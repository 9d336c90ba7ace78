"""Jamba's closed form, in ``flops_mamba.py``'s and ``flops_gptneox.py``'s
conventions: products only, 2 FLOPs a multiply-add, the backward twice the
forward, no recompute. The Mamba layers count as ``flops_mamba.py``'s (the
inner norms and the gate are elementwise and count nothing); attention
counts its causal core, half the (query, key) pairs, as the flash kernels
do the work. Under ``FlopCounterMode`` the port counts, besides, the LM
head's logits a second time in the backward that recomputes each chunk,
the head over the shifted S - 1 positions and not S, and the causal pairs
on the diagonal (S (S + 1) / 2, not S^2 / 2); ``bench_port/tests`` checks
the form against that count with those terms added."""


def layer_counts(cfg: dict) -> tuple[int, int]:
    """(attention layers, Mamba layers)."""
    period, offset, layers = cfg["attn_layer_period"], cfg["attn_layer_offset"], cfg["num_hidden_layers"]
    attention = sum(1 for i in range(layers) if i % period == offset)
    return attention, layers - attention


def flops_per_token(cfg: dict, seq_len: int) -> float:
    """Forward and backward FLOPs a token at ``seq_len`` positions: per
    Mamba mixer in_proj (d_model -> 2 d_inner), the depthwise conv, x_proj
    (d_inner -> dt_rank + 2 d_state), dt_proj, the selective scan (9 a state
    and channel, plus the D skip) and out_proj; per attention mixer q, k, v
    and the output projection, and the causal scores and values, 2 S H; per
    layer the SwiGLU MLP's three products; the tied head 2 d_model V."""
    dm, di, ffn, vocab = cfg["hidden_size"], cfg["d_inner"], cfg["intermediate_size"], cfg["vocab_size"]
    n, k, r = cfg["mamba_d_state"], cfg["mamba_d_conv"], cfg["mamba_dt_rank"]
    heads, kv_heads = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = dm // heads
    mamba = (2 * dm * 2 * di + 2 * k * di + 2 * di * (r + 2 * n) + 2 * r * di + 9 * di * n + di + 2 * di * dm)
    attention = 2 * dm * (heads + 2 * kv_heads) * d + 2 * heads * d * dm + 2 * seq_len * heads * d
    mlp = 3 * 2 * dm * ffn
    n_attn, n_mamba = layer_counts(cfg)
    return 3.0 * (n_mamba * mamba + n_attn * attention + cfg["num_hidden_layers"] * mlp + 2 * dm * vocab)


def flops_per_sequence(cfg: dict) -> float:
    return cfg["sequence_length"] * flops_per_token(cfg, cfg["sequence_length"])
