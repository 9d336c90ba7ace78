"""granite-4.0-h-micro's closed form, in ``flops_jamba.py``'s conventions:
products only, 2 FLOPs a multiply-add, the backward twice the forward, no
recompute. A Mamba-2 mixer counts in_proj, the depthwise conv, the SSD's
products as the published chunked decomposition does them (C B^T once a
chunk and group, each head's chunk state and its entering state's outputs,
the intra-chunk product over the causal pairs with the diagonal) and
out_proj; the gated norm, dt's softplus and the multipliers are elementwise
and count nothing. Attention counts its causal core, half the (query, key)
pairs, as Jamba's does. Under ``FlopCounterMode`` the port counts, besides,
the LM head's logits a second time in the backward that recomputes each
chunk, the head over the shifted S - 1 positions and not S, and the causal
pairs on the diagonal (S (S + 1) / 2, not S^2 / 2); ``bench_port/tests``
checks the form against that count with those terms added."""


def layer_counts(cfg: dict) -> tuple[int, int]:
    """(attention layers, Mamba-2 layers)."""
    attention = sum(1 for kind in cfg["layer_types"] if kind == "attention")
    return attention, len(cfg["layer_types"]) - attention


def ssd_flops_per_token(cfg: dict) -> float:
    """The SSD's forward products a token, chunks of Q: C B^T 2 Q N a group,
    and a head's chunk state and entering state's outputs 2 N P each and its
    intra-chunk pairs (Q + 1) / 2 of 2 P."""
    nh, hd, n = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"]
    q, groups = cfg["mamba_chunk_size"], cfg["mamba_n_groups"]
    return 2 * q * n * groups + nh * (4 * n * hd + hd * (q + 1))


def flops_per_token(cfg: dict, seq_len: int) -> float:
    """Forward and backward FLOPs a token at ``seq_len`` positions: per
    Mamba-2 mixer in_proj (d_model -> z, xBC and dt), the conv over xBC, the
    SSD and out_proj; per attention mixer q, k, v and the output projection,
    and the causal scores and values, 2 S H; per layer the SwiGLU MLP's three
    products; the tied head 2 d_model V."""
    dm, ffn, vocab = cfg["hidden_size"], cfg["shared_intermediate_size"], cfg["vocab_size"]
    nh, hd, n, groups, k = (cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"], cfg["mamba_n_groups"],
                            cfg["mamba_d_conv"])
    di = nh * hd
    conv = di + 2 * groups * n
    heads, kv_heads = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = dm // heads
    mamba = 2 * dm * (di + conv + nh) + 2 * k * conv + ssd_flops_per_token(cfg) + 2 * di * dm
    attention = 2 * dm * (heads + 2 * kv_heads) * d + 2 * heads * d * dm + 2 * seq_len * heads * d
    mlp = 3 * 2 * dm * ffn
    n_attn, n_mamba = layer_counts(cfg)
    return 3.0 * (n_mamba * mamba + n_attn * attention + len(cfg["layer_types"]) * mlp + 2 * dm * vocab)


def flops_per_sequence(cfg: dict) -> float:
    return cfg["sequence_length"] * flops_per_token(cfg, cfg["sequence_length"])
