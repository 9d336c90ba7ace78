"""Mamba's closed form, new here. The port counts mamba only by running it
under ``FlopCounterMode``; this form counts the same products by hand and
comes out 1.515% under that count (6.951503e13 an example at mamba-2.8b):
the counter also counts the LM head's logits a second time, in the backward
that recomputes each chunk, 2 x d_model x vocab x 4095 FLOPs. With that
term added the two agree to 1e-5."""


def flops_per_token(num_layers: int, d_model: int, d_inner: int, d_state: int, d_conv: int, dt_rank: int,
                    vocab: int) -> float:
    """Forward and backward FLOPs a token: per layer in_proj (d_model ->
    2 d_inner), the depthwise conv (d_conv taps), x_proj (d_inner -> dt_rank
    + 2 d_state), dt_proj (dt_rank -> d_inner), the selective scan (9 a
    state and channel, mamba_ssm's ``flops_selective_scan_ref``, plus the D
    skip) and out_proj (d_inner -> d_model); the tied head 2*d_model*V."""
    per_layer = (2 * d_model * 2 * d_inner + 2 * d_conv * d_inner + 2 * d_inner * (dt_rank + 2 * d_state)
                 + 2 * dt_rank * d_inner + 9 * d_inner * d_state + d_inner + 2 * d_inner * d_model)
    return 3.0 * (num_layers * per_layer + 2 * d_model * vocab)


def flops_per_sequence(cfg: dict) -> float:
    return cfg["sequence_length"] * flops_per_token(cfg["n_layer"], cfg["d_model"], cfg["d_inner"], cfg["d_state"],
                                                    cfg["d_conv"], cfg["dt_rank"], cfg["padded_vocab_size"])
