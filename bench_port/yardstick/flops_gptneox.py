"""GPT-NeoX's closed form: a copy of the port's
``transformer_flops_per_token`` (``benchmarking/flops.py``), the formula the
repo's MFU has always used. Attention counts every (query, key) pair, with
no causal halving, as the port's own closed form does."""


def flops_per_token(num_layers: int, hidden: int, seq_len: int, vocab: int, ffn_mult: float = 4.0) -> float:
    """Forward and backward FLOPs a token: per layer QKVO 8H^2, MLP
    4*ffn_mult*H^2, attention scores and values 4*S*H; the head 2*H*V."""
    per_layer = (8 + 4 * ffn_mult) * hidden * hidden + 4 * seq_len * hidden
    return 3.0 * (num_layers * per_layer + 2 * hidden * vocab)


def flops_per_sequence(cfg: dict) -> float:
    s = cfg["sequence_length"]
    return s * flops_per_token(cfg["num_hidden_layers"], cfg["hidden_size"], s, cfg["vocab_size"],
                               cfg["intermediate_size"] / cfg["hidden_size"])
