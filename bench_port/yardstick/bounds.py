"""The least time the card could take for one call of each hand-written
kernel, from the call's shape: a copy of the bound arithmetic of the port's
``chip_smoke.py`` (``bound``, ``attention_bounds``) and ``time_scan.py``.

A call's bound is the larger of its bytes over the memory rate (each input
read once, each output written once) and its operations over their rate:
products at the bf16 tensor-core rate for attention, f32 operations outside
the tensor cores for the scan, and one exp per (query, key) pair or per
state and step at the special-function rate.
"""

# H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W). The exp rate: 16
# special-function results per SM per clock (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0) x 132 SMs x
# 1.98 GHz.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
PEAK_EXPS = 16 * 132 * 1.98e9

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(nbytes: float, flops: float, flop_rate: float, exps: float) -> float:
    return max(nbytes / PEAK_BYTES, flops / flop_rate, exps / PEAK_EXPS)


def visible_pairs(bh: int, q_seq: int, kv_seq: int, causal: bool) -> int:
    """(query, key) pairs some query row sees, all lengths full."""
    if not causal:
        return bh * q_seq * kv_seq
    return bh * sum(min(i, kv_seq) for i in range(1, q_seq + 1))


def flash_bounds(batch: int, heads: int, seq: int, head_dim: int, causal: bool, dtype: str = "bfloat16") -> dict:
    """Seconds a forward (q, k, v -> out and an f32 lse row; 2 products)
    and a backward (q, k, v, out, dO, lse -> dq, dk, dv; 5 products) take at
    least, on [batch, heads, seq, head_dim] self-attention."""
    pairs = visible_pairs(batch * heads, seq, seq, causal)
    f = 2 * head_dim * pairs
    tensor = batch * heads * seq * head_dim * DTYPE_BYTES[dtype]
    stats = batch * heads * seq * 4
    return {
        "fwd": bound_s(3 * tensor + tensor + stats, 2 * f, PEAK_BF16_FLOPS, pairs),
        "bwd": bound_s(3 * tensor + 2 * tensor + stats + 3 * tensor, 5 * f, PEAK_BF16_FLOPS, pairs),
    }


def scan_bounds(batch: int, seq: int, d_inner: int, d_state: int, dtype: str = "bfloat16", chunk: int = 256) -> dict:
    """Seconds the selective-scan forward and backward take at least, on the
    operands as the kernels take them: u and delta [B, L, I] and B, C
    [B, L, N] in ``dtype``, A [I, N] and D [I] f32; the forward writes y in
    ``dtype`` and the f32 state entering each ``chunk``-step chunk; the
    backward reads an f32 dy and that state, and writes f32 du, ddelta
    [B, L, I], dA [I, N], dB, dC [B, L, N]. Operations: 6 f32 a state and
    step forward, 16 backward, one exp each way."""
    w = DTYPE_BYTES[dtype]
    bli, bln, elems = batch * seq * d_inner, batch * seq * d_state, batch * seq * d_inner * d_state
    ckpt = batch * -(-seq // chunk) * d_state * d_inner * 4
    inputs = 2 * bli * w + 2 * bln * w + d_inner * d_state * 4
    return {
        "fwd": bound_s(inputs + d_inner * 4 + bli * w + ckpt, 6 * elems, PEAK_F32_FLOPS, elems),
        "bwd": bound_s(inputs + bli * 4 + ckpt + 2 * bli * 4 + d_inner * d_state * 4 + 2 * bln * 4, 16 * elems,
                       PEAK_F32_FLOPS, elems),
    }
