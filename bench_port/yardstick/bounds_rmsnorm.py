"""The least time the card could take for one call of each RMSNorm kernel
(the port's ``rmsnorm_fwd_kernel`` and ``rmsnorm_bwd_kernel``), from the
call's shape: its bytes over the memory rate, each input read once and each
output written once. Kept here, apart from the port, so that a change to
the program cannot move the yardstick.

The forward reads the stream x [rows, cols] and the f32 scale, and writes y
in the compute dtype and an f32 rstd a row. The backward reads dy in the
compute dtype, x, the rstd and the scale, and, where the norm feeds a
residual add, the stream's incoming gradient in the stream's dtype; it
writes the stream's gradient in that dtype and the scale's f32 gradient.
Their operations (a few a element) are far below the card's rates.
"""

PEAK_BYTES = 3.35e12  # H100 SXM's HBM3 (NVIDIA's data sheet)
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def rmsnorm_bytes(rows: int, cols: int, stream: str, compute: str, residual: bool) -> dict:
    """Bytes a forward and a backward call must move."""
    s, c, n = DTYPE_BYTES[stream], DTYPE_BYTES[compute], rows * cols
    scale, stats = cols * 4, rows * 4
    return {"fwd": n * s + scale + n * c + stats,
            "bwd": n * c + n * s + stats + scale + (n * s if residual else 0) + n * s + scale}


def rmsnorm_bounds(rows: int, cols: int, stream: str, compute: str, residual: bool) -> dict:
    """Seconds a forward and a backward call take at least."""
    return {k: v / PEAK_BYTES for k, v in rmsnorm_bytes(rows, cols, stream, compute, residual).items()}
