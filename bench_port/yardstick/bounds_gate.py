"""The least time the card could take for one call of each gate kernel (the
port's ``gate_silu_fwd_kernel`` and ``gate_silu_bwd_kernel``, mamba's
y * SiLU(z)), from the call's shape: its bytes over the memory rate, each
input read once and each output written once. Kept here, apart from the
port, so that a change to the program cannot move the yardstick.

The forward reads y and z [rows, channels] and writes the gated output, all
in the compute dtype. The backward reads the output's gradient, y and z and
writes the gradients of y and z, all in the compute dtype. Their operations
(a few a element) are far below the card's rates.
"""

PEAK_BYTES = 3.35e12  # H100 SXM's HBM3 (NVIDIA's data sheet)
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def gate_bytes(rows: int, channels: int, compute: str) -> dict:
    """Bytes a forward and a backward call must move."""
    tensor = rows * channels * DTYPE_BYTES[compute]
    return {"fwd": 3 * tensor, "bwd": 5 * tensor}


def gate_bounds(rows: int, channels: int, compute: str) -> dict:
    """Seconds a forward and a backward call take at least."""
    return {k: v / PEAK_BYTES for k, v in gate_bytes(rows, channels, compute).items()}
