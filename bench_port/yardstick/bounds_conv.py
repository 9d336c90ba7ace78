"""The least time the card could take for one call of each causal-conv
kernel (the port's ``causal_conv_fwd_kernel`` and ``causal_conv_bwd_kernel``,
mamba's depthwise conv with its bias and SiLU), from the call's shape: its
bytes over the memory rate, each input read once and each output written
once. Kept here, apart from the port, so that a change to the program
cannot move the yardstick.

The forward reads x [rows, channels] in the compute dtype, the taps [width,
channels] and the bias [channels] in the parameters' dtype, and writes the
output in the compute dtype. The backward reads x, the output's gradient,
the taps and the bias, and writes x's gradient in the compute dtype and the
f32 sums of the taps' and the bias's gradients. Their operations (about ten
a byte) are far below the card's rates.
"""

PEAK_BYTES = 3.35e12  # H100 SXM's HBM3 (NVIDIA's data sheet)
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def param_dtype(state_layout: str) -> str:
    """The parameters' dtype under a state layout: bf16 under ``bf16_sr``."""
    return "bfloat16" if state_layout == "bf16_sr" else "float32"


def conv_bytes(rows: int, channels: int, width: int, compute: str, params: str) -> dict:
    """Bytes a forward and a backward call must move."""
    c, p, n = DTYPE_BYTES[compute], DTYPE_BYTES[params], rows * channels
    taps, bias = width * channels * p, channels * p
    return {"fwd": n * c + taps + bias + n * c,
            "bwd": n * c + n * c + taps + bias + n * c + (width + 1) * channels * 4}


def conv_bounds(rows: int, channels: int, width: int, compute: str, params: str) -> dict:
    """Seconds a forward and a backward call take at least."""
    return {k: v / PEAK_BYTES for k, v in conv_bytes(rows, channels, width, compute, params).items()}
