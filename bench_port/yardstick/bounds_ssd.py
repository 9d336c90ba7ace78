"""The least time the card could take for one call of the SSD, Mamba-2's
chunked scan (the port's ``mlpt::ssd_fwd`` and ``mlpt::ssd_bwd``, whatever
kernels implement them), from the call's shape: the larger of its bytes over
the memory rate and its products over the bf16 tensor-core rate. Kept here,
apart from the port, so that a change to the program cannot move the
yardstick.

Bytes are the op's inputs and outputs only, each read or written once:
forward x [B, L, H, P] in the compute dtype, dt [B, L, H] in f32, B and C
[B, L, G, N] in the compute dtype, A and D [H] in f32, and y like x; the
backward reads those inputs and dy and writes dx, ddt, dB, dC, dA and dD in
their inputs' dtypes. Whatever an implementation keeps between its steps
(the states entering each chunk, C B^T) is its own traffic. Products are
the published chunked decomposition's (``flops_granite.ssd_flops_per_token``),
the backward twice the forward.
"""

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense (NVIDIA's data sheet, 700 W)
PEAK_BYTES = 3.35e12  # H100 SXM's HBM3
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def ssd_bytes(batch: int, seq: int, heads: int, head_dim: int, groups: int, d_state: int,
              compute: str = "bfloat16") -> dict:
    """Bytes a forward and a backward call must move."""
    w = DTYPE_BYTES[compute]
    x = batch * seq * heads * head_dim * w
    dt = batch * seq * heads * 4
    bc = 2 * batch * seq * groups * d_state * w
    params = 2 * heads * 4
    inputs = x + dt + bc + params
    return {"fwd": inputs + x, "bwd": inputs + x + inputs}


def ssd_products(batch: int, seq: int, heads: int, head_dim: int, groups: int, d_state: int, chunk: int) -> dict:
    """Products of a forward and a backward call, whole chunks."""
    chunks = batch * -(-seq // chunk)
    fwd = chunks * (2 * chunk * chunk * d_state * groups
                    + heads * (4 * chunk * d_state * head_dim + head_dim * chunk * (chunk + 1)))
    return {"fwd": fwd, "bwd": 2 * fwd}


def ssd_bounds(batch: int, seq: int, heads: int, head_dim: int, groups: int, d_state: int, chunk: int,
               compute: str = "bfloat16") -> dict:
    """Seconds a forward and a backward call take at least."""
    nbytes = ssd_bytes(batch, seq, heads, head_dim, groups, d_state, compute)
    flops = ssd_products(batch, seq, heads, head_dim, groups, d_state, chunk)
    return {k: max(nbytes[k] / PEAK_BYTES, flops[k] / PEAK_BF16_FLOPS) for k in ("fwd", "bwd")}


def cell_bounds(cfg: dict, micro_batch: int) -> dict:
    """``ssd_bounds`` at a configuration's shape and a micro-batch."""
    return ssd_bounds(micro_batch, cfg["sequence_length"], cfg["mamba_n_heads"], cfg["mamba_d_head"],
                      cfg["mamba_n_groups"], cfg["mamba_d_state"], cfg["mamba_chunk_size"], cfg["compute_dtype"])
