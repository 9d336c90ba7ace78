"""Mamba's gate ``y * SiLU(z)`` on two hand-written CUDA kernels
(``csrc/gate.cu``, built on first use by ``ops/_build.py``): mamba_ssm's
arithmetic, in f32 and rounded once to the compute dtype.

``gate_silu(y, z)`` is ``y * SiLU(z)`` for y and z [B, L, I] of one dtype
(bf16 or f32), computed in f32 and rounded once to y's dtype, contiguous.
Either may be a view whose rows are further apart than I: z is the second
half of ``in_proj``'s [B, L, 2I] output, which the kernels read where it
lies, uncopied. The forward and the backward are ``torch.library`` custom
ops, ``mlpt::gate_silu_fwd`` (out) and ``mlpt::gate_silu_bwd`` (dy in y's
dtype, dz in z's); the forward's autograd rule saves y and the z view, and
no f32 tensor.

Which version an op runs is decided by where the tensors lie, and nothing
else: CUDA tensors launch the kernels or raise, CPU tensors run the plain
versions, ``gate_silu_fwd_reference`` and ``gate_silu_bwd_reference``. The
plain forward is the composition the port computed before the kernels,
``(y.float() * F.silu(z.float())).to(y.dtype)``, and the plain backward is
the gradient autograd took of it, by the same ATen ops, so the CPU path
computes what it did, bit for bit. There is no fallback from a kernel to its
plain version. ``GATE_FWD_LAUNCHES`` and ``GATE_BWD_LAUNCHES`` count the
kernels' launches.

The kernels replace no TPU kernel: the JAX package's gate is XLA's. Their
bound is bytes: at mamba-2.8b's micro-batch of 8 x 4096 rows of 5120 in bf16
the forward reads y and z and writes out (1.007 GB, 0.300 ms at 3.35 TB/s),
the backward reads dout, y and z and writes dy and dz (1.678 GB, 0.501 ms).
The eager composition made four passes forward and about six backward over
f32 temporaries, and saved two f32 tensors for its backward.
"""

import torch
import torch.nn.functional as F

from . import _build

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
PIECE_BYTES = 16  # the kernels' vector loads and stores

# Kernel launches in this process, counted by the wrappers right where they
# launch; plain-version calls do not count.
GATE_FWD_LAUNCHES = 0
GATE_BWD_LAUNCHES = 0


def reset_launch_counts() -> None:
    global GATE_FWD_LAUNCHES, GATE_BWD_LAUNCHES
    GATE_FWD_LAUNCHES = GATE_BWD_LAUNCHES = 0


# ---------------------------------------------------------------- plain versions


def gate_silu_fwd_reference(y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward kernel: y * SiLU(z) in f32, rounded once
    to y's dtype; contiguous [B, L, I]."""
    return (y.float() * F.silu(z.float())).to(y.dtype).contiguous()


def gate_silu_bwd_reference(y: torch.Tensor, z: torch.Tensor,
                            dout: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel: (dy in y's dtype, dz in z's),
    the gradient autograd takes of ``gate_silu_fwd_reference`` through the
    ATen ops its graph's nodes call: the f32 cotangent, the product's two
    gradients, SiLU's backward at the f32 z, then the casts."""
    g, zf = dout.float(), z.float()
    dy = (g * F.silu(zf)).to(y.dtype)
    dz = torch.ops.aten.silu_backward(g * y.float(), zf).to(z.dtype)
    return dy.contiguous(), dz.contiguous()


# ---------------------------------------------------------------- kernels


def _row_stride(t: torch.Tensor) -> int | None:
    """The stride in elements between consecutive rows of [B, L, I] taken as
    B x L rows, or None where the rows are not evenly spaced."""
    bsz, L, _ = t.shape
    if L == 1:
        return t.stride(0)
    if bsz == 1 or t.stride(0) == L * t.stride(1):
        return t.stride(1)
    return None


def _rows_of(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """t with contiguous channels and evenly spaced rows (a view as given,
    else a copy), and its row stride."""
    if t.stride(-1) != 1 or _row_stride(t) is None:
        t = t.contiguous()
    return t, _row_stride(t)


def _kernel_inputs(y: torch.Tensor, z: torch.Tensor):
    """Check what the kernels take; return y and z as ``_rows_of`` gives
    them, with their row strides."""
    if y.device.type != "cuda" or z.device != y.device:
        raise ValueError(f"gate kernels take CUDA tensors on one device, got {y.device} and {z.device}")
    if y.ndim != 3 or 0 in y.shape or z.shape != y.shape:
        raise ValueError(f"gate kernels take non-empty y and z [B, L, I] of one shape, got {tuple(y.shape)} and "
                         f"{tuple(z.shape)}")
    if y.dtype not in _DTYPE_CODE or z.dtype != y.dtype:
        raise ValueError(f"gate kernels take bf16 or f32 y and z of one dtype, got {y.dtype} and {z.dtype}")
    (y, ys), (z, zs) = _rows_of(y), _rows_of(z)
    return y, ys, z, zs


def _vec(tensors, strides, I: int) -> bool:
    """Whether every row is whole 16-byte pieces: the pointers aligned, I
    and the row strides multiples of a piece."""
    per_piece = PIECE_BYTES // tensors[0].element_size()
    return (all(t.data_ptr() % PIECE_BYTES == 0 for t in tensors) and I % per_piece == 0
            and all(s % per_piece == 0 for s in strides))


def gate_silu_fwd_cuda(y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel: out contiguous [B, L, I] in y's dtype."""
    global GATE_FWD_LAUNCHES
    y, ys, z, zs = _kernel_inputs(y, z)
    bsz, L, I = y.shape
    out = torch.empty(bsz, L, I, dtype=y.dtype, device=y.device)
    lib = _build.load()
    with torch.cuda.device(y.device):
        err = lib.mlpt_gate_silu_fwd(y.data_ptr(), ys, z.data_ptr(), zs, out.data_ptr(), bsz * L, I,
                                     _DTYPE_CODE[y.dtype], int(_vec((y, z, out), (ys, zs), I)),
                                     torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(lib, err, "gate forward kernel")
    GATE_FWD_LAUNCHES += 1
    return out


def gate_silu_bwd_cuda(y: torch.Tensor, z: torch.Tensor, dout: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel: (dy, dz), contiguous [B, L, I] in y's
    and z's dtype."""
    global GATE_BWD_LAUNCHES
    y, ys, z, zs = _kernel_inputs(y, z)
    bsz, L, I = y.shape
    if dout.shape != y.shape or dout.device != y.device:
        raise ValueError(f"dout must be {tuple(y.shape)} on {y.device}, got {tuple(dout.shape)} on {dout.device}")
    dout = dout.to(y.dtype).contiguous()
    dy = torch.empty(bsz, L, I, dtype=y.dtype, device=y.device)
    dz = torch.empty(bsz, L, I, dtype=z.dtype, device=y.device)
    lib = _build.load()
    with torch.cuda.device(y.device):
        err = lib.mlpt_gate_silu_bwd(dout.data_ptr(), y.data_ptr(), ys, z.data_ptr(), zs, dy.data_ptr(),
                                     dz.data_ptr(), bsz * L, I, _DTYPE_CODE[y.dtype],
                                     int(_vec((dout, y, z, dy, dz), (ys, zs), I)),
                                     torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(lib, err, "gate backward kernel")
    GATE_BWD_LAUNCHES += 1
    return dy, dz


# ---------------------------------------------------------------- custom ops
#
# Each op's CUDA implementation launches a kernel, its CPU implementation is
# the plain version: the only place where the choice is made.


def _no_kernel(y: torch.Tensor, *args) -> None:
    raise ValueError(f"the gate has no kernel for device {y.device}")


@torch.library.custom_op("mlpt::gate_silu_fwd", mutates_args=())
def gate_silu_fwd(y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """y * SiLU(z), contiguous [B, L, I] in y's dtype."""
    _no_kernel(y)


@torch.library.custom_op("mlpt::gate_silu_bwd", mutates_args=())
def gate_silu_bwd(y: torch.Tensor, z: torch.Tensor, dout: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(dy in y's dtype, dz in z's dtype)."""
    _no_kernel(y)


gate_silu_fwd.register_kernel("cuda")(gate_silu_fwd_cuda)
gate_silu_fwd.register_kernel("cpu")(gate_silu_fwd_reference)
gate_silu_bwd.register_kernel("cuda")(gate_silu_bwd_cuda)
gate_silu_bwd.register_kernel("cpu")(gate_silu_bwd_reference)


@gate_silu_fwd.register_fake
def _(y, z):
    return y.new_empty(y.shape)


@gate_silu_bwd.register_fake
def _(y, z, dout):
    return y.new_empty(y.shape), z.new_empty(z.shape)


def _setup_context(ctx, inputs, output) -> None:
    """Save y and z as given (z the view of in_proj's output): the backward
    recomputes SiLU(z) from them."""
    ctx.save_for_backward(*inputs)


def _backward(ctx, dout):
    return gate_silu_bwd(*ctx.saved_tensors, dout)


gate_silu_fwd.register_autograd(_backward, setup_context=_setup_context)

gate_silu = gate_silu_fwd  # the forward op with its autograd rule, under the name the model calls
