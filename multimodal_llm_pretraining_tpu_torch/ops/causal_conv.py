"""Mamba's depthwise causal conv with its bias and SiLU on two hand-written
CUDA kernels (``csrc/causal_conv.cu``, built on first use by
``ops/_build.py``): mamba_ssm's causal-conv1d arithmetic, in f32 and rounded
once to the compute dtype.

``causal_conv_silu(x, weight, bias)`` is ``SiLU(causal_conv1d(x) + bias)``
for x [B, L, I] (bf16 or f32), the taps ``weight`` [K, I] in the JAX layout
and ``bias`` [I], each in the parameters' own dtype: the conv, its bias and
the SiLU in f32, the result rounded once to x's dtype, contiguous. x may be
a view whose rows are further apart than I, the half of ``in_proj``'s
[B, L, 2I] output that the block convolves: the kernels read it where it
lies, uncopied. The forward and the backward are ``torch.library`` custom
ops, ``mlpt::causal_conv_fwd`` (out) and ``mlpt::causal_conv_bwd`` (dx in
x's dtype, dw and db in the parameters' dtypes), so that the FLOP counter
counts them (``benchmarking/flops.py``); the forward's autograd rule saves
x (the view), the taps and the bias, and no f32 tensor.

Which version an op runs is decided by where the tensors lie, and nothing
else: CUDA tensors launch the kernels or raise, CPU tensors run the plain
versions, ``causal_conv_fwd_reference`` and ``causal_conv_bwd_reference``.
The plain forward is the composition the port computed before the kernels,
``F.silu(causal_conv1d(x.float(), w.float(), b.float())).to(x.dtype)``, and
the plain backward is the gradient autograd took of it, by the same ATen
ops, so the CPU path computes what it did, bit for bit. The kernels take K
up to 4 (mamba's published ``d_conv``), any L and any I; there is no
fallback from a kernel to its plain version. ``CONV_FWD_LAUNCHES`` and
``CONV_BWD_LAUNCHES`` count the kernels' launches.

The kernels replace no TPU kernel: the JAX package's conv is XLA's. Their
bound is bytes: at mamba-2.8b's micro-batch of 8 x 4096 rows of 5120 in
bf16 the forward reads x and writes out (671 MB, 0.200 ms at 3.35 TB/s), the
backward reads x and dout and writes dx (1.0 GB, 0.300 ms). The eager
composition made seven passes forward, f32 temporaries among them.
"""

import torch
import torch.nn.functional as F

from . import _build
from .selective_scan import causal_conv1d

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
MAX_WIDTH = 4  # the kernels' largest K
VEC_MULTIPLE = 8  # I and x's strides in elements, for the kernels' whole 8- and 16-byte pieces

# Kernel launches in this process, counted by the wrappers right where they
# launch; plain-version calls do not count.
CONV_FWD_LAUNCHES = 0
CONV_BWD_LAUNCHES = 0


def reset_launch_counts() -> None:
    global CONV_FWD_LAUNCHES, CONV_BWD_LAUNCHES
    CONV_FWD_LAUNCHES = CONV_BWD_LAUNCHES = 0


# ---------------------------------------------------------------- plain versions


def causal_conv_fwd_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward kernel: the conv, its bias and the SiLU
    in f32, rounded once to x's dtype; contiguous [B, L, I]."""
    return F.silu(causal_conv1d(x.float(), weight.float(), bias.float())).to(x.dtype).contiguous()


def causal_conv_bwd_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                              dout: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel: (dx in x's dtype, dw [K, I] in
    the taps' dtype, db [I] in the bias's), the gradient autograd takes of
    ``causal_conv_fwd_reference`` through the ATen ops its graph's nodes
    call, on the same operands: the f32 cotangent, SiLU's backward at the
    (transposed) conv output, the convolution's backward at the padded
    input, then the pad's slice and the casts."""
    k, c = weight.shape
    x_pad = F.pad(x.float().transpose(1, 2), (k - 1, 0))
    w3 = weight.float().t().unsqueeze(1)
    pre = F.conv1d(x_pad, w3, bias.float(), groups=c).transpose(1, 2)
    g = torch.ops.aten.silu_backward(dout.float(), pre).transpose(1, 2)
    dx_pad, dw3, db = torch.ops.aten.convolution_backward(g, x_pad, w3, [c], [1], [0], [1], False, [0], c,
                                                          [True, True, True])
    dx = dx_pad[..., k - 1:].transpose(1, 2)
    return (dx.to(x.dtype).contiguous(), dw3.squeeze(1).t().to(weight.dtype).contiguous(),
            db.to(bias.dtype))


# ---------------------------------------------------------------- kernels


def _kernel_inputs(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor):
    """Check what the kernels take; return x (channels contiguous: a view
    as given, else a copy), the taps and bias contiguous, and whether x's
    rows are whole aligned pieces. A grid past the card's (more than 65,535
    sequences) is refused by the launch, which raises."""
    if x.device.type != "cuda":
        raise ValueError(f"causal-conv kernels take CUDA tensors, got {x.device}")
    if x.ndim != 3 or 0 in x.shape:
        raise ValueError(f"causal-conv kernels take a non-empty x [B, L, I], got {tuple(x.shape)}")
    I = x.shape[-1]
    if x.dtype not in _DTYPE_CODE or weight.dtype not in _DTYPE_CODE or bias.dtype != weight.dtype:
        raise ValueError(f"causal-conv kernels take bf16 or f32 x and bf16 or f32 taps and bias of one dtype, got "
                         f"{x.dtype}, {weight.dtype} and {bias.dtype}")
    if weight.ndim != 2 or not 1 <= weight.shape[0] <= MAX_WIDTH or weight.shape[1] != I or bias.shape != (I,):
        raise ValueError(f"causal-conv kernels take taps [K <= {MAX_WIDTH}, {I}] and bias [{I}], got "
                         f"{tuple(weight.shape)} and {tuple(bias.shape)}")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError("causal-conv kernel inputs must lie on one device")
    if x.stride(-1) != 1:
        x = x.contiguous()
    vec = (x.data_ptr() % 16 == 0 and I % VEC_MULTIPLE == 0 and x.stride(0) % VEC_MULTIPLE == 0
           and x.stride(1) % VEC_MULTIPLE == 0)
    return x, weight.contiguous(), bias.contiguous(), vec


def causal_conv_fwd_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel: out contiguous [B, L, I] in x's dtype."""
    global CONV_FWD_LAUNCHES
    x, weight, bias, vec = _kernel_inputs(x, weight, bias)
    bsz, L, I = x.shape
    out = torch.empty(bsz, L, I, dtype=x.dtype, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.mlpt_causal_conv_fwd(x.data_ptr(), x.stride(0), x.stride(1), weight.data_ptr(), bias.data_ptr(),
                                       out.data_ptr(), bsz, L, I, weight.shape[0], _DTYPE_CODE[x.dtype],
                                       _DTYPE_CODE[weight.dtype], int(vec),
                                       torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "causal-conv forward kernel")
    CONV_FWD_LAUNCHES += 1
    return out


def causal_conv_bwd_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         dout: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel: (dx contiguous in x's dtype, dw [K, I] and
    db [I] in the parameters' dtype). dw and db come from the kernel as f32
    partials, one row a block, summed here in a fixed order, so two runs
    give identical results."""
    global CONV_BWD_LAUNCHES
    x, weight, bias, vec = _kernel_inputs(x, weight, bias)
    bsz, L, I = x.shape
    if dout.shape != x.shape or dout.device != x.device:
        raise ValueError(f"dout must be {tuple(x.shape)} on {x.device}, got {tuple(dout.shape)} on {dout.device}")
    dout = dout.to(x.dtype).contiguous()
    if dout.data_ptr() % 16:
        dout = dout.clone()
    k = weight.shape[0]
    dx = torch.empty(bsz, L, I, dtype=x.dtype, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        part = torch.empty(lib.mlpt_causal_conv_bwd_partials(bsz, L), k + 1, I, dtype=torch.float32, device=x.device)
        err = lib.mlpt_causal_conv_bwd(x.data_ptr(), x.stride(0), x.stride(1), weight.data_ptr(), bias.data_ptr(),
                                       dout.data_ptr(), dx.data_ptr(), part.data_ptr(), bsz, L, I, k,
                                       _DTYPE_CODE[x.dtype], _DTYPE_CODE[weight.dtype], int(vec),
                                       torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "causal-conv backward kernel")
    CONV_BWD_LAUNCHES += 1
    dwb = part.sum(0)
    return dx, dwb[:k].to(weight.dtype), dwb[k].to(bias.dtype, copy=True)  # db apart from dw's storage


# ---------------------------------------------------------------- custom ops
#
# Each op's CUDA implementation launches a kernel, its CPU implementation is
# the plain version: the only place where the choice is made.


def _no_kernel(x: torch.Tensor, *args) -> None:
    raise ValueError(f"causal conv has no kernel for device {x.device}")


@torch.library.custom_op("mlpt::causal_conv_fwd", mutates_args=())
def causal_conv_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """SiLU(causal conv of x + bias), contiguous [B, L, I] in x's dtype."""
    _no_kernel(x)


@torch.library.custom_op("mlpt::causal_conv_bwd", mutates_args=())
def causal_conv_bwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    dout: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dw and db in the parameters' dtypes)."""
    _no_kernel(x)


causal_conv_fwd.register_kernel("cuda")(causal_conv_fwd_cuda)
causal_conv_fwd.register_kernel("cpu")(causal_conv_fwd_reference)
causal_conv_bwd.register_kernel("cuda")(causal_conv_bwd_cuda)
causal_conv_bwd.register_kernel("cpu")(causal_conv_bwd_reference)


@causal_conv_fwd.register_fake
def _(x, weight, bias):
    return x.new_empty(x.shape)


@causal_conv_bwd.register_fake
def _(x, weight, bias, dout):
    return x.new_empty(x.shape), weight.new_empty(weight.shape), bias.new_empty(bias.shape)


def _setup_context(ctx, inputs, output) -> None:
    """Save x as given (the view of in_proj's output), the taps and the
    bias: the backward recomputes the conv from them."""
    ctx.save_for_backward(*inputs)


def _backward(ctx, dout):
    return causal_conv_bwd(*ctx.saved_tensors, dout)


causal_conv_fwd.register_autograd(_backward, setup_context=_setup_context)

causal_conv_silu = causal_conv_fwd  # the forward op with its autograd rule, under the name the model calls
