"""RMSNorm on two hand-written CUDA kernels (``csrc/rmsnorm.cu``, built on
first use by ``ops/_build.py``): the published ``fused_add_norm`` of
state-spaces/mamba, whose residual stream is f32 (``residual_in_fp32``).

``rmsnorm(x, weight, eps, dtype)`` is flax's ``nn.RMSNorm`` as
``layers.RMSNorm`` computes it: the mean square of each row in f32, then
``x * (rsqrt(ms + eps) * weight)`` in f32, rounded once to ``dtype``. Its
autograd Function, ``_RMSNorm``, keeps x, the scale and each row's f32 rstd;
its backward writes the row's gradient in x's dtype and, where the scale
trains, the scale's from per-block partial sums, summed once. With
``residual=True`` it also returns
x itself, for the caller's residual add (``x + block(norm(x))``): the add's
gradient for x then reaches this backward, which adds it to the norm's own
in the same pass, so the stream's gradient is written once, where autograd
would sum the two in a pass of its own.

``rmsnorm_fwd`` and ``rmsnorm_bwd`` launch the kernels on CUDA tensors and
run their plain PyTorch versions, ``rmsnorm_fwd_reference`` and
``rmsnorm_bwd_reference``, on CPU tensors: a CUDA tensor launches the
kernel or raises. ``kernel_takes`` says which inputs the kernels take (f32
or bf16 rows of a multiple of 4 up to 8192 columns on the card);
``layers.RMSNorm`` sends every CUDA tensor here and computes CPU tensors
with its plain math. ``RMSNORM_FWD_LAUNCHES`` and ``RMSNORM_BWD_LAUNCHES`` count the
kernels' launches.

The kernels replace no TPU kernel: the JAX package's RMSNorm is flax's,
fused by XLA. Their bound is bytes: at mamba-2.8b's micro-batch of 8 x 4096
rows of 2560 the forward reads the f32 stream and writes bf16 (0.50 GB,
0.150 ms at 3.35 TB/s), the backward reads bf16 dy, the f32 stream and the
f32 residual gradient and writes the f32 stream gradient (1.17 GB, 0.350
ms). Under eager autograd the same norm made some five passes forward and
more backward over the f32 stream.
"""

import torch

from . import _build

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
MAX_COLS = 8192  # the kernels' widest row: 8 groups of four for each of 256 threads

# Kernel launches in this process, counted by the wrappers right where they
# launch; plain-version calls do not count.
RMSNORM_FWD_LAUNCHES = 0
RMSNORM_BWD_LAUNCHES = 0


def reset_launch_counts() -> None:
    global RMSNORM_FWD_LAUNCHES, RMSNORM_BWD_LAUNCHES
    RMSNORM_FWD_LAUNCHES = RMSNORM_BWD_LAUNCHES = 0


def kernel_takes(x: torch.Tensor) -> bool:
    """Whether the kernels take rows of ``x``: a CUDA tensor in f32 or bf16
    whose last dim is a positive multiple of 4 up to ``MAX_COLS``."""
    cols = x.shape[-1] if x.ndim else 0
    return x.is_cuda and x.dtype in _DTYPE_CODE and 0 < cols <= MAX_COLS and cols % 4 == 0


# ---------------------------------------------------------------- plain versions


def rmsnorm_fwd_reference(x: torch.Tensor, weight: torch.Tensor, eps: float,
                          dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (y in ``dtype``, each row's f32
    rstd), by ``layers.RMSNorm``'s own ops."""
    xf = x.float()
    rstd = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * (rstd * weight.float())).to(dtype), rstd[..., 0]


def rmsnorm_bwd_reference(dy: torch.Tensor, x: torch.Tensor, rstd: torch.Tensor, weight: torch.Tensor,
                          dres: torch.Tensor | None = None,
                          need_dw: bool = True) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain version of the backward kernel: (dx in x's dtype, dw f32 [cols]
    or None without ``need_dw``), ``dx = g * rstd - x * rstd^3 * mean(g *
    x)`` with ``g = dy * w``, plus ``dres`` where given, in f32; ``dw = sum
    over rows of dy * x * rstd``."""
    xf, r = x.float(), rstd[..., None]
    g = dy.float() * weight.float()
    dx = g * r - xf * (r * r * r * (g * xf).mean(-1, keepdim=True))
    if dres is not None:
        dx = dx + dres.float()
    dw = (dy.float() * (xf * r)).reshape(-1, x.shape[-1]).sum(0) if need_dw else None
    return dx.to(x.dtype), dw


# ---------------------------------------------------------------- kernels


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as contiguous [rows, cols], copied where it is not contiguous or
    not aligned for the kernels' 16-byte loads."""
    t = t.reshape(-1, t.shape[-1]).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(x: torch.Tensor, dtype: torch.dtype) -> None:
    if not kernel_takes(x) or dtype not in _DTYPE_CODE:
        raise ValueError(f"rmsnorm kernels take CUDA f32 or bf16 rows of a multiple of 4 up to {MAX_COLS} columns "
                         f"into f32 or bf16, got {x.dtype} {tuple(x.shape)} on {x.device} into {dtype}")


def rmsnorm_fwd_cuda(x: torch.Tensor, weight: torch.Tensor, eps: float,
                     dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel: (y in ``dtype`` shaped as x, f32 rstd
    shaped as x without its last dim)."""
    global RMSNORM_FWD_LAUNCHES
    _check(x, dtype)
    rows_x, w = _rows(x), weight.float().contiguous()
    if w.shape != (x.shape[-1],) or w.device != x.device:
        raise ValueError(f"rmsnorm scale must be [{x.shape[-1]}] on {x.device}, got {tuple(w.shape)} on {w.device}")
    rows, cols = rows_x.shape
    y = torch.empty(rows, cols, dtype=dtype, device=x.device)
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows:
        lib = _build.load()
        with torch.cuda.device(x.device):
            err = lib.mlpt_rmsnorm_fwd(rows_x.data_ptr(), w.data_ptr(), y.data_ptr(), rstd.data_ptr(), rows, cols,
                                       eps, _DTYPE_CODE[x.dtype], _DTYPE_CODE[dtype],
                                       torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, err, "rmsnorm forward kernel")
        RMSNORM_FWD_LAUNCHES += 1
    return y.view(x.shape), rstd.view(x.shape[:-1])


def rmsnorm_bwd_cuda(dy: torch.Tensor, x: torch.Tensor, rstd: torch.Tensor, weight: torch.Tensor,
                     dres: torch.Tensor | None = None, need_dw: bool = True) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch the backward kernel: (dx in x's dtype shaped as x, dw f32
    [cols], the partials of the kernel's blocks summed once; None without
    ``need_dw``, the kernel then writing no partials)."""
    global RMSNORM_BWD_LAUNCHES
    _check(x, x.dtype)
    if dy.shape != x.shape or dy.dtype not in _DTYPE_CODE or dy.device != x.device:
        raise ValueError(f"rmsnorm backward takes f32 or bf16 dy shaped as x {tuple(x.shape)}, got {dy.dtype} "
                         f"{tuple(dy.shape)} on {dy.device}")
    if dres is not None and (dres.shape != x.shape or dres.dtype != x.dtype or dres.device != x.device):
        raise ValueError(f"rmsnorm backward takes the residual gradient as x, {x.dtype} {tuple(x.shape)}, got "
                         f"{dres.dtype} {tuple(dres.shape)}")
    rows_x, rows_dy, w = _rows(x), _rows(dy), weight.float().contiguous()
    rows_res = None if dres is None else _rows(dres)
    r = rstd.reshape(-1).float().contiguous()
    rows, cols = rows_x.shape
    dx = torch.empty_like(rows_x)
    if not rows:
        return dx.view(x.shape), torch.zeros(cols, dtype=torch.float32, device=x.device) if need_dw else None
    lib = _build.load()
    xdt, gdt = _DTYPE_CODE[x.dtype], _DTYPE_CODE[dy.dtype]
    with torch.cuda.device(x.device):
        grid = lib.mlpt_rmsnorm_bwd_grid(rows, cols, xdt, gdt)
        if grid <= 0:
            raise RuntimeError(f"rmsnorm backward kernel: no grid for [{rows}, {cols}]")
        dw_part = torch.empty(grid, cols, dtype=torch.float32, device=x.device) if need_dw else None
        err = lib.mlpt_rmsnorm_bwd(rows_dy.data_ptr(), rows_x.data_ptr(), r.data_ptr(), w.data_ptr(),
                                   None if rows_res is None else rows_res.data_ptr(), dx.data_ptr(),
                                   None if dw_part is None else dw_part.data_ptr(), rows, cols, grid, xdt, gdt,
                                   torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "rmsnorm backward kernel")
    RMSNORM_BWD_LAUNCHES += 1
    return dx.view(x.shape), None if dw_part is None else dw_part.sum(0)


def rmsnorm_fwd(x, weight, eps, dtype):
    return (rmsnorm_fwd_cuda if x.is_cuda else rmsnorm_fwd_reference)(x, weight, eps, dtype)


def rmsnorm_bwd(dy, x, rstd, weight, dres=None, need_dw=True):
    return (rmsnorm_bwd_cuda if x.is_cuda else rmsnorm_bwd_reference)(dy, x, rstd, weight, dres, need_dw)


# ---------------------------------------------------------------- autograd


class _RMSNorm(torch.autograd.Function):
    """y = RMSNorm(x) in ``dtype``; with ``residual`` also x itself, whose
    gradient the backward adds to the norm's in its one pass."""

    @staticmethod
    def forward(ctx, x, weight, eps: float, dtype: torch.dtype, residual: bool):
        y, rstd = rmsnorm_fwd(x, weight, eps, dtype)
        ctx.save_for_backward(x, weight, rstd)
        ctx.set_materialize_grads(False)  # an unused x passed back brings None, not a zero tensor to read
        return (y, x) if residual else y

    @staticmethod
    def backward(ctx, dy, dres=None):
        x, weight, rstd = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dx, dw = rmsnorm_bwd(dy, x, rstd, weight, dres, ctx.needs_input_grad[1])
        return dx, None if dw is None else dw.to(weight.dtype), None, None, None


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float, dtype: torch.dtype, residual: bool = False):
    """RMSNorm of x's last dim in ``dtype`` (see above); with ``residual``
    the pair (y, x)."""
    return _RMSNorm.apply(x, weight, eps, dtype, residual)
