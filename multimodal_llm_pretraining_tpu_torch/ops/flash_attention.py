"""Flash attention over [B, H, S, D]: CUDA kernels for Hopper plus their
plain PyTorch versions.

Counterpart of ``multimodal_llm_pretraining_tpu/ops/flash_attention.py``. The
forward kernel replaces ``_fwd_kernel`` (``:91``) and the backward kernel the
fused single-pass ``_bwd_fused_kernel`` (``:208``), the JAX package's default
backward. Both live in ``csrc/flash_attention.cu`` and are built on first use
(``ops/_build.py``).

Which version runs is decided by where the tensors lie, and nothing else:
CPU tensors take the plain versions (``flash_fwd_reference`` /
``flash_bwd_reference``), CUDA tensors launch the kernels or raise. There is
no fallback from the kernel to the plain version.

Numerics mirror the TPU kernels: the scale folds into q for the forward
scores and into k for the backward scores, products take bf16 operands with
f32 accumulation, probabilities are recomputed from the saved f32 logsumexp,
ds = p * (dp - delta) * scale, and a query row with no visible key gives 0.
"""

import torch

from . import _build

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

# Kernel launches in this process, counted by the wrappers right where they
# launch; plain-version calls do not count.
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0


def reset_launch_counts() -> None:
    global FWD_LAUNCHES, BWD_LAUNCHES
    FWD_LAUNCHES = 0
    BWD_LAUNCHES = 0


# ---------------------------------------------------------------- plain versions


def _visible(q_seq: int, kv_seq: int, causal: bool, device) -> torch.Tensor:
    """[Sq, Sk] bool: which keys each query may attend to."""
    if not causal:
        return torch.ones(q_seq, kv_seq, dtype=torch.bool, device=device)
    qi = torch.arange(q_seq, device=device)[:, None]
    ki = torch.arange(kv_seq, device=device)[None, :]
    return qi >= ki


def flash_fwd_reference(q, k, v, causal: bool, sm_scale: float):
    """Plain version of the forward kernel: (out [.., Sq, D] in q's dtype,
    lse [.., Sq] f32). Works on any leading dims."""
    in_dtype = q.dtype
    qs = (q.float() * sm_scale).to(in_dtype)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    mask = _visible(q.shape[-2], k.shape[-2], causal, q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l > 0, l, 1.0)
    # the kernel feeds p to the p.v product as an operand of the input dtype
    out = torch.matmul(p.to(in_dtype).float(), v.float()) / l_safe
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return out.to(in_dtype), lse


def flash_bwd_reference(q, k, v, out, lse, dout, causal: bool, sm_scale: float):
    """Plain version of the fused backward kernel: (dq, dk, dv) in the input
    dtypes. p and ds are rounded to the input dtype before their products, as
    the kernels round them to bf16 operands."""
    in_dtype = k.dtype
    delta = (dout.float() * out.float()).sum(-1, keepdim=True)
    ks = (k.float() * sm_scale).to(in_dtype)
    s = torch.matmul(q.float(), ks.float().transpose(-1, -2))
    mask = _visible(q.shape[-2], k.shape[-2], causal, q.device)
    p = torch.exp(torch.where(mask, s, NEG_INF) - lse.float()[..., None]) * mask
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta) * sm_scale).to(in_dtype).float()
    p = p.to(in_dtype).float()
    dv = torch.matmul(p.transpose(-1, -2), dout.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dq = torch.matmul(ds, k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------- kernel wrappers


MAX_GRID_Y = 65535  # batch*heads is the launch grid's y dimension


def _check_kernel_inputs(tensors, head_dim: int) -> None:
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"flash attention kernels take CUDA tensors, got {dev}")
    if tensors[0].shape[0] > MAX_GRID_Y:
        raise ValueError(f"flash attention kernels take at most {MAX_GRID_Y} batch*heads, got {tensors[0].shape[0]}")
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"flash attention kernels take bfloat16 or float32, got {dtype}")
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash attention kernels take head_dim in {KERNEL_HEAD_DIMS}, got {head_dim}")
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError("flash attention kernel inputs must share one device and dtype")
        if t.ndim != 3 or t.shape[-1] != head_dim:
            raise ValueError(f"flash attention kernels take [BH, S, D] tensors, got {tuple(t.shape)}")


def _kernel_ready(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, 16-byte aligned (the kernels load 16-byte vectors)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_fwd_cuda(q, k, v, causal: bool, sm_scale: float):
    """Launch the forward kernel on [BH, S, D] CUDA tensors; returns
    (out in q's dtype, lse f32 [BH, Sq])."""
    global FWD_LAUNCHES
    q, k, v = (_kernel_ready(t) for t in (q, k, v))
    bh, q_seq, d = q.shape
    _check_kernel_inputs((q, k, v), d)
    kv_seq = k.shape[1]
    if k.shape != v.shape or k.shape[0] != bh or q_seq == 0 or kv_seq == 0:
        raise ValueError(f"flash attention shapes disagree: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    lib = _build.load()
    out = torch.empty_like(q)
    lse = torch.empty(bh, q_seq, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.mlpt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            bh, q_seq, kv_seq, d, _DTYPE_CODE[q.dtype], int(causal), float(sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, err, "flash attention forward kernel")
    FWD_LAUNCHES += 1
    return out, lse


def flash_bwd_cuda(q, k, v, out, lse, dout, causal: bool, sm_scale: float):
    """Launch the fused backward kernel; returns (dq, dk, dv) in the input
    dtype. dq accumulates in a zeroed f32 buffer by atomic adds in an order
    that changes between runs, so two runs may differ by one ulp of dq's
    dtype per element; dk and dv repeat exactly."""
    global BWD_LAUNCHES
    q, k, v, out, dout = (_kernel_ready(t) for t in (q, k, v, out, dout))
    bh, q_seq, d = q.shape
    _check_kernel_inputs((q, k, v, out, dout), d)
    kv_seq = k.shape[1]
    if out.shape != q.shape or dout.shape != q.shape or k.shape != v.shape or lse.shape != (bh, q_seq):
        raise ValueError("flash attention backward shapes disagree")
    if lse.device != q.device:
        raise ValueError(f"lse lies on {lse.device}, the other inputs on {q.device}")
    lse = _kernel_ready(lse.float())
    delta = _kernel_ready((dout.float() * out.float()).sum(-1))  # [BH, Sq] f32, as the TPU path computes it
    lib = _build.load()
    dq = torch.zeros(bh, q_seq, d, dtype=torch.float32, device=q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = lib.mlpt_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, q_seq, kv_seq, d, _DTYPE_CODE[q.dtype], int(causal), float(sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, err, "flash attention backward kernel")
    BWD_LAUNCHES += 1
    return dq.to(q.dtype), dk, dv


def _fwd(q, k, v, causal, sm_scale):
    if q.device.type == "cuda":
        return flash_fwd_cuda(q, k, v, causal, sm_scale)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal, sm_scale)
    raise ValueError(f"flash attention has no kernel for device {q.device}")


def _bwd(q, k, v, out, lse, dout, causal, sm_scale):
    if q.device.type == "cuda":
        return flash_bwd_cuda(q, k, v, out, lse, dout, causal, sm_scale)
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, out, lse, dout, causal, sm_scale)
    raise ValueError(f"flash attention has no kernel for device {q.device}")


class FlashAttention(torch.autograd.Function):
    """[BH, S, D] attention; saves (q, k, v, out, lse) like the JAX
    ``_flash_fwd_rule`` and runs the fused backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        out, lse = _fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, out, lse, dout, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = False, sm_scale: float | None = None) -> torch.Tensor:
    """Flash attention over [B, H, S, D] (no padding mask: the varlen mode is
    ROADMAP Queue 2 item 2)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    b, h, sq, d = q.shape
    sk = k.shape[2]
    out = FlashAttention.apply(q.reshape(b * h, sq, d), k.reshape(b * h, sk, d), v.reshape(b * h, sk, d), causal, sm_scale)
    return out.reshape(b, h, sq, d)
