"""Flash attention over [B, H, S, D]: CUDA kernels for Hopper plus their
plain PyTorch versions.

Counterpart of ``multimodal_llm_pretraining_tpu/ops/flash_attention.py``. The
forward kernel replaces ``_fwd_kernel`` (``:91``); the backward is either the
fused single-pass kernel, replacing ``_bwd_fused_kernel`` (``:208``), or the
split pair, a dq kernel replacing ``_bwd_dq_kernel`` (``:161``) and a dk/dv
kernel replacing ``_bwd_dkv_kernel`` (``:293``). Each runs in its plain and
its varlen (padded-batch, ``:622-652``) mode. The forward lives in
``csrc/flash_fwd.cu`` (TMA loads, ``wgmma`` products, softmax and output in
registers), the backward kernels in ``csrc/flash_attention.cu``; all are
built on first use (``ops/_build.py``).

``PREFER_FUSED_BWD`` chooses the backward, as in the JAX package (``:440-451``):
set from ``MLPT_FLASH_FUSED_BWD`` (default on; ``0`` takes the split
kernels) and read at every backward, so a program may flip it. The split
backward does 7 tile products to the fused one's 5, but it sums nothing
across blocks, so its dq repeats bit for bit where the fused kernel's may
move by one ulp between runs.

Which version runs is decided by where the tensors lie, and nothing else:
CPU tensors take the plain versions (``flash_fwd_reference``,
``flash_bwd_reference`` and the split ``flash_bwd_dq_reference`` /
``flash_bwd_dkv_reference``), CUDA tensors launch the kernels or raise.
There is no fallback from the kernel to the plain version.

Numerics mirror the TPU kernels: the scale folds into q for the forward
scores and the dq kernel's, into k for the other backward scores; products
take bf16 operands with f32 accumulation (f32 inputs are rounded to bf16,
by the forward's wrapper and by the backward kernels as they load),
probabilities are recomputed from the saved f32 logsumexp, ds = p * (dp -
delta) * scale, and a query row with no visible key gives 0.

Varlen mode: an int32 ``kv_lens`` [BH] gives each batch-head its key count;
keys at or past it are invisible to every query row, padded rows included,
and dk, dv are exactly 0 there. ``flash_attention(..., kv_len_mask=m)``
reduces a [B, Sk] keep-mask to lens as the JAX package does (``:694-697``).
"""

import os

import torch

from . import _build

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

# The fused backward (default) or the split dq + dk/dv kernels; see above.
PREFER_FUSED_BWD = os.environ.get("MLPT_FLASH_FUSED_BWD", "1") != "0"

# Kernel launches in this process, counted by the wrappers right where they
# launch, plain and varlen mode apart; plain-version calls do not count.
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
VARLEN_FWD_LAUNCHES = 0
VARLEN_BWD_LAUNCHES = 0
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0
VARLEN_DQ_LAUNCHES = 0
VARLEN_DKV_LAUNCHES = 0


def reset_launch_counts() -> None:
    global FWD_LAUNCHES, BWD_LAUNCHES, VARLEN_FWD_LAUNCHES, VARLEN_BWD_LAUNCHES
    global DQ_LAUNCHES, DKV_LAUNCHES, VARLEN_DQ_LAUNCHES, VARLEN_DKV_LAUNCHES
    FWD_LAUNCHES = BWD_LAUNCHES = VARLEN_FWD_LAUNCHES = VARLEN_BWD_LAUNCHES = 0
    DQ_LAUNCHES = DKV_LAUNCHES = VARLEN_DQ_LAUNCHES = VARLEN_DKV_LAUNCHES = 0


# ---------------------------------------------------------------- plain versions


def _visible(q: torch.Tensor, kv_seq: int, causal: bool, kv_lens: torch.Tensor | None = None) -> torch.Tensor:
    """Which keys each query of ``q`` [..., Sq, D] may attend to: [Sq, Sk]
    bool, or [..., Sq, Sk] with ``kv_lens`` (one length per leading index,
    in their row-major order; key k visible iff k < len)."""
    q_seq, device = q.shape[-2], q.device
    ki = torch.arange(kv_seq, device=device)[None, :]
    if causal:
        mask = torch.arange(q_seq, device=device)[:, None] >= ki
    else:
        mask = torch.ones(q_seq, kv_seq, dtype=torch.bool, device=device)
    if kv_lens is not None:
        mask = mask & (ki < kv_lens.to(device).reshape(*q.shape[:-2], 1, 1))
    return mask


def flash_fwd_reference(q, k, v, causal: bool, sm_scale: float, kv_lens=None):
    """Plain version of the forward kernel: (out [.., Sq, D] in q's dtype,
    lse [.., Sq] f32). Works on any leading dims; ``kv_lens`` holds one
    length per leading index ([BH] for [BH, S, D] tensors)."""
    in_dtype = q.dtype
    qs = (q.float() * sm_scale).to(in_dtype)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    mask = _visible(q, k.shape[-2], causal, kv_lens)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l > 0, l, 1.0)
    # the kernel feeds p to the p.v product as an operand of the input dtype
    out = torch.matmul(p.to(in_dtype).float(), v.float()) / l_safe
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return out.to(in_dtype), lse


def bwd_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, [.., Sq]: computed once per backward and
    read by every backward kernel, as the JAX ``_bwd_impl`` does (``:507``)."""
    return (dout.float() * out.float()).sum(-1)


def _bwd_probs(q, k, v, lse, dout, delta, causal: bool, sm_scale: float, kv_lens, scale_q: bool):
    """(p, ds), [.., Sq, Sk] f32, each rounded to the input dtype, as the
    kernels round them to bf16 operands before their products. The scale
    folds into q for the scores (the dq kernel) or into k (the others)."""
    in_dtype = k.dtype
    if scale_q:
        s = torch.matmul((q.float() * sm_scale).to(in_dtype).float(), k.float().transpose(-1, -2))
    else:
        s = torch.matmul(q.float(), (k.float() * sm_scale).to(in_dtype).float().transpose(-1, -2))
    mask = _visible(q, k.shape[-2], causal, kv_lens)
    p = torch.exp(torch.where(mask, s, NEG_INF) - lse.float()[..., None]) * mask
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta.float()[..., None]) * sm_scale).to(in_dtype).float()
    return p.to(in_dtype).float(), ds


def flash_bwd_reference(q, k, v, out, lse, dout, causal: bool, sm_scale: float, kv_lens=None):
    """Plain version of the fused backward kernel: (dq, dk, dv) in the input
    dtypes, all three from one p and ds tile."""
    p, ds = _bwd_probs(q, k, v, lse, dout, bwd_delta(out, dout), causal, sm_scale, kv_lens, scale_q=False)
    dv = torch.matmul(p.transpose(-1, -2), dout.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dq = torch.matmul(ds, k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal: bool, sm_scale: float, kv_lens=None):
    """Plain version of the split backward's dq kernel: dq in q's dtype, from
    scores with the scale folded into q and ds against the unscaled k."""
    _, ds = _bwd_probs(q, k, v, lse, dout, delta, causal, sm_scale, kv_lens, scale_q=True)
    return torch.matmul(ds, k.float()).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal: bool, sm_scale: float, kv_lens=None):
    """Plain version of the split backward's dk/dv kernel: (dk, dv) in the
    input dtypes, the fused version's dk and dv."""
    p, ds = _bwd_probs(q, k, v, lse, dout, delta, causal, sm_scale, kv_lens, scale_q=False)
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.transpose(-1, -2), dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


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
    """Contiguous, 16-byte aligned (the kernels load 16-byte vectors, TMA
    needs 16-byte aligned bases)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _lens_ptr(kv_lens: torch.Tensor | None, bh: int, device) -> tuple[torch.Tensor | None, int | None]:
    """(contiguous int32 lens, its device pointer), or (None, None) for the
    plain mode. The lens stay on the device: no value is read back."""
    if kv_lens is None:
        return None, None
    if kv_lens.device != device or kv_lens.dtype != torch.int32 or kv_lens.shape != (bh,):
        raise ValueError(f"kv_lens must be int32 [{bh}] on {device}, got {kv_lens.dtype} {tuple(kv_lens.shape)} on {kv_lens.device}")
    kv_lens = kv_lens.contiguous()
    return kv_lens, kv_lens.data_ptr()


def _bf16_operands(q, k, v, sm_scale: float):
    """The forward kernel's bf16 operands and the scale it still has to
    apply: bf16 inputs as they are (the kernel rounds q*scale once); f32
    inputs rounded here, one tensor op each, q*scale computed in f32 and
    rounded once, as the plain version and the TPU's default-precision dot
    round them."""
    if q.dtype == torch.bfloat16:
        return q, k, v, sm_scale
    qs = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    torch.mul(q, sm_scale, out=qs)
    return qs, k.to(torch.bfloat16), v.to(torch.bfloat16), 1.0


def flash_fwd_cuda(q, k, v, causal: bool, sm_scale: float, kv_lens=None):
    """Launch the forward kernel on [BH, S, D] CUDA tensors; returns
    (out in q's dtype, lse f32 [BH, Sq]). ``kv_lens`` (int32 [BH]) selects
    the varlen mode. The kernel reads bf16 operands through TMA; f32 inputs
    are rounded first (``_bf16_operands``), and that time counts here."""
    global FWD_LAUNCHES, VARLEN_FWD_LAUNCHES
    q, k, v = (_kernel_ready(t) for t in (q, k, v))
    bh, q_seq, d = q.shape
    _check_kernel_inputs((q, k, v), d)
    kv_seq = k.shape[1]
    if k.shape != v.shape or k.shape[0] != bh or q_seq == 0 or kv_seq == 0:
        raise ValueError(f"flash attention shapes disagree: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    kv_lens, lens_ptr = _lens_ptr(kv_lens, bh, q.device)
    lib = _build.load()
    out = torch.empty_like(q)
    lse = torch.empty(bh, q_seq, dtype=torch.float32, device=q.device)
    qb, kb, vb, q_scale = _bf16_operands(q, k, v, sm_scale)
    with torch.cuda.device(q.device):
        err = lib.mlpt_flash_fwd(
            qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), out.data_ptr(), lse.data_ptr(), lens_ptr,
            bh, q_seq, kv_seq, d, _DTYPE_CODE[q.dtype], int(causal), float(q_scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, err, "flash attention forward kernel")
    if kv_lens is None:
        FWD_LAUNCHES += 1
    else:
        VARLEN_FWD_LAUNCHES += 1
    return out, lse


def flash_bwd_cuda(q, k, v, out, lse, dout, causal: bool, sm_scale: float, kv_lens=None):
    """Launch the fused backward kernel; returns (dq, dk, dv) in the input
    dtype. dq accumulates in a zeroed f32 buffer by atomic adds in an order
    that changes between runs, so two runs may differ by one ulp of dq's
    dtype per element; dk and dv repeat exactly. ``kv_lens`` (int32 [BH])
    selects the varlen mode; dk and dv rows at or past each length are
    written as zeros."""
    global BWD_LAUNCHES, VARLEN_BWD_LAUNCHES
    q, k, v, out, dout = (_kernel_ready(t) for t in (q, k, v, out, dout))
    bh, q_seq, d = q.shape
    _check_kernel_inputs((q, k, v, out, dout), d)
    kv_seq = k.shape[1]
    if out.shape != q.shape or dout.shape != q.shape or k.shape != v.shape or lse.shape != (bh, q_seq):
        raise ValueError("flash attention backward shapes disagree")
    if lse.device != q.device:
        raise ValueError(f"lse lies on {lse.device}, the other inputs on {q.device}")
    kv_lens, lens_ptr = _lens_ptr(kv_lens, bh, q.device)
    lse = _kernel_ready(lse.float())
    delta = _kernel_ready(bwd_delta(out, dout))
    lib = _build.load()
    dq = torch.zeros(bh, q_seq, d, dtype=torch.float32, device=q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = lib.mlpt_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), lens_ptr,
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, q_seq, kv_seq, d, _DTYPE_CODE[q.dtype], int(causal), float(sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, err, "flash attention backward kernel")
    if kv_lens is None:
        BWD_LAUNCHES += 1
    else:
        VARLEN_BWD_LAUNCHES += 1
    return dq.to(q.dtype), dk, dv


def _split_inputs(q, k, v, dout, lse, delta, kv_lens):
    """The split kernels' common checks: contiguous 16-byte aligned tensors,
    f32 lse and delta [BH, Sq] on q's device, and the lens pointer."""
    q, k, v, dout = (_kernel_ready(t) for t in (q, k, v, dout))
    bh, q_seq, d = q.shape
    _check_kernel_inputs((q, k, v, dout), d)
    if dout.shape != q.shape or k.shape != v.shape or k.shape[0] != bh or k.shape[1] == 0 or q_seq == 0:
        raise ValueError("flash attention backward shapes disagree")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.device != q.device or t.shape != (bh, q_seq):
            raise ValueError(f"{name} must be [{bh}, {q_seq}] on {q.device}, got {tuple(t.shape)} on {t.device}")
    kv_lens, lens_ptr = _lens_ptr(kv_lens, bh, q.device)
    return q, k, v, dout, _kernel_ready(lse.float()), _kernel_ready(delta.float()), kv_lens, lens_ptr


def flash_bwd_dq_cuda(q, k, v, dout, lse, delta, causal: bool, sm_scale: float, kv_lens=None):
    """Launch the split backward's dq kernel; returns dq in q's dtype. No
    atomics: two runs give the same bits. ``delta`` is ``bwd_delta(out,
    dout)``; ``kv_lens`` (int32 [BH]) selects the varlen mode."""
    global DQ_LAUNCHES, VARLEN_DQ_LAUNCHES
    q, k, v, dout, lse, delta, kv_lens, lens_ptr = _split_inputs(q, k, v, dout, lse, delta, kv_lens)
    bh, q_seq, d = q.shape
    lib = _build.load()
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.mlpt_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), lens_ptr,
            dq.data_ptr(), bh, q_seq, k.shape[1], d, _DTYPE_CODE[q.dtype], int(causal), float(sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, err, "flash attention dq kernel")
    if kv_lens is None:
        DQ_LAUNCHES += 1
    else:
        VARLEN_DQ_LAUNCHES += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, causal: bool, sm_scale: float, kv_lens=None):
    """Launch the split backward's dk/dv kernel; returns (dk, dv) in the
    input dtype, rows at or past each varlen length written as zeros."""
    global DKV_LAUNCHES, VARLEN_DKV_LAUNCHES
    q, k, v, dout, lse, delta, kv_lens, lens_ptr = _split_inputs(q, k, v, dout, lse, delta, kv_lens)
    bh, q_seq, d = q.shape
    lib = _build.load()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = lib.mlpt_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), lens_ptr,
            dk.data_ptr(), dv.data_ptr(), bh, q_seq, k.shape[1], d, _DTYPE_CODE[q.dtype], int(causal),
            float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, err, "flash attention dk/dv kernel")
    if kv_lens is None:
        DKV_LAUNCHES += 1
    else:
        VARLEN_DKV_LAUNCHES += 1
    return dk, dv


def _on_device(cuda_fn, plain_fn, q, *args):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cuda":
        return cuda_fn(q, *args)
    if q.device.type == "cpu":
        return plain_fn(q, *args)
    raise ValueError(f"flash attention has no kernel for device {q.device}")


class FlashAttention(torch.autograd.Function):
    """[BH, S, D] attention; saves (q, k, v, kv_lens, out, lse) like the JAX
    ``_flash_varlen_fwd_rule`` (``kv_lens`` None in the plain mode, which
    saves what ``_flash_fwd_rule`` does). The backward is the fused kernel,
    or with ``PREFER_FUSED_BWD`` off the dq kernel and then the dk/dv
    kernel, both reading one delta."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float, kv_lens=None):
        out, lse = _on_device(flash_fwd_cuda, flash_fwd_reference, q, k, v, causal, sm_scale, kv_lens)
        ctx.save_for_backward(q, k, v, kv_lens, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_lens, out, lse = ctx.saved_tensors
        args = (ctx.causal, ctx.sm_scale, kv_lens)
        if PREFER_FUSED_BWD:
            dq, dk, dv = _on_device(flash_bwd_cuda, flash_bwd_reference, q, k, v, out, lse, dout, *args)
        else:
            delta = bwd_delta(out, dout)
            dq = _on_device(flash_bwd_dq_cuda, flash_bwd_dq_reference, q, k, v, dout, lse, delta, *args)
            dk, dv = _on_device(flash_bwd_dkv_cuda, flash_bwd_dkv_reference, q, k, v, dout, lse, delta, *args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = False, sm_scale: float | None = None, kv_len_mask=None) -> torch.Tensor:
    """Flash attention over [B, H, S, D].

    ``kv_len_mask`` is a [B, Sk] keep-mask (1 = attend). As in the JAX
    package it must be prefix-contiguous (right-padded batches): it is
    reduced to one key count per row, its sum, so a non-prefix mask is read
    as its prefix of that length. A mask always takes the varlen mode, even
    when every row is full."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    b, h, sq, d = q.shape
    sk = k.shape[2]
    lens = None
    if kv_len_mask is not None:
        lens = kv_len_mask.to(torch.int32).sum(-1, dtype=torch.int32)  # [B]
        lens = lens[:, None].expand(b, h).reshape(b * h)
    out = FlashAttention.apply(
        q.reshape(b * h, sq, d), k.reshape(b * h, sk, d), v.reshape(b * h, sk, d), causal, sm_scale, lens
    )
    return out.reshape(b, h, sq, d)
