"""Flash attention over [B, H, S, D]: CUDA kernels for Hopper plus their
plain PyTorch versions.

Counterpart of ``multimodal_llm_pretraining_tpu/ops/flash_attention.py``. The
forward kernel replaces ``_fwd_kernel`` (``:91``); the backward is either the
fused single-pass kernel, replacing ``_bwd_fused_kernel`` (``:208``), or the
split pair, a dq kernel replacing ``_bwd_dq_kernel`` (``:161``) and a dk/dv
kernel replacing ``_bwd_dkv_kernel`` (``:293``). Each runs in its plain and
its varlen (padded-batch, ``:622-652``) mode. The forward lives in
``csrc/flash_fwd.cu`` (TMA loads, ``wgmma`` products, softmax and output in
registers), the fused backward in ``csrc/flash_bwd.cu`` (TMA loads, ``wgmma``
products, dk and dv in registers). The split pair's dk/dv kernel is that
same kernel compiled without dq (``csrc/flash_bwd.cu``), its dq kernel is
``csrc/flash_bwd_dq.cu`` (the forward's structure with dQ in place of O);
both read the lse and delta rows of one prep launch per backward. All are
built on first use (``ops/_build.py``).

The kernels are instantiated at head dims 64, 128 and 256. The wrappers take
any head dim up to 256 and zero-pad it to the next of these in the copy they
make for the kernel (32 -> 64, 80 -> 128, 88 -> 128), keeping the caller's
``sm_scale``, and slice the outputs back. That is exact: the zero columns add
exact zeros to every score, out's padded columns are 0 (v is 0 there), and
dq, dk, dv are 0 there (k, q, dO are 0 there). The launch grid's y dimension
holds at most ``MAX_GRID_Y`` batch-heads, so the wrappers launch larger
batches in contiguous chunks (``bh_chunks``), each launch counted. Head
dims above 256 never reach the kernels: ``flash_supported`` sends them to
the dispatcher's ``xla`` branch (``ops/attention.py``), and the wrappers
raise on them.

``PREFER_FUSED_BWD`` chooses the backward, as in the JAX package (``:440-451``):
set from ``MLPT_FLASH_FUSED_BWD`` (default on; ``0`` takes the split
kernels) and read at every backward, so a program may flip it. The split
backward does 7 tile products to the fused one's 5, but it sums nothing
across blocks, so its dq repeats bit for bit where the fused kernel's may
move by one ulp between runs.

The forward and the two backwards are ``torch.library`` custom ops,
``mlpt::flash_fwd`` (returning out and lse), ``mlpt::flash_bwd`` and
``mlpt::flash_bwd_split``, so that the dispatcher sees them: a remat
policy saves the forward's outputs by naming its op, and the FLOP counter
counts all three. Which version an op runs is decided by where the tensors
lie, and nothing else: CPU tensors take the plain versions
(``flash_fwd_reference``, ``flash_bwd_reference`` and the split
``flash_bwd_split_reference``), CUDA tensors launch the kernels or raise.
There is no fallback from the kernel to the plain version.

Numerics mirror the TPU kernels: the scale folds into q for the forward
scores and the dq kernel's, into k for the other backward scores; products
take bf16 operands with f32 accumulation (f32 inputs are rounded to bf16
by the wrappers, once per call: the split pair's two kernels share one set
of copies, ``split_operands``),
probabilities are recomputed from the saved f32 logsumexp, ds = p * (dp -
delta) * scale, and a query row with no visible key gives 0.

Varlen mode: an int32 ``kv_lens`` [BH] gives each batch-head its key count;
keys at or past it are invisible to every query row, padded rows included,
and dk, dv are exactly 0 there. ``flash_attention(..., kv_len_mask=m)``
reduces a [B, Sk] keep-mask to lens as the JAX package does (``:694-697``).
"""

import math
import os
from typing import NamedTuple, Optional

import torch

from . import _build

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128, 256)  # instantiated; other head dims up to the last are zero-padded to the next
MAX_GRID_Y = 65535  # batch-heads of one launch: the launch grid's y dimension
STATS_ROWS = 64  # the backward kernels read lse and delta padded to rows of this many queries
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


def flash_bwd_split_reference(q, k, v, out, lse, dout, causal: bool, sm_scale: float, kv_lens=None):
    """Plain version of the split backward: delta once, then the dq and the
    dk/dv plain versions; (dq, dk, dv) in the input dtypes."""
    delta = bwd_delta(out, dout)
    dq = flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal, sm_scale, kv_lens)
    return (dq, *flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal, sm_scale, kv_lens))


# ---------------------------------------------------------------- kernel wrappers


def kernel_head_dim(head_dim: int) -> int:
    """The instantiated head dim a kernel runs ``head_dim`` at: the smallest
    of ``KERNEL_HEAD_DIMS`` not below it."""
    for d in KERNEL_HEAD_DIMS:
        if head_dim <= d:
            return d
    raise ValueError(f"flash attention kernels take head_dim up to {KERNEL_HEAD_DIMS[-1]}, got {head_dim} "
                     "(dot_product_attention sends larger head dims to its xla branch)")


def flash_supported(q, k, v, mask) -> bool:
    """Whether ``dot_product_attention(impl="flash")`` takes the kernels, by
    shape alone: the contract of the JAX ``flash_supported`` (``:35-42``),
    [B, H, S, D] q, k, v and a None or [B, Sk] keep-mask, with the kernels'
    largest head dim in place of the TPU kernel's 512. Anything else takes
    the dispatcher's ``xla`` branch."""
    if not (q.ndim == 4 and k.ndim == 4 and v.ndim == 4 and q.shape[-1] <= KERNEL_HEAD_DIMS[-1]):
        return False
    return mask is None or (mask.ndim == 2 and mask.shape[0] == q.shape[0] and mask.shape[1] == k.shape[2])


def bh_chunks(bh: int, limit: int = MAX_GRID_Y) -> list[tuple[int, int]]:
    """Contiguous [start, stop) ranges of at most ``limit`` batch-heads that
    cover ``bh``: one launch each."""
    return [(b0, min(b0 + limit, bh)) for b0 in range(0, bh, limit)]


def _check_kernel_inputs(tensors, head_dim: int) -> None:
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"flash attention kernels take CUDA tensors, got {dev}")
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"flash attention kernels take bfloat16 or float32, got {dtype}")
    kernel_head_dim(head_dim)
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError("flash attention kernel inputs must share one device and dtype")
        if t.ndim != 3 or t.shape[-1] != head_dim:
            raise ValueError(f"flash attention kernels take [BH, S, D] tensors, got {tuple(t.shape)}")


def _check_backward_inputs(q, k, v, out, lse, dout) -> None:
    """The backward wrappers' checks: [BH, S, D] tensors as the kernels take
    them, out and dO shaped as q, lse [BH, Sq] on q's device."""
    bh, q_seq, d = q.shape
    _check_kernel_inputs((q, k, v, out, dout), d)
    if (out.shape != q.shape or dout.shape != q.shape or k.shape != v.shape or k.shape[0] != bh or lse.shape != (bh, q_seq)
            or q_seq == 0 or k.shape[1] == 0):
        raise ValueError("flash attention backward shapes disagree")
    if lse.device != q.device:
        raise ValueError(f"lse lies on {lse.device}, the other inputs on {q.device}")


def _kernel_ready(t: torch.Tensor, head_dim: int | None = None) -> torch.Tensor:
    """Contiguous, 16-byte aligned (the kernels load 16-byte vectors, TMA
    needs 16-byte aligned bases), the last dim zero-padded to ``head_dim``."""
    if head_dim is not None and t.shape[-1] != head_dim:
        return torch.nn.functional.pad(t, (0, head_dim - t.shape[-1]))
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _checked_lens(kv_lens: torch.Tensor | None, bh: int, device) -> torch.Tensor | None:
    """Contiguous int32 lens [BH] on ``device``, or None for the plain mode.
    The lens stay on the device: no value is read back."""
    if kv_lens is None:
        return None
    if kv_lens.device != device or kv_lens.dtype != torch.int32 or kv_lens.shape != (bh,):
        raise ValueError(f"kv_lens must be int32 [{bh}] on {device}, got {kv_lens.dtype} {tuple(kv_lens.shape)} on {kv_lens.device}")
    return kv_lens.contiguous()


def _chunk_ptr(t: torch.Tensor | None, b0: int) -> int | None:
    """The device pointer of ``t[b0]`` (a contiguous tensor's chunk from
    batch-head ``b0``), or None."""
    return None if t is None else t[b0].data_ptr()


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
    bh, q_seq, d = q.shape
    _check_kernel_inputs((q, k, v), d)
    kv_seq = k.shape[1]
    if k.shape != v.shape or k.shape[0] != bh or q_seq == 0 or kv_seq == 0:
        raise ValueError(f"flash attention shapes disagree: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    kv_lens = _checked_lens(kv_lens, bh, q.device)
    dp = kernel_head_dim(d)
    q, k, v = (_kernel_ready(t, dp) for t in (q, k, v))
    lib = _build.load()
    out = torch.empty_like(q)
    lse = torch.empty(bh, q_seq, dtype=torch.float32, device=q.device)
    qb, kb, vb, q_scale = _bf16_operands(q, k, v, sm_scale)
    for b0, b1 in bh_chunks(bh):
        with torch.cuda.device(q.device):
            err = lib.mlpt_flash_fwd(
                qb[b0].data_ptr(), kb[b0].data_ptr(), vb[b0].data_ptr(), out[b0].data_ptr(), lse[b0].data_ptr(),
                _chunk_ptr(kv_lens, b0), b1 - b0, q_seq, kv_seq, dp, _DTYPE_CODE[q.dtype], int(causal),
                float(q_scale), torch.cuda.current_stream(q.device).cuda_stream,
            )
        _build.check(lib, err, "flash attention forward kernel")
        if kv_lens is None:
            FWD_LAUNCHES += 1
        else:
            VARLEN_FWD_LAUNCHES += 1
    return out[..., :d], lse


def flash_bwd_cuda(q, k, v, out, lse, dout, causal: bool, sm_scale: float, kv_lens=None):
    """Launch the fused backward kernel; returns (dq, dk, dv) in the input
    dtype. dq accumulates in a zeroed f32 buffer by atomic adds in an order
    that changes between runs, so two runs may differ by one ulp of dq's
    dtype per element; dk and dv repeat exactly. ``kv_lens`` (int32 [BH])
    selects the varlen mode; dk and dv rows at or past each length are
    written as zeros. The kernel reads bf16 q, k, v and dO: f32 inputs are
    rounded here, and dk and dv come back in f32; its first launch takes
    delta = rowsum(dO * out) from out and dO in the input dtype. At head dim
    256 (padded or not) a power-of-two scale, as the model's own 1/16, is
    applied to the f32 scores; any other scale runs the kernel's one-stage
    variant, which has room for a k*scale tile."""
    global BWD_LAUNCHES, VARLEN_BWD_LAUNCHES
    bh, q_seq, d = q.shape
    kv_seq = k.shape[1]
    _check_backward_inputs(q, k, v, out, lse, dout)
    dp = kernel_head_dim(d)
    kv_lens = _checked_lens(kv_lens, bh, q.device)
    out, dout = (_kernel_ready(t, dp) for t in (out, dout))
    qb, kb, vb, dob = (_kernel_ready(t.to(torch.bfloat16), dp) for t in (q, k, v, dout))
    lse = _kernel_ready(lse.float())
    # the first launch fills these: [BH, Sq rounded up to STATS_ROWS], delta
    # 0 and lse +inf past Sq (a query row there gets p = exp(s - inf) = 0)
    stats = torch.empty(2, bh, -(-q_seq // STATS_ROWS) * STATS_ROWS, dtype=torch.float32, device=q.device)
    lib = _build.load()
    dq = torch.zeros(bh, q_seq, dp, dtype=torch.float32, device=q.device)
    dk = torch.empty(bh, kv_seq, dp, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    for b0, b1 in bh_chunks(bh):
        with torch.cuda.device(q.device):
            err = lib.mlpt_flash_bwd(
                qb[b0].data_ptr(), kb[b0].data_ptr(), vb[b0].data_ptr(), dob[b0].data_ptr(), out[b0].data_ptr(),
                dout[b0].data_ptr(), lse[b0].data_ptr(), stats[0, b0].data_ptr(), stats[1, b0].data_ptr(),
                _chunk_ptr(kv_lens, b0), dq[b0].data_ptr(), dk[b0].data_ptr(), dv[b0].data_ptr(), b1 - b0, q_seq,
                kv_seq, dp, _DTYPE_CODE[q.dtype], int(causal), float(sm_scale),
                torch.cuda.current_stream(q.device).cuda_stream,
            )
        _build.check(lib, err, "flash attention backward kernel")
        if kv_lens is None:
            BWD_LAUNCHES += 1
        else:
            VARLEN_BWD_LAUNCHES += 1
    return dq[..., :d].to(q.dtype), dk[..., :d], dv[..., :d]


def _power_of_two(x: float) -> bool:
    return x > 0 and math.frexp(x)[0] == 0.5


def _scaled_bf16(t: torch.Tensor, scale: float) -> torch.Tensor:
    """bf16(t * scale), the product taken in f32 and rounded once, as the
    plain versions and the kernels round q*scale and k*scale."""
    return torch.mul(t, scale, out=torch.empty(t.shape, dtype=torch.bfloat16, device=t.device))


class SplitOperands(NamedTuple):
    """What the split pair's two kernels read, made once per backward by
    ``split_operands``: bf16 [BH, S, Dp] operands (Dp the kernel's head dim),
    the prep launch's padded lse and delta rows, the lens, the scale, the
    caller's dtype and head dim."""

    q: torch.Tensor  # q, for dk = ds^T . q
    q_dq: torch.Tensor  # the dq kernel's q: q itself (the kernel rounds q*scale once), or q*scale rounded from f32
    q_scale: float  # the scale the dq kernel applies to q_dq: sm_scale, or 1.0 where q_dq is q*scale
    k: torch.Tensor  # k, for dq = ds . k
    k_dkv: torch.Tensor  # the dk/dv kernel's k: k itself (a power-of-two scale, applied to the f32 scores), or k*scale
    k_scaled: bool  # whether k_dkv is k*scale
    v: torch.Tensor
    dout: torch.Tensor
    stats: torch.Tensor  # f32 [2, BH, Sq rounded up to STATS_ROWS]: lse (+inf past Sq) and delta (0 past Sq)
    kv_lens: torch.Tensor | None
    sm_scale: float
    dtype: torch.dtype  # of the inputs and of dq, dk, dv
    head_dim: int  # the caller's, before padding


def split_operands(q, k, v, out, lse, dout, sm_scale: float, kv_lens=None) -> SplitOperands:
    """The split backward's shared work on [BH, S, D] CUDA tensors, once per
    backward: the checks, the head dim padded to the kernel's, bf16 copies
    of f32 inputs (q*scale or k*scale rounded once from f32 where the
    kernels cannot form it exactly from the bf16 copy), and the fused
    backward's prep launch, which writes delta = rowsum(dO * out) from out
    and dO in the input dtype and the lse rows, both padded to a multiple
    of STATS_ROWS queries."""
    bh, q_seq, d = q.shape
    _check_backward_inputs(q, k, v, out, lse, dout)
    dp = kernel_head_dim(d)
    kv_lens = _checked_lens(kv_lens, bh, q.device)
    q, k, v, out, dout = (_kernel_ready(t, dp) for t in (q, k, v, out, dout))
    lse = _kernel_ready(lse.float())
    stats = torch.empty(2, bh, -(-q_seq // STATS_ROWS) * STATS_ROWS, dtype=torch.float32, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.mlpt_flash_bwd_prep(out.data_ptr(), dout.data_ptr(), lse.data_ptr(), stats[0].data_ptr(),
                                      stats[1].data_ptr(), bh, q_seq, dp, _DTYPE_CODE[q.dtype],
                                      torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash attention backward prep kernel")
    exact = _power_of_two(sm_scale)  # bf16(x) * scale is bf16(x * scale): the kernels scale the bf16 copy
    qb, kb, vb, dob = (t if t.dtype == torch.bfloat16 else t.to(torch.bfloat16) for t in (q, k, v, dout))
    q_scaled = q.dtype == torch.float32 and not exact
    q_dq = _scaled_bf16(q, sm_scale) if q_scaled else qb
    k_dkv = kb if exact else _scaled_bf16(k, sm_scale)
    return SplitOperands(qb, q_dq, 1.0 if q_scaled else sm_scale, kb, k_dkv, not exact, vb, dob, stats, kv_lens,
                         sm_scale, q.dtype, d)


def flash_bwd_dq_cuda(ops: SplitOperands, causal: bool) -> torch.Tensor:
    """Launch the split backward's dq kernel on ``split_operands``; returns
    dq [BH, Sq, Dp] in the input dtype (padded columns included). No
    atomics: two runs give the same bits."""
    global DQ_LAUNCHES, VARLEN_DQ_LAUNCHES
    bh, q_seq, dp = ops.q.shape
    lib = _build.load()
    dq = torch.empty(bh, q_seq, dp, dtype=ops.dtype, device=ops.q.device)
    for b0, b1 in bh_chunks(bh):
        with torch.cuda.device(dq.device):
            err = lib.mlpt_flash_bwd_dq(
                ops.q_dq[b0].data_ptr(), ops.k[b0].data_ptr(), ops.v[b0].data_ptr(), ops.dout[b0].data_ptr(),
                ops.stats[0, b0].data_ptr(), ops.stats[1, b0].data_ptr(), _chunk_ptr(ops.kv_lens, b0),
                dq[b0].data_ptr(), b1 - b0, q_seq, ops.k.shape[1], dp, _DTYPE_CODE[ops.dtype], int(causal),
                float(ops.sm_scale), float(ops.q_scale),
                torch.cuda.current_stream(dq.device).cuda_stream,
            )
        _build.check(lib, err, "flash attention dq kernel")
        if ops.kv_lens is None:
            DQ_LAUNCHES += 1
        else:
            VARLEN_DQ_LAUNCHES += 1
    return dq


def flash_bwd_dkv_cuda(ops: SplitOperands, causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the split backward's dk/dv kernel (the fused backward's
    kernel without dq) on ``split_operands``; returns (dk, dv) [BH, Sk, Dp]
    in the input dtype, rows at or past each varlen length written as
    zeros. With the same stats they equal the fused kernel's bit for bit
    (where both form k*scale from the same bf16 k)."""
    global DKV_LAUNCHES, VARLEN_DKV_LAUNCHES
    bh, q_seq, dp = ops.q.shape
    kv_seq = ops.k.shape[1]
    lib = _build.load()
    dk = torch.empty(bh, kv_seq, dp, dtype=ops.dtype, device=ops.q.device)
    dv = torch.empty_like(dk)
    for b0, b1 in bh_chunks(bh):
        with torch.cuda.device(dk.device):
            err = lib.mlpt_flash_bwd_dkv(
                ops.q[b0].data_ptr(), ops.k_dkv[b0].data_ptr(), ops.v[b0].data_ptr(), ops.dout[b0].data_ptr(),
                ops.stats[0, b0].data_ptr(), ops.stats[1, b0].data_ptr(), _chunk_ptr(ops.kv_lens, b0),
                dk[b0].data_ptr(), dv[b0].data_ptr(), b1 - b0, q_seq, kv_seq, dp, _DTYPE_CODE[ops.dtype],
                int(causal), float(ops.sm_scale), int(ops.k_scaled),
                torch.cuda.current_stream(dk.device).cuda_stream,
            )
        _build.check(lib, err, "flash attention dk/dv kernel")
        if ops.kv_lens is None:
            DKV_LAUNCHES += 1
        else:
            VARLEN_DKV_LAUNCHES += 1
    return dk, dv


def flash_bwd_split_cuda(q, k, v, out, lse, dout, causal: bool, sm_scale: float, kv_lens=None):
    """The split backward as ``mlpt::flash_bwd_split`` runs it on CUDA
    tensors: ``split_operands`` (one prep launch, the casts), then the dq
    kernel, then the dk/dv kernel; returns (dq, dk, dv) in the input dtype.
    Nothing is summed across blocks, so all three repeat bit for bit.
    ``kv_lens`` (int32 [BH]) selects the varlen mode."""
    ops = split_operands(q, k, v, out, lse, dout, sm_scale, kv_lens)
    dq = flash_bwd_dq_cuda(ops, causal)
    dk, dv = flash_bwd_dkv_cuda(ops, causal)
    d = ops.head_dim
    return dq[..., :d], dk[..., :d], dv[..., :d]


# ---------------------------------------------------------------- custom ops
#
# Each op's CUDA implementation launches the kernels, its CPU implementation
# is the plain version: the only place where the choice is made.


def _no_kernel(q: torch.Tensor, *args) -> None:
    raise ValueError(f"flash attention has no kernel for device {q.device}")


@torch.library.custom_op("mlpt::flash_fwd", mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, sm_scale: float,
              kv_lens: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """[BH, S, D] attention forward: (out in q's dtype, lse f32 [BH, Sq])."""
    _no_kernel(q)


@torch.library.custom_op("mlpt::flash_bwd", mutates_args=())
def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
              dout: torch.Tensor, causal: bool, sm_scale: float,
              kv_lens: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused backward: (dq, dk, dv) in the input dtype."""
    _no_kernel(q)


@torch.library.custom_op("mlpt::flash_bwd_split", mutates_args=())
def flash_bwd_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                    dout: torch.Tensor, causal: bool, sm_scale: float,
                    kv_lens: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The split backward (prep launch, dq kernel, dk/dv kernel): (dq, dk,
    dv) in the input dtype."""
    _no_kernel(q)


for _op, _cuda, _plain in ((flash_fwd, flash_fwd_cuda, flash_fwd_reference),
                           (flash_bwd, flash_bwd_cuda, flash_bwd_reference),
                           (flash_bwd_split, flash_bwd_split_cuda, flash_bwd_split_reference)):
    _op.register_kernel("cuda")(_cuda)
    _op.register_kernel("cpu")(_plain)


@flash_fwd.register_fake
def _(q, k, v, causal, sm_scale, kv_lens=None):
    return torch.empty_like(q), q.new_empty(q.shape[:-1], dtype=torch.float32)


def _grads_fake(q, k, v, out, lse, dout, causal, sm_scale, kv_lens=None):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


flash_bwd.register_fake(_grads_fake)
flash_bwd_split.register_fake(_grads_fake)


def _fwd_setup_context(ctx, inputs, output) -> None:
    """Save (q, k, v, kv_lens, out, lse) like the JAX
    ``_flash_varlen_fwd_rule`` (``kv_lens`` None in the plain mode, which
    saves what ``_flash_fwd_rule`` does). lse is a residual, not a result
    that takes a gradient."""
    q, k, v, causal, sm_scale, kv_lens = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, kv_lens, out, lse)
    ctx.causal, ctx.sm_scale = causal, sm_scale
    ctx.mark_non_differentiable(lse)


def _fwd_backward(ctx, dout, _dlse):
    """The fused backward op, or with ``PREFER_FUSED_BWD`` off the split
    one (one prep launch for delta and the lse rows, then the dq kernel and
    the dk/dv kernel, both reading them)."""
    q, k, v, kv_lens, out, lse = ctx.saved_tensors
    bwd = flash_bwd if PREFER_FUSED_BWD else flash_bwd_split
    dq, dk, dv = bwd(q, k, v, out, lse, dout, ctx.causal, ctx.sm_scale, kv_lens)
    return dq, dk, dv, None, None, None


flash_fwd.register_autograd(_fwd_backward, setup_context=_fwd_setup_context)


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
    out, _lse = flash_fwd(q.reshape(b * h, sq, d), k.reshape(b * h, sk, d), v.reshape(b * h, sk, d), causal,
                          sm_scale, lens)
    return out.reshape(b, h, sq, d)
