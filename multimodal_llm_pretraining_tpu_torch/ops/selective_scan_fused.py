"""Selective-scan forward and backward: CUDA kernels for Hopper plus their
plain PyTorch versions, and the custom-VJP autograd Function around them.

Counterpart of ``multimodal_llm_pretraining_tpu/ops/selective_scan_pallas.py``
(named after its ``selective_scan_fused``, ``:325-352``). The forward kernel
replaces ``_scan_kernel`` (``:47``) and the backward kernel
``_scan_bwd_kernel`` (``:161``). Both live in ``csrc/selective_scan.cu`` and
are built on first use (``ops/_build.py``).

Shapes: u, delta [B, L, I]; A [I, N]; B, C [B, L, N]; D [I]; dy [B, L, I].
The forward returns y and the state entering each 256-step chunk, f32 [B,
ceil(L / 256), N, I] (the TPU kernel's ``with_checkpoints`` output at its
default ``block_l``). Given D, y is ``selective_scan_pallas_fwd``'s: the scan
plus the skip D * u, in f32, rounded to u's dtype (``:154-155``; the kernel
computes it in its epilogue); without D, y is f32 before the skip. The
backward returns (du, ddelta, dA, dB, dC) of y before the D skip, all f32;
the skip's ``du += D * g`` term and ``dD`` stay in the autograd rule, in
f32, as in the JAX custom VJP.

The kernels run 16 states a launch. Any other d_state N is zero-padded to a
multiple of 16, as the JAX kernels pad it to a multiple of 8
(``selective_scan_pallas.py:96-100``), and each group of 16 states is one
launch on its own copies of A, B and C (``state_groups``, ``grouped_fwd``,
``grouped_bwd``); at N = 16 that is one launch on the inputs as given, with
the skip fused. The kernels' tensor maps take I a multiple of 8: the
wrappers zero-pad it and slice the outputs back (``padded_fwd``,
``padded_bwd``). A launch takes at most 65,535 batch elements (the grid's
y): larger batches launch in contiguous chunks, one counted launch each, and
their outputs are joined in order (``batch_chunked``). All three are exact.

The forward and the backward are ``torch.library`` custom ops,
``mlpt::scan_fwd`` (y and the checkpoint) and ``mlpt::scan_bwd``, so that
the dispatcher sees them: the FLOP counter counts both
(``benchmarking/flops.py``), and ``selective_scan_fused`` is the forward op
with its autograd rule. Which version an op runs is decided by where the
tensors lie, and nothing else: CPU tensors take the plain versions, CUDA
tensors launch the kernels or raise. There is no fallback from a kernel to
its plain version.
"""

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .flash_attention import MAX_GRID_Y, bh_chunks

SCAN_CHUNK = 256  # checkpoint interval, the TPU kernel's DEFAULT_BLOCK_L
KERNEL_D_STATE = 16  # states a launch (Mamba's d_state); other d_states run in zero-padded groups of 16
BWD_CHANNELS_PER_BLOCK = 80  # the backward kernel's channel tile: dB/dC partials per tile
CHANNEL_MULTIPLE = 8  # the kernels' tensor maps take rows of whole 16 bytes: I padded to a multiple
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


def scan_states(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over dim 1, from h_{-1} = h0: a log-depth
    doubling scan (Hillis-Steele) over a [B, T, ...] chunk. Differentiable."""
    steps = a.shape[1]
    offset = 1
    while offset < steps:
        b = torch.cat([b[:, :offset], a[:, offset:] * b[:, :-offset] + b[:, offset:]], dim=1)
        a = torch.cat([a[:, :offset], a[:, offset:] * a[:, :-offset]], dim=1)
        offset *= 2
    return a * h0[:, None] + b


def _discretize(u, delta, A, B):
    """(da, db) f32 [B, T, I, N]: exp(delta * A) and delta * u * B."""
    d = delta.float()
    da = torch.exp(d[..., None] * A.float())
    db = (d * u.float())[..., None] * B.float()[:, :, None, :]
    return da, db


def chunked_scan(u, delta, A, B, C, chunk_size: int = SCAN_CHUNK):
    """y before the D skip, f32 [B, L, I], and the state entering each chunk,
    a list of f32 [B, I, N]. The discretized tensors exist one chunk at a
    time. Differentiable."""
    bsz, L, I = u.shape
    h = u.new_zeros((bsz, I, A.shape[1]), dtype=torch.float32)
    ys, entries = [], []
    for start in range(0, L, chunk_size):
        sl = slice(start, start + chunk_size)
        entries.append(h)
        da, db = _discretize(u[:, sl], delta[:, sl], A, B[:, sl])
        hs = scan_states(da, db, h)
        ys.append(torch.einsum("blin,bln->bli", hs, C[:, sl].float()))
        h = hs[:, -1]
    return torch.cat(ys, dim=1), entries


def skip(y, D, u):
    """y + D * u in f32, rounded to u's dtype: the D skip."""
    return (y + D.float() * u.float()).to(u.dtype)


def selective_scan_fwd_reference(u, delta, A, B, C, D=None):
    """Plain version of the forward kernel: (y, checkpoint f32 [B, ceil(L /
    256), N, I]); y is ``skip(y, D, u)`` given D, else f32 before the skip."""
    y, entries = chunked_scan(u, delta, A, B, C, SCAN_CHUNK)
    ckpt = torch.stack(entries, dim=1).transpose(-1, -2).contiguous()
    return (y if D is None else skip(y, D, u)), ckpt


def selective_scan_bwd_by_batch_reference(u, delta, A, B, C, dy, ckpt):
    """Plain version of one backward launch: (du, ddelta, dA, dB, dC) of y
    before the D skip, f32, with dA kept per batch element, [B, I, N], as
    the kernel writes it. Chunk by chunk in reverse: the states are
    recomputed from the checkpoint, and the reverse recurrence
    gh_t = C_t dy_t + da_{t+1} gh_{t+1} runs as a doubling scan over the
    reversed chunk, carried between chunks by G = da_t gh_t of the chunk's
    first step. The cotangents are the formulas of the TPU kernel
    (``selective_scan_pallas.py:230-243``)."""
    bsz, L, I = u.shape
    A32 = A.float()
    du = torch.empty(bsz, L, I, dtype=torch.float32, device=u.device)
    ddelta = torch.empty_like(du)
    dB = torch.empty(bsz, L, A.shape[1], dtype=torch.float32, device=u.device)
    dC = torch.empty_like(dB)
    dA = torch.zeros(bsz, *A32.shape, dtype=torch.float32, device=u.device)
    G = torch.zeros(bsz, I, A.shape[1], dtype=torch.float32, device=u.device)
    for k in reversed(range(ckpt.shape[1])):
        sl = slice(k * SCAN_CHUNK, (k + 1) * SCAN_CHUNK)
        d, uu, Bc, Cc, g = (t[:, sl].float() for t in (delta, u, B, C, dy))
        da, db = _discretize(uu, d, A32, Bc)
        h0 = ckpt[:, k].transpose(-1, -2).float()
        h = scan_states(da, db, h0)
        h_prev = torch.cat([h0[:, None], h[:, :-1]], dim=1)
        da_next = torch.cat([da[:, 1:], torch.ones_like(da[:, :1])], dim=1)
        x = Cc[:, :, None, :] * g[..., None]
        gh = scan_states(da_next.flip(1), x.flip(1), G).flip(1)
        common = gh * h_prev * da
        dA += (common * d[..., None]).sum(1)
        gh_b = (gh * Bc[:, :, None, :]).sum(-1)
        ddelta[:, sl] = (common * A32).sum(-1) + gh_b * uu
        du[:, sl] = gh_b * d
        dB[:, sl] = (gh * (d * uu)[..., None]).sum(2)
        dC[:, sl] = (h * g[..., None]).sum(2)
        G = da[:, 0] * gh[:, 0]
    return du, ddelta, dA, dB, dC


def sum_dA(du, ddelta, dA, dB, dC):
    """A backward's outputs with dA summed over its batch dim, in one fixed order."""
    return du, ddelta, dA.sum(0), dB, dC


def selective_scan_bwd_reference(u, delta, A, B, C, dy, ckpt):
    """Plain version of the backward kernel: (du, ddelta, dA, dB, dC) of y
    before the D skip, f32."""
    return sum_dA(*selective_scan_bwd_by_batch_reference(u, delta, A, B, C, dy, ckpt))


# ---------------------------------------------------------------- state groups


def padded_d_state(n: int) -> int:
    """The d_state the kernels run ``n`` states at: the next multiple of
    ``KERNEL_D_STATE``."""
    return -(-n // KERNEL_D_STATE) * KERNEL_D_STATE


def state_groups(A, B, C) -> list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """(A, B, C) of each group of ``KERNEL_D_STATE`` states, contiguous, the
    state dim zero-padded to a whole number of groups; at d_state 16 the
    inputs themselves, uncopied. The padding is exact: a padded state has A
    = 0 (da = 1), B = 0 and a zero entry state, so it stays 0, and C = 0,
    so it adds 0 to y; in the backward its cotangent C dy + da G stays 0, so
    it adds 0 to du, ddelta, dA, dB and dC."""
    n = A.shape[-1]
    if n == KERNEL_D_STATE:
        return [(A, B, C)]
    pad = padded_d_state(n) - n
    A, B, C = (F.pad(t, (0, pad)) for t in (A, B, C))
    return [tuple(t[..., g:g + KERNEL_D_STATE].contiguous() for t in (A, B, C))
            for g in range(0, n + pad, KERNEL_D_STATE)]


def grouped_fwd(fwd, u, delta, A, B, C, D=None):
    """The forward at any d_state through ``fwd`` (a forward at 16 states:
    the kernel's launch, or in the CPU tests the plain version). At 16
    states, ``fwd`` itself, the skip included. Otherwise each group runs
    without D, y is summed over the groups in their order in f32 (so a
    second run repeats the first) and then skipped, and the checkpoints are
    concatenated along the state dim and sliced back to N."""
    n = A.shape[-1]
    if n == KERNEL_D_STATE:
        return fwd(u, delta, A, B, C, D)
    outs = [fwd(u, delta, *g) for g in state_groups(A, B, C)]
    y = outs[0][0]
    for o in outs[1:]:
        y = y + o[0]
    return (y if D is None else skip(y, D, u)), torch.cat([o[1] for o in outs], dim=2)[:, :, :n]


def grouped_bwd(bwd, u, delta, A, B, C, dy, ckpt):
    """The backward at any d_state through ``bwd`` (a backward at 16
    states): du and ddelta summed over the groups in their order, dA, dB and
    dC concatenated along the state dim and sliced back to N; the checkpoint
    zero-padded as the states are."""
    n = A.shape[-1]
    if n == KERNEL_D_STATE:
        return bwd(u, delta, A, B, C, dy, ckpt)
    ckpt = F.pad(ckpt, (0, 0, 0, padded_d_state(n) - n))
    outs = [bwd(u, delta, *g, dy, ckpt[:, :, k * KERNEL_D_STATE:(k + 1) * KERNEL_D_STATE].contiguous())
            for k, g in enumerate(state_groups(A, B, C))]
    du, ddelta = outs[0][0], outs[0][1]
    for o in outs[1:]:
        du, ddelta = du + o[0], ddelta + o[1]
    dA, dB, dC = (torch.cat([o[k] for o in outs], dim=-1)[..., :n] for k in (2, 3, 4))
    return du, ddelta, dA, dB, dC


# ---------------------------------------------------------------- channel padding and batch chunks


def padded_fwd(fwd, u, delta, A, B, C, D=None):
    """``fwd`` on I zero-padded to a multiple of ``CHANNEL_MULTIPLE`` (u,
    delta, A's rows and D), y and the checkpoint sliced back. Exact: a zero
    channel has zero inputs and touches no other channel."""
    I = u.shape[-1]
    pad = -I % CHANNEL_MULTIPLE
    if not pad:
        return fwd(u, delta, A, B, C, D)
    u, delta = (F.pad(t, (0, pad)) for t in (u, delta))
    y, ckpt = fwd(u, delta, F.pad(A, (0, 0, 0, pad)), B, C, None if D is None else F.pad(D, (0, pad)))
    return y[..., :I], ckpt[..., :I]


def padded_bwd(bwd, u, delta, A, B, C, dy, ckpt):
    """``bwd`` on I zero-padded as ``padded_fwd`` pads it (and dy and the
    checkpoint), du, ddelta and dA sliced back."""
    I = u.shape[-1]
    pad = -I % CHANNEL_MULTIPLE
    if not pad:
        return bwd(u, delta, A, B, C, dy, ckpt)
    u, delta, dy, ckpt = (F.pad(t, (0, pad)) for t in (u, delta, dy, ckpt))
    du, ddelta, dA, dB, dC = bwd(u, delta, F.pad(A, (0, 0, 0, pad)), B, C, dy, ckpt)
    return du[..., :I], ddelta[..., :I], dA[:I], dB, dC


def batch_chunked(fn, *args, limit: int = MAX_GRID_Y):
    """``fn(*args)`` in launches of at most ``limit`` batch elements. The
    arguments of 3 or more dims (u, delta, B, C, dy, the checkpoint) are cut
    along their batch dim into contiguous chunks (``bh_chunks``); the others
    (A, D) go whole to each. Every output of ``fn`` is batch-major, and each
    is joined along that dim in order: exact, since batch elements are
    independent. One chunk is ``fn`` on the arguments as given."""
    bsz = args[0].shape[0]
    if bsz <= limit:
        return fn(*args)
    outs = [fn(*(a[b0:b1] if a is not None and a.ndim >= 3 else a for a in args)) for b0, b1 in bh_chunks(bsz, limit)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


# ---------------------------------------------------------------- kernel wrappers


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous with a 16-byte aligned base (the kernels' TMA copies need one)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel_inputs(u, delta, A, B, C, D=None):
    """Check what the kernels take and return the tensors ready for them:
    contiguous and aligned, and A and D as f32."""
    if u.device.type != "cuda":
        raise ValueError(f"selective-scan kernels take CUDA tensors, got {u.device}")
    if u.dtype not in _DTYPE_CODE:
        raise ValueError(f"selective-scan kernels take bfloat16 or float32, got {u.dtype}")
    for t in (delta, A, B, C, D):
        if t is not None and t.device != u.device:
            raise ValueError("selective-scan kernel inputs must lie on one device")
    for t in (delta, B, C):
        if t.dtype != u.dtype:
            raise ValueError(f"selective-scan kernels take u, delta, B and C of one dtype, got {u.dtype} and {t.dtype}")
    if u.ndim != 3 or delta.shape != u.shape:
        raise ValueError(f"selective-scan kernels take u and delta [B, L, I], got {tuple(u.shape)} and {tuple(delta.shape)}")
    bsz, L, I = u.shape
    N = A.shape[-1]
    if A.shape != (I, N) or B.shape != (bsz, L, N) or C.shape != (bsz, L, N):
        raise ValueError(f"selective-scan shapes disagree: A {tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}")
    if D is not None and D.shape != (I,):
        raise ValueError(f"selective-scan D must be [I] = [{I}], got {tuple(D.shape)}")
    if bsz == 0 or L == 0 or I == 0 or N == 0:
        raise ValueError(f"selective-scan kernels take non-empty inputs, got {tuple(u.shape)} and d_state {N}")
    return (_aligned(u), _aligned(delta), _aligned(A.float()), _aligned(B), _aligned(C),
            None if D is None else _aligned(D.float()))


def _n_chunks(L: int) -> int:
    return -(-L // SCAN_CHUNK)


def _launch_fwd(u, delta, A, B, C, D=None):
    """One forward launch at 16 states, I a multiple of 8, at most
    ``MAX_GRID_Y`` batch elements: (y, checkpoint); y in u's dtype with the
    skip given D, else f32 before it."""
    global FWD_LAUNCHES
    bsz, L, I = u.shape
    lib = _build.load()
    y = torch.empty(bsz, L, I, dtype=torch.float32 if D is None else u.dtype, device=u.device)
    ckpt = torch.empty(bsz, _n_chunks(L), KERNEL_D_STATE, I, dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        err = lib.mlpt_scan_fwd(
            u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            None if D is None else D.data_ptr(), y.data_ptr(), ckpt.data_ptr(),
            bsz, L, I, KERNEL_D_STATE, _DTYPE_CODE[u.dtype], torch.cuda.current_stream(u.device).cuda_stream,
        )
    _build.check(lib, err, "selective-scan forward kernel")
    FWD_LAUNCHES += 1
    return y, ckpt


def _launch_bwd(u, delta, A, B, C, dy, ckpt):
    """One backward launch at 16 states, I a multiple of 8, at most
    ``MAX_GRID_Y`` batch elements: (du, ddelta, dA [B, I, 16] per batch
    element, dB, dC). dB and dC come from the kernel as one partial per
    80-channel tile and are summed here in a fixed order."""
    global BWD_LAUNCHES
    bsz, L, I = u.shape
    n_tiles = -(-I // BWD_CHANNELS_PER_BLOCK)
    lib = _build.load()
    f32 = dict(dtype=torch.float32, device=u.device)
    du = torch.empty(bsz, L, I, **f32)
    ddelta = torch.empty(bsz, L, I, **f32)
    dA_part = torch.empty(bsz, KERNEL_D_STATE, I, **f32)
    dB_part = torch.empty(n_tiles, bsz, L, KERNEL_D_STATE, **f32)
    dC_part = torch.empty(n_tiles, bsz, L, KERNEL_D_STATE, **f32)
    with torch.cuda.device(u.device):
        err = lib.mlpt_scan_bwd(
            u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), dy.data_ptr(), ckpt.data_ptr(),
            du.data_ptr(), ddelta.data_ptr(), dA_part.data_ptr(), dB_part.data_ptr(), dC_part.data_ptr(),
            bsz, L, I, KERNEL_D_STATE, _DTYPE_CODE[u.dtype], torch.cuda.current_stream(u.device).cuda_stream,
        )
    _build.check(lib, err, "selective-scan backward kernel")
    BWD_LAUNCHES += 1
    return du, ddelta, dA_part.transpose(1, 2), dB_part.sum(0), dC_part.sum(0)


def selective_scan_fwd_cuda(u, delta, A, B, C, D=None):
    """Launch the forward kernel, once per group of 16 states and chunk of
    at most 65,535 batch elements; returns (y, checkpoint f32 [B, ceil(L /
    256), N, I]), y in u's dtype with the D skip given D, else f32 before
    it. Both repeat bit for bit on a second call."""
    fwd = functools.partial(grouped_fwd, functools.partial(batch_chunked, _launch_fwd))
    return padded_fwd(fwd, *_kernel_inputs(u, delta, A, B, C, D))


def _bwd_launches(u, delta, A, B, C, dy, ckpt):
    return sum_dA(*batch_chunked(_launch_bwd, u, delta, A, B, C, dy, ckpt))


def selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt):
    """Launch the backward kernel, once per group of 16 states and chunk of
    at most 65,535 batch elements; returns (du, ddelta, dA, dB, dC) f32 of y
    before the D skip. dA comes from the kernel as one partial per batch
    element and dB, dC as one partial per 80-channel tile; they are summed
    here, so two runs give identical results."""
    u, delta, A, B, C, _ = _kernel_inputs(u, delta, A, B, C)
    bsz, L, I = u.shape
    N = A.shape[1]
    if dy.shape != u.shape or dy.device != u.device:
        raise ValueError(f"dy must be [B, L, I] on {u.device}, got {tuple(dy.shape)} on {dy.device}")
    if ckpt.shape != (bsz, _n_chunks(L), N, I) or ckpt.device != u.device:
        raise ValueError(f"checkpoint must be [B, ceil(L / {SCAN_CHUNK}), N, I] on {u.device}, got {tuple(ckpt.shape)}")
    bwd = functools.partial(grouped_bwd, _bwd_launches)
    return padded_bwd(bwd, u, delta, A, B, C, _aligned(dy.float()), _aligned(ckpt.float()))


# ---------------------------------------------------------------- custom ops
#
# Each op's CUDA implementation launches the kernels, its CPU implementation
# is the plain version: the only place where the choice is made.


def _no_kernel(u: torch.Tensor, *args) -> None:
    raise ValueError(f"selective scan has no kernel for device {u.device}")


@torch.library.custom_op("mlpt::scan_fwd", mutates_args=())
def scan_fwd(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
             D: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The scan forward: (y, checkpoint f32 [B, ceil(L / 256), N, I]); y in
    u's dtype with the D skip given D, else f32 before it."""
    _no_kernel(u)


@torch.library.custom_op("mlpt::scan_bwd", mutates_args=())
def scan_bwd(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
             dy: torch.Tensor, ckpt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                                                             torch.Tensor]:
    """The scan backward: (du, ddelta, dA, dB, dC) f32 of y before the D skip."""
    _no_kernel(u)


scan_fwd.register_kernel("cuda")(selective_scan_fwd_cuda)
scan_fwd.register_kernel("cpu")(selective_scan_fwd_reference)
scan_bwd.register_kernel("cuda")(selective_scan_bwd_cuda)
scan_bwd.register_kernel("cpu")(selective_scan_bwd_reference)


@scan_fwd.register_fake
def _(u, delta, A, B, C, D=None):
    bsz, L, I = u.shape
    y = u.new_empty(u.shape, dtype=torch.float32 if D is None else u.dtype)
    return y, u.new_empty((bsz, _n_chunks(L), A.shape[-1], I), dtype=torch.float32)


@scan_bwd.register_fake
def _(u, delta, A, B, C, dy, ckpt):
    f32 = dict(dtype=torch.float32)
    return (u.new_empty(u.shape, **f32), u.new_empty(u.shape, **f32), A.new_empty(A.shape, **f32),
            B.new_empty(B.shape, **f32), C.new_empty(C.shape, **f32))


def _scan_setup_context(ctx, inputs, output) -> None:
    """Save the inputs in their own dtype plus the f32 chunk checkpoint,
    never f32 copies of the [B, L, I] inputs; the checkpoint is a residual,
    not a result that takes a gradient."""
    u, delta, A, B, C, D = inputs
    _y, ckpt = output
    ctx.save_for_backward(u, delta, A, B, C, D, ckpt)
    ctx.mark_non_differentiable(ckpt)


def _scan_backward(ctx, g, _dckpt):
    """The backward op, then the D skip's terms in f32, as in the JAX
    custom VJP: y = scan(...) + D * u adds D * g to du and carries dD."""
    u, delta, A, B, C, D, ckpt = ctx.saved_tensors
    g32 = g.float()
    du, ddelta, dA, dB, dC = scan_bwd(u, delta, A, B, C, g32, ckpt)
    dD = None
    if D is not None:
        du = du + D.float() * g32
        dD = (g32 * u.float()).sum((0, 1)).to(D.dtype)
    return du.to(u.dtype), ddelta.to(delta.dtype), dA.to(A.dtype), dB.to(B.dtype), dC.to(C.dtype), dD


scan_fwd.register_autograd(_scan_backward, setup_context=_scan_setup_context)


def selective_scan_fused(u, delta, A, B, C, D) -> torch.Tensor:
    """y = scan(u, delta, A, B, C) + D * u in u's dtype, with the custom VJP
    of ``selective_scan_fused`` (``selective_scan_pallas.py:330-349``)."""
    return scan_fwd(u, delta, A, B, C, D)[0]
