"""The port's CUDA kernels (flash attention: forward, fused backward and the
split dq and dk/dv backward; selective scan; the LM-head loss; RMSNorm;
mamba's causal conv with its SiLU and its gate y * SiLU(z)) against their
plain versions.

This file imports no JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda

The tests marked ``cuda`` skip where no GPU is visible (the kernels have no
CPU mode); the others check the wrappers' guards and run anywhere.

Tolerances (bf16 inputs): out, dq, dk and dv within 1e-2 of their norm (the
two sides round the same operands to bf16 and differ in summation order and
in the online softmax's rescaling); lse within 1e-3 absolute (f32, no bf16
output rounding). The forward has no atomics and repeats bit for bit; it is
also held at its tile edges (q lengths around its 64- and 128-row blocks,
key counts other than the query count, varlen lengths 0, 1, 64, 127, 128
and full), as is the fused backward (q lengths around its 64-row blocks,
other key counts, lengths 0, 1, 63, 64, 65, 127, 128 and full). dq is summed
with f32 atomics in an order that changes from run to run, so two runs may
differ by one bf16 ulp of the larger value per element (plus f32 noise where
terms cancel); dk and dv are summed in one block each and repeat bit for
bit. The varlen mode (int32 lens per batch-head) keeps
these tolerances, and dk and dv at and past each length are exactly 0. The
split backward (one prep launch, the dq kernel and the dk/dv kernel, as
``mlpt::flash_bwd_split`` runs them) keeps them too, at the fused
backward's tile edges and at head dim 256 with any scale; it has no
atomics, so dq, dk and dv all repeat bit for bit, and it lies within 1e-2
of the fused kernel's norm. Its dk/dv kernel is the fused kernel without
dq, so on the same inputs dk and dv equal the fused kernel's bit for bit
wherever both form k*scale from the same bf16 k (bf16 inputs, or a
power-of-two scale).
f32 inputs are rounded to bf16 where they enter the tensor cores and the
plain versions are not: out and the gradients keep the 1e-2 of their norm (a
few roundings of 2^-9 each), and each row's lse is held to 1e-3 plus the
most that rounding q*scale and k can move its largest score, (2^-8 +
2^-18) * max_k sum_d |q_d * scale| * |k_d| (``_lse_limit_f32``).

Head dims other than the kernels' 64, 128 and 256 are zero-padded by the
wrappers (32 and 80 and 88 here): the kernels keep the tolerances above, and
on the CPU pad -> plain version -> slice equals the plain version to f32
summation order (1e-6). Batches of more than 65,535 batch-heads launch in
chunks, one launch counted each.

Selective scan (f32 or bf16 u/delta/B/C, both sides computing in f32 and
differing only in summation order and in the kernels' fast exp): y before
the D skip within 1e-4 of its norm, the checkpoint and the five gradients
within 1e-3 (dA and dB sum thousands of terms). y with the skip, in u's
dtype, keeps 1e-4 in f32; in bf16 both sides round to bf16 values that
differ by that f32 error, so an element may land one bf16 ulp (2^-8
relative) apart: one bf16 rounding, 4e-3 of the norm. Neither kernel has
atomics (the backward sums its partials outside the kernel), so two runs
repeat bit for bit, forward and backward. The kernels run 16 states a
launch: other d_states (1, 8, 12, 24, 64 here) go in zero-padded groups of
16. Both are held at their tile edges: L around the backward's 8-step and
the forward's 64-step groups and 192-step ring, and the 256-step chunks; I
around both kernels' 80-channel tiles and not a multiple of 8.
Batches above 65,535 launch in chunks, one launch counted each. The
backward's skip mode (D given, dy in u's dtype, du and ddelta out in it)
equals the f32 mode followed by the PyTorch epilogue it replaced: du,
ddelta, dA, dB and dC bit for bit, and dD, summed in another f32 order,
within 1e-6 of its largest value; a full-depth mamba and Jamba micro-batch
run every scan backward in it, with no PyTorch pass over [B, L, I] inside
``scan.backward``. The fused
backward at head dim 256 takes any scale (0.07, and 200^-0.5 at D=200
padded to 256).

Jamba: its Mamba mixer (inner dt/B/C norms, the conv and the gate in f32)
at [2, 4096, 5120] on the kernels against the same mixer's plain path on the
card, MQA attention (20 query heads of 128, one KV head repeated) on flash
against the plain versions, and a full-width micro-batch of one Mamba and
one attention layer counting its launches.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from multimodal_llm_pretraining_tpu_torch.ops import flash_attention as fa
from multimodal_llm_pretraining_tpu_torch.ops import selective_scan_fused as ssf

NORM_REL = 1e-2
LSE_ABS = 1e-3
SCAN_Y_NORM_REL = 1e-4
SCAN_Y_BF16_NORM_REL = 4e-3  # y with the skip in bf16: one bf16 rounding
SCAN_GRAD_NORM_REL = 1e-3
SCAN_DD_OF_MAX = 1e-6  # dD in the skip mode: its f32 sum in another order


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _rand(*shape, seed=0, dtype=torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(*shape, generator=g, device="cuda").to(dtype)


def _lse_limit_f32(q, k, scale):
    """Per query row: each bf16 rounding of an operand moves it by at most
    2^-9 of itself, so a score q.k moves by at most (2^-8 + 2^-18) * sum_d
    |q_d * scale| * |k_d|, and lse by no more than its row's largest score
    moves; LSE_ABS stays on top for the f32 exp and summation order."""
    return LSE_ABS + (2**-8 + 2**-18) * torch.matmul(q.abs() * scale, k.abs().transpose(-1, -2)).amax(-1)


def _close(got, want, tol=NORM_REL):
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).norm() / want.float().norm()
    assert err <= tol, err.item()


def test_wrappers_refuse_cpu_tensors():
    """CPU tensors never reach a kernel wrapper: the plain version is chosen
    by where the tensors lie, not as a fallback."""
    q = torch.randn(2, 16, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd_cuda(q, q, q, True, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd_cuda(q, q, q, q, torch.zeros(2, 16), q, True, 0.125)


def test_function_takes_plain_versions_on_cpu_without_launching():
    before = (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES)
    q = torch.randn(1, 2, 9, 16, requires_grad=True)
    fa.flash_attention(q, q, q, causal=True).sum().backward()
    assert (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES) == before
    assert q.grad is not None


@pytest.mark.cuda
@pytest.mark.parametrize("seq,head_dim,causal", [(77, 64, True), (77, 64, False), (130, 128, False), (257, 256, True),
                                                  (64, 256, False), (197, 64, False), (577, 64, False)])
def test_kernels_match_plain_versions(seq, head_dim, causal):
    _needs_cuda()
    q, k, v, do = (_rand(6, seq, head_dim, seed=i) for i in range(4))
    scale = head_dim**-0.5
    out, lse = fa.flash_fwd_cuda(q, k, v, causal, scale)
    out_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal, scale)
    _close(out, out_ref)
    torch.testing.assert_close(lse, lse_ref, atol=LSE_ABS, rtol=0)
    grads = fa.flash_bwd_cuda(q, k, v, out_ref, lse_ref, do, causal, scale)
    for got, want in zip(grads, fa.flash_bwd_reference(q, k, v, out_ref, lse_ref, do, causal, scale)):
        assert got.dtype == torch.bfloat16
        _close(got, want)


def _check_forward(q, k, v, causal, scale, kv_lens=None):
    """The forward kernel against its plain version (out to NORM_REL of its
    norm, lse per row to LSE_ABS, or to ``_lse_limit_f32`` on f32 inputs), a
    second launch bit for bit, and out 0 on rows that see no key."""
    out, lse = fa.flash_fwd_cuda(q, k, v, causal, scale, kv_lens)
    out_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal, scale, kv_lens)
    assert out.dtype == q.dtype and out.shape == q.shape and lse.shape == q.shape[:2]
    _close(out, out_ref)
    limit = LSE_ABS if q.dtype == torch.bfloat16 else _lse_limit_f32(q, k, scale)
    assert bool(((lse - lse_ref).abs() <= limit).all()), (lse - lse_ref).abs().max().item()
    out2, lse2 = fa.flash_fwd_cuda(q, k, v, causal, scale, kv_lens)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    if kv_lens is not None and bool((kv_lens == 0).any()):
        assert not out[kv_lens == 0].any()


# q lengths around the forward's 64- or 128-row q blocks and 64- or 128-key tiles
EDGE_SEQS = (1, 63, 64, 65, 127, 128, 129, 2049)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("head_dim", fa.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("seq", EDGE_SEQS)
def test_forward_at_tile_edges(seq, head_dim, causal, dtype):
    _needs_cuda()
    q, k, v = (_rand(3, seq, head_dim, seed=60 + i, dtype=dtype) for i in range(3))
    _check_forward(q, k, v, causal, head_dim**-0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("head_dim", fa.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("q_seq,kv_seq", [(65, 200), (200, 65), (129, 1), (1, 129), (2049, 300)])
def test_forward_with_other_key_count(q_seq, kv_seq, head_dim, causal):
    """kv_seq other than q_seq: the key tail masks on its own length, and a
    causal row still sees the keys at or before its own index."""
    _needs_cuda()
    q = _rand(3, q_seq, head_dim, seed=70)
    k, v = (_rand(3, kv_seq, head_dim, seed=71 + i) for i in range(2))
    _check_forward(q, k, v, causal, head_dim**-0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("head_dim", fa.KERNEL_HEAD_DIMS)
def test_varlen_forward_at_tile_edges(head_dim, causal, dtype):
    """Lens 0, 1, 64, 127, 128 and full (300) per batch row, 2 heads each:
    empty, one key, on and around both key-tile edges."""
    _needs_cuda()
    kv_lens = _lens([0, 1, 64, 127, 128, 300], 2)
    q, k, v = (_rand(12, 300, head_dim, seed=80 + i, dtype=dtype) for i in range(3))
    _check_forward(q, k, v, causal, head_dim**-0.5, kv_lens)


@pytest.mark.cuda
def test_kernels_take_f32_inputs():
    """f32 inputs are rounded to bf16 where they enter the tensor cores, as a
    default-precision f32 dot does on the TPU: the outputs stay f32 and
    agree with the f32 plain version to bf16 accuracy, lse within the most
    the rounding of q*scale and k can move it."""
    _needs_cuda()
    q, k, v, do = (_rand(4, 100, 64, seed=i, dtype=torch.float32) for i in range(4))
    out, lse = fa.flash_fwd_cuda(q, k, v, True, 0.125)
    out_ref, lse_ref = fa.flash_fwd_reference(q, k, v, True, 0.125)
    assert out.dtype == torch.float32
    _close(out, out_ref)
    assert bool(((lse - lse_ref).abs() <= _lse_limit_f32(q, k, 0.125)).all())
    for got, want in zip(fa.flash_bwd_cuda(q, k, v, out_ref, lse_ref, do, True, 0.125),
                         fa.flash_bwd_reference(q, k, v, out_ref, lse_ref, do, True, 0.125)):
        assert got.dtype == torch.float32
        _close(got, want)


@pytest.mark.cuda
def test_autograd_function_launches_kernels_on_strided_views():
    """[B, S, H, D] -> [B, H, S, D] transposed views, as ``SelfAttention``
    makes them, go through the custom op: one forward and one
    backward launch, results equal to the plain versions."""
    _needs_cuda()
    b, s, h, d = 2, 90, 3, 64
    base = [_rand(b, s, h, d, seed=i).requires_grad_() for i in range(3)]
    q, k, v = (t.transpose(1, 2) for t in base)
    do = _rand(b, h, s, d, seed=9)
    fa.reset_launch_counts()
    fa.flash_attention(q, k, v, causal=True).backward(do)
    assert (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES) == (1, 1)
    flat = [t.detach().transpose(1, 2).reshape(b * h, s, d) for t in base]
    out_ref, lse_ref = fa.flash_fwd_reference(*flat, True, d**-0.5)
    grads_ref = fa.flash_bwd_reference(*flat, out_ref, lse_ref, do.reshape(b * h, s, d), True, d**-0.5)
    for t, want in zip(base, grads_ref):
        _close(t.grad.transpose(1, 2).reshape(b * h, s, d), want)


@pytest.mark.cuda
def test_dq_varies_by_at_most_one_ulp_between_runs():
    _needs_cuda()
    q, k, v, do = (_rand(8, 257, 256, seed=i) for i in range(4))
    out, lse = fa.flash_fwd_cuda(q, k, v, True, 1 / 16)
    dq1, dk1, dv1 = fa.flash_bwd_cuda(q, k, v, out, lse, do, True, 1 / 16)
    dq2, dk2, dv2 = fa.flash_bwd_cuda(q, k, v, out, lse, do, True, 1 / 16)
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)
    # one bf16 ulp of the larger value, plus f32 summation-order noise
    # where the terms cancel to near zero
    ulp = torch.maximum(dq1.float().abs(), dq2.float().abs()) * 2.0**-7
    assert ((dq1.float() - dq2.float()).abs() <= ulp + 1e-6).all()


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take():
    _needs_cuda()
    q = _rand(2, 16, 320)
    with pytest.raises(ValueError, match="head_dim up to 256"):
        fa.flash_fwd_cuda(q, q, q, True, 0.1)
    # head_dim 256 with a scale that is not a power of two: no longer refused
    q, k, v, do = (_rand(2, 16, 256, seed=140 + i) for i in range(4))
    out, lse = fa.flash_fwd_reference(q, k, v, False, 0.1)
    for got, want in zip(fa.flash_bwd_cuda(q, k, v, out, lse, do, False, 0.1),
                         fa.flash_bwd_reference(q, k, v, out, lse, do, False, 0.1)):
        _close(got, want)
    q = _rand(2, 16, 64, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fa.flash_fwd_cuda(q, q, q, True, 0.1)
    q = _rand(2, 16, 64)
    for lens in (torch.tensor([16, 3], device="cuda"), torch.tensor([16, 3], dtype=torch.int32),
                 torch.tensor([16], dtype=torch.int32, device="cuda")):
        with pytest.raises(ValueError, match="kv_lens"):
            fa.flash_fwd_cuda(q, q, q, True, 0.1, lens)


def _check_backward(q, k, v, do, causal, scale, kv_lens=None):
    """The fused backward against its plain version (dq, dk, dv to NORM_REL
    of their norm, in the input dtype), dk and dv bit for bit on a second
    launch, dq within one bf16 ulp, dk and dv exactly 0 at and past each
    length."""
    out, lse = fa.flash_fwd_reference(q, k, v, causal, scale, kv_lens)
    grads = fa.flash_bwd_cuda(q, k, v, out, lse, do, causal, scale, kv_lens)
    for got, want in zip(grads, fa.flash_bwd_reference(q, k, v, out, lse, do, causal, scale, kv_lens)):
        assert got.dtype == q.dtype and got.shape == want.shape
        _close(got, want)
    dq2, dk2, dv2 = fa.flash_bwd_cuda(q, k, v, out, lse, do, causal, scale, kv_lens)
    assert torch.equal(dk2, grads[1]) and torch.equal(dv2, grads[2])
    ulp = torch.maximum(dq2.float().abs(), grads[0].float().abs()) * 2.0**-7
    assert ((dq2.float() - grads[0].float()).abs() <= ulp + 1e-6).all()
    if kv_lens is not None:
        past = torch.arange(k.shape[1], device="cuda")[None, :] >= kv_lens[:, None]
        assert not grads[1][past].any() and not grads[2][past].any()


# q lengths around the fused backward's 64-row q and k blocks. One query
# alone (q_seq 1, or a causal row 0) sees one key, where ds = p (dp - delta)
# is rounding noise on both sides: such rows are kept to a minority.
BWD_EDGE_SEQS = (17, 63, 64, 65, 127, 128, 129, 2049)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("head_dim", fa.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("seq", BWD_EDGE_SEQS)
def test_fused_backward_at_tile_edges(seq, head_dim, causal, dtype):
    _needs_cuda()
    q, k, v, do = (_rand(3, seq, head_dim, seed=90 + i, dtype=dtype) for i in range(4))
    _check_backward(q, k, v, do, causal, head_dim**-0.5)


# (q_seq, kv_seq, causal): key counts other than the query count, both ways;
# one query alone runs non-causal only (see above)
OTHER_KEY_COUNTS = [
    (1, 129, False), (65, 200, True), (65, 200, False), (200, 65, True), (200, 65, False), (129, 130, True),
    (129, 130, False), (2049, 300, True), (2049, 300, False), (300, 2049, True), (300, 2049, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("head_dim", fa.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("q_seq,kv_seq,causal", OTHER_KEY_COUNTS)
def test_fused_backward_with_other_key_count(q_seq, kv_seq, causal, head_dim, dtype):
    _needs_cuda()
    q, do = (_rand(3, q_seq, head_dim, seed=100 + i, dtype=dtype) for i in range(2))
    k, v = (_rand(3, kv_seq, head_dim, seed=102 + i, dtype=dtype) for i in range(2))
    _check_backward(q, k, v, do, causal, head_dim**-0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("head_dim", fa.KERNEL_HEAD_DIMS)
def test_varlen_backward_at_tile_edges(head_dim, causal, dtype):
    """Lens 0, 1, 63, 64, 65, 127, 128 and full (300) per batch row, 2
    heads each: empty, one key, on and around the 64-key block edges."""
    _needs_cuda()
    kv_lens = _lens([0, 1, 63, 64, 65, 127, 128, 300], 2)
    q, k, v, do = (_rand(16, 300, head_dim, seed=110 + i, dtype=dtype) for i in range(4))
    _check_backward(q, k, v, do, causal, head_dim**-0.5, kv_lens)


@pytest.mark.cuda
@pytest.mark.parametrize("varlen", [False, True])
@pytest.mark.parametrize("head_dim,scale", [(256, 0.07), (200, 200**-0.5)])
@pytest.mark.parametrize("causal", [True, False])
def test_fused_backward_at_d256_with_any_scale(head_dim, scale, causal, varlen):
    """Head dim 256 (or 200 zero-padded to 256) with a scale that is not a
    power of two: the kernel's one-stage variant with its k*scale tile,
    plain and varlen mode, held as ``_check_backward`` holds the others."""
    _needs_cuda()
    kv_lens = _lens([0, 1, 63, 64, 65, 300], 2) if varlen else None
    q, k, v, do = (_rand(12, 300, head_dim, seed=130 + i) for i in range(4))
    before = fa.VARLEN_BWD_LAUNCHES if varlen else fa.BWD_LAUNCHES
    _check_backward(q, k, v, do, causal, scale, kv_lens)
    assert (fa.VARLEN_BWD_LAUNCHES if varlen else fa.BWD_LAUNCHES) == before + 2


PADDED_HEAD_DIMS = (32, 80, 88)  # pythia-14m/31m, pythia-2.8b, the default ViLT trunk


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("head_dim", PADDED_HEAD_DIMS)
def test_padded_head_dim_is_exact_in_the_plain_versions(head_dim, causal):
    """On the CPU: the wrappers' zero padding of the head dim, then the plain
    versions at the model's scale, then the slice back, equal the plain
    versions at the model's head dim (f32, to summation order: 1e-6)."""
    g = torch.Generator().manual_seed(head_dim)
    q, k, v, do = (torch.randn(3, 70, head_dim, generator=g) for _ in range(4))
    scale = head_dim**-0.5
    dp = fa.kernel_head_dim(head_dim)
    pq, pk, pv, pdo = (fa._kernel_ready(t, dp) for t in (q, k, v, do))
    assert pq.shape[-1] == dp and not pq[..., head_dim:].any()
    out, lse = fa.flash_fwd_reference(q, k, v, causal, scale)
    pout, plse = fa.flash_fwd_reference(pq, pk, pv, causal, scale)
    assert not pout[..., head_dim:].any()
    torch.testing.assert_close(pout[..., :head_dim], out, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(plse, lse, rtol=1e-6, atol=1e-6)
    grads = fa.flash_bwd_reference(q, k, v, out, lse, do, causal, scale)
    pgrads = fa.flash_bwd_reference(pq, pk, pv, pout, plse, pdo, causal, scale)
    for got, want in zip(pgrads, grads):
        assert not got[..., head_dim:].any()
        torch.testing.assert_close(got[..., :head_dim], want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bh,limit,expected", [
    (1, 65535, [(0, 1)]), (65535, 65535, [(0, 65535)]), (65536, 65535, [(0, 65535), (65535, 65536)]),
    (7, 3, [(0, 3), (3, 6), (6, 7)]), (131070, 65535, [(0, 65535), (65535, 131070)]),
])
def test_bh_chunks_cover_the_batch_in_launchable_pieces(bh, limit, expected):
    chunks = fa.bh_chunks(bh, limit)
    assert chunks == expected
    assert all(0 < b1 - b0 <= limit for b0, b1 in chunks) and chunks[0][0] == 0 and chunks[-1][1] == bh
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("head_dim", PADDED_HEAD_DIMS)
def test_kernels_at_padded_head_dims(head_dim, causal):
    """The forward, fused backward and split pair at head dims the kernels
    run zero-padded, plain and varlen mode, against the plain versions at the
    model's head dim; each output keeps the caller's head dim."""
    _needs_cuda()
    q, k, v, do = (_rand(4, 130, head_dim, seed=120 + i) for i in range(4))
    scale = head_dim**-0.5
    for kv_lens in (None, _lens([130, 64], 2)):
        _check_forward(q, k, v, causal, scale, kv_lens)
        _check_backward(q, k, v, do, causal, scale, kv_lens)
        out, lse = fa.flash_fwd_reference(q, k, v, causal, scale, kv_lens)
        for got, want in zip(_split(q, k, v, out, lse, do, causal, scale, kv_lens),
                             _split_reference(q, k, v, out, lse, do, causal, scale, kv_lens)):
            assert got.shape == want.shape
            _close(got, want)


@pytest.mark.cuda
def test_kernels_launch_more_than_max_grid_y_batch_heads():
    """65,536 batch-heads, one more than a launch grid's y dimension holds:
    every wrapper launches twice, and the results equal the plain versions."""
    _needs_cuda()
    bh = fa.MAX_GRID_Y + 1
    q, k, v, do = (_rand(bh, 16, 64, seed=130 + i) for i in range(4))
    lens = torch.randint(0, 17, (bh,), generator=torch.Generator().manual_seed(0), dtype=torch.int32).cuda()
    fa.reset_launch_counts()
    for kv_lens in (None, lens):
        _check_forward(q, k, v, True, 0.125, kv_lens)
        out, lse = fa.flash_fwd_reference(q, k, v, True, 0.125, kv_lens)
        for got, want in zip(fa.flash_bwd_cuda(q, k, v, out, lse, do, True, 0.125, kv_lens),
                             fa.flash_bwd_reference(q, k, v, out, lse, do, True, 0.125, kv_lens)):
            _close(got, want)
        for got, want in zip(_split(q, k, v, out, lse, do, True, 0.125, kv_lens),
                             _split_reference(q, k, v, out, lse, do, True, 0.125, kv_lens)):
            _close(got, want)
    counts = (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES, fa.VARLEN_FWD_LAUNCHES,
              fa.VARLEN_BWD_LAUNCHES, fa.VARLEN_DQ_LAUNCHES, fa.VARLEN_DKV_LAUNCHES)
    assert counts == (4, 2, 2, 2, 4, 2, 2, 2)  # _check_forward launches the forward twice


# ---------------------------------------------------------------- varlen mode


def test_varlen_function_takes_plain_versions_on_cpu_without_launching():
    before = (fa.VARLEN_FWD_LAUNCHES, fa.VARLEN_BWD_LAUNCHES, fa.FWD_LAUNCHES, fa.BWD_LAUNCHES)
    q = torch.randn(2, 2, 9, 16, requires_grad=True)
    mask = (torch.arange(9)[None, :] < torch.tensor([[9], [4]])).long()
    fa.flash_attention(q, q, q, causal=True, kv_len_mask=mask).sum().backward()
    assert (fa.VARLEN_FWD_LAUNCHES, fa.VARLEN_BWD_LAUNCHES, fa.FWD_LAUNCHES, fa.BWD_LAUNCHES) == before
    assert q.grad is not None


def _lens(values, heads):
    return torch.tensor(values, dtype=torch.int32, device="cuda").repeat_interleave(heads)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "seq,head_dim,causal,lens",
    [(77, 64, True, [77, 37, 64, 0]), (77, 64, False, [77, 37, 64, 0]), (300, 128, True, [300, 135, 1, 256]),
     (577, 64, False, [577, 576, 100, 31]), (130, 256, True, [130, 32, 65, 129])],
)
def test_varlen_kernels_match_plain_versions(seq, head_dim, causal, lens):
    """Lens per batch row (4 rows x 2 heads): full, inside a tile, on a tile
    edge, empty. Every query row is compared, padded ones included; dk and
    dv are exactly 0 at and past each length; an empty row gives out 0."""
    _needs_cuda()
    kv_lens = _lens(lens, 2)
    q, k, v, do = (_rand(8, seq, head_dim, seed=10 + i) for i in range(4))
    scale = head_dim**-0.5
    out, lse = fa.flash_fwd_cuda(q, k, v, causal, scale, kv_lens)
    out_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal, scale, kv_lens)
    _close(out, out_ref)
    torch.testing.assert_close(lse, lse_ref, atol=LSE_ABS, rtol=0)
    empty = kv_lens == 0
    assert not out[empty].any()
    grads = fa.flash_bwd_cuda(q, k, v, out_ref, lse_ref, do, causal, scale, kv_lens)
    for got, want in zip(grads, fa.flash_bwd_reference(q, k, v, out_ref, lse_ref, do, causal, scale, kv_lens)):
        _close(got, want)
    past = torch.arange(seq, device="cuda")[None, :] >= kv_lens[:, None]
    assert not grads[1][past].any() and not grads[2][past].any()


@pytest.mark.cuda
def test_varlen_backward_repeats_dk_dv_bit_for_bit():
    _needs_cuda()
    kv_lens = _lens([1087, 1024, 37, 500], 4)
    q, k, v, do = (_rand(16, 1087, 64, seed=20 + i) for i in range(4))
    out, lse = fa.flash_fwd_cuda(q, k, v, True, 0.125, kv_lens)
    _, dk1, dv1 = fa.flash_bwd_cuda(q, k, v, out, lse, do, True, 0.125, kv_lens)
    _, dk2, dv2 = fa.flash_bwd_cuda(q, k, v, out, lse, do, True, 0.125, kv_lens)
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)


@pytest.mark.cuda
def test_mask_takes_the_varlen_kernels_even_when_full():
    """A [B, S] keep-mask always takes the varlen mode (one varlen launch
    each way, no plain-mode launch); with every row full it gives the plain
    mode's numbers, and a right-padded mask gives the plain versions'."""
    _needs_cuda()
    b, h, s, d = 2, 3, 90, 64
    base = [_rand(b, h, s, d, seed=30 + i).requires_grad_() for i in range(3)]
    do = _rand(b, h, s, d, seed=33)
    for mask in (torch.ones(b, s, dtype=torch.long, device="cuda"),
                 (torch.arange(s, device="cuda")[None, :] < torch.tensor([[90], [41]], device="cuda")).long()):
        fa.reset_launch_counts()
        out = fa.flash_attention(*base, causal=True, kv_len_mask=mask)
        grads = torch.autograd.grad(out, base, grad_outputs=do)
        assert (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES, fa.VARLEN_FWD_LAUNCHES, fa.VARLEN_BWD_LAUNCHES) == (0, 0, 1, 1)
        flat = [t.detach().reshape(b * h, s, d) for t in base]
        lens = mask.sum(-1).to(torch.int32).repeat_interleave(h)
        out_ref, lse_ref = fa.flash_fwd_reference(*flat, True, d**-0.5, lens)
        _close(out.reshape(b * h, s, d), out_ref)
        for got, want in zip(grads, fa.flash_bwd_reference(*flat, out_ref, lse_ref, do.reshape(b * h, s, d), True,
                                                            d**-0.5, lens)):
            _close(got.reshape(b * h, s, d), want)


# ---------------------------------------------------------------- split backward


def test_split_wrappers_refuse_cpu_tensors():
    q = torch.randn(2, 16, 64)
    lse = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.split_operands(q, q, q, q, lse, q, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd_split_cuda(q, q, q, q, lse, q, True, 0.125)


def test_split_function_takes_plain_versions_on_cpu_without_launching(monkeypatch):
    monkeypatch.setattr(fa, "PREFER_FUSED_BWD", False)
    names = ("DQ_LAUNCHES", "DKV_LAUNCHES", "VARLEN_DQ_LAUNCHES", "VARLEN_DKV_LAUNCHES", "BWD_LAUNCHES")
    before = [getattr(fa, n) for n in names]
    q = torch.randn(2, 2, 9, 16, requires_grad=True)
    mask = (torch.arange(9)[None, :] < torch.tensor([[9], [4]])).long()
    for m in (None, mask):
        fa.flash_attention(q, q, q, causal=True, kv_len_mask=m).sum().backward()
    assert [getattr(fa, n) for n in names] == before
    assert q.grad is not None


def _split(q, k, v, out, lse, do, causal, scale, kv_lens=None):
    """The split pair as ``mlpt::flash_bwd_split`` runs it."""
    return fa.flash_bwd_split_cuda(q, k, v, out, lse, do, causal, scale, kv_lens)


def _split_reference(q, k, v, out, lse, do, causal, scale, kv_lens=None):
    return fa.flash_bwd_split_reference(q, k, v, out, lse, do, causal, scale, kv_lens)


def _check_split(q, k, v, do, causal, scale, kv_lens=None, against_fused=False):
    """The split pair against its plain versions (dq, dk, dv to NORM_REL of
    their norm, in the input dtype), all three bit for bit on a second run,
    dk and dv exactly 0 at and past each length, dq 0 on a row that sees no
    key. With ``against_fused``, also against the fused kernel on the same
    inputs: all three within NORM_REL of its, and dk and dv bit for bit
    wherever both form k*scale from the same bf16 k (bf16 inputs, or a
    power-of-two scale)."""
    out, lse = fa.flash_fwd_reference(q, k, v, causal, scale, kv_lens)
    grads = _split(q, k, v, out, lse, do, causal, scale, kv_lens)
    if against_fused:
        fused = fa.flash_bwd_cuda(q, k, v, out, lse, do, causal, scale, kv_lens)
        for a, f in zip(grads, fused):
            _close(a, f)
        if q.dtype == torch.bfloat16 or math.frexp(scale)[0] == 0.5:
            assert torch.equal(grads[1], fused[1]) and torch.equal(grads[2], fused[2])
    for got, want in zip(grads, _split_reference(q, k, v, out, lse, do, causal, scale, kv_lens)):
        assert got.dtype == q.dtype and got.shape == want.shape
        _close(got, want)
    for a, b in zip(grads, _split(q, k, v, out, lse, do, causal, scale, kv_lens)):
        assert torch.equal(a, b)
    if kv_lens is not None:
        past = torch.arange(k.shape[1], device="cuda")[None, :] >= kv_lens[:, None]
        assert not grads[1][past].any() and not grads[2][past].any()
        assert not grads[0][kv_lens == 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("head_dim", fa.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("seq", BWD_EDGE_SEQS)
def test_split_backward_at_tile_edges(seq, head_dim, causal, dtype):
    """The fused backward's tile-edge cases, through the split pair: q
    lengths around the dq kernel's 64- and 128-row q blocks and the 64-key
    blocks of both kernels."""
    _needs_cuda()
    q, k, v, do = (_rand(3, seq, head_dim, seed=140 + i, dtype=dtype) for i in range(4))
    _check_split(q, k, v, do, causal, head_dim**-0.5, against_fused=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("head_dim", fa.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("q_seq,kv_seq,causal", OTHER_KEY_COUNTS)
def test_split_backward_with_other_key_count(q_seq, kv_seq, causal, head_dim, dtype):
    _needs_cuda()
    q, do = (_rand(3, q_seq, head_dim, seed=150 + i, dtype=dtype) for i in range(2))
    k, v = (_rand(3, kv_seq, head_dim, seed=152 + i, dtype=dtype) for i in range(2))
    _check_split(q, k, v, do, causal, head_dim**-0.5, against_fused=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("head_dim", fa.KERNEL_HEAD_DIMS)
def test_split_varlen_backward_at_tile_edges(head_dim, causal, dtype):
    """Lens 0, 1, 63, 64, 65, 127, 128 and full (300) per batch row, 2
    heads each, through the split pair."""
    _needs_cuda()
    kv_lens = _lens([0, 1, 63, 64, 65, 127, 128, 300], 2)
    q, k, v, do = (_rand(16, 300, head_dim, seed=160 + i, dtype=dtype) for i in range(4))
    _check_split(q, k, v, do, causal, head_dim**-0.5, kv_lens, against_fused=True)


@pytest.mark.cuda
@pytest.mark.parametrize("varlen", [False, True])
@pytest.mark.parametrize("head_dim,scale,dtype", [
    (256, 0.07, torch.bfloat16), (200, 200**-0.5, torch.bfloat16), (256, 0.07, torch.float32),
])
@pytest.mark.parametrize("causal", [True, False])
def test_split_backward_at_d256_with_any_scale(head_dim, scale, causal, dtype, varlen):
    """Head dim 256 (or 200 zero-padded to 256) with a scale that is not a
    power of two: the dk/dv kernel reads k*scale rounded once by the
    wrapper, the dq kernel q*scale (formed in the kernel, or by the wrapper
    from f32), plain and varlen mode."""
    _needs_cuda()
    kv_lens = _lens([0, 1, 63, 64, 65, 300], 2) if varlen else None
    q, k, v, do = (_rand(12, 300, head_dim, seed=170 + i, dtype=dtype) for i in range(4))
    names = ("VARLEN_DQ_LAUNCHES", "VARLEN_DKV_LAUNCHES") if varlen else ("DQ_LAUNCHES", "DKV_LAUNCHES")
    before = [getattr(fa, n) for n in names]
    _check_split(q, k, v, do, causal, scale, kv_lens)
    assert [getattr(fa, n) for n in names] == [b + 2 for b in before]


@pytest.mark.cuda
@pytest.mark.parametrize("varlen", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("head_dim,scale,dtype", [
    (64, 0.125, torch.bfloat16), (128, 128**-0.5, torch.bfloat16), (256, 0.0625, torch.bfloat16),
    (256, 0.07, torch.bfloat16), (80, 80**-0.5, torch.bfloat16), (64, 0.125, torch.float32),
])
def test_split_dk_dv_equal_the_fused_kernels_bit_for_bit(head_dim, scale, dtype, causal, varlen):
    """The dk/dv kernel is the fused kernel without dq: on the same inputs
    it reads the same prep rows and the same k*scale (formed from the same
    bf16 k: bf16 inputs, or a power-of-two scale) and gives the same bits."""
    _needs_cuda()
    kv_lens = _lens([0, 1, 63, 64, 65, 300], 2) if varlen else None
    q, k, v, do = (_rand(12, 300, head_dim, seed=180 + i, dtype=dtype) for i in range(4))
    out, lse = fa.flash_fwd_reference(q, k, v, causal, scale, kv_lens)
    _, dk, dv = fa.flash_bwd_cuda(q, k, v, out, lse, do, causal, scale, kv_lens)
    _, dk_split, dv_split = _split(q, k, v, out, lse, do, causal, scale, kv_lens)
    assert torch.equal(dk_split, dk) and torch.equal(dv_split, dv)


@pytest.mark.cuda
@pytest.mark.parametrize("seq,kv_seq,head_dim,causal,dtype", [
    (77, 77, 64, True, torch.bfloat16), (130, 130, 128, False, torch.bfloat16), (257, 257, 256, True, torch.bfloat16),
    (197, 197, 64, False, torch.float32), (300, 150, 64, False, torch.bfloat16), (64, 64, 256, False, torch.float32),
    (77, 77, 64, False, torch.bfloat16), (197, 197, 64, False, torch.bfloat16),
])
def test_split_kernels_match_plain_versions_and_repeat(seq, kv_seq, head_dim, causal, dtype):
    """dq and dk/dv against their plain versions, a second run bit for bit,
    and the pair within 1e-2 of the fused kernel's norm."""
    _needs_cuda()
    q, do = (_rand(6, seq, head_dim, seed=i, dtype=dtype) for i in (0, 3))
    k, v = (_rand(6, kv_seq, head_dim, seed=i, dtype=dtype) for i in (1, 2))
    scale = head_dim**-0.5
    out, lse = fa.flash_fwd_reference(q, k, v, causal, scale)
    grads = _split(q, k, v, out, lse, do, causal, scale)
    for got, want in zip(grads, _split_reference(q, k, v, out, lse, do, causal, scale)):
        assert got.dtype == dtype and got.shape == want.shape
        _close(got, want)
    for a, b in zip(grads, _split(q, k, v, out, lse, do, causal, scale)):
        assert torch.equal(a, b)
    for a, b in zip(grads, fa.flash_bwd_cuda(q, k, v, out, lse, do, causal, scale)):
        _close(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("seq,head_dim,causal,lens", [
    (77, 64, True, [77, 37, 64, 0]), (77, 64, False, [77, 37, 64, 0]), (300, 128, True, [300, 135, 1, 256]),
    (130, 256, True, [130, 32, 65, 129]),
])
def test_split_varlen_kernels_match_plain_versions(seq, head_dim, causal, lens):
    """Lens per batch row (4 rows x 2 heads), as the fused varlen cases; dk
    and dv exactly 0 at and past each length, dq 0 on an empty row."""
    _needs_cuda()
    kv_lens = _lens(lens, 2)
    q, k, v, do = (_rand(8, seq, head_dim, seed=40 + i) for i in range(4))
    scale = head_dim**-0.5
    out, lse = fa.flash_fwd_reference(q, k, v, causal, scale, kv_lens)
    grads = _split(q, k, v, out, lse, do, causal, scale, kv_lens)
    for got, want in zip(grads, _split_reference(q, k, v, out, lse, do, causal, scale, kv_lens)):
        _close(got, want)
    past = torch.arange(seq, device="cuda")[None, :] >= kv_lens[:, None]
    assert not grads[1][past].any() and not grads[2][past].any()
    assert not grads[0][kv_lens == 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("mask", [False, True])
def test_function_takes_the_split_kernels_when_fused_is_off(mask, monkeypatch):
    """With ``PREFER_FUSED_BWD`` off the autograd Function launches one dq
    and one dk/dv kernel (varlen ones under a mask) and no fused backward."""
    _needs_cuda()
    monkeypatch.setattr(fa, "PREFER_FUSED_BWD", False)
    b, h, s, d = 2, 3, 90, 64
    base = [_rand(b, h, s, d, seed=50 + i, dtype=torch.float32).requires_grad_() for i in range(3)]
    do = _rand(b, h, s, d, seed=53, dtype=torch.float32)
    m = (torch.arange(s, device="cuda")[None, :] < torch.tensor([[90], [41]], device="cuda")).long() if mask else None
    fa.reset_launch_counts()
    out = fa.flash_attention(*base, causal=False, kv_len_mask=m)
    grads = torch.autograd.grad(out, base, grad_outputs=do)
    split = (fa.DQ_LAUNCHES, fa.DKV_LAUNCHES, fa.VARLEN_DQ_LAUNCHES, fa.VARLEN_DKV_LAUNCHES)
    assert split == ((0, 0, 1, 1) if mask else (1, 1, 0, 0))
    assert fa.BWD_LAUNCHES == fa.VARLEN_BWD_LAUNCHES == 0
    flat = [t.detach().reshape(b * h, s, d) for t in base]
    lens = None if m is None else m.sum(-1).to(torch.int32).repeat_interleave(h)
    out_ref, lse_ref = fa.flash_fwd_reference(*flat, False, d**-0.5, lens)
    for got, want in zip(grads, _split_reference(*flat, out_ref, lse_ref, do.reshape(b * h, s, d), False, d**-0.5,
                                                 lens)):
        _close(got.reshape(b * h, s, d), want)


# ---------------------------------------------------------------- selective scan


def _scan_inputs(b, L, I, N=16, seed=0, dtype=torch.float32, device="cuda"):
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=device)

    u = rand(b, L, I).to(dtype)
    delta = (torch.rand(b, L, I, generator=g, device=device) * 0.5 + 0.01).to(dtype)
    A = -(torch.rand(I, N, generator=g, device=device) + 0.5)
    B, C = rand(b, L, N).to(dtype), rand(b, L, N).to(dtype)
    dy = rand(b, L, I)
    return u, delta, A, B, C, dy


def test_scan_wrappers_refuse_cpu_tensors():
    u, delta, A, B, C, dy = _scan_inputs(1, 8, 4, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ssf.selective_scan_fwd_cuda(u, delta, A, B, C)
    with pytest.raises(ValueError, match="CUDA"):
        ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, torch.zeros(1, 1, 16, 4))


def test_scan_function_takes_plain_versions_on_cpu_without_launching():
    before = (ssf.FWD_LAUNCHES, ssf.BWD_LAUNCHES)
    u, delta, A, B, C, _ = _scan_inputs(1, 9, 4, device="cpu")
    u.requires_grad_()
    ssf.selective_scan_fused(u, delta, A, B, C, torch.ones(4)).sum().backward()
    assert (ssf.FWD_LAUNCHES, ssf.BWD_LAUNCHES) == before
    assert u.grad is not None


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 300, 96), (1, 64, 32), (2, 1000, 40), (1, 7, 5), (2, 4096, 5120)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernels_match_plain_versions(shape, dtype):
    """Ragged L (not a multiple of 256 or of the kernels' tiles), ragged I
    (not a multiple of the kernels' channel tiles) and mamba-2.8b's own
    shape: ``_check_scan``, the checkpoint's first chunk exactly 0, and dD
    through the autograd Function equal to the sum of dy * u."""
    _needs_cuda()
    u, delta, A, B, C, dy = _scan_inputs(*shape, seed=sum(shape), dtype=dtype)
    _check_scan(u, delta, A, B, C, dy)
    _, ckpt = ssf.selective_scan_fwd_cuda(u, delta, A, B, C)
    assert torch.equal(ckpt[:, 0], torch.zeros_like(ckpt[:, 0]))
    leaves = [t.clone().requires_grad_() for t in (u, delta, A, B, C, torch.randn(shape[-1], device="cuda"))]
    g = dy.to(dtype)
    ssf.selective_scan_fused(*leaves).backward(g)
    _close(leaves[5].grad, (g.float() * u.float()).sum((0, 1)), SCAN_GRAD_NORM_REL)


@pytest.mark.cuda
def test_scan_backward_repeats_bit_for_bit():
    _needs_cuda()
    u, delta, A, B, C, dy = _scan_inputs(2, 600, 100, seed=3, dtype=torch.bfloat16)
    _, ckpt = ssf.selective_scan_fwd_cuda(u, delta, A, B, C)
    first = ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt)
    second = ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_scan_function_launches_kernels_and_adds_the_skip():
    """One forward and one backward launch through the ``mlpt::scan_fwd``
    op's autograd rule, on strided views of one projection as the Mamba
    block makes them; the six gradients, dD included, equal the plain
    versions'."""
    _needs_cuda()
    u, delta, A, B, C, dy = _scan_inputs(2, 300, 64, seed=5)
    D = torch.randn(64, device="cuda")
    x_dbc = torch.cat([B, C], dim=-1)
    leaves = [t.clone().requires_grad_() for t in (u, delta, A, x_dbc, D)]
    lu, ld, lA, lx, lD = leaves
    ssf.reset_launch_counts()
    y = ssf.selective_scan_fused(lu, ld, lA, lx[..., :16], lx[..., 16:], lD)
    y.backward(dy)
    assert (ssf.FWD_LAUNCHES, ssf.BWD_LAUNCHES) == (1, 1)
    y_ref, ckpt = ssf.selective_scan_fwd_reference(u, delta, A, B, C)
    _close(y, y_ref + D * u, SCAN_Y_NORM_REL)
    du, dd, dA, dB, dC = ssf.selective_scan_bwd_reference(u, delta, A, B, C, dy, ckpt)
    for got, want in zip((lu.grad, ld.grad, lA.grad, lx.grad, lD.grad),
                         (du + D * dy, dd, dA, torch.cat([dB, dC], -1), (dy * u).sum((0, 1)))):
        _close(got, want, SCAN_GRAD_NORM_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("with_d", [True, False])
def test_scan_ops_pass_opcheck_on_the_card(with_d):
    """``torch.library.opcheck`` of ``mlpt::scan_fwd`` (with the skip and
    without) and ``mlpt::scan_bwd`` on CUDA tensors; each op's outputs are
    its wrapper's bit for bit."""
    _needs_cuda()
    u, delta, A, B, C, dy = _scan_inputs(2, 300, 64, seed=6)
    D = torch.randn(64, device="cuda") if with_d else None
    y, ckpt = ssf.scan_fwd(u, delta, A, B, C, D)
    y_w, ckpt_w = ssf.selective_scan_fwd_cuda(u, delta, A, B, C, D)
    assert torch.equal(y, y_w) and torch.equal(ckpt, ckpt_w)
    for got, want in zip(ssf.scan_bwd(u, delta, A, B, C, dy, ckpt),
                         ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt)):
        assert torch.equal(got, want)
    leaves = [t.clone().requires_grad_() for t in (u, delta)]
    torch.library.opcheck(ssf.scan_fwd, (*leaves, A, B, C, None if D is None else D.clone().requires_grad_()))
    torch.library.opcheck(ssf.scan_bwd, (u, delta, A, B, C, dy, ckpt))


@pytest.mark.cuda
def test_scan_wrappers_refuse_what_the_kernels_do_not_take():
    _needs_cuda()
    # d_state 8 is no longer refused: the wrapper zero-pads it to 16
    u, delta, A, B, C, dy = _scan_inputs(1, 8, 4, N=8)
    y, ckpt = ssf.selective_scan_fwd_cuda(u, delta, A, B, C)
    y_ref, ckpt_ref = ssf.selective_scan_fwd_reference(u, delta, A, B, C)
    _close(y, y_ref, SCAN_Y_NORM_REL)
    assert ckpt.shape == ckpt_ref.shape == (1, 1, 8, 4)
    for got, want in zip(ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt_ref),
                         ssf.selective_scan_bwd_reference(u, delta, A, B, C, dy, ckpt_ref)):
        _close(got, want, SCAN_GRAD_NORM_REL)
    u, delta, A, B, C, _ = _scan_inputs(1, 8, 4)
    with pytest.raises(ValueError, match="one dtype"):
        ssf.selective_scan_fwd_cuda(u, delta.to(torch.bfloat16), A, B, C)


def _check_scan(u, delta, A, B, C, dy, D=None):
    """Both scan kernels against their plain versions (y before the skip to
    SCAN_Y_NORM_REL; y with the skip of D, random if not given, in u's dtype
    to SCAN_Y_NORM_REL in f32 and SCAN_Y_BF16_NORM_REL in bf16; the
    checkpoint and gradients to SCAN_GRAD_NORM_REL of their norms, a
    gradient that is exactly 0 in the plain version exactly 0), and the
    forward (y and the checkpoint) and the backward bit for bit on a second
    run."""
    if D is None:
        D = torch.randn(u.shape[-1], generator=torch.Generator(device="cuda").manual_seed(7), device="cuda")
    y, ckpt = ssf.selective_scan_fwd_cuda(u, delta, A, B, C)
    y_ref, ckpt_ref = ssf.selective_scan_fwd_reference(u, delta, A, B, C)
    _close(y, y_ref, SCAN_Y_NORM_REL)
    assert ckpt.shape == ckpt_ref.shape
    if ckpt.shape[1] > 1:
        _close(ckpt[:, 1:], ckpt_ref[:, 1:], SCAN_GRAD_NORM_REL)
    ys, ckpt_s = ssf.selective_scan_fwd_cuda(u, delta, A, B, C, D)
    ys_ref, _ = ssf.selective_scan_fwd_reference(u, delta, A, B, C, D)
    assert ys.dtype == u.dtype and ys.shape == ys_ref.shape and torch.equal(ckpt_s, ckpt)
    _close(ys, ys_ref, SCAN_Y_BF16_NORM_REL if u.dtype == torch.bfloat16 else SCAN_Y_NORM_REL)
    again = ssf.selective_scan_fwd_cuda(u, delta, A, B, C, D)
    assert torch.equal(again[0], ys) and torch.equal(again[1], ckpt_s)
    grads = ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt_ref)
    for got, want in zip(grads, ssf.selective_scan_bwd_reference(u, delta, A, B, C, dy, ckpt_ref)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        if want.any():
            _close(got, want, SCAN_GRAD_NORM_REL)
        else:  # dA at L = 1: its one term has the zero entry state, on both sides
            assert not got.any()
    for a, b in zip(grads, ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt_ref)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 8, 12, 24, 64])
def test_scan_kernels_at_any_d_state(N):
    """d_state zero-padded to a multiple of 16, one launch per group of 16."""
    _needs_cuda()
    ssf.reset_launch_counts()
    _check_scan(*_scan_inputs(2, 300, 96, N=N, seed=N, dtype=torch.bfloat16))
    groups = -(-N // 16)
    assert (ssf.FWD_LAUNCHES, ssf.BWD_LAUNCHES) == (3 * groups, 2 * groups)


# the backward's tile edges: 8-step groups, 256-step chunks, 80-channel
# tiles, and I not a multiple of 8 (zero-padded by the wrapper)
SCAN_EDGE_L = (1, 7, 8, 9, 15, 16, 17, 255, 256, 257, 4096)
SCAN_EDGE_I = (1, 31, 33, 79, 80, 81, 100, 5120)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", SCAN_EDGE_L)
def test_scan_backward_at_step_edges(L, dtype):
    _needs_cuda()
    _check_scan(*_scan_inputs(2, L, 33, seed=L, dtype=dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("I", SCAN_EDGE_I)
def test_scan_backward_at_channel_edges(I, dtype):
    _needs_cuda()
    _check_scan(*_scan_inputs(2, 257, I, seed=I, dtype=dtype))


# the forward's own edges: its 64-step groups (one and two of them), its ring
# of 3 such stages (192 steps) and two 256-step chunks; its 80-channel tile
# (two of them) +- 1 and I not a multiple of 8
SCAN_FWD_EDGE_L = (63, 64, 65, 127, 128, 129, 191, 192, 193, 511, 512, 513)
SCAN_FWD_EDGE_I = (5, 8, 159, 160, 161, 163)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", SCAN_FWD_EDGE_L)
def test_scan_forward_at_step_edges(L, dtype):
    _needs_cuda()
    _check_scan(*_scan_inputs(2, L, 81, seed=1000 + L, dtype=dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("I", SCAN_FWD_EDGE_I)
def test_scan_forward_at_channel_edges(I, dtype):
    _needs_cuda()
    _check_scan(*_scan_inputs(2, 129, I, seed=1000 + I, dtype=dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernels_take_batches_above_the_grid_limit(dtype):
    """65,536 batch elements, one more than a launch grid's y holds: each
    wrapper call launches twice, and both kernels keep their plain
    versions' values and repeat bit for bit."""
    _needs_cuda()
    ssf.reset_launch_counts()
    _check_scan(*_scan_inputs(65536, 3, 8, seed=65536, dtype=dtype))
    # _check_scan: 3 forward calls (before the skip, with it, once more) and 2 backward calls
    assert (ssf.FWD_LAUNCHES, ssf.BWD_LAUNCHES) == (3 * 2, 2 * 2)


# the backward's skip mode (D given, dy in u's dtype): mamba's micro-batch, L
# off the 8-step groups and the 256-step chunks, I padded to a multiple of 8,
# f32, and a batch above the grid's limit
SCAN_SKIP_CASES = {"mamba": ((8, 4096, 5120), torch.bfloat16), "ragged L": ((2, 1003, 96), torch.bfloat16),
                   "I 100": ((2, 300, 100), torch.bfloat16), "f32": ((2, 1003, 100), torch.float32),
                   "batch 65536": ((65536, 3, 8), torch.bfloat16)}


def _scan_bwd_then_epilogue(u, delta, A, B, C, dy, ckpt, D):
    """The backward as the autograd rule composed it before the kernel took
    D: the f32 mode on an f32 dy, then the skip's terms in PyTorch, dD
    summed over batch and length, and the casts (dD f32)."""
    g32 = dy.float()
    du, ddelta, dA, dB, dC = ssf.selective_scan_bwd_cuda(u, delta, A, B, C, g32, ckpt)
    du = du + D.float() * g32
    dD = (g32 * u.float()).sum((0, 1))
    return du.to(u.dtype), ddelta.to(delta.dtype), dA, dB, dC, dD


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SCAN_SKIP_CASES))
def test_scan_skip_mode_is_the_f32_mode_and_its_epilogue(case):
    """The backward in its skip mode, one launch per batch chunk, against
    the f32 mode followed by the PyTorch epilogue it replaced: du and ddelta
    in u's dtype and dA, dB and dC bit for bit; dD, whose f32 sum runs in
    another order, within ``SCAN_DD_OF_MAX`` of its largest value; a second
    call repeats the first bit for bit, dD included."""
    _needs_cuda()
    shape, dtype = SCAN_SKIP_CASES[case]
    u, delta, A, B, C, dy = _scan_inputs(*shape, seed=sum(shape), dtype=dtype)
    dy = dy.to(dtype)
    D = torch.randn(shape[-1], generator=torch.Generator(device="cuda").manual_seed(9), device="cuda")
    _, ckpt = ssf.selective_scan_fwd_cuda(u, delta, A, B, C)
    ssf.reset_launch_counts()
    got = ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt, D)
    chunks = -(-shape[0] // fa.MAX_GRID_Y)
    assert (ssf.BWD_LAUNCHES, ssf.BWD_SKIP_LAUNCHES) == (chunks, chunks)
    want = _scan_bwd_then_epilogue(u, delta, A, B, C, dy, ckpt, D)
    assert [t.dtype for t in got] == [dtype, dtype] + [torch.float32] * 4
    for name, g, w in zip(("du", "ddelta", "dA", "dB", "dC"), got, want):
        assert g.shape == w.shape and torch.equal(g, w), name
    gap = (got[5] - want[5]).abs().max() / want[5].abs().max()
    assert got[5].shape == D.shape and gap <= SCAN_DD_OF_MAX, gap.item()
    again = ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt, D)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _scan_backward_ops(prof, rows: int, seq: int, width: int) -> list[str]:
    """The PyTorch ops named aten::mul, add, copy_ or sum whose inputs
    include a [rows, seq, width] tensor, launched inside a span
    ``scan.backward`` of ``prof`` (recorded with ``record_shapes``)."""

    def in_span(e):
        while e is not None:
            if e.name == "scan.backward":
                return True
            e = e.cpu_parent
        return False

    names = {"aten::mul", "aten::add", "aten::copy_", "aten::sum"}
    return [e.name for e in prof.events()
            if e.name in names and [rows, seq, width] in e.input_shapes and in_span(e)]


def _skip_mode_micro_batch(model: str) -> tuple[int, int, list[str], int]:
    """One full-size micro-batch of one row of ``model`` under its remat in
    ``bf16_sr``, after a warmup, profiled with shapes: (backward launches,
    of them in the skip mode, the elementwise ops over [1, L, d_inner]
    inside ``scan.backward``, the spans ``scan.backward`` on the host)."""
    from multimodal_llm_pretraining_tpu_torch.models import get_model_class
    from multimodal_llm_pretraining_tpu_torch.profile_step import make_plan

    mc = get_model_class(model)
    sess = make_plan(mc, 1, 1, True, "bf16_sr").build_session(mc, device="cuda")
    state = sess.init_state()
    batch = {k: v[0] for k, v in sess.make_train_batch(seed=0).items()}
    accumulate = sess.accumulate_fn()
    accumulate(state, batch)
    torch.cuda.synchronize()
    ssf.reset_launch_counts()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities, record_shapes=True) as prof:
        loss = accumulate(state, batch)
        torch.cuda.synchronize()
    assert math.isfinite(float(loss))
    mixer = next(m for m in sess.module.modules() if hasattr(m, "d_inner"))
    seq = batch["input_ids"].shape[-1]
    ops = _scan_backward_ops(prof, 1, seq, mixer.d_inner)
    spans = sum(e.name == "scan.backward" and e.device_type == torch.autograd.DeviceType.CPU for e in prof.events())
    launches = (ssf.BWD_LAUNCHES, ssf.BWD_SKIP_LAUNCHES)
    del sess, state, prof
    torch.cuda.empty_cache()
    return (*launches, ops, spans)


@pytest.mark.cuda
@pytest.mark.parametrize("model,mixers", [("mamba", 64), ("jamba2-3b", 26)])
def test_micro_batch_folds_the_skip_into_every_scan_backward(model, mixers):
    """A full-depth micro-batch of mamba-2.8b (64 blocks) and of Jamba2-3B
    (26 Mamba mixers), one row at full sequence: every scan backward
    launches once, in its skip mode, and its span ``scan.backward`` holds no
    PyTorch mul, add, copy or sum over a [1, L, d_inner] tensor."""
    _needs_cuda()
    bwd, skip, ops, spans = _skip_mode_micro_batch(model)
    assert (bwd, skip, spans) == (mixers, mixers, mixers)
    assert not ops, ops


# ---------------------------------------------------------------- the custom ops on the card

# pythia-1b's attention ([4, 8, 2049, 256] causal) and the llava decoder's
# in varlen mode (2 of its 16 rows, 32 heads of 64, 1087 merged positions)
OP_SHAPES = {"plain": (32, 2049, 256, None), "varlen": (64, 1087, 64, [1087, 700])}


def _op_inputs(mode: str):
    bh, seq, d, lens = OP_SHAPES[mode]
    q, k, v, do = (_rand(bh, seq, d, seed=i) for i in range(4))
    kv_lens = None if lens is None else _lens(lens, bh // len(lens))
    return q, k, v, do, kv_lens, d**-0.5


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "varlen"])
def test_custom_ops_launch_the_kernels_and_match_plain_versions(mode):
    """``mlpt::flash_fwd``, ``mlpt::flash_bwd`` and ``mlpt::flash_bwd_split``
    on CUDA tensors: each launches its kernels once (the split op a dq and
    a dk/dv launch) and keeps the tolerances above against its plain
    version; the forward op's outputs are the wrapper's bit for bit, and
    the split op's too (it has no atomics)."""
    _needs_cuda()
    q, k, v, do, kv_lens, scale = _op_inputs(mode)
    varlen = kv_lens is not None
    fa.reset_launch_counts()
    out, lse = fa.flash_fwd(q, k, v, True, scale, kv_lens)
    out_ref, lse_ref = fa.flash_fwd_reference(q, k, v, True, scale, kv_lens)
    _close(out, out_ref)
    torch.testing.assert_close(lse, lse_ref, atol=LSE_ABS, rtol=0)
    out_w, lse_w = fa.flash_fwd_cuda(q, k, v, True, scale, kv_lens)
    assert torch.equal(out, out_w) and torch.equal(lse, lse_w)
    want = fa.flash_bwd_reference(q, k, v, out_ref, lse_ref, do, True, scale, kv_lens)
    for op in (fa.flash_bwd, fa.flash_bwd_split):
        for got, ref in zip(op(q, k, v, out_ref, lse_ref, do, True, scale, kv_lens), want):
            assert got.dtype == q.dtype
            _close(got, ref)
    split = fa.flash_bwd_split(q, k, v, out_ref, lse_ref, do, True, scale, kv_lens)
    for got, ref in zip(split, fa.flash_bwd_split_cuda(q, k, v, out_ref, lse_ref, do, True, scale, kv_lens)):
        assert torch.equal(got, ref)
    launches = (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    if varlen:
        launches = (fa.VARLEN_FWD_LAUNCHES, fa.VARLEN_BWD_LAUNCHES, fa.VARLEN_DQ_LAUNCHES, fa.VARLEN_DKV_LAUNCHES)
    assert launches == (2, 1, 3, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "varlen"])
@pytest.mark.parametrize("op", ["flash_fwd", "flash_bwd", "flash_bwd_split"])
def test_opcheck_on_the_card(op, mode):
    """``torch.library.opcheck`` (schema, autograd registration, fake
    implementation, AOT dispatch) of each op on CUDA tensors, at head dims
    the kernels take without padding."""
    _needs_cuda()
    q, k, v, do, kv_lens, scale = _op_inputs(mode)
    q, k, v, do = (t[:8, :300].contiguous() for t in (q, k, v, do))
    kv_lens = None if kv_lens is None else kv_lens[:8].clamp(max=300)
    if op == "flash_fwd":
        args = (q.requires_grad_(), k.requires_grad_(), v.requires_grad_(), True, scale, kv_lens)
    else:
        out, lse = fa.flash_fwd_cuda(q, k, v, True, scale, kv_lens)
        args = (q, k, v, out, lse, do, True, scale, kv_lens)
    torch.library.opcheck(getattr(fa, op), args)


# ---------------------------------------------------------------- LM-head loss

# The xent kernels against their plain versions, all f32 inside: lse within
# XENT_LSE_ABS (the kernel's exp2 of (x - max) * log2(e) and its online max,
# against one max and exp, over up to 128k terms summed in another order);
# each row's nll within XENT_LSE_ABS too; dlogits within
# 1e-5 of their norm in f32, and in bf16, where both sides round f32 values
# that may lie one bf16 ulp apart, within one bf16 rounding (4e-3).
XENT_LSE_ABS = 1e-4
XENT_D_NORM_REL = {torch.float32: 1e-5, torch.bfloat16: 4e-3}
# The loss on the kernels against the pre-change autograd path
# (``xent_autograd_yardstick``), which takes its logits from the same
# products: the loss within 1e-5; the gradients within 1e-5 of their norm in
# f32, and in bf16 within 2e-3, dlogits being rounded to bf16 from f32 values
# that differ by the lse's error, so that a few land one ulp apart before the
# same products.
XENT_LOSS_REL = 1e-5
XENT_GRAD_NORM_REL = {torch.float32: 1e-5, torch.bfloat16: 2e-3}


def _xent_inputs(rows: int, vocab: int, width: int, seed: int = 0):
    """f32 logits [rows, width] about N(0, 9), NaN past ``vocab`` and on
    every 7th row, which is ignored (-100): a kernel that read either would
    show NaN."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn(rows, width, generator=g, device="cuda") * 3
    labels = torch.randint(0, vocab, (rows,), generator=g, device="cuda")
    labels[::7] = -100
    logits[:, vocab:] = float("nan")
    logits[labels == -100] = float("nan")
    return logits, labels


def _check_xent_kernels(rows: int, vocab: int, width: int, dtype: torch.dtype) -> None:
    from multimodal_llm_pretraining_tpu_torch.ops import xent

    logits, labels = _xent_inputs(rows, vocab, width)
    valid = labels != -100
    lse_ref, nll_ref = xent.xent_fwd_reference(logits, labels, vocab, -100)
    runs = []
    for _ in range(2):
        lse, nll = torch.empty(rows, device="cuda"), torch.empty(rows, device="cuda")
        xent.xent_fwd_cuda(logits, labels, vocab, -100, lse, nll)
        runs.append((lse, nll))
    (lse, nll), (lse2, nll2) = runs
    torch.testing.assert_close(lse, lse_ref, atol=XENT_LSE_ABS, rtol=0)
    torch.testing.assert_close(nll, nll_ref, atol=XENT_LSE_ABS, rtol=0)
    assert (lse[~valid] == 0).all() and (nll[~valid] == 0).all()
    assert torch.equal(lse, lse2) and torch.equal(nll, nll2)
    scale = torch.tensor(1.0 / max(int(valid.sum()), 1), device="cuda")
    want = xent.xent_bwd_reference(logits, labels, lse_ref, scale, vocab, -100, dtype)
    got = xent.xent_bwd_cuda(logits, labels, lse_ref, scale, vocab, -100, dtype)
    assert got.dtype == dtype and got.shape == logits.shape
    assert (got[~valid] == 0).all() and (got[:, vocab:] == 0).all()
    if want.float().norm() > 0:
        _close(got, want, XENT_D_NORM_REL[dtype])
    else:  # all rows ignored, or vocab 1: p is exactly 1 on both sides
        assert torch.equal(got, want)
    assert torch.equal(got, xent.xent_bwd_cuda(logits, labels, lse_ref, scale, vocab, -100, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("vocab,width", [(50304, 50304), (128257, 128264)])
def test_xent_kernels_match_plain_versions(vocab, width, dtype):
    """Both kernels at pythia's chunk (1024 rows of 50,304) and llava's (1024
    rows of 128,257 padded to 128,264), each seventh row ignored: lse, each
    row's nll and dlogits against the plain versions; a second forward
    repeats the first bit for bit, a second backward too; ignored rows and
    the padded columns come out 0 without being read."""
    _needs_cuda()
    _check_xent_kernels(1024, vocab, width, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("vocab", [1, 3, 4, 5, 1023, 1024, 1025, 4096, 4097, 4100, 30522])
@pytest.mark.parametrize("rows", [1, 33])
def test_xent_kernels_at_their_edges(rows, vocab, dtype):
    """Vocabs around the kernels' 4-column loads and their 4096-column
    strides (256 threads x 4 loads x 4 columns), padded to a multiple of 8
    as the loss pads them, one row or a few (row 0 is ignored)."""
    _needs_cuda()
    _check_xent_kernels(rows, vocab, vocab + (-vocab % 8), dtype)


@pytest.mark.cuda
def test_xent_forward_gives_nan_for_a_label_out_of_range():
    from multimodal_llm_pretraining_tpu_torch.ops import xent

    _needs_cuda()
    logits, labels = _xent_inputs(4, 50, 56)
    labels[1] = 50
    lse, nll = torch.empty(4, device="cuda"), torch.empty(4, device="cuda")
    xent.xent_fwd_cuda(logits, labels, 50, -100, lse, nll)
    assert torch.isnan(nll[1]) and torch.isfinite(nll[2:]).all()
    with pytest.raises(ValueError, match="multiple of 4"):
        xent.xent_fwd_cuda(logits[:, :50].contiguous(), labels, 50, -100, lse, nll)


@pytest.mark.cuda
@pytest.mark.parametrize("tokens,hidden,vocab,dtype,frozen", [
    (4096, 2048, 50304, torch.bfloat16, False),  # pythia-1b's head, four chunks
    (2085, 2048, 128257, torch.bfloat16, True),  # llava's frozen tied head, odd vocab, a short last chunk
    (1500, 768, 30522, torch.float32, False),  # ViLT's f32 MLM head, odd vocab
])
def test_xent_loss_matches_the_pre_change_path(tokens, hidden, vocab, dtype, frozen):
    """``chunked_lm_cross_entropy`` on the kernels against the autograd path
    it replaced (``xent_autograd_yardstick``, the same products): the loss
    and the gradients of hidden and, where it trains, the head; one launch
    of each kernel a chunk."""
    from multimodal_llm_pretraining_tpu_torch.ops import xent

    _needs_cuda()
    g = torch.Generator(device="cuda").manual_seed(1)
    h = torch.randn(tokens, hidden, generator=g, device="cuda").to(dtype)
    w = (torch.randn(hidden, vocab, generator=g, device="cuda") * hidden**-0.5).to(dtype)
    labels = torch.randint(0, vocab, (tokens,), generator=g, device="cuda")
    labels[::5] = -100
    labels[:1024][200:700] = -100
    results = []
    for loss_fn in (xent.chunked_lm_cross_entropy, xent.xent_autograd_yardstick):
        hh, ww = h.clone().requires_grad_(), w.clone().requires_grad_(not frozen)
        xent.reset_launch_counts()
        loss = loss_fn(hh, ww, labels)
        loss.backward()
        results.append((loss.detach(), hh.grad, ww.grad, (xent.XENT_FWD_LAUNCHES, xent.XENT_BWD_LAUNCHES)))
    (loss, dh, dw, launches), (loss_ref, dh_ref, dw_ref, launches_ref) = results
    chunks = -(-tokens // 1024)
    assert launches == (chunks, chunks) and launches_ref == (0, 0)
    torch.testing.assert_close(loss, loss_ref, rtol=XENT_LOSS_REL, atol=0)
    assert dh.dtype == dtype
    _close(dh, dh_ref, XENT_GRAD_NORM_REL[dtype])
    if frozen:
        assert dw is None and dw_ref is None
    else:
        assert dw.dtype == dtype
        _close(dw, dw_ref, XENT_GRAD_NORM_REL[dtype])


@pytest.mark.cuda
def test_pythia_micro_batch_runs_its_loss_on_the_xent_kernels():
    """One pythia-1b micro-batch at the benchmark's 16 rows of 2049 tokens
    (no remat, ``bf16_sr``): its 32,768 shifted tokens are 32 chunks, each
    one launch of each kernel."""
    from multimodal_llm_pretraining_tpu_torch.models import get_model_class
    from multimodal_llm_pretraining_tpu_torch.ops import xent
    from multimodal_llm_pretraining_tpu_torch.profile_step import make_plan

    _needs_cuda()
    mc = get_model_class("pythia-1b")
    sess = make_plan(mc, 16, 1, False, "bf16_sr").build_session(mc, device="cuda")
    state = sess.init_state()
    batch = {k: v[0] for k, v in sess.make_train_batch(seed=0).items()}
    xent.reset_launch_counts()
    loss = sess.accumulate_fn()(state, batch)
    torch.cuda.synchronize()
    assert (xent.XENT_FWD_LAUNCHES, xent.XENT_BWD_LAUNCHES) == (32, 32)
    assert 10.0 < float(loss) < 12.0
    del sess, state
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- RMSNorm

# The norm kernels against their plain versions, both computing in f32 and
# differing in summation order (a row's mean square and the backward's dot,
# the scale's gradient over rows) and in the kernel's rsqrtf (2 ulps): rstd
# within 1e-5 relative; dx in f32 and the scale's f32 gradient within 1e-5 of
# their norm; y and dx in bf16 within one bf16 rounding (4e-3 of the norm),
# the two sides rounding f32 values that may lie an ulp apart. Neither
# kernel has atomics, so a second run repeats the first bit for bit.
RMSNORM_F32_NORM_REL = 1e-5
RMSNORM_BF16_NORM_REL = 4e-3
RMSNORM_RSTD_REL = 1e-5
RMSNORM_EPS = 1e-5


def _rmsnorm_tol(dtype: torch.dtype) -> float:
    return RMSNORM_BF16_NORM_REL if dtype == torch.bfloat16 else RMSNORM_F32_NORM_REL


def _rmsnorm_inputs(rows: int, cols: int, x_dtype: torch.dtype, dy_dtype: torch.dtype, seed: int = 0,
                    device: str = "cuda"):
    """x about N(0.5, 9), the scale in [0.5, 1.5), dy and the residual's
    gradient N(0, 1)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(rows, cols, generator=g, device=device) * 3 + 0.5).to(x_dtype)
    w = torch.rand(cols, generator=g, device=device) + 0.5
    dy = torch.randn(rows, cols, generator=g, device=device).to(dy_dtype)
    dres = torch.randn(rows, cols, generator=g, device=device).to(x_dtype)
    return x, w, dy, dres


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols,x_dtype,y_dtype,residual", [
    (32768, 2560, torch.float32, torch.bfloat16, True),  # mamba-2.8b's micro-batch: a block's norm on the f32 stream
    (32768, 2560, torch.float32, torch.bfloat16, False),  # its final norm
    (17392, 2048, torch.bfloat16, torch.bfloat16, False),  # llava-pretrain's decoder (Llama-3.2-1B) at 16 x 1087
    (1, 4, torch.float32, torch.float32, True),  # one group of four
    (3, 100, torch.bfloat16, torch.float32, True),  # 25 groups: one warp, 7 lanes idle
    (5, 1028, torch.float32, torch.bfloat16, True),  # 257 groups: two a thread, a ragged last warp
    (7, 4100, torch.bfloat16, torch.bfloat16, True),  # 1025 groups: eight a thread
    (2, 8192, torch.float32, torch.bfloat16, True),  # the widest row, 256 threads of eight groups
    (1000, 64, torch.bfloat16, torch.bfloat16, False),  # more rows than the backward's grid
])
def test_rmsnorm_kernels_match_plain_versions(rows, cols, x_dtype, y_dtype, residual):
    from multimodal_llm_pretraining_tpu_torch.ops import rmsnorm

    _needs_cuda()
    x, w, dy, dres = _rmsnorm_inputs(rows, cols, x_dtype, y_dtype)
    dres = dres if residual else None
    y_ref, rstd_ref = rmsnorm.rmsnorm_fwd_reference(x, w, RMSNORM_EPS, y_dtype)
    dx_ref, dw_ref = rmsnorm.rmsnorm_bwd_reference(dy, x, rstd_ref, w, dres)
    runs = []
    for _ in range(2):
        y, rstd = rmsnorm.rmsnorm_fwd_cuda(x, w, RMSNORM_EPS, y_dtype)
        dx, dw = rmsnorm.rmsnorm_bwd_cuda(dy, x, rstd_ref, w, dres)
        runs.append((y, rstd, dx, dw))
    y, rstd, dx, dw = runs[0]
    assert (y.dtype, rstd.dtype, dx.dtype, dw.dtype) == (y_dtype, torch.float32, x_dtype, torch.float32)
    torch.testing.assert_close(rstd, rstd_ref, rtol=RMSNORM_RSTD_REL, atol=0)
    _close(y, y_ref, _rmsnorm_tol(y_dtype))
    _close(dx, dx_ref, _rmsnorm_tol(x_dtype))
    _close(dw, dw_ref, RMSNORM_F32_NORM_REL)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    dx_frozen, dw_frozen = rmsnorm.rmsnorm_bwd_cuda(dy, x, rstd_ref, w, dres, need_dw=False)
    assert dw_frozen is None and torch.equal(dx_frozen, dx)


@pytest.mark.cuda
def test_rmsnorm_kernels_refuse_what_they_do_not_take():
    """Rows the kernels do not take raise, in the launch wrapper and in
    ``layers.RMSNorm`` on the card, which has no plain fallback there."""
    from multimodal_llm_pretraining_tpu_torch.models import layers
    from multimodal_llm_pretraining_tpu_torch.ops import rmsnorm

    _needs_cuda()
    for x in (torch.ones(2, 6, device="cuda"), torch.ones(2, 8196, device="cuda"),
              torch.ones(2, 8, device="cuda", dtype=torch.float16)):
        assert not rmsnorm.kernel_takes(x)
        with pytest.raises(ValueError, match="rmsnorm kernels take"):
            rmsnorm.rmsnorm_fwd_cuda(x, torch.ones(x.shape[-1], device="cuda"), RMSNORM_EPS, torch.bfloat16)
        norm = layers.RMSNorm(x.shape[-1], dtype=torch.bfloat16).cuda()
        with pytest.raises(ValueError, match="rmsnorm kernels take"):
            norm(x.clone().requires_grad_(), residual=True)


@pytest.mark.cuda
def test_rmsnorm_module_runs_on_the_kernels():
    """``layers.RMSNorm`` on the card at mamba's width: one forward and one
    backward launch, the residual's gradient joining the norm's in the
    backward; the output and the gradients are the plain math's."""
    from multimodal_llm_pretraining_tpu_torch.models import layers
    from multimodal_llm_pretraining_tpu_torch.ops import rmsnorm

    _needs_cuda()
    x, w, dy, dres = _rmsnorm_inputs(64, 2560, torch.float32, torch.bfloat16, seed=3)
    norm = layers.RMSNorm(2560, dtype=torch.bfloat16).cuda()
    with torch.no_grad():
        norm.weight.copy_(w)
    xk = x.clone().requires_grad_()
    rmsnorm.reset_launch_counts()
    y, passed = norm(xk, residual=True)
    ((y.float() * dy.float()).sum() + (passed * dres).sum()).backward()
    assert (rmsnorm.RMSNORM_FWD_LAUNCHES, rmsnorm.RMSNORM_BWD_LAUNCHES) == (1, 1)
    assert passed.dtype == torch.float32 and passed.data_ptr() == xk.data_ptr()
    y_ref, rstd = rmsnorm.rmsnorm_fwd_reference(x, w, RMSNORM_EPS, torch.bfloat16)
    dx_ref, dw_ref = rmsnorm.rmsnorm_bwd_reference(dy, x, rstd, w, dres)
    _close(y, y_ref, RMSNORM_BF16_NORM_REL)
    _close(xk.grad, dx_ref, RMSNORM_F32_NORM_REL)
    _close(norm.weight.grad, dw_ref, RMSNORM_F32_NORM_REL)


@pytest.mark.cuda
def test_mamba_micro_batch_runs_its_norms_on_the_kernels(monkeypatch):
    """A mamba micro-batch at full width and sequence, narrowed to 4 blocks,
    under block remat in ``bf16_sr``: each block's norm forward twice (the
    replay runs it again) and backward once, plus the final norm's, all on
    the kernels (2 x 4 + 1 forward, 4 + 1 backward); the residual stream
    between blocks is f32."""
    from multimodal_llm_pretraining_tpu_torch.models import get_model_class
    from multimodal_llm_pretraining_tpu_torch.models import mamba as tmamba
    from multimodal_llm_pretraining_tpu_torch.ops import rmsnorm
    from multimodal_llm_pretraining_tpu_torch.profile_step import make_plan

    _needs_cuda()
    monkeypatch.setattr(tmamba, "N_LAYER", 4)
    mc = get_model_class("mamba")
    sess = make_plan(mc, 2, 1, True, "bf16_sr").build_session(mc, device="cuda")
    state = sess.init_state()
    streams = []
    for block in sess.module.layers:
        block.register_forward_hook(lambda mod, args, out: streams.append((args[0].dtype, out.dtype)))
    batch = {k: v[0] for k, v in sess.make_train_batch(seed=0).items()}
    rmsnorm.reset_launch_counts()
    loss = sess.accumulate_fn()(state, batch)
    torch.cuda.synchronize()
    assert (rmsnorm.RMSNORM_FWD_LAUNCHES, rmsnorm.RMSNORM_BWD_LAUNCHES) == (9, 5)
    # one record a block: the replay stops once it has recomputed what the backward reads
    assert streams == [(torch.float32, torch.float32)] * 4
    assert 10.0 < float(loss) < 12.0
    del sess, state
    torch.cuda.empty_cache()


@pytest.mark.parametrize("x_dtype,dtype", [(torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16),
                                           (torch.float32, torch.float32)])
@pytest.mark.parametrize("residual", [False, True])
def test_rmsnorm_plain_path_equals_layers_rmsnorm(x_dtype, dtype, residual):
    """On the CPU ``ops/rmsnorm.py``'s autograd Function on the plain versions
    gives ``layers.RMSNorm``'s plain math: the output bit for bit (the same
    ops), the passed-through x as the input itself, and the gradients of x
    and of the scale to f32 summation order (the backward's closed form
    against autograd's chain). A bf16 x's gradient with the residual's added
    may land one bf16 ulp apart: the Function adds in f32 and rounds once,
    autograd rounds the norm's gradient and then sums in bf16: one ulp of
    the largest entry, since the sum may cancel to near 0."""
    from multimodal_llm_pretraining_tpu_torch.models import layers
    from multimodal_llm_pretraining_tpu_torch.ops import rmsnorm

    x, w, dy, dres = _rmsnorm_inputs(6, 64, x_dtype, dtype, seed=5, device="cpu")
    x = x.reshape(2, 3, 64)
    dy, dres = dy.reshape(2, 3, 64), dres.reshape(2, 3, 64)
    norm = layers.RMSNorm(64, dtype=dtype)
    with torch.no_grad():
        norm.weight.copy_(w)
    outs = []
    for fn, weight in ((norm, norm.weight), (None, w.clone().requires_grad_())):
        xx = x.clone().requires_grad_()
        out = fn(xx, residual=residual) if fn else rmsnorm.rmsnorm(xx, weight, RMSNORM_EPS, dtype, residual)
        y, passed = out if residual else (out, None)
        loss = (y.float() * dy.float()).sum() + ((passed.float() * dres.float()).sum() if residual else 0.0)
        loss.backward()
        outs.append((y, passed, xx, xx.grad, weight.grad))
    (y, passed, xx, dx, dw), (y2, passed2, xx2, dx2, dw2) = outs
    assert y2.dtype == dtype and torch.equal(y, y2)
    if residual:
        assert passed2.data_ptr() == xx2.data_ptr() and torch.equal(passed, passed2)
    ulp = 2.0**-7 if x_dtype == torch.bfloat16 else 1e-6
    torch.testing.assert_close(dx2, dx, rtol=ulp, atol=max(1e-6, ulp * float(dx.float().abs().max())))
    torch.testing.assert_close(dw2, dw, rtol=1e-6, atol=1e-5)


def test_rmsnorm_frozen_scale_takes_no_gradient():
    """A scale that does not train (llava's frozen decoder) gets no
    gradient, and the backward computes none; x's is the same."""
    from multimodal_llm_pretraining_tpu_torch.ops import rmsnorm

    x, w, dy, _ = _rmsnorm_inputs(4, 64, torch.float32, torch.bfloat16, seed=6, device="cpu")
    grads = []
    for trains in (True, False):
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_(trains)
        (rmsnorm.rmsnorm(xx, ww, RMSNORM_EPS, torch.bfloat16).float() * dy.float()).sum().backward()
        grads.append((xx.grad, ww.grad))
    assert grads[0][1] is not None and grads[1][1] is None and torch.equal(grads[0][0], grads[1][0])


def test_rmsnorm_kernels_take_no_cpu_tensor():
    """``kernel_takes`` is False for a CPU tensor, which ``layers.RMSNorm``
    computes with its plain math; the launch wrappers refuse one."""
    from multimodal_llm_pretraining_tpu_torch.ops import rmsnorm

    x = torch.ones(2, 8)
    assert not rmsnorm.kernel_takes(x)
    with pytest.raises(ValueError, match="rmsnorm kernels take"):
        rmsnorm.rmsnorm_fwd_cuda(x, torch.ones(8), RMSNORM_EPS, torch.bfloat16)
    with pytest.raises(ValueError, match="rmsnorm kernels take"):
        rmsnorm.rmsnorm_bwd_cuda(x, x, torch.ones(2), torch.ones(8))


# ---------------------------------------------------------------- causal conv

# (B, L, I, K, x dtype, parameter dtype, x a strided half of [B, L, 2I])
CONV_CASES = [
    (8, 4096, 5120, 4, torch.bfloat16, torch.bfloat16, True),  # mamba-2.8b's micro-batch under bf16_sr, as the block hands it
    (8, 4096, 5120, 4, torch.bfloat16, torch.float32, True),  # the same with f32 parameters
    (2, 300, 100, 4, torch.bfloat16, torch.bfloat16, True),  # I not a multiple of 8 (element loads), L no tile's multiple
    (3, 2, 24, 4, torch.float32, torch.float32, False),  # L < K
    (1, 257, 136, 3, torch.float32, torch.bfloat16, True),  # f32 x, K 3, one step past a forward block's 256
    (2, 1025, 64, 2, torch.bfloat16, torch.float32, False),  # K 2, one step past a backward block's 1024
    (3, 129, 40, 4, torch.bfloat16, torch.bfloat16, True),  # one step past a backward slice, 40 channels: a part warp
    (1, 33, 8, 1, torch.bfloat16, torch.bfloat16, True),  # K 1: no halo
    (2, 300, 100, 3, torch.bfloat16, torch.bfloat16, True),  # K 3 with element loads
]


def _conv_inputs(B, L, I, K, x_dtype, p_dtype, strided, device="cuda", seed=0):
    """x and dout N(0, 1), the taps and bias uniform in [-0.5, 0.5) (mamba's
    initialisation at d_conv 4); x the first half of a [B, L, 2I] tensor
    where ``strided``, as ``in_proj``'s output is split."""
    g = torch.Generator(device=device).manual_seed(seed)
    base = torch.randn(B, L, 2 * I if strided else I, generator=g, device=device).to(x_dtype)
    x = base[..., :I]
    w = (torch.rand(K, I, generator=g, device=device) - 0.5).to(p_dtype)
    b = (torch.rand(I, generator=g, device=device) - 0.5).to(p_dtype)
    dout = torch.randn(B, L, I, generator=g, device=device).to(x_dtype)
    return x, w, b, dout


def _within_one_rounding(got, want):
    """Elementwise within one rounding of ``want``'s dtype (2^-7 of the value
    in bf16, 1e-5 in f32: both sides compute in f32 in another order, with
    the kernels' fast exp), plus 1e-5 of the largest entry for sums that
    cancel to near 0."""
    assert got.dtype == want.dtype and got.shape == want.shape and torch.isfinite(got).all()
    rel = 2.0**-7 if want.dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=rel, atol=1e-5 * float(want.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,I,K,x_dtype,p_dtype,strided", CONV_CASES)
def test_causal_conv_kernels_match_plain_versions(B, L, I, K, x_dtype, p_dtype, strided):
    """Both conv kernels against their plain versions (PyTorch's native
    depthwise conv in f32, cuDNN off): out and dx within one rounding of x's
    dtype, dw and db (f32 sums over B x L terms in another order) within
    1e-5 of their norm in f32 and one bf16 rounding (4e-3) in bf16; a second
    run repeats the first bit for bit."""
    from multimodal_llm_pretraining_tpu_torch.ops import causal_conv as cc

    _needs_cuda()
    x, w, b, dout = _conv_inputs(B, L, I, K, x_dtype, p_dtype, strided)
    with torch.backends.cudnn.flags(enabled=False):
        out_ref = cc.causal_conv_fwd_reference(x, w, b)
        dx_ref, dw_ref, db_ref = cc.causal_conv_bwd_reference(x, w, b, dout)
    runs = [(cc.causal_conv_fwd_cuda(x, w, b), *cc.causal_conv_bwd_cuda(x, w, b, dout)) for _ in range(2)]
    out, dx, dw, db = runs[0]
    assert out.is_contiguous() and dx.is_contiguous()
    assert (dw.dtype, db.dtype) == (p_dtype, p_dtype)
    _within_one_rounding(out, out_ref)
    _within_one_rounding(dx, dx_ref)
    f32_tol = 1e-5 if p_dtype == torch.float32 else 4e-3  # bf16 parameters: dw and db rounded once to bf16
    _close(dw, dw_ref, f32_tol)
    _close(db, db_ref, f32_tol)
    assert all(torch.equal(a, c) for a, c in zip(*runs))


@pytest.mark.cuda
def test_causal_conv_ops_pass_opcheck_on_the_card():
    """``torch.library.opcheck`` of ``mlpt::causal_conv_fwd`` (with its
    autograd rule, on a strided half) and ``mlpt::causal_conv_bwd``."""
    from multimodal_llm_pretraining_tpu_torch.ops import causal_conv as cc

    _needs_cuda()
    x, w, b, dout = _conv_inputs(2, 70, 48, 4, torch.bfloat16, torch.float32, True)
    torch.library.opcheck(cc.causal_conv_fwd, (x.detach().requires_grad_(), w.requires_grad_(), b.requires_grad_()))
    torch.library.opcheck(cc.causal_conv_bwd, (x, w.detach(), b.detach(), dout))


@pytest.mark.cuda
def test_causal_conv_kernels_refuse_what_they_do_not_take():
    """K past 4, fp16, taps of another width, or a CPU tensor raise: there
    is no plain fallback on the card."""
    from multimodal_llm_pretraining_tpu_torch.ops import causal_conv as cc

    _needs_cuda()
    x, w, b, _ = _conv_inputs(1, 16, 32, 4, torch.bfloat16, torch.bfloat16, False)
    for args in ((x, torch.zeros(5, 32, device="cuda", dtype=torch.bfloat16), b), (x.half(), w, b),
                 (x, w[:, :16], b), (x.cpu(), w.cpu(), b.cpu())):
        with pytest.raises(ValueError, match="causal-conv kernels take"):
            cc.causal_conv_fwd_cuda(*args)


@pytest.mark.cuda
def test_mamba_micro_batch_runs_its_conv_on_the_kernels(monkeypatch):
    """A mamba micro-batch at full width and sequence, narrowed to 4 blocks,
    under block remat in ``bf16_sr``: each block's conv forward twice (the
    replay runs it again) and backward once, all on the kernels (8 and 4
    launches), and no PyTorch depthwise conv kernel in its trace."""
    from multimodal_llm_pretraining_tpu_torch.models import get_model_class
    from multimodal_llm_pretraining_tpu_torch.models import mamba as tmamba
    from multimodal_llm_pretraining_tpu_torch.ops import causal_conv as cc
    from multimodal_llm_pretraining_tpu_torch.profile_step import make_plan

    _needs_cuda()
    monkeypatch.setattr(tmamba, "N_LAYER", 4)
    mc = get_model_class("mamba")
    sess = make_plan(mc, 2, 1, True, "bf16_sr").build_session(mc, device="cuda")
    state = sess.init_state()
    batch = {k: v[0] for k, v in sess.make_train_batch(seed=0).items()}
    accumulate = sess.accumulate_fn()
    accumulate(state, batch)
    torch.cuda.synchronize()
    cc.reset_launch_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        loss = accumulate(state, batch)
        torch.cuda.synchronize()
    assert (cc.CONV_FWD_LAUNCHES, cc.CONV_BWD_LAUNCHES) == (8, 4)
    kernels = [e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("causal_conv_fwd_kernel" in k for k in kernels) and sum("causal_conv_bwd_kernel" in k for k in kernels)
    assert not [k for k in kernels if "conv_depthwise" in k], kernels
    assert 10.0 < float(loss) < 12.0
    del sess, state
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- gate

# (B, L, I, dtype, z a strided half of [B, L, 2I], view offset in elements)
GATE_CASES = [
    (8, 4096, 5120, torch.bfloat16, True, 0),  # mamba-2.8b's micro-batch, as the block hands it over
    (2, 300, 100, torch.bfloat16, True, 0),  # I = 100 not a multiple of 8: element loads and stores
    (3, 1, 64, torch.bfloat16, True, 0),  # L = 1
    (2, 77, 64, torch.bfloat16, False, 3),  # y and z views 3 elements into their storage: unaligned
    (2, 129, 96, torch.float32, True, 0),  # f32: 4 channels a piece
    (2, 550_000, 8, torch.bfloat16, True, 0),  # 1.1 M rows: more row tiles than the grid's 65,535
]


def _gate_inputs(B, L, I, dtype, strided, offset, seed=0):
    """y, z and dout N(0, 2^2) (both SiLU tails); z the second half of a [B,
    L, 2I] tensor where ``strided``; y and z ``offset`` elements into their
    storage."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    y = (torch.randn(B * L * I + offset, generator=g, device="cuda") * 2).to(dtype)[offset:].view(B, L, I)
    width = 2 * I if strided else I
    base = (torch.randn(B * L * width + offset, generator=g, device="cuda") * 2).to(dtype)[offset:].view(B, L, width)
    dout = (torch.randn(B, L, I, generator=g, device="cuda") * 2).to(dtype)
    return y, base[..., width - I:], dout


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,I,dtype,strided,offset", GATE_CASES)
def test_gate_kernels_match_plain_versions(B, L, I, dtype, strided, offset):
    """Both gate kernels against their plain versions (PyTorch's f32 SiLU
    and its backward): out, dy and dz within one rounding of their dtype, in
    their dtypes and contiguous; a second launch repeats the first bit for
    bit."""
    from multimodal_llm_pretraining_tpu_torch.ops import gate

    _needs_cuda()
    y, z, dout = _gate_inputs(B, L, I, dtype, strided, offset)
    out_ref = gate.gate_silu_fwd_reference(y, z)
    dy_ref, dz_ref = gate.gate_silu_bwd_reference(y, z, dout)
    runs = [(gate.gate_silu_fwd_cuda(y, z), *gate.gate_silu_bwd_cuda(y, z, dout)) for _ in range(2)]
    for got, want in zip(runs[0], (out_ref, dy_ref, dz_ref)):
        assert got.is_contiguous()
        _within_one_rounding(got, want)
    assert all(torch.equal(a, c) for a, c in zip(*runs))


@pytest.mark.cuda
def test_gate_ops_pass_opcheck_on_the_card():
    """``torch.library.opcheck`` of ``mlpt::gate_silu_fwd`` (with its
    autograd rule, z a strided half) and ``mlpt::gate_silu_bwd``."""
    from multimodal_llm_pretraining_tpu_torch.ops import gate

    _needs_cuda()
    y, z, dout = _gate_inputs(2, 70, 48, torch.bfloat16, True, 0)
    torch.library.opcheck(gate.gate_silu_fwd, (y.clone().requires_grad_(), z.detach().requires_grad_()))
    torch.library.opcheck(gate.gate_silu_bwd, (y, z, dout))


@pytest.mark.cuda
def test_gate_kernels_refuse_what_they_do_not_take():
    """fp16, two dtypes, two shapes, a 2-d tensor, a CPU tensor or a dout
    of another shape raise: there is no plain fallback on the card."""
    from multimodal_llm_pretraining_tpu_torch.ops import gate

    _needs_cuda()
    y, z, dout = _gate_inputs(1, 16, 32, torch.bfloat16, True, 0)
    for args in ((y.half(), z.half()), (y, z.float()), (y, z[:, :8]), (y[0], z[0]), (y.cpu(), z.cpu())):
        with pytest.raises(ValueError, match="gate kernels take"):
            gate.gate_silu_fwd_cuda(*args)
    with pytest.raises(ValueError, match="dout must be"):
        gate.gate_silu_bwd_cuda(y, z, dout[:, :8])


@pytest.mark.cuda
def test_mamba_micro_batch_runs_its_gate_on_the_kernels(monkeypatch):
    """A mamba micro-batch at full width, depth and sequence under block
    remat in ``bf16_sr``: each block's gate forward twice (the replay runs
    it again) and backward once, all on the kernels (128 and 64 launches),
    and no PyTorch SiLU kernel in its trace."""
    from multimodal_llm_pretraining_tpu_torch.models import get_model_class
    from multimodal_llm_pretraining_tpu_torch.ops import gate
    from multimodal_llm_pretraining_tpu_torch.profile_step import make_plan

    _needs_cuda()
    mc = get_model_class("mamba")
    sess = make_plan(mc, 1, 1, True, "bf16_sr").build_session(mc, device="cuda")
    state = sess.init_state()
    batch = {k: v[0] for k, v in sess.make_train_batch(seed=0).items()}
    accumulate = sess.accumulate_fn()
    accumulate(state, batch)
    torch.cuda.synchronize()
    gate.reset_launch_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        loss = accumulate(state, batch)
        torch.cuda.synchronize()
    assert (gate.GATE_FWD_LAUNCHES, gate.GATE_BWD_LAUNCHES) == (128, 64)
    kernels = [e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("gate_silu_fwd_kernel" in k for k in kernels) and sum("gate_silu_bwd_kernel" in k for k in kernels)
    assert not [k for k in kernels if "silu" in k.lower() and "gate_silu" not in k], kernels
    assert 10.0 < float(loss) < 12.0
    del sess, state
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- Jamba on the card


def _plain_rmsnorm(x, weight, eps, dtype, residual=False):
    """``layers.RMSNorm``'s plain math, on any device."""
    xf = x.float()
    y = (xf * (torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) * weight.float())).to(dtype)
    return (y, x) if residual else y


@pytest.mark.cuda
def test_jamba_mamba_mixer_runs_on_the_kernels_as_its_plain_path(monkeypatch):
    """Jamba's Mamba mixer (inner dt/B/C norms, the conv and the gate in
    f32) at [2, 4096, 5120], d_state 16, bf16 compute and bf16 parameters,
    as ``bf16_sr`` holds them: on the kernels (one launch each of the scan,
    conv and gate pairs, three norm forwards and backwards) against the same
    mixer on its plain path on the card (the plain chunked scan, the conv's
    and the gate's f32 compositions, the norms' plain math). Both round the
    same bf16 operands and differ in summation order and in where the scan's
    y and the products' bf16 results land: the output and every gradient
    within 1e-2 of its norm."""
    from multimodal_llm_pretraining_tpu_torch.models import mamba as tmamba
    from multimodal_llm_pretraining_tpu_torch.ops import causal_conv, gate, rmsnorm
    from multimodal_llm_pretraining_tpu_torch.ops.selective_scan import causal_conv1d

    _needs_cuda()
    torch.manual_seed(0)
    mixer = tmamba.MambaMixer(2560, 5120, 16, 4, 160, use_custom_kernels=True, dtype=torch.bfloat16,
                              f32_conv_gate=True, inner_norm_eps=1e-6).cuda()
    with torch.no_grad():
        for name, p in mixer.named_parameters():
            if name == "A_log":
                p.copy_(torch.log(torch.arange(1, 17.0)).expand_as(p))
            elif name.endswith("norm.weight") or name == "D":
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02)
    mixer.to(torch.bfloat16)
    h = _rand(2, 4096, 2560, seed=1)
    dout = _rand(2, 4096, 2560, seed=2)

    def run():
        mixer.zero_grad(set_to_none=True)
        x = h.clone().requires_grad_()
        out = mixer(x)
        out.backward(dout)
        return [out.detach(), x.grad] + [p.grad for p in mixer.parameters()]

    for mod in (ssf, causal_conv, gate, rmsnorm):
        mod.reset_launch_counts()
    got = run()
    launches = (ssf.FWD_LAUNCHES, ssf.BWD_LAUNCHES, causal_conv.CONV_FWD_LAUNCHES, causal_conv.CONV_BWD_LAUNCHES,
                gate.GATE_FWD_LAUNCHES, gate.GATE_BWD_LAUNCHES, rmsnorm.RMSNORM_FWD_LAUNCHES,
                rmsnorm.RMSNORM_BWD_LAUNCHES)
    assert launches == (1, 1, 1, 1, 1, 1, 3, 3)
    monkeypatch.setattr(tmamba, "causal_conv_silu",
                        lambda u, w, b: F.silu(causal_conv1d(u.float(), w.float(), b.float())).to(u.dtype))
    monkeypatch.setattr(tmamba, "gate_silu", lambda y, z: (y.float() * F.silu(z.float())).to(y.dtype))
    monkeypatch.setattr(rmsnorm, "rmsnorm", _plain_rmsnorm)
    mixer.use_custom_kernels = False
    want = run()
    names = ["out", "dh"] + [n for n, _ in mixer.named_parameters()]
    errs = {n: float((a.float() - b.float()).norm() / b.float().norm()) for n, a, b in zip(names, got, want)}
    assert all(e <= NORM_REL for e in errs.values()), errs


@pytest.mark.cuda
def test_mqa_attention_at_20_to_1_heads_of_128_on_flash():
    """Jamba's attention: 20 query heads of 128 and one KV head repeated for
    each, causal, at 4096 positions, through ``SelfAttention``'s path onto
    the flash kernels (D=128, scale 128^-0.5), against ``flash_fwd_reference``
    on the same repeated heads: out within 1e-2 of its norm, lse within
    1e-3. Backward through the repeat: dq, and dk and dv summed over the 20
    heads, within 1e-2 of the plain backward's."""
    _needs_cuda()
    b, h, s, d = 2, 20, 4096, 128
    q = _rand(b, h, s, d, seed=3)
    k1, v1 = _rand(b, 1, s, d, seed=4), _rand(b, 1, s, d, seed=5)
    scale = d**-0.5
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k1, v1))
    out = fa.flash_attention(qq, kk.repeat_interleave(h, 1), vv.repeat_interleave(h, 1), causal=True, sm_scale=scale)
    dout = _rand(b, h, s, d, seed=6)
    out.backward(dout)
    flat = [t.reshape(b * h, s, d) for t in (q, k1.repeat_interleave(h, 1), v1.repeat_interleave(h, 1))]
    want, lse = fa.flash_fwd_reference(*flat, True, scale)
    _close(out.reshape(b * h, s, d), want)
    got_lse = fa.flash_fwd_cuda(*flat, True, scale)[1]
    assert (got_lse - lse).abs().max() <= LSE_ABS
    dq, dk, dv = fa.flash_bwd_reference(*flat, want, lse, dout.reshape(b * h, s, d), True, scale)
    _close(qq.grad.reshape(b * h, s, d), dq)
    _close(kk.grad, dk.float().reshape(b, h, s, d).sum(1, keepdim=True))
    _close(vv.grad, dv.float().reshape(b, h, s, d).sum(1, keepdim=True))


@pytest.mark.cuda
def test_jamba_micro_batch_runs_on_the_kernels(monkeypatch):
    """A Jamba micro-batch at full width and sequence (one row of 16,384
    tokens), narrowed to one Mamba and one attention layer, under
    whole-layer remat in ``bf16_sr``: the scan, conv and gate pairs and the
    flash kernels each launch twice forward (the replay runs them again) and
    once backward; the norm kernels launch 15 times forward (each layer's
    two stream norms and the Mamba layer's three inner norms, twice, and the
    final norm) and 8 backward; and the first loss sits near log(65536)."""
    from multimodal_llm_pretraining_tpu_torch.models import get_model_class
    from multimodal_llm_pretraining_tpu_torch.models import jamba as tjamba
    from multimodal_llm_pretraining_tpu_torch.ops import causal_conv, gate, rmsnorm
    from multimodal_llm_pretraining_tpu_torch.profile_step import make_plan

    _needs_cuda()
    for name, value in (("N_LAYER", 2), ("ATTN_LAYER_PERIOD", 2), ("ATTN_LAYER_OFFSET", 1)):
        monkeypatch.setattr(tjamba, name, value)
    mc = get_model_class("jamba2-3b")
    sess = make_plan(mc, 1, 1, True, "bf16_sr").build_session(mc, device="cuda")
    state = sess.init_state()
    batch = {k: v[0] for k, v in sess.make_train_batch(seed=0).items()}
    accumulate = sess.accumulate_fn()
    accumulate(state, batch)
    torch.cuda.synchronize()
    for mod in (ssf, causal_conv, gate, fa, rmsnorm):
        mod.reset_launch_counts()
    loss = accumulate(state, batch)
    torch.cuda.synchronize()
    assert (ssf.FWD_LAUNCHES, ssf.BWD_LAUNCHES) == (2, 1)
    assert (rmsnorm.RMSNORM_FWD_LAUNCHES, rmsnorm.RMSNORM_BWD_LAUNCHES) == (15, 8)
    assert (causal_conv.CONV_FWD_LAUNCHES, causal_conv.CONV_BWD_LAUNCHES) == (2, 1)
    assert (gate.GATE_FWD_LAUNCHES, gate.GATE_BWD_LAUNCHES) == (2, 1)
    assert fa.FWD_LAUNCHES == 2 and fa.BWD_LAUNCHES + fa.DQ_LAUNCHES == 1
    assert 10.5 < float(loss) < 12.5
    del sess, state
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- SSD (Mamba-2's chunk scan)

# y, the entering states, dx, dB, dC, ddt and dA within 1e-2 of their norm: the kernels and the cuBLAS steps
# take bf16 operands (the decay-masked C B^T, x, C, the states, dy exp(acs), B dS) where the plain version
# computes in f32, a few roundings of 2^-9 each (about 3e-3 at these shapes when the kernels are emulated
# on the CPU); dD, an f32 sum of dy x on both sides in another order, within 1e-4.
SSD_NORM_REL = 1e-2
SSD_DD_NORM_REL = 1e-4
SSD_CASES = [  # B, L, H, G, N, chunk, strided x
    (2, 300, 8, 2, 64, 256, True),  # L not a multiple of the chunk, two groups, x a view of a wider row
    (1, 200, 4, 1, 128, 64, False),
    (3, 96, 2, 1, 16, 32, True),
]


def _ssd_inputs(b, L, H, G, N, strided, seed=0):
    """bf16 x (a view of a wider row when ``strided``, as the mixer hands it
    over), B and C; dt a softplus in f32; A -exp of a normal draw; D."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    wide = (rand(b, L, H * 64 + 2 * G * N) * 0.5).to(torch.bfloat16)
    x = wide[..., :H * 64].unflatten(-1, (H, 64)) if strided else wide[..., :H * 64].reshape(b, L, H, 64)
    B = (rand(b, L, G, N) * 0.3).to(torch.bfloat16)
    C = (rand(b, L, G, N) * 0.3).to(torch.bfloat16)
    dt = F.softplus(rand(b, L, H) + 0.5)
    A = -torch.exp(rand(H))
    D = rand(H)
    return x, dt, A, B, C, D


def _ssd_against_plain(args, chunk, dy, got_y, got_states, got_grads, rows=None):
    from multimodal_llm_pretraining_tpu_torch.ops import ssd

    x, dt, A, B, C, D = args
    rows = range(x.shape[0]) if rows is None else rows
    dA = dD = 0
    for i in rows:
        one = [t[i:i + 1] for t in (x, dt)] + [A] + [t[i:i + 1] for t in (B, C)] + [D]
        y, states = ssd.ssd_fwd_reference(*one, chunk)
        _close(got_y[i:i + 1], y, SSD_NORM_REL)
        _close(got_states[i:i + 1], states, SSD_NORM_REL)
        grads = ssd.ssd_bwd_reference(*one, states, dy[i:i + 1], chunk)
        for got, want in zip((got_grads[0], got_grads[1], got_grads[3], got_grads[4]),
                             (grads[0], grads[1], grads[3], grads[4])):
            _close(got[i:i + 1], want, SSD_NORM_REL)
        dA, dD = dA + grads[2], dD + grads[5]
        del y, states, grads
    _close(got_grads[2], dA, SSD_NORM_REL)
    _close(got_grads[5], dD, SSD_DD_NORM_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,L,H,G,N,chunk,strided", SSD_CASES)
def test_ssd_kernels_match_plain_versions(b, L, H, G, N, chunk, strided):
    """The card's SSD (the kernel pair between its PyTorch and cuBLAS steps)
    against the plain chunked form at ragged and small shapes: y and the
    entering states, then dx, ddt, dA, dB, dC and dD, each within its
    tolerance (``SSD_NORM_REL``, ``SSD_DD_NORM_REL``); outputs in their
    inputs' dtypes, dx and y contiguous; one launch each way."""
    from multimodal_llm_pretraining_tpu_torch.ops import ssd

    _needs_cuda()
    args = _ssd_inputs(b, L, H, G, N, strided)
    ssd.reset_launch_counts()
    y, states = ssd.ssd_fwd_cuda(*args, chunk)
    dy = _rand(b, L, H, 64, seed=7)
    grads = ssd.ssd_bwd_cuda(*args, states, dy, chunk)
    torch.cuda.synchronize()
    assert (ssd.SSD_FWD_LAUNCHES, ssd.SSD_BWD_LAUNCHES) == (1, 1)
    assert y.is_contiguous() and grads[0].is_contiguous()
    assert [g.dtype for g in grads] == [t.dtype for t in args]
    _ssd_against_plain(args, chunk, dy, y, states, grads)


@pytest.mark.cuda
def test_ssd_at_the_cells_shape_without_a_chunk_mask_tensor():
    """granite-4.0-h-micro's micro-batch, [8, 16384, 64, 64] with N 128,
    one group, chunks of 256, x a view of the conv's [8, 16384, 4352]
    output: forward and backward against the plain chunked form, a row at a
    time, each within its tolerance. No tensor the size of [B, H, chunks,
    256, 256] is made: the largest any op of the forward or the backward
    returns is the size of x."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from multimodal_llm_pretraining_tpu_torch.ops import ssd

    class Largest(TorchDispatchMode):
        numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor):
                    Largest.numel = max(Largest.numel, t.numel())
            return out

    _needs_cuda()
    b, L, H, N, chunk = 8, 16384, 64, 128, 256
    args = _ssd_inputs(b, L, H, 1, N, True)
    dy = _rand(b, L, H, 64, seed=8)
    with Largest():
        y, states = ssd.ssd_fwd_cuda(*args, chunk)
        grads = ssd.ssd_bwd_cuda(*args, states, dy, chunk)
    torch.cuda.synchronize()
    assert Largest.numel == b * L * H * 64 < b * H * (L // chunk) * chunk * chunk
    _ssd_against_plain(args, chunk, dy, y, states, grads)


@pytest.mark.cuda
def test_ssd_ops_pass_opcheck_on_the_card():
    """``torch.library.opcheck`` of ``mlpt::ssd_fwd`` (with its autograd
    rule, x a view) and ``mlpt::ssd_bwd``."""
    from multimodal_llm_pretraining_tpu_torch.ops import ssd

    _needs_cuda()
    x, dt, A, B, C, D = _ssd_inputs(1, 70, 2, 1, 16, True)
    torch.library.opcheck(ssd.ssd_fwd, (x.detach().requires_grad_(), dt.requires_grad_(), A.requires_grad_(),
                                        B.requires_grad_(), C.requires_grad_(), D.requires_grad_(), 32))
    args = [t.detach() for t in (x, dt, A, B, C, D)]
    y, states = ssd.ssd_fwd(*args, 32)
    torch.library.opcheck(ssd.ssd_bwd, (*args, states, torch.randn_like(y), 32))


@pytest.mark.cuda
def test_ssd_kernels_refuse_what_they_do_not_take():
    """f32 x, a head dim other than 64, N above 128, a chunk that is not a
    multiple of 32 or CPU tensors raise: there is no plain fallback on the
    card."""
    from multimodal_llm_pretraining_tpu_torch.ops import ssd

    _needs_cuda()
    x, dt, A, B, C, D = _ssd_inputs(1, 64, 2, 1, 16, False)
    for args, chunk in (((x.float(), dt, A, B, C, D), 32), ((x[..., :32], dt, A, B, C, D), 32),
                        ((x, dt, A, torch.cat([B] * 9, -1), torch.cat([C] * 9, -1), D), 32),
                        ((x, dt, A, B, C, D), 48), ((x.cpu(), dt.cpu(), A.cpu(), B.cpu(), C.cpu(), D.cpu()), 32)):
        with pytest.raises(ValueError, match="ssd kernels take"):
            ssd.ssd_fwd_cuda(*args, chunk)


def _granite_session(monkeypatch, mbs, layer_types=None):
    from multimodal_llm_pretraining_tpu_torch.models import get_model_class
    from multimodal_llm_pretraining_tpu_torch.models import granite as tgranite
    from multimodal_llm_pretraining_tpu_torch.profile_step import make_plan

    if layer_types is not None:
        monkeypatch.setattr(tgranite, "LAYER_TYPES", layer_types)
    mc = get_model_class("granite-4.0-h-micro")
    sess = make_plan(mc, mbs, 1, True, "bf16_sr").build_session(mc, device="cuda")
    state = sess.init_state()
    batch = {k: v[0] for k, v in sess.make_train_batch(seed=0).items()}
    return sess, state, batch


@pytest.mark.cuda
def test_granite_micro_batch_runs_on_the_kernels(monkeypatch):
    """A granite-4.0-h-micro micro-batch at full width and sequence (one row
    of 16,384 tokens), narrowed to one Mamba-2 and one attention layer,
    under whole-layer remat in ``bf16_sr``: the SSD, conv and gate pairs and
    the flash kernels each launch twice forward (the replay runs them again)
    and once backward; the norm kernels launch 11 times forward (each
    layer's two stream norms and the mixer's gated norm, twice, and the
    final norm) and 6 backward; the first loss sits near log(100352)."""
    from multimodal_llm_pretraining_tpu_torch.ops import causal_conv, gate, rmsnorm, ssd

    _needs_cuda()
    sess, state, batch = _granite_session(monkeypatch, 1, ("mamba", "attention"))
    accumulate = sess.accumulate_fn()
    accumulate(state, batch)
    torch.cuda.synchronize()
    for mod in (ssd, causal_conv, gate, fa, rmsnorm):
        mod.reset_launch_counts()
    loss = accumulate(state, batch)
    torch.cuda.synchronize()
    assert (ssd.SSD_FWD_LAUNCHES, ssd.SSD_BWD_LAUNCHES) == (2, 1)
    assert (rmsnorm.RMSNORM_FWD_LAUNCHES, rmsnorm.RMSNORM_BWD_LAUNCHES) == (11, 6)
    assert (causal_conv.CONV_FWD_LAUNCHES, causal_conv.CONV_BWD_LAUNCHES) == (2, 1)
    assert (gate.GATE_FWD_LAUNCHES, gate.GATE_BWD_LAUNCHES) == (2, 1)
    assert fa.FWD_LAUNCHES == 2 and fa.BWD_LAUNCHES + fa.DQ_LAUNCHES == 1
    assert abs(float(loss) - math.log(100352)) < 1.0
    del sess, state
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_granite_cell_micro_batch_counts_its_ssd_calls(monkeypatch):
    """The cell's micro-batch, 8 rows of 16,384 tokens through all 40
    layers under whole-layer remat in ``bf16_sr``: 72 SSD forward launches
    (36 mixers and their replays) and 36 backward, under 80 GB at its peak."""
    from multimodal_llm_pretraining_tpu_torch.ops import ssd

    _needs_cuda()
    sess, state, batch = _granite_session(monkeypatch, 8)
    accumulate = sess.accumulate_fn()
    accumulate(state, batch)
    torch.cuda.synchronize()
    ssd.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    loss = accumulate(state, batch)
    torch.cuda.synchronize()
    assert (ssd.SSD_FWD_LAUNCHES, ssd.SSD_BWD_LAUNCHES) == (72, 36)
    assert torch.isfinite(loss)
    print(f"[granite] mbs 8 peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, loss {float(loss):.4f}")
    assert torch.cuda.max_memory_allocated() < 80e9
    del sess, state
    torch.cuda.empty_cache()
