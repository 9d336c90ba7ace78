"""The port's CUDA kernels (flash attention: forward, fused backward and the
split dq and dk/dv backward; selective scan) against their plain versions.

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
``FlashAttention.backward`` runs them) keeps them too, at the fused
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
Batches above 65,535 launch in chunks, one launch counted each. The fused
backward at head dim 256 takes any scale (0.07, and 200^-0.5 at D=200
padded to 256).
"""

import pytest
import torch

from multimodal_llm_pretraining_tpu_torch.ops import flash_attention as fa
from multimodal_llm_pretraining_tpu_torch.ops import selective_scan_fused as ssf

NORM_REL = 1e-2
LSE_ABS = 1e-3
SCAN_Y_NORM_REL = 1e-4
SCAN_Y_BF16_NORM_REL = 4e-3  # y with the skip in bf16: one bf16 rounding
SCAN_GRAD_NORM_REL = 1e-3


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
@pytest.mark.parametrize("seq,head_dim,causal", [(77, 64, True), (130, 128, False), (257, 256, True), (64, 256, False)])
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
    makes them, go through the autograd Function: one forward and one
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


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", fa.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("q_seq,kv_seq,causal", [
    (1, 129, False), (65, 200, True), (65, 200, False), (200, 65, True), (200, 65, False), (129, 130, True),
    (2049, 300, True), (300, 2049, False),
])
def test_fused_backward_with_other_key_count(q_seq, kv_seq, causal, head_dim):
    _needs_cuda()
    q, do = (_rand(3, q_seq, head_dim, seed=100 + i) for i in range(2))
    k, v = (_rand(3, kv_seq, head_dim, seed=102 + i) for i in range(2))
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
    """The split pair as ``FlashAttention.backward`` runs it."""
    return fa.flash_bwd_split_cuda(q, k, v, out, lse, do, causal, scale, kv_lens)


def _split_reference(q, k, v, out, lse, do, causal, scale, kv_lens=None):
    return fa.flash_bwd_split_reference(q, k, v, out, lse, do, causal, scale, kv_lens)


def _check_split(q, k, v, do, causal, scale, kv_lens=None):
    """The split pair against its plain versions (dq, dk, dv to NORM_REL of
    their norm, in the input dtype), all three bit for bit on a second run,
    dk and dv exactly 0 at and past each length, dq 0 on a row that sees no
    key."""
    out, lse = fa.flash_fwd_reference(q, k, v, causal, scale, kv_lens)
    grads = _split(q, k, v, out, lse, do, causal, scale, kv_lens)
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
    _check_split(q, k, v, do, causal, head_dim**-0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", fa.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("q_seq,kv_seq,causal", [
    (1, 129, False), (65, 200, True), (65, 200, False), (200, 65, True), (200, 65, False), (129, 130, True),
    (2049, 300, True), (300, 2049, False),
])
def test_split_backward_with_other_key_count(q_seq, kv_seq, causal, head_dim):
    _needs_cuda()
    q, do = (_rand(3, q_seq, head_dim, seed=150 + i) for i in range(2))
    k, v = (_rand(3, kv_seq, head_dim, seed=152 + i) for i in range(2))
    _check_split(q, k, v, do, causal, head_dim**-0.5)


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
    _check_split(q, k, v, do, causal, head_dim**-0.5, kv_lens)


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
    ssf.SelectiveScanFused.apply(u, delta, A, B, C, torch.ones(4)).sum().backward()
    assert (ssf.FWD_LAUNCHES, ssf.BWD_LAUNCHES) == before
    assert u.grad is not None


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 300, 96), (1, 64, 32), (2, 1000, 40), (1, 7, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernels_match_plain_versions(shape, dtype):
    """Ragged L (not a multiple of 256 or of the kernels' tiles) and ragged I
    (not a multiple of the kernels' channel tiles)."""
    _needs_cuda()
    u, delta, A, B, C, dy = _scan_inputs(*shape, seed=sum(shape), dtype=dtype)
    y, ckpt = ssf.selective_scan_fwd_cuda(u, delta, A, B, C)
    y_ref, ckpt_ref = ssf.selective_scan_fwd_reference(u, delta, A, B, C)
    _close(y, y_ref, SCAN_Y_NORM_REL)
    if ckpt.shape[1] > 1:
        _close(ckpt[:, 1:], ckpt_ref[:, 1:], SCAN_GRAD_NORM_REL)
    assert torch.equal(ckpt[:, 0], torch.zeros_like(ckpt[:, 0]))
    grads = ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt_ref)
    for got, want in zip(grads, ssf.selective_scan_bwd_reference(u, delta, A, B, C, dy, ckpt_ref)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        _close(got, want, SCAN_GRAD_NORM_REL)


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
    """One forward and one backward launch through the autograd Function, on
    strided views of one projection as the Mamba block makes them; the six
    gradients, dD included, equal the plain versions'."""
    _needs_cuda()
    u, delta, A, B, C, dy = _scan_inputs(2, 300, 64, seed=5)
    D = torch.randn(64, device="cuda")
    x_dbc = torch.cat([B, C], dim=-1)
    leaves = [t.clone().requires_grad_() for t in (u, delta, A, x_dbc, D)]
    lu, ld, lA, lx, lD = leaves
    ssf.reset_launch_counts()
    y = ssf.SelectiveScanFused.apply(lu, ld, lA, lx[..., :16], lx[..., 16:], lD)
    y.backward(dy)
    assert (ssf.FWD_LAUNCHES, ssf.BWD_LAUNCHES) == (1, 1)
    y_ref, ckpt = ssf.selective_scan_fwd_reference(u, delta, A, B, C)
    _close(y, y_ref + D * u, SCAN_Y_NORM_REL)
    du, dd, dA, dB, dC = ssf.selective_scan_bwd_reference(u, delta, A, B, C, dy, ckpt)
    for got, want in zip((lu.grad, ld.grad, lA.grad, lx.grad, lD.grad),
                         (du + D * dy, dd, dA, torch.cat([dB, dC], -1), (dy * u).sum((0, 1)))):
        _close(got, want, SCAN_GRAD_NORM_REL)


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
