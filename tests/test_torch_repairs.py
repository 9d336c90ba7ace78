"""Shapes the JAX package computes and the port's kernels do not take, against the JAX package.

- Head dims above the kernels' 256: ``dot_product_attention(impl="flash")``
  routes them, by shape alone (``flash_supported``), to its ``xla`` branch,
  as the JAX dispatcher does. Held against JAX's ``impl="pallas"``, which
  runs its Pallas kernel in interpret mode at D=320, under "highest" matmul
  precision: out to 2e-5 and the gradients to 5e-4 absolute, the tolerances
  of ``tests/test_torch_flash_attention.py``.
- Any d_state: the scan kernels run 16 states a launch, and the wrapper
  zero-pads N to a multiple of 16 and launches each group (``state_groups``,
  ``grouped_fwd``, ``grouped_bwd``). On the CPU the grouping runs over the
  plain versions: pad, plain version per group, sum / concatenate / slice
  equals the unpadded plain version to f32 summation order (1e-6 relative
  to the largest value), and both equal JAX's Pallas scan (interpret mode,
  N zero-padded to a multiple of 8 there) to 1e-5 for y and the checkpoint
  and the JAX suite's 2e-4 for the gradients. Off d_state 16 the groups run
  without the D skip, which ``grouped_fwd`` adds to their sum.
- Any batch: a scan launch takes at most 65,535 batch elements (the grid's
  y), and the wrappers launch larger batches in contiguous chunks
  (``batch_chunked``). On the plain versions, at a limit of 3, chunked
  equals whole bit for bit: the forward, and the backward with dA per batch
  element (``selective_scan_bwd_by_batch_reference``) and summed after.
- Any I: the kernels' tensor maps take I a multiple of 8, and the wrappers
  zero-pad it (``padded_fwd``, ``padded_bwd``); on the plain versions pad ->
  plain version -> slice equals the plain version bit for bit (dA, a sum
  over the steps vectorised across the channels, to f32 summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_llm_pretraining_tpu.ops import attention as jattn
from multimodal_llm_pretraining_tpu.ops import flash_attention as jfa
from multimodal_llm_pretraining_tpu.ops.selective_scan_pallas import selective_scan_pallas_bwd, selective_scan_pallas_fwd
from multimodal_llm_pretraining_tpu_torch.ops import attention as tattn
from multimodal_llm_pretraining_tpu_torch.ops import flash_attention as tfa
from multimodal_llm_pretraining_tpu_torch.ops import selective_scan_fused as ssf

torch.set_num_threads(2)
torch.exp(torch.ones(4096))  # one single-threaded first exp; see tests/test_torch_flash_attention.py

ATOL_OUT = 2e-5
ATOL_GRAD = 5e-4
SCAN_FWD_TOL = 1e-5
SCAN_GRAD_TOL = 2e-4
GROUPED_REL = 1e-6


# ---------------------------------------------------------------- head dims above 256


@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)])
def test_head_dim_320_takes_the_xla_branch_and_matches_jax_pallas(causal, masked):
    """D=320: the port counts one xla-branch call and gives JAX's Pallas
    kernel's out and gradients (the mask right-pads one row)."""
    b, h, s, d = 2, 2, 40, 320
    rng = np.random.default_rng(8)
    q, k, v, do = (rng.normal(size=(b, h, s, d)).astype(np.float32) for _ in range(4))
    mask = np.ones((b, s), np.int32)
    mask[1, 27:] = 0
    jmask = jnp.asarray(mask) if masked else None

    def jf(q, k, v):
        return jattn.dot_product_attention(q, k, v, causal=causal, mask=jmask, impl="pallas")

    with jax.default_matmul_precision("highest"):
        assert jfa.flash_supported(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask)  # JAX runs its kernel
        out_j, vjp = jax.vjp(jf, *(jnp.asarray(x) for x in (q, k, v)))
        grads_j = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    before = tattn.XLA_BRANCH_CALLS
    out_t = tattn.dot_product_attention(*leaves, causal=causal, mask=torch.from_numpy(mask) if masked else None,
                                        impl="flash")
    assert tattn.XLA_BRANCH_CALLS == before + 1
    out_t.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=ATOL_OUT, rtol=0)
    for t, g in zip(leaves, grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=ATOL_GRAD, rtol=0)


def test_xla_branch_keeps_bf16_like_jax():
    """The xla branch on bf16 inputs: f32-accumulated scores, an f32 softmax
    rounded to bf16, a bf16 product, as JAX's ``impl="xla"``; out within 2
    bf16 ulps."""
    rng = np.random.default_rng(9)
    q, k, v = (rng.normal(size=(1, 2, 24, 320)).astype(np.float32) for _ in range(3))
    want = jattn.dot_product_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=True, impl="xla")
    got = tattn.dot_product_attention(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)), causal=True,
                                      impl="xla")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=2**-7, atol=2**-7)


@pytest.mark.parametrize("q_shape,kv_shape,mask_shape,expected", [
    ((2, 4, 16, 256), (2, 4, 16, 256), None, True),
    ((2, 4, 16, 257), (2, 4, 16, 257), None, False),
    ((2, 4, 16, 512), (2, 4, 16, 512), None, False),
    ((2, 4, 16, 64), (2, 4, 24, 64), (2, 24), True),
    ((2, 4, 16, 64), (2, 4, 24, 64), (2, 16), False),
    ((2, 4, 16, 64), (2, 4, 24, 64), (1, 24), False),
    ((2, 4, 16, 64), (2, 4, 24, 64), (2, 1, 24), False),
    ((8, 16, 64), (8, 16, 64), None, False),
])
def test_flash_supported_by_shape(q_shape, kv_shape, mask_shape, expected):
    """The port's bound (256) where JAX's is its kernel's 512; the mask and
    rank rules as JAX's, which agrees wherever D <= 256."""
    q, k = torch.zeros(q_shape), torch.zeros(kv_shape)
    mask = None if mask_shape is None else torch.ones(mask_shape)
    assert tfa.flash_supported(q, k, k, mask) is expected
    if q_shape[-1] <= 256:
        jmask = None if mask is None else jnp.ones(mask_shape)
        assert jfa.flash_supported(jnp.zeros(q_shape), jnp.zeros(kv_shape), jnp.zeros(kv_shape), jmask) is expected


# ---------------------------------------------------------------- any d_state


def _scan_inputs(b, L, I, N, seed):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(b, L, I)).astype(np.float32)
    delta = (rng.random((b, L, I)) * 0.5 + 0.01).astype(np.float32)
    A = -(rng.random((I, N)) + 0.5).astype(np.float32)
    B = rng.normal(size=(b, L, N)).astype(np.float32)
    C = rng.normal(size=(b, L, N)).astype(np.float32)
    dy = rng.normal(size=(b, L, I)).astype(np.float32)
    return u, delta, A, B, C, dy


@pytest.mark.parametrize("N", [1, 8, 12, 24])
def test_scan_plain_versions_match_pallas_at_any_d_state(N):
    """The plain forward and backward, directly and through the state
    groups, against JAX's Pallas kernels (interpret mode) at d_state N;
    L 300: two chunks, the second ragged."""
    u, delta, A, B, C, dy = _scan_inputs(1, 300, 8, N, seed=20 + N)
    args = [jnp.asarray(a) for a in (u, delta, A, B, C)]
    y_j, ck_j = selective_scan_pallas_fwd(*args, jnp.zeros(8), block_i=8, with_checkpoints=True)
    grads_j = selective_scan_pallas_bwd(*args, jnp.asarray(dy), ck_j, block_i=8)
    tu, td, tA, tB, tC, tdy = (torch.from_numpy(a) for a in (u, delta, A, B, C, dy))
    for fwd, bwd in ((ssf.selective_scan_fwd_reference, ssf.selective_scan_bwd_reference),
                     (lambda *a: ssf.grouped_fwd(ssf.selective_scan_fwd_reference, *a),
                      lambda *a: ssf.grouped_bwd(ssf.selective_scan_bwd_reference, *a))):
        y, ckpt = fwd(tu, td, tA, tB, tC)
        assert ckpt.shape == (1, 2, N, 8)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=SCAN_FWD_TOL, atol=SCAN_FWD_TOL)
        np.testing.assert_allclose(ckpt.numpy(), np.asarray(ck_j)[:, :, :N], rtol=SCAN_FWD_TOL, atol=SCAN_FWD_TOL)
        for name, g, w in zip(("du", "ddelta", "dA", "dB", "dC"), bwd(tu, td, tA, tB, tC, tdy, ckpt), grads_j):
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=SCAN_GRAD_TOL, atol=SCAN_GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("N", [1, 8, 12, 24, 64])
def test_state_groups_are_exact_in_the_plain_versions(N):
    """Pad to a multiple of 16, plain version per group of 16, then sum (y,
    du, ddelta), concatenate and slice (checkpoint, dA, dB, dC): the
    unpadded plain version's values, to f32 summation order."""
    u, delta, A, B, C, dy = (torch.from_numpy(a) for a in _scan_inputs(2, 270, 6, N, seed=40 + N))
    groups = ssf.state_groups(A, B, C)
    assert len(groups) == ssf.padded_d_state(N) // 16 == -(-N // 16)
    assert all(g.shape[-1] == 16 and g.is_contiguous() for grp in groups for g in grp)
    want_fwd = ssf.selective_scan_fwd_reference(u, delta, A, B, C)
    got_fwd = ssf.grouped_fwd(ssf.selective_scan_fwd_reference, u, delta, A, B, C)
    want_bwd = ssf.selective_scan_bwd_reference(u, delta, A, B, C, dy, want_fwd[1])
    got_bwd = ssf.grouped_bwd(ssf.selective_scan_bwd_reference, u, delta, A, B, C, dy, want_fwd[1])
    for got, want in zip((*got_fwd, *got_bwd), (*want_fwd, *want_bwd)):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0, atol=GROUPED_REL * want.abs().max().item())


def test_d_state_16_is_one_group_of_the_inputs_themselves():
    u, delta, A, B, C, _ = (torch.from_numpy(a) for a in _scan_inputs(1, 20, 4, 16, seed=5))
    ((gA, gB, gC),) = ssf.state_groups(A, B, C)
    assert gA is A and gB is B and gC is C
    assert [ssf.padded_d_state(n) for n in (1, 15, 16, 17, 64)] == [16, 16, 16, 32, 64]


@pytest.mark.parametrize("N", [8, 24])
def test_grouped_forward_adds_the_skip_like_jax_pallas(N):
    """Off d_state 16 the groups run without D and ``grouped_fwd`` skips
    their f32 sum: JAX's Pallas forward with D (interpret mode) to 1e-5, and
    exactly the plain forward with D to f32 summation order."""
    u, delta, A, B, C, _ = _scan_inputs(2, 300, 8, N, seed=60 + N)
    D = np.random.default_rng(70 + N).normal(size=(8,)).astype(np.float32)
    y_j, ck_j = selective_scan_pallas_fwd(*(jnp.asarray(a) for a in (u, delta, A, B, C, D)), block_i=8,
                                          with_checkpoints=True)
    args = [torch.from_numpy(a) for a in (u, delta, A, B, C, D)]
    y, ckpt = ssf.grouped_fwd(ssf.selective_scan_fwd_reference, *args)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=SCAN_FWD_TOL, atol=SCAN_FWD_TOL)
    np.testing.assert_allclose(ckpt.numpy(), np.asarray(ck_j)[:, :, :N], rtol=SCAN_FWD_TOL, atol=SCAN_FWD_TOL)
    y_ref, _ = ssf.selective_scan_fwd_reference(*args)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=GROUPED_REL * y_ref.abs().max().item())


@pytest.mark.parametrize("with_skip", [False, True])
def test_batch_chunks_are_exact_in_the_plain_versions(with_skip):
    """7 batch elements in chunks of at most 3 (3, 3, 1): the plain forward
    (y with or without the skip, the checkpoint) and the plain backward by
    batch element (du, ddelta, dA per element, dB, dC) equal the whole
    batch's bit for bit, and so does dA summed over the batch after."""
    u, delta, A, B, C, dy = (torch.from_numpy(a) for a in _scan_inputs(7, 300, 8, 16, seed=80))
    D = torch.from_numpy(np.random.default_rng(81).normal(size=(8,)).astype(np.float32)) if with_skip else None
    assert ssf.bh_chunks(7, 3) == [(0, 3), (3, 6), (6, 7)]
    whole = ssf.selective_scan_fwd_reference(u, delta, A, B, C, D)
    chunked = ssf.batch_chunked(ssf.selective_scan_fwd_reference, u, delta, A, B, C, D, limit=3)
    assert all(torch.equal(a, b) for a, b in zip(chunked, whole))
    ckpt = whole[1]
    whole = ssf.selective_scan_bwd_by_batch_reference(u, delta, A, B, C, dy, ckpt)
    chunked = ssf.batch_chunked(ssf.selective_scan_bwd_by_batch_reference, u, delta, A, B, C, dy, ckpt, limit=3)
    assert whole[2].shape == (7, 8, 16)
    assert all(torch.equal(a, b) for a, b in zip(chunked, whole))
    summed = ssf.sum_dA(*chunked)
    assert all(torch.equal(a, b) for a, b in zip(summed, ssf.selective_scan_bwd_reference(u, delta, A, B, C, dy, ckpt)))
    # at or under the limit the function runs once, on the arguments as given
    assert ssf.batch_chunked(lambda *a: a, u, delta, A, B, C, D, limit=7)[0] is u


@pytest.mark.parametrize("I", [1, 5, 13])
def test_channel_padding_is_exact_in_the_plain_versions(I):
    """I zero-padded to a multiple of 8 (u, delta, A's rows, D, dy, the
    checkpoint), plain version, outputs sliced back: the unpadded plain
    version's values bit for bit, forward with and without the skip, and
    the backward's du, ddelta, dB and dC; dA, a sum over the steps that
    PyTorch vectorises across the channels, to f32 summation order."""
    u, delta, A, B, C, dy = (torch.from_numpy(a) for a in _scan_inputs(2, 270, I, 16, seed=90 + I))
    D = torch.from_numpy(np.random.default_rng(91).normal(size=(I,)).astype(np.float32))
    for d in (None, D):
        want = ssf.selective_scan_fwd_reference(u, delta, A, B, C, d)
        got = ssf.padded_fwd(ssf.selective_scan_fwd_reference, u, delta, A, B, C, d)
        assert all(g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, want))
    ckpt = want[1]
    want = ssf.selective_scan_bwd_reference(u, delta, A, B, C, dy, ckpt)
    got = ssf.padded_bwd(ssf.selective_scan_bwd_reference, u, delta, A, B, C, dy, ckpt)
    assert all(g.shape == w.shape for g, w in zip(got, want))
    assert all(torch.equal(got[k], want[k]) for k in (0, 1, 3, 4))
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=GROUPED_REL * want[2].abs().max().item())
