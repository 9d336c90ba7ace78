"""The port's selective scan and causal conv against the JAX package.

The same inputs, made with numpy, go through the JAX functions and the port's.
The JAX Pallas kernels run in interpret mode on the CPU, as the JAX suite runs
them; the port takes the plain versions of its kernels (CPU tensors). Both
sides compute in f32 and differ only in summation order, so y and the state
checkpoint agree to 1e-5, and the gradients to the JAX suite's own tolerance,
rtol = atol = 2e-4 (``tests/test_selective_scan.py:86,114``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_llm_pretraining_tpu.ops.selective_scan import causal_conv1d as jax_causal_conv1d
from multimodal_llm_pretraining_tpu.ops.selective_scan import selective_scan_xla
from multimodal_llm_pretraining_tpu.ops.selective_scan_pallas import (
    selective_scan_fused,
    selective_scan_pallas_bwd,
    selective_scan_pallas_fwd,
)
from multimodal_llm_pretraining_tpu_torch.ops import selective_scan_fused as ssf
from multimodal_llm_pretraining_tpu_torch.ops.selective_scan import causal_conv1d, selective_scan

torch.set_num_threads(2)

GRAD_TOL = 2e-4


def _inputs(b, L, I, N, seed):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(b, L, I)).astype(np.float32)
    delta = (rng.random((b, L, I)) * 0.5 + 0.01).astype(np.float32)
    A = -(rng.random((I, N)) + 0.5).astype(np.float32)
    B = rng.normal(size=(b, L, N)).astype(np.float32)
    C = rng.normal(size=(b, L, N)).astype(np.float32)
    D = rng.normal(size=(I,)).astype(np.float32)
    dy = rng.normal(size=(b, L, I)).astype(np.float32)
    return u, delta, A, B, C, D, dy


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# L 300: two 256-step chunks, the second ragged (the JAX side pads it);
# I 24 with block_i 8: three I-blocks on the JAX side
SHAPE = (2, 300, 24, 16)


@pytest.fixture(scope="module")
def pallas_run():
    """The JAX Pallas forward (with checkpoints) and backward, interpret mode."""
    u, delta, A, B, C, D, dy = _inputs(*SHAPE, seed=0)
    args = [jnp.asarray(a) for a in (u, delta, A, B, C, D)]
    _, ckpt = selective_scan_pallas_fwd(*args, block_i=8, with_checkpoints=True)
    y_pre = selective_scan_pallas_fwd(*args[:5], jnp.zeros_like(args[5]), block_i=8)
    grads = selective_scan_pallas_bwd(*args[:5], jnp.asarray(dy), ckpt, block_i=8)
    return np.array(y_pre), np.array(ckpt), [np.array(g) for g in grads]


def test_plain_forward_matches_pallas_forward(pallas_run):
    """y before the D skip, and the checkpoint as "state entering chunk l"."""
    y_want, ckpt_want, _ = pallas_run
    u, delta, A, B, C, _, _ = _inputs(*SHAPE, seed=0)
    y, ckpt = ssf.selective_scan_fwd_reference(*_t(u, delta, A, B, C))
    assert ckpt.shape == ckpt_want.shape == (2, 2, 16, 24)
    np.testing.assert_allclose(y.numpy(), y_want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ckpt.numpy(), ckpt_want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunk_size", [16, 256])
def test_plain_forward_matches_xla_scan(chunk_size):
    """Against ``selective_scan_xla`` (D skip included), chunked at 16 and
    over the whole length; the port's own chunk stays 256 either way."""
    u, delta, A, B, C, D, _ = _inputs(2, 70, 8, 16, seed=1)
    want = selective_scan_xla(*[jnp.asarray(a) for a in (u, delta, A, B, C, D)], chunk_size=chunk_size)
    y, _ = ssf.selective_scan_fwd_reference(*_t(u, delta, A, B, C))
    np.testing.assert_allclose((y + torch.from_numpy(D * u)).numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_plain_backward_matches_pallas_backward(pallas_run):
    _, ckpt, want = pallas_run
    u, delta, A, B, C, _, dy = _inputs(*SHAPE, seed=0)
    got = ssf.selective_scan_bwd_reference(*_t(u, delta, A, B, C, dy), torch.from_numpy(ckpt))
    for name, g, w in zip(("du", "ddelta", "dA", "dB", "dC"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=name)


def test_plain_backward_matches_xla_vjp():
    """Against ``jax.vjp`` of ``selective_scan_xla`` (chunk 16), with D = 0 so
    the XLA du carries no skip term: three 256-step chunks, the last ragged,
    so the reverse carry crosses two chunk boundaries."""
    u, delta, A, B, C, _, dy = _inputs(1, 600, 8, 16, seed=2)
    D = np.zeros(8, np.float32)
    _, vjp = jax.vjp(lambda *a: selective_scan_xla(*a, chunk_size=16), *[jnp.asarray(a) for a in (u, delta, A, B, C, D)])
    want = vjp(jnp.asarray(dy))[:5]
    tu, td, tA, tB, tC, tdy = _t(u, delta, A, B, C, dy)
    _, ckpt = ssf.selective_scan_fwd_reference(tu, td, tA, tB, tC)
    got = ssf.selective_scan_bwd_reference(tu, td, tA, tB, tC, tdy, ckpt)
    for name, g, w in zip(("du", "ddelta", "dA", "dB", "dC"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=name)


def test_plain_backward_matches_autograd_through_plain_forward():
    """The explicit reverse-time backward equals autograd through the plain
    chunked forward, an independent derivation of the same gradients."""
    u, delta, A, B, C, _, dy = _inputs(2, 270, 6, 16, seed=3)
    leaves = [t.requires_grad_() for t in _t(u, delta, A, B, C)]
    y, ckpt = ssf.selective_scan_fwd_reference(*leaves)
    want = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    got = ssf.selective_scan_bwd_reference(*[t.detach() for t in leaves], torch.from_numpy(dy), ckpt.detach())
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_fused_function_matches_jax_selective_scan_fused():
    """``selective_scan_fused`` on CPU tensors against JAX
    ``selective_scan_fused`` (Pallas forward and backward, interpret mode):
    y and all six gradients, dD included, through a weighted sum."""
    u, delta, A, B, C, D, w = _inputs(2, 100, 12, 16, seed=4)

    def jloss(*args):
        return jnp.sum(selective_scan_fused(*args) * jnp.asarray(w))

    want = jax.grad(jloss, argnums=tuple(range(6)))(*[jnp.asarray(a) for a in (u, delta, A, B, C, D)])
    leaves = [t.requires_grad_() for t in _t(u, delta, A, B, C, D)]
    (ssf.selective_scan_fused(*leaves) * torch.from_numpy(w)).sum().backward()
    for name, t, g in zip(("u", "delta", "A", "B", "C", "D"), leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("use_custom_kernels", [True, False])
def test_selective_scan_dispatch_matches_xla_scan(use_custom_kernels):
    """Both branches of the dispatcher give ``selective_scan_xla``'s y, in
    u's dtype; the custom-kernel branch takes the plain versions on the CPU
    without counting a launch."""
    u, delta, A, B, C, D, _ = _inputs(1, 40, 4, 16, seed=5)
    want = selective_scan_xla(*[jnp.asarray(a) for a in (u, delta, A, B, C, D)], chunk_size=16)
    before = (ssf.FWD_LAUNCHES, ssf.BWD_LAUNCHES)
    y = selective_scan(*_t(u, delta, A, B, C, D), chunk_size=16, use_custom_kernels=use_custom_kernels)
    assert y.dtype == torch.float32 and (ssf.FWD_LAUNCHES, ssf.BWD_LAUNCHES) == before
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_bf16_inputs_cast_like_jax():
    """bf16 u/delta/B/C: the scan runs in f32 and y comes back in u's dtype,
    as ``selective_scan_fused(...).astype(u.dtype)``; within 2 bf16 ulps."""
    u, delta, A, B, C, D, _ = _inputs(2, 50, 8, 16, seed=6)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (u, delta)] + [jnp.asarray(A)] + [jnp.asarray(a, jnp.bfloat16) for a in (B, C)]
    want = np.asarray(selective_scan_fused(*bf, jnp.asarray(D)).astype(jnp.float32))
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (u, delta)]
    tb += [torch.from_numpy(A)] + [torch.from_numpy(a).to(torch.bfloat16) for a in (B, C)]
    y = selective_scan(*tb, torch.from_numpy(D))
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), want, rtol=2**-7, atol=2**-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_with_skip_matches_pallas_forward(dtype):
    """``selective_scan_fwd_reference(..., D)`` against JAX's
    ``selective_scan_pallas_fwd(..., D, with_checkpoints=True)`` (interpret
    mode, three I-blocks): y with the skip in u's dtype and the checkpoint.
    f32 to 1e-5; bf16 u, delta, B, C within 2 bf16 ulps (both sides round
    an f32 y that differs in summation order), the checkpoint (f32 on both
    sides) to 1e-5."""
    u, delta, A, B, C, D, _ = _inputs(2, 100, 24, 16, seed=8)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    y_j, ck_j = selective_scan_pallas_fwd(*[jnp.asarray(a, jdt) for a in (u, delta)], jnp.asarray(A),
                                          *[jnp.asarray(a, jdt) for a in (B, C)], jnp.asarray(D),
                                          block_i=8, with_checkpoints=True)
    tu, td, tB, tC = (torch.from_numpy(a).to(tdt) for a in (u, delta, B, C))
    y, ckpt = ssf.selective_scan_fwd_reference(tu, td, torch.from_numpy(A), tB, tC, torch.from_numpy(D))
    assert y.dtype == tdt and ckpt.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2**-7
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_j.astype(jnp.float32)), rtol=tol, atol=tol)
    np.testing.assert_allclose(ckpt.numpy(), np.asarray(ck_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_forward_skip_is_the_functions_expression(dtype):
    """With D the plain forward returns exactly ``(y + D * u)`` in f32 cast
    to u's dtype, the expression ``selective_scan_fused`` applied to the
    pre-skip y: the CPU results of the op are bitwise those of y
    before the skip plus that expression."""
    u, delta, A, B, C, D, _ = _inputs(2, 60, 8, 16, seed=9)
    tu, td, tB, tC = (torch.from_numpy(a).to(dtype) for a in (u, delta, B, C))
    tA, tD = torch.from_numpy(A), torch.from_numpy(D)
    y_pre, ckpt_pre = ssf.selective_scan_fwd_reference(tu, td, tA, tB, tC)
    y, ckpt = ssf.selective_scan_fwd_reference(tu, td, tA, tB, tC, tD)
    assert torch.equal(y, (y_pre + tD.float() * tu.float()).to(dtype)) and torch.equal(ckpt, ckpt_pre)
    assert torch.equal(ssf.selective_scan_fused(tu, td, tA, tB, tC, tD), y)


def test_causal_conv1d_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 13, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    want = np.asarray(jax_causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = causal_conv1d(*_t(x, w, b))
    assert got.shape == (2, 13, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # causal: an impulse at t = 4 reaches nothing before t = 4
    imp = torch.zeros(1, 8, 6)
    imp[0, 4] = 1.0
    out = causal_conv1d(imp, torch.from_numpy(w))
    assert torch.equal(out[0, :4], torch.zeros(4, 6))
    torch.testing.assert_close(out[0, 4], torch.from_numpy(w[-1]))


@pytest.mark.parametrize("with_d", [True, False])
def test_scan_ops_pass_opcheck_on_the_cpu(with_d):
    """``mlpt::scan_fwd`` (with the skip and without) and ``mlpt::scan_bwd``
    under ``torch.library.opcheck`` on CPU tensors, where they run the plain
    versions: schema, fakes and the forward's autograd registration; each
    op's outputs equal its plain version's."""
    u, delta, A, B, C, D, dy = _t(*_inputs(2, 300, 24, 16, seed=11))
    D = D if with_d else None
    y, ckpt = ssf.scan_fwd(u, delta, A, B, C, D)
    y_ref, ckpt_ref = ssf.selective_scan_fwd_reference(u, delta, A, B, C, D)
    assert torch.equal(y, y_ref) and torch.equal(ckpt, ckpt_ref)
    grads = ssf.scan_bwd(u, delta, A, B, C, dy, ckpt)
    for got, want in zip(grads, ssf.selective_scan_bwd_reference(u, delta, A, B, C, dy, ckpt)):
        assert torch.equal(got, want)
    leaves = [t.clone().requires_grad_() for t in (u, delta)]
    torch.library.opcheck(ssf.scan_fwd, (*leaves, A, B, C, None if D is None else D.clone().requires_grad_()))
    torch.library.opcheck(ssf.scan_bwd, (u, delta, A, B, C, dy, ckpt))
