"""Flash attention in the PyTorch port against the JAX Pallas kernels.

The JAX side runs its forward kernel and the fused single-pass backward
(``PREFER_FUSED_BWD`` pinned on) in interpret mode on the CPU; the port's side
runs its plain versions ``flash_fwd_reference`` / ``flash_bwd_reference`` and
the autograd ``FlashAttention`` (which takes the plain versions for CPU
tensors). Inputs come from one numpy generator and go to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_llm_pretraining_tpu.ops import flash_attention as jfa
from multimodal_llm_pretraining_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)

# f32 under "highest" matmul precision: the tolerances of tests/test_ops.py
ATOL_OUT = 2e-5
ATOL_GRAD = 5e-4


def _inputs(b, h, s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, s, d)).astype(np.float32) for _ in range(4)]


def _jax_side(q, k, v, do, causal, block, dtype):
    """(out, lse, dq, dk, dv) from the Pallas kernels in interpret mode."""
    b, h, s, d = q.shape
    jq, jk, jv, jdo = (jnp.asarray(x, dtype) for x in (q, k, v, do))
    scale = d**-0.5
    out, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(q, k, v, causal=causal, block_q=block, block_k=block), jq, jk, jv)
    dq, dk, dv = vjp(jdo)
    _, lse = jfa._fwd_impl(jq.reshape(b * h, s, d), jk.reshape(b * h, s, d), jv.reshape(b * h, s, d), causal, scale, block, block)
    return [np.asarray(jnp.asarray(x, jnp.float32)) for x in (out, lse.reshape(b, h, s), dq, dk, dv)]


def _torch_side(q, k, v, do, causal, dtype):
    """(out, lse, dq, dk, dv) from the plain versions, and (out, dq, dk, dv)
    through the autograd Function."""
    d = q.shape[-1]
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    out, lse = tfa.flash_fwd_reference(tq, tk, tv, causal, d**-0.5)
    grads = tfa.flash_bwd_reference(tq, tk, tv, out, lse, tdo, causal, d**-0.5)
    plain = [out, lse, *grads]
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    fout = tfa.flash_attention(*leaves, causal=causal)
    fgrads = torch.autograd.grad(fout, leaves, grad_outputs=tdo)
    fn = [fout, *fgrads]
    return [t.detach().float().numpy() for t in plain], [t.detach().float().numpy() for t in fn]


@pytest.fixture(autouse=True)
def _fused_backward(monkeypatch):
    monkeypatch.setattr(jfa, "PREFER_FUSED_BWD", True)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [200, 600])
@pytest.mark.parametrize("head_dim", [64, 256])
def test_plain_versions_match_pallas_kernels_f32(causal, seq, head_dim):
    """Blocks of 64 (S=200) and 128 (S=600) leave ragged tails on both axes."""
    q, k, v, do = _inputs(1, 2, seq, head_dim, seed=seq + head_dim)
    block = 64 if seq == 200 else 128
    with jax.default_matmul_precision("highest"):
        ref = _jax_side(q, k, v, do, causal, block, jnp.float32)
    plain, fn = _torch_side(q, k, v, do, causal, torch.float32)
    names = ("out", "lse", "dq", "dk", "dv")
    for name, got, want in zip(names, plain, ref):
        np.testing.assert_allclose(got, want, atol=ATOL_OUT if name in ("out", "lse") else ATOL_GRAD, err_msg=name)
    for name, got, want in zip(("out", "dq", "dk", "dv"), fn, [ref[0], *ref[2:]]):
        np.testing.assert_allclose(got, want, atol=ATOL_OUT if name == "out" else ATOL_GRAD, err_msg=f"Function {name}")


def test_plain_versions_match_pallas_kernels_bf16():
    """bf16 inputs: both sides round the same operands (q*scale, k*scale, p,
    ds) to bf16 and accumulate in f32, but sum in another order and round
    the bf16 outputs independently. Bound the difference by 2% of each
    output's norm (a few bf16 ulps, 2^-8 = 0.4% each) and lse, which stays
    f32, by 1e-3."""
    q, k, v, do = _inputs(1, 2, 200, 256, seed=7)
    ref = _jax_side(q, k, v, do, True, 64, jnp.bfloat16)
    plain, fn = _torch_side(q, k, v, do, True, torch.bfloat16)
    for name, got, want in zip(("out", "lse", "dq", "dk", "dv"), plain, ref):
        if name == "lse":
            np.testing.assert_allclose(got, want, atol=1e-3, err_msg=name)
        else:
            assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want), name
    for name, got, want in zip(("out", "dq", "dk", "dv"), fn, [ref[0], *ref[2:]]):
        assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want), f"Function {name}"


@pytest.mark.parametrize("causal", [False, True])
def test_attention_dispatcher_flash_matches_naive(causal):
    """``dot_product_attention``: the "flash" impl (plain versions on CPU)
    against the f32 eager "naive" impl; a padding mask is refused until the
    varlen kernel is ported."""
    from multimodal_llm_pretraining_tpu_torch.ops.attention import dot_product_attention

    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(2, 2, 33, 16, seed=3))
    flash = dot_product_attention(q, k, v, causal=causal, impl="flash")
    naive = dot_product_attention(q, k, v, causal=causal, impl="naive")
    torch.testing.assert_close(flash, naive, atol=ATOL_OUT, rtol=0)
    with pytest.raises(NotImplementedError, match="varlen"):
        dot_product_attention(q, k, v, mask=torch.ones(2, 33), impl="flash")
