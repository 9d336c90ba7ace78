"""The port's LM-head loss (``multimodal_llm_pretraining_tpu_torch/ops/xent.py``)
on the CPU, where its ``autograd.Function`` runs the kernels' plain versions,
against the JAX package's ``lm_head_loss``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_llm_pretraining_tpu.ops.xent import lm_head_loss
from multimodal_llm_pretraining_tpu_torch.ops import xent as txent

# f32: both sides compute the same f32 arithmetic in another summation order.
# bf16: the logits are f32 from exact bf16 products on both sides, so the loss
# keeps f32's tolerance; the port rounds dlogits to bf16 before the head's
# products (a default-precision dot's operands on the TPU) where JAX's CPU
# dot takes them in f32, and both round dx and each chunk's dW (summed in
# bf16) to bf16: a few roundings of 2^-9 each, under 1e-2 of each norm.
PORT_LOSS_RTOL = 1e-6
PORT_GRAD_NORM_REL = {"float32": 1e-6, "bfloat16": 1e-2}


@pytest.mark.parametrize("frozen_head", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_loss_matches_jax(dtype, with_bias, frozen_head):
    """The port's ``lm_head_loss`` against the JAX package's: the loss and the
    gradients of hidden and kernel (and bias). 2 x 41 shifted tokens in
    chunks of 16, so the last chunk holds 2 rows; the second chunk's labels
    are all ignore_index and a few others too; vocab 50, not a multiple of 8,
    so the port pads the head to 56 columns that the loss never reads. A
    frozen head (llava's tied embedding) gets no gradient, and its [H, V]
    product is never computed: the backward runs two products a chunk, not
    three."""
    rng = np.random.default_rng(7)
    hidden = rng.normal(size=(2, 42, 32)).astype(np.float32)
    kernel = (rng.normal(size=(32, 50)) * 0.3).astype(np.float32)
    bias = rng.normal(size=(50,)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 42))
    labels[0, 17:33] = -100  # flat rows 16-31 after the shift: the whole second chunk
    labels[1, [3, 20, 41]] = -100
    b = bias if with_bias else None

    def jloss(h, k, bb):
        return lm_head_loss(h, k, jnp.asarray(labels, jnp.int32), chunk_size=16, bias=bb)

    jdt = jnp.dtype(dtype)
    jargs = (jnp.asarray(hidden, jdt), jnp.asarray(kernel, jdt), None if b is None else jnp.asarray(b, jdt))
    argnums = (0,) if frozen_head else (0, 1, 2) if with_bias else (0, 1)
    with jax.default_matmul_precision("highest"):
        jl, jgrads = jax.value_and_grad(jloss, argnums=argnums)(*jargs)

    tdt = getattr(torch, dtype)
    th = torch.from_numpy(hidden).to(tdt).requires_grad_()
    tk = torch.from_numpy(kernel).to(tdt).requires_grad_(not frozen_head)
    tb = torch.from_numpy(bias).to(tdt).requires_grad_(not frozen_head) if with_bias else None
    products = []
    real_mm = txent._mm

    def counted_mm(a, w, out_dtype, out=None):
        products.append(tuple(a.shape))
        return real_mm(a, w, out_dtype, out)

    launches = (txent.XENT_FWD_LAUNCHES, txent.XENT_BWD_LAUNCHES)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(txent, "_mm", counted_mm)
        tl = txent.lm_head_loss(th, tk, torch.from_numpy(labels), chunk_size=16, bias=tb)
        assert len(products) == 6  # one head product a chunk
        tl.backward()
    assert len(products) == 6 + 6 * (2 if frozen_head else 3)
    assert (txent.XENT_FWD_LAUNCHES, txent.XENT_BWD_LAUNCHES) == launches  # the plain versions ran
    np.testing.assert_allclose(tl.item(), float(jl), rtol=PORT_LOSS_RTOL)
    got = [th.grad] + ([] if frozen_head else [tk.grad] + ([tb.grad] if with_bias else []))
    for g, want in zip(got, jgrads, strict=True):
        assert g.dtype == tdt
        want = np.asarray(want, np.float32)
        err = np.linalg.norm(g.float().numpy() - want) / np.linalg.norm(want)
        assert err <= PORT_GRAD_NORM_REL[dtype], err
    if frozen_head:
        assert tk.grad is None and (tb is None or tb.grad is None)


def test_port_plain_versions_zero_what_the_kernels_never_read():
    """The plain versions of the port's kernels: lse 0 and nll 0 on an
    ignored row, and a zero gradient there and in the head's padded columns;
    the kernel wrappers refuse CPU tensors (no fallback)."""
    rng = np.random.default_rng(9)
    logits = torch.from_numpy(rng.normal(size=(5, 12)).astype(np.float32))
    labels = torch.tensor([3, -100, 9, 0, -100])
    logits[:, 10:] = float("nan")  # the head's padding, and the ignored rows: read, they would give NaN
    logits[labels == -100] = float("nan")
    lse, nll = txent.xent_fwd_reference(logits, labels, 10, -100)
    want = torch.logsumexp(logits[:, :10], -1)
    valid = labels != -100
    torch.testing.assert_close(lse[valid], want[valid], rtol=0, atol=0)
    assert (lse[~valid] == 0).all() and (nll[~valid] == 0).all()
    gold = logits[valid, labels[valid]]
    torch.testing.assert_close(nll[valid], want[valid] - gold, rtol=0, atol=0)
    for dtype in (torch.float32, torch.bfloat16):
        d = txent.xent_bwd_reference(logits, labels, lse, torch.tensor(0.5), 10, -100, dtype)
        assert d.dtype == dtype and d.shape == (5, 12)
        assert (d[~valid] == 0).all() and (d[:, 10:] == 0).all()
        p = torch.softmax(logits[valid, :10], -1)
        p[torch.arange(3), labels[valid]] -= 1
        torch.testing.assert_close(d[valid, :10], (0.5 * p).to(dtype))
    with pytest.raises(ValueError, match="CUDA"):
        txent.xent_fwd_cuda(logits, labels, 10, -100, torch.zeros(5), torch.zeros(5))
    with pytest.raises(ValueError, match="CUDA"):
        txent.xent_bwd_cuda(logits, labels, lse, torch.tensor(0.5), 10, -100, torch.bfloat16)
