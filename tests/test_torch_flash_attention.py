"""Flash attention in the PyTorch port against the JAX Pallas kernels.

The JAX side runs its forward kernel and its backward in interpret mode on
the CPU; the port's side runs its plain versions (``flash_fwd_reference``,
and ``flash_bwd_reference`` or the split ``flash_bwd_dq_reference`` /
``flash_bwd_dkv_reference``) and the custom op ``mlpt::flash_fwd`` with its
autograd (which take the plain versions for CPU tensors). A test's ``fused`` parameter pins
``PREFER_FUSED_BWD`` on both sides together: the fused single-pass backward,
or the split dq and dk/dv kernels. Inputs come from one numpy generator and
go to both. The varlen cases give both sides the same right-padded [B, S]
keep-mask. Every JAX call runs under "highest" matmul precision.

The module calls ``torch.exp`` once, single-threaded, at import. The first
``torch.exp`` of a process that runs on two intra-op threads can return
values about 1e-4 off in relative terms (seen in about 1 of 25 fresh
processes on a loaded 8-core CPU, never in a later call nor with one
thread or after a single-threaded first call), which put ``out`` 3.1e-5
off (bound 2e-5) in whichever case of this file ran first in its worker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_llm_pretraining_tpu.ops import flash_attention as jfa
from multimodal_llm_pretraining_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)
torch.exp(torch.ones(4096))  # below the parallel grain size: one thread; see above

# f32 under "highest" matmul precision: the tolerances of tests/test_ops.py
ATOL_OUT = 2e-5
ATOL_GRAD = 5e-4


def _inputs(b, h, s, d, seed, kv_seq=None):
    """q, k, v, dO drawn in that order; k and v have ``kv_seq`` rows."""
    rng = np.random.default_rng(seed)
    shapes = [(b, h, s, d), (b, h, kv_seq or s, d), (b, h, kv_seq or s, d), (b, h, s, d)]
    return [rng.normal(size=shape).astype(np.float32) for shape in shapes]


def _jax_side(q, k, v, do, causal, block, dtype, mask=None):
    """(out, lse, dq, dk, dv) from the Pallas kernels in interpret mode under
    "highest" precision; ``mask`` ([B, Sk] keep-mask) takes their varlen
    mode."""
    b, h, s, d = q.shape
    sk = k.shape[2]
    jq, jk, jv, jdo = (jnp.asarray(x, dtype) for x in (q, k, v, do))
    jmask = None if mask is None else jnp.asarray(mask)
    scale = d**-0.5

    def f(q, k, v):
        return jfa.flash_attention(q, k, v, causal=causal, block_q=block, block_k=block, kv_len_mask=jmask)

    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(f, jq, jk, jv)
        dq, dk, dv = vjp(jdo)
        lens = None if mask is None else jnp.asarray(np.repeat(mask.sum(-1), h)[:, None].astype(np.int32))
        _, lse = jfa._fwd_impl(jq.reshape(b * h, s, d), jk.reshape(b * h, sk, d), jv.reshape(b * h, sk, d), causal,
                               scale, block, block, kv_lens=lens)
    return [np.asarray(jnp.asarray(x, jnp.float32)) for x in (out, lse.reshape(b, h, s), dq, dk, dv)]


def _torch_side(q, k, v, do, causal, dtype, mask=None):
    """(out, lse, dq, dk, dv) from the plain versions of the backward that
    ``tfa.PREFER_FUSED_BWD`` selects, and (out, dq, dk, dv) through the
    autograd Function."""
    h, d = q.shape[1], q.shape[-1]
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    tmask = None if mask is None else torch.from_numpy(mask)
    lens = None if mask is None else torch.from_numpy(np.repeat(mask.sum(-1), h).astype(np.int32))
    out, lse = tfa.flash_fwd_reference(tq, tk, tv, causal, d**-0.5, lens)
    if tfa.PREFER_FUSED_BWD:
        grads = tfa.flash_bwd_reference(tq, tk, tv, out, lse, tdo, causal, d**-0.5, lens)
    else:
        grads = tfa.flash_bwd_split_reference(tq, tk, tv, out, lse, tdo, causal, d**-0.5, lens)
    plain = [out, lse, *grads]
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    fout = tfa.flash_attention(*leaves, causal=causal, kv_len_mask=tmask)
    fgrads = torch.autograd.grad(fout, leaves, grad_outputs=tdo)
    fn = [fout, *fgrads]
    return [t.detach().float().numpy() for t in plain], [t.detach().float().numpy() for t in fn]


def both_backwards(argnames: str = "", cases=((),)):
    """Parametrize over ``cases`` and ``fused``: each case under the fused
    backward keeps the id it had before the split backward was ported, and
    runs again under the split one, its id prefixed ``split``."""
    ids = ["-".join(str(x) for x in case) for case in cases]
    params = [pytest.param(*case, True, id=i or "fused") for case, i in zip(cases, ids)]
    params += [pytest.param(*case, False, id="-".join(("split", i)) if i else "split") for case, i in zip(cases, ids)]
    return pytest.mark.parametrize(",".join(filter(None, (argnames, "fused"))), params)


@pytest.fixture(autouse=True)
def _pin_backward(request, monkeypatch):
    """The backward on both sides: the test's ``fused`` (the fused
    single-pass kernel, or the split dq and dk/dv kernels), fused if it has
    none."""
    callspec = getattr(request.node, "callspec", None)
    fused = callspec.params.get("fused", True) if callspec else True
    monkeypatch.setattr(jfa, "PREFER_FUSED_BWD", fused)
    monkeypatch.setattr(tfa, "PREFER_FUSED_BWD", fused)


def _assert_f32_close(plain, fn, ref):
    for name, got, want in zip(("out", "lse", "dq", "dk", "dv"), plain, ref):
        np.testing.assert_allclose(got, want, atol=ATOL_OUT if name in ("out", "lse") else ATOL_GRAD, err_msg=name)
    for name, got, want in zip(("out", "dq", "dk", "dv"), fn, [ref[0], *ref[2:]]):
        np.testing.assert_allclose(got, want, atol=ATOL_OUT if name == "out" else ATOL_GRAD, err_msg=f"Function {name}")


@both_backwards("head_dim,seq,causal",
                [(d, s, c) for d in (64, 256) for s in (200, 600) for c in (False, True)] + [(80, 200, True)])
def test_plain_versions_match_pallas_kernels_f32(head_dim, seq, causal, fused):
    """Blocks of 64 (S=200) and 128 (S=600) leave ragged tails on both axes.
    Head dim 80 (pythia-2.8b's) is one the port's kernels run zero-padded to
    128; the plain versions take it as it is."""
    q, k, v, do = _inputs(1, 2, seq, head_dim, seed=seq + head_dim)
    block = 64 if seq == 200 else 128
    ref = _jax_side(q, k, v, do, causal, block, jnp.float32)
    _assert_f32_close(*_torch_side(q, k, v, do, causal, torch.float32), ref)


@both_backwards()
def test_plain_versions_match_pallas_kernels_rectangular(fused):
    """q 300 against kv 150 (``tests/test_ops.py``'s cross-attention case),
    blocks of 128: the bounds masks of both backwards with kv_seq != q_seq
    and ragged tails on both axes; the f32 tolerances above."""
    q, k, v, do = _inputs(1, 2, 300, 64, seed=8, kv_seq=150)
    ref = _jax_side(q, k, v, do, False, 128, jnp.float32)
    _assert_f32_close(*_torch_side(q, k, v, do, False, torch.float32), ref)


@both_backwards()
def test_plain_versions_match_pallas_kernels_bf16(fused):
    """bf16 inputs: both sides round the same operands (q*scale or k*scale,
    p, ds) to bf16 and accumulate in f32, but sum in another order and round
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


@pytest.mark.parametrize("fused", [False], ids=["split"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("q_seq,kv_seq", [(63, 63), (65, 65), (129, 129), (65, 200), (200, 65)])
def test_split_plain_versions_match_pallas_split_kernels_at_block_edges(q_seq, kv_seq, causal, fused):
    """The split pair's plain versions against JAX's ``_bwd_dq_kernel`` and
    ``_bwd_dkv_kernel`` (interpret mode) at lengths around their 64-row
    blocks, the split kernels' tile edges too, kv_seq other than q_seq both
    ways, D=64; the f32 tolerances above."""
    q, k, v, do = _inputs(1, 2, q_seq, 64, seed=q_seq + 3 * kv_seq + causal, kv_seq=kv_seq)
    ref = _jax_side(q, k, v, do, causal, 64, jnp.float32)
    _assert_f32_close(*_torch_side(q, k, v, do, causal, torch.float32), ref)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_dispatcher_flash_matches_naive(causal):
    """``dot_product_attention``: the "flash" impl (plain versions on CPU)
    against the f32 eager "naive" impl, without a mask and with a
    right-padded [B, S] keep-mask (varlen on the flash side, an additive
    -inf key bias on the naive side), every row compared."""
    from multimodal_llm_pretraining_tpu_torch.ops.attention import dot_product_attention

    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(2, 2, 33, 16, seed=3))
    mask = (torch.arange(33)[None, :] < torch.tensor([[33], [20]])).long()
    for m in (None, mask):
        flash = dot_product_attention(q, k, v, causal=causal, mask=m, impl="flash")
        naive = dot_product_attention(q, k, v, causal=causal, mask=m, impl="naive")
        torch.testing.assert_close(flash, naive, atol=ATOL_OUT, rtol=0)


# ---------------------------------------------------------------- varlen mode


def _padding_mask(lens, seq):
    return (np.arange(seq)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)


@both_backwards("causal", [(False,), (True,)])
def test_varlen_plain_versions_match_pallas_kernels_f32(causal, fused):
    """Lens [300, 135] at S=300, D=64, blocks of 128 (``tests/test_ops.py``'s
    varlen case: one full row, one padded inside a k block). out, lse and
    dq, dk, dv compared everywhere, padded query rows included, with the
    f32 tolerances above; dk and dv are exactly 0 past each length on both
    sides."""
    q, k, v, do = _inputs(2, 2, 300, 64, seed=21 + causal)
    mask = _padding_mask([300, 135], 300)
    ref = _jax_side(q, k, v, do, causal, 128, jnp.float32, mask)
    plain, fn = _torch_side(q, k, v, do, causal, torch.float32, mask)
    _assert_f32_close(plain, fn, ref)
    for got, want in ((plain[3], ref[3]), (plain[4], ref[4])):
        assert not got[1, :, 135:].any() and not want[1, :, 135:].any()


def test_varlen_mask_always_takes_the_varlen_mode():
    """A mask whose rows are all full gives the plain mode's numbers, but
    runs the varlen mode (the plain versions see lens); a non-prefix mask is
    read as the prefix of its sum, the JAX contract."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(2, 2, 40, 16, seed=5))
    full = torch.ones(2, 40, dtype=torch.long)
    torch.testing.assert_close(tfa.flash_attention(q, k, v, causal=True, kv_len_mask=full),
                               tfa.flash_attention(q, k, v, causal=True), rtol=0, atol=0)
    holes = torch.ones(2, 40, dtype=torch.long)
    holes[:, 3:10] = 0  # sum 33: read as keys [0, 33)
    prefix = torch.from_numpy(_padding_mask([33, 33], 40))
    torch.testing.assert_close(tfa.flash_attention(q, k, v, kv_len_mask=holes),
                               tfa.flash_attention(q, k, v, kv_len_mask=prefix), rtol=0, atol=0)


def test_varlen_row_that_sees_no_key_gives_zeros():
    """A zero length leaves every query row of that batch element without a
    visible key: out 0 and lse -1e30, as the kernels' l_safe guard gives,
    and zero gradients for that element."""
    q, k, v, do = (torch.from_numpy(x).reshape(4, 9, 16) for x in _inputs(2, 2, 9, 16, seed=6))
    lens = torch.tensor([9, 9, 0, 0], dtype=torch.int32)
    out, lse = tfa.flash_fwd_reference(q, k, v, False, 0.25, lens)
    assert not out[2:].any() and bool((lse[2:] == tfa.NEG_INF).all())
    delta = tfa.bwd_delta(out, do)
    split = (tfa.flash_bwd_dq_reference(q, k, v, do, lse, delta, False, 0.25, lens),
             *tfa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, False, 0.25, lens))
    for g in (*tfa.flash_bwd_reference(q, k, v, out, lse, do, False, 0.25, lens), *split):
        assert not g[2:].any()
