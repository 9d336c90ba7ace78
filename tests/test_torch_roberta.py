"""RoBERTa-large (post-LN encoder, tied MLM decoder) in the PyTorch port
against the JAX model.

The JAX model reads its widths as module constants at call time
(``models/roberta.py:21-27``), so it is narrowed with pytest's
``MonkeyPatch`` as ``tests/test_torch_vit.py`` narrows ViT: 2 layers,
hidden 128 = 2 heads of 64, ffn 256, a 512-token vocab, 64 positions; the
port takes the widths as constructor arguments and reads ``MAX_POS`` (and
``build_model`` all of them) from its own module, narrowed the same way.
Weights are made once by the JAX init and carried across with
``roberta_params_from_jax``; ids come from numpy. The JAX attention is its
Pallas flash kernel in interpret mode (``attn_impl="pallas"``), the port's
the "flash" path, whose plain versions run on CPU tensors, under either
backward.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_llm_pretraining_tpu.models import get_model_class as jax_get_model_class
from multimodal_llm_pretraining_tpu.models import roberta as jroberta
from multimodal_llm_pretraining_tpu_torch.models import get_model_class
from multimodal_llm_pretraining_tpu_torch.models import roberta as troberta
from multimodal_llm_pretraining_tpu_torch.models.from_jax import roberta_params_from_jax
from multimodal_llm_pretraining_tpu_torch.ops import flash_attention as tfa
from multimodal_llm_pretraining_tpu_torch.profile_step import make_plan
from multimodal_llm_pretraining_tpu_torch.training import step as tstep

torch.set_num_threads(2)
torch.exp(torch.ones(4096))  # one-threaded first exp (tests/test_torch_flash_attention.py says why)

NARROW = dict(HIDDEN=128, LAYERS=2, HEADS=2, FFN=256, VOCAB=512, MAX_POS=64)
SEQ, BATCH = 40, 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@contextlib.contextmanager
def _narrow(*modules):
    with pytest.MonkeyPatch.context() as mp:
        for module in modules:
            for name, value in NARROW.items():
                mp.setattr(module, name, value)
        yield mp


def _ids(seed=0):
    """Ids and MLM labels: -100 except at about 15% of the positions."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, NARROW["VOCAB"], (BATCH, SEQ)).astype(np.int32)
    labels = np.where(rng.random((BATCH, SEQ)) < 0.15, ids, -100).astype(np.int32)
    labels[:, 0] = ids[:, 0]  # at least one label a row
    return ids, labels


def _torch_model(remat_policy=None):
    n = NARROW
    with _narrow(troberta):
        return troberta.RobertaMLM(n["HIDDEN"], n["LAYERS"], n["HEADS"], n["FFN"], n["VOCAB"], remat_policy=remat_policy)


@pytest.fixture(scope="module")
def jax_roberta():
    """JAX params (numpy), loss and grads with dropout off, f32 under
    "highest" precision."""
    ids, labels = _ids()
    with _narrow(jroberta):
        model = jroberta.RobertaMLM(attn_impl="pallas")
        params = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
        with jax.default_matmul_precision("highest"):
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: model.apply({"params": p}, jnp.asarray(ids), labels=jnp.asarray(labels))))(params)
    return _np(params), float(loss), roberta_params_from_jax(_np(grads))


def test_roberta_params_from_jax_fills_the_state_dict(jax_roberta):
    """Every port parameter gets a JAX leaf of its shape: the stack split,
    Dense kernels transposed, LayerNorm scales as weights; the tied decoder
    has no leaf of its own."""
    params = jax_roberta[0]
    converted = roberta_params_from_jax(params)
    own = _torch_model().state_dict()
    assert converted.keys() == own.keys()
    for name, t in converted.items():
        assert t.shape == own[name].shape, name
    np.testing.assert_array_equal(converted["layers.1.attn.qkv.weight"].numpy(), params["layers"]["attn"]["qkv"]["kernel"][1].T)
    np.testing.assert_array_equal(converted["word_embeddings"].numpy(), params["word_embeddings"])
    np.testing.assert_array_equal(converted["mlm_bias"].numpy(), params["mlm_bias"])


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_loss_and_grads_match_jax_f32(jax_roberta, fused, monkeypatch):
    """Dropout off, f32 end to end, both backwards of the port against the
    JAX kernels: the loss to 1e-5 relative, every grad to 1e-4 relative
    plus 1e-5 of that grad's largest entry. The word embedding takes two
    contributions (lookup and tied decoder) on both sides."""
    monkeypatch.setattr(tfa, "PREFER_FUSED_BWD", fused)
    params, jloss, jgrads = jax_roberta
    model = _torch_model()
    model.load_state_dict(roberta_params_from_jax(params))
    ids, labels = _ids()
    loss = model(torch.from_numpy(ids).long(), labels=torch.from_numpy(labels).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert grads.keys() == jgrads.keys()
    for name, want in jgrads.items():
        want = want.numpy()
        np.testing.assert_allclose(grads[name].numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max() + 1e-9,
                                   err_msg=name)


def test_recipe_and_full_size_parameter_count_match_jax():
    """The whole recipe and the widths are the JAX package's; built on the
    meta device the model holds 355,408,985 parameters, the JAX abstract
    init's count; with remat every block runs under "flash"."""
    j, t = jax_get_model_class("roberta"), get_model_class("roberta")
    for attr in ("batch_size", "training_steps", "mixed_precision", "optimizer", "optimizer_kwargs",
                 "scheduler_kwargs", "max_grad_norm", "fsdp_layers_to_wrap", "supports_activation_checkpointing",
                 "vocab_size", "sequence_length"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.scheduler_type.value == j.scheduler_type.value
    for name in (*NARROW, "LN_EPS"):
        assert getattr(troberta, name) == getattr(jroberta, name), name
    assert troberta.DROPOUT == jroberta.RobertaMLM.dropout == jroberta.RobertaBlock.dropout
    module = t.build_model(device="meta").module
    shapes = jax.eval_shape(j.build_model().init_fn, jax.random.key(0))
    count = sum(p.numel() for p in module.parameters())
    assert count == 355_408_985 == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert module.remat_policy is None
    assert t.build_model(activation_checkpointing=True, device="meta").module.remat_policy == "flash"


def test_dropout_only_with_a_generator(jax_roberta):
    """A generator applies dropout (another loss, repeatable from the seed);
    without one the loss is the deterministic model's, the JAX one."""
    model = _torch_model()
    model.load_state_dict(roberta_params_from_jax(jax_roberta[0]))
    ids, labels = (torch.from_numpy(a).long() for a in _ids())
    with torch.no_grad():
        plain = model(ids, labels=labels)
        drop = [model(ids, labels=labels, generator=torch.Generator().manual_seed(1)) for _ in range(2)]
    np.testing.assert_allclose(float(plain), jax_roberta[1], rtol=1e-5)
    assert torch.equal(drop[0], drop[1]) and not torch.equal(drop[0], plain)


def test_remat_grads_equal_no_remat_with_dropout(jax_roberta):
    """Every block under ``checkpoint_block``'s "flash" policy, dropout on:
    the loss and every grad bit for bit those without remat from the same
    generator seed (the recompute replays the masks), and the generator in
    the same state after the backward."""
    runs = {}
    for policy in (None, "flash"):
        model = _torch_model(remat_policy=policy)
        model.load_state_dict(roberta_params_from_jax(jax_roberta[0]))
        gen = torch.Generator().manual_seed(3)
        ids, labels = (torch.from_numpy(a).long() for a in _ids())
        loss = model(ids, labels=labels, generator=gen)
        loss.backward()
        runs[policy] = loss.detach(), {n: p.grad for n, p in model.named_parameters()}, gen.get_state()
    (l0, g0, s0), (l1, g1, s1) = runs[None], runs["flash"]
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_one_f32_session_step(monkeypatch):
    """``get_model_class("roberta")`` -> ``make_plan(..., "f32")`` ->
    session -> one step on the CPU, narrowed: f32 params and moments, the
    loss equal to the two micro-batch losses recomputed with the session's
    dropout generator replayed from ``DROPOUT_SEED`` (so the step trained
    with dropout on), and the first loss near ln 512 (the tied rows are
    N(0, 0.02^2)). The linear schedule starts at lr 0, so a second step is
    what moves every parameter."""
    monkeypatch.setattr(troberta.RobertaModelClass, "sequence_length", property(lambda self: SEQ))
    with _narrow(troberta):
        mc = get_model_class("roberta")
        sess = make_plan(mc, 2, 2, False, "f32").build_session(mc, device="cpu")
    state = sess.init_state()
    before = {n: p.detach().clone() for n, p in state.params.items()}
    batch = sess.make_train_batch(seed=0)
    replay = torch.Generator().manual_seed(tstep.DROPOUT_SEED)
    with torch.no_grad():
        want = sum(float(sess.bundle.loss_fn(sess.module, {k: v[i] for k, v in batch.items()}, replay)[0])
                   for i in range(2)) / 2
    state, metrics = sess.train_step_fn()(state, batch)
    assert float(metrics["loss"]) == pytest.approx(want, rel=1e-6)
    assert abs(want - np.log(NARROW["VOCAB"])) < 0.5
    state, metrics = sess.train_step_fn()(state, sess.make_train_batch(seed=1))
    assert np.isfinite(float(metrics["loss"]))
    assert all(m.dtype == torch.float32 for m in state.opt_state.mu + state.opt_state.nu)
    for n, p in state.params.items():
        assert p.dtype == torch.float32 and not torch.equal(p, before[n]), n
