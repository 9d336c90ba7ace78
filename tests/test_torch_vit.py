"""ViT-L/16 in the PyTorch port against the JAX model.

The JAX model reads its widths as module constants at call time
(``models/vit.py:22-27``), so it is narrowed with pytest's ``MonkeyPatch``
as ``tests/test_torch_mamba.py`` narrows mamba; the port takes the same
widths as constructor arguments (and its ``build_model`` reads its own module
constants the same way). Weights are made once by the JAX init and carried
across with ``vit_params_from_jax``; pixels and labels come from numpy. The
JAX attention is its Pallas flash kernel in interpret mode
(``attn_impl="pallas"``), the port's the "flash" path, whose plain versions
run on CPU tensors, under either backward.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_llm_pretraining_tpu.models import get_model_class as jax_get_model_class
from multimodal_llm_pretraining_tpu.models import layers as jlayers
from multimodal_llm_pretraining_tpu.models import vit as jvit
from multimodal_llm_pretraining_tpu_torch.models import get_model_class
from multimodal_llm_pretraining_tpu_torch.models import layers as tlayers
from multimodal_llm_pretraining_tpu_torch.models import vit as tvit
from multimodal_llm_pretraining_tpu_torch.models.from_jax import vit_params_from_jax
from multimodal_llm_pretraining_tpu_torch.ops import flash_attention as tfa
from multimodal_llm_pretraining_tpu_torch.profile_step import make_plan
from multimodal_llm_pretraining_tpu_torch.training import step as tstep

torch.set_num_threads(2)
torch.exp(torch.ones(4096))  # one-threaded first exp (tests/test_torch_flash_attention.py says why)

# 2 blocks, hidden 128, 2 heads of 64, ffn 256; 48-pixel images (9 patches +
# the class token), 10 classes
NARROW = dict(HIDDEN=128, LAYERS=2, HEADS=2, FFN=256)
IMAGE, CLASSES, BATCH = 48, 10, 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@contextlib.contextmanager
def _narrow(*modules):
    with pytest.MonkeyPatch.context() as mp:
        for module in modules:
            for name, value in NARROW.items():
                mp.setattr(module, name, value)
        yield mp


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((BATCH, IMAGE, IMAGE, 3), dtype=np.float32), rng.integers(0, CLASSES, BATCH).astype(np.int32)


def _torch_model(attn_impl="flash"):
    return tvit.ViTClassifier(CLASSES, IMAGE, NARROW["HIDDEN"], NARROW["LAYERS"], NARROW["HEADS"], NARROW["FFN"],
                              attn_impl=attn_impl)


@pytest.fixture(scope="module")
def jax_vit():
    """JAX params (numpy), logits, loss and grads with dropout off, in f32
    under "highest" precision."""
    pix, labels = _batch()
    with _narrow(jvit):
        model = jvit.ViTClassifier(num_classes=CLASSES, image_size=IMAGE, attn_impl="pallas")
        params = model.init(jax.random.key(0), jnp.zeros((1, IMAGE, IMAGE, 3), jnp.float32))["params"]

        def loss_fn(p):
            logits = model.apply({"params": p}, jnp.asarray(pix), deterministic=True)
            return jlayers.cross_entropy_loss(logits[:, None, :], jnp.asarray(labels)[:, None]), logits

        with jax.default_matmul_precision("highest"):
            (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return _np(params), np.asarray(logits), float(loss), vit_params_from_jax(_np(grads))


def test_vit_params_from_jax_fills_the_state_dict(jax_vit):
    """Every port parameter gets a JAX leaf of its shape: the stacked blocks
    split, Dense kernels transposed, LayerNorm scales as weights, the class
    token and positions kept."""
    params = jax_vit[0]
    converted = vit_params_from_jax(params)
    own = _torch_model().state_dict()
    assert converted.keys() == own.keys()
    for name, t in converted.items():
        assert t.shape == own[name].shape, name
    np.testing.assert_array_equal(converted["layers.1.mlp.up.weight"].numpy(), params["layers"]["mlp"]["up"]["kernel"][1].T)
    np.testing.assert_array_equal(converted["position_embeddings"].numpy(), params["position_embeddings"])
    np.testing.assert_array_equal(converted["layers.0.ln_attn.weight"].numpy(), params["layers"]["ln_attn"]["scale"][0])


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_logits_loss_and_grads_match_jax_f32(jax_vit, fused, monkeypatch):
    """Dropout off, f32 end to end, both backwards of the port against the
    JAX fused kernels: logits to 1e-5 absolute (they are O(1)), the loss to
    1e-5 relative, every grad to 1e-4 relative plus 1e-5 of that grad's
    largest entry (the attention sums run in another order on the two
    sides, as in ``tests/test_torch_flash_attention.py``)."""
    monkeypatch.setattr(tfa, "PREFER_FUSED_BWD", fused)
    params, jlogits, jloss, jgrads = jax_vit
    model = _torch_model()
    model.load_state_dict(vit_params_from_jax(params))
    pix, labels = _batch()
    logits = model(torch.from_numpy(pix))
    loss = tlayers.cross_entropy_loss(logits, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, rtol=0, atol=1e-5)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert grads.keys() == jgrads.keys()
    for name, want in jgrads.items():
        want = want.numpy()
        np.testing.assert_allclose(grads[name].numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max() + 1e-9,
                                   err_msg=name)


def test_dropout_keeps_nine_tenths_scaled_by_one_over_point_nine():
    """1e6 draws at rate 0.1: the kept share lies within 3e-3 of 0.9 (ten
    standard deviations of the share, 3e-4); every kept value is x / 0.9 and
    every other exactly 0; the same seed gives the same mask; no generator
    (or rate 0) passes x through."""
    x = torch.full((1000, 1000), 2.0)
    y = tlayers.dropout(x, 0.1, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 3e-3
    assert bool((y[kept] == x[kept] / 0.9).all())
    assert torch.equal(y, tlayers.dropout(x, 0.1, torch.Generator().manual_seed(0)))
    assert tlayers.dropout(x, 0.1, None) is x and tlayers.dropout(x, 0.0, torch.Generator()) is x


def test_loss_fn_draws_dropout_only_when_training(jax_vit):
    """A generator applies dropout (another loss than the deterministic one,
    repeatable from the seed); without one the loss is the deterministic
    model's, the JAX model's own."""
    with _narrow(tvit):
        bundle = get_model_class("vit").build_model(device="cpu")
    module = _torch_model()
    module.load_state_dict(vit_params_from_jax(jax_vit[0]))
    pix, labels = _batch()
    batch = {"pixel_values": torch.from_numpy(pix), "labels": torch.from_numpy(labels).long()}
    with torch.no_grad():
        plain = bundle.loss_fn(module, batch)[0]
        drop = [bundle.loss_fn(module, batch, torch.Generator().manual_seed(1))[0] for _ in range(2)]
    np.testing.assert_allclose(float(plain), jax_vit[2], rtol=1e-5)
    assert torch.equal(drop[0], drop[1]) and not torch.equal(drop[0], plain)


def test_recipe_matches_jax():
    """The whole training recipe and the widths are copies of the JAX
    package's."""
    j, t = jax_get_model_class("vit"), get_model_class("vit")
    for attr in (
        "batch_size", "training_steps", "mixed_precision", "optimizer", "optimizer_kwargs", "scheduler_kwargs",
        "max_grad_norm", "fsdp_layers_to_wrap", "supports_activation_checkpointing", "image_size", "num_classes",
    ):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.scheduler_type.value == j.scheduler_type.value
    for name in ("HIDDEN", "LAYERS", "HEADS", "FFN", "PATCH", "LN_EPS"):
        assert getattr(tvit, name) == getattr(jvit, name), name
    assert tvit.DROPOUT == jvit.ViTClassifier.dropout == jvit.ViTBlock.dropout
    ds = t.load_dummy_dataset().sample_batch(2, seed=3)
    jds = j.load_dummy_dataset().sample_batch(2, seed=3)
    for name in ("pixel_values", "labels"):
        np.testing.assert_array_equal(ds[name], jds[name])


def test_full_size_parameter_count():
    """ViT-L/16 built on the meta device: 325,688,657 parameters, the count
    of the JAX model's abstract init; 24 blocks; remat refused with the
    ROADMAP item until the remat policies are ported."""
    bundle = get_model_class("vit").build_model(device="meta")
    count = sum(p.numel() for p in bundle.module.parameters())
    shapes = jax.eval_shape(lambda: jvit.ViTClassifier().init(jax.random.key(0), jnp.zeros((1, 224, 224, 3))))["params"]
    assert count == 325_688_657 == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert len(bundle.module.layers) == 24 and bundle.module.position_embeddings.shape == (1, 197, 1024)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model_class("vit").build_model(activation_checkpointing=True, device="meta")


def test_one_f32_session_step(monkeypatch):
    """``get_model_class("vit")`` -> ``make_plan(..., "f32")`` -> session
    -> one step on the CPU, narrowed: f32 params and moments, the loss equal
    to the two micro-batch losses recomputed with the session's dropout
    generator replayed from ``DROPOUT_SEED`` (so the step trained with
    dropout on), and the first loss near ln 10 plus half the logits' unit
    variance. The linear schedule starts at lr 0, so a second step is what
    moves every parameter."""
    monkeypatch.setattr(tvit.ViTModelClass, "image_size", property(lambda self: IMAGE))
    monkeypatch.setattr(tvit.ViTModelClass, "num_classes", property(lambda self: CLASSES))
    with _narrow(tvit):
        mc = get_model_class("vit")
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
    assert 1.3 < want < 3.3
    state, metrics = sess.train_step_fn()(state, sess.make_train_batch(seed=1))
    assert np.isfinite(float(metrics["loss"]))
    assert all(m.dtype == torch.float32 for m in state.opt_state.mu + state.opt_state.nu)
    for n, p in state.params.items():
        assert p.dtype == torch.float32 and not torch.equal(p, before[n]), n
