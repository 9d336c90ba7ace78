"""ConvNeXt (NHWC, depthwise 7x7, layer scale) in the PyTorch port against
the JAX model.

Narrow on both sides: depths (1, 1, 2, 1), dims (16, 32, 64, 128), 10
classes; 64-px images (no padding for the stem and the downsamplers) and
70-px ones (flax's SAME padding: one row and column each side of the stem,
then odd sizes at the downsamplers). The JAX module takes these as fields.
Weights are made once by the JAX init and carried across with
``convnext_params_from_jax``; pixels and labels come from numpy. There is
no attention and no kernel of the port on this path: the convolutions are
``F.conv2d`` on both devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_llm_pretraining_tpu.models import convnext as jconvnext
from multimodal_llm_pretraining_tpu.models import get_model_class as jax_get_model_class
from multimodal_llm_pretraining_tpu.models import layers as jlayers
from multimodal_llm_pretraining_tpu_torch.models import convnext as tconvnext
from multimodal_llm_pretraining_tpu_torch.models import get_model_class
from multimodal_llm_pretraining_tpu_torch.models import layers as tlayers
from multimodal_llm_pretraining_tpu_torch.models.from_jax import convnext_params_from_jax
from multimodal_llm_pretraining_tpu_torch.profile_step import make_plan

torch.set_num_threads(2)

NARROW = dict(depths=(1, 1, 2, 1), dims=(16, 32, 64, 128), num_classes=10)
BATCH = 3
CONVNEXT_TYPES = ("convnext-large-1k", "convnext-large-22k", "convnext-xlarge-22k")
FULL_COUNTS = {"convnext-large-1k": 197_767_336, "convnext-large-22k": 229_799_953,
               "convnext-xlarge-22k": 392_900_177}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(image: int, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((BATCH, image, image, 3), dtype=np.float32), rng.integers(0, 10, BATCH).astype(np.int32)


@pytest.fixture(scope="module")
def jax_params():
    model = jconvnext.ConvNextClassifier(**NARROW)
    return _np(jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 64, 64, 3), jnp.float32))["params"])


def _jax_run(params, image: int):
    """Logits, loss and grads of the JAX model, f32 under "highest"."""
    model = jconvnext.ConvNextClassifier(**NARROW)
    pix, labels = _batch(image)

    def loss_fn(p):
        logits = model.apply({"params": p}, jnp.asarray(pix))
        return jlayers.cross_entropy_loss(logits[:, None, :], jnp.asarray(labels)[:, None]), logits

    with jax.default_matmul_precision("highest"):
        (loss, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return np.asarray(logits), float(loss), convnext_params_from_jax(_np(grads))


def _torch_model(params, remat_policy=None):
    model = tconvnext.ConvNextClassifier(**NARROW, remat_policy=remat_policy)
    model.load_state_dict(convnext_params_from_jax(params))
    return model


def test_convnext_params_from_jax_fills_the_state_dict(jax_params):
    """Every port parameter gets a JAX leaf of its shape: each stage's stack
    split into ``stage_i.j``, conv kernels [kh, kw, in / groups, out]
    permuted to [out, in / groups, kh, kw], Dense kernels transposed,
    LayerNorm scales as weights."""
    converted = convnext_params_from_jax(jax_params)
    own = tconvnext.ConvNextClassifier(**NARROW).state_dict()
    assert converted.keys() == own.keys()
    for name, t in converted.items():
        assert t.shape == own[name].shape, name
    dw = jax_params["stage_2"]["dwconv"]["kernel"][1]  # [7, 7, 1, 64]
    np.testing.assert_array_equal(converted["stage_2.1.dwconv.weight"].numpy(), dw.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(converted["stem_conv.weight"].numpy(),
                                  jax_params["stem_conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(converted["stage_0.0.pw_up.weight"].numpy(), jax_params["stage_0"]["pw_up"]["kernel"][0].T)
    np.testing.assert_array_equal(converted["stage_3.0.layer_scale"].numpy(), jax_params["stage_3"]["layer_scale"][0])


@pytest.mark.parametrize("image", [64, 70])
def test_logits_loss_and_grads_match_jax_f32(jax_params, image):
    """f32 end to end: logits to 1e-5 absolute, the loss to 1e-5 relative,
    every grad to 1e-4 relative plus 1e-5 of that grad's largest entry (the
    convolutions sum in another order on the two sides)."""
    jlogits, jloss, jgrads = _jax_run(jax_params, image)
    model = _torch_model(jax_params)
    pix, labels = _batch(image)
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


@pytest.mark.parametrize("model_type", CONVNEXT_TYPES)
def test_recipe_and_full_size_parameter_count_match_jax(model_type):
    """The recipe properties and the configurations are the JAX package's;
    built on the meta device each model holds the JAX abstract init's
    parameter count."""
    j, t = jax_get_model_class(model_type), get_model_class(model_type)
    for attr in ("batch_size", "training_steps", "mixed_precision", "optimizer", "optimizer_kwargs",
                 "scheduler_kwargs", "max_grad_norm", "fsdp_layers_to_wrap", "supports_activation_checkpointing",
                 "image_size", "num_classes"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.scheduler_type.value == j.scheduler_type.value
    assert tconvnext.CONFIGS == jconvnext.CONFIGS and tconvnext.LN_EPS == jconvnext.LN_EPS
    module = t.build_model(device="meta").module
    shapes = jax.eval_shape(j.build_model().init_fn, jax.random.key(0))
    count = sum(p.numel() for p in module.parameters())
    assert count == FULL_COUNTS[model_type] == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert module.remat_policy is None
    assert t.build_model(activation_checkpointing=True, device="meta").module.remat_policy == "flash"


def test_remat_grads_equal_no_remat(jax_params):
    """Every block recomputed in the backward (``checkpoint_block`` with no
    flash op keeps nothing): the loss and every grad bit for bit those
    without remat."""
    runs = {}
    pix, labels = (torch.from_numpy(a) for a in _batch(64))
    for policy in (None, "flash"):
        model = _torch_model(jax_params, remat_policy=policy)
        loss = tlayers.cross_entropy_loss(model(pix), labels)
        loss.backward()
        runs[policy] = loss.detach(), {n: p.grad for n, p in model.named_parameters()}
    (l0, g0), (l1, g1) = runs[None], runs["flash"]
    assert torch.equal(l0, l1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_one_f32_session_step(monkeypatch):
    """``get_model_class("convnext-large-1k")`` -> ``make_plan(..., "f32")``
    -> session -> two steps on the CPU, narrowed to 64 px: f32 params and
    moments, the first loss equal to the two micro-batch losses recomputed
    and near ln 10 (layer scale 1e-6 leaves the head LayerNorm unit rows,
    so the logits are about N(0, 1)). The cosine schedule's warmup starts
    at lr 0, so the second step is what moves every parameter."""
    monkeypatch.setitem(tconvnext.CONFIGS, "convnext-large-1k", NARROW)
    monkeypatch.setattr(tconvnext.ConvNextModelClass, "image_size", property(lambda self: 64))
    mc = get_model_class("convnext-large-1k")
    sess = make_plan(mc, 2, 2, False, "f32").build_session(mc, device="cpu")
    state = sess.init_state()
    before = {n: p.detach().clone() for n, p in state.params.items()}
    batch = sess.make_train_batch(seed=0)
    with torch.no_grad():
        want = sum(float(sess.bundle.loss_fn(sess.module, {k: v[i] for k, v in batch.items()})[0]) for i in range(2)) / 2
    state, metrics = sess.train_step_fn()(state, batch)
    assert float(metrics["loss"]) == pytest.approx(want, rel=1e-6)
    assert abs(want - (np.log(10) + 0.5)) < 1.0
    state, metrics = sess.train_step_fn()(state, sess.make_train_batch(seed=1))
    assert np.isfinite(float(metrics["loss"]))
    assert all(m.dtype == torch.float32 for m in state.opt_state.mu + state.opt_state.nu)
    for n, p in state.params.items():
        assert p.dtype == torch.float32 and not torch.equal(p, before[n]), n
