"""ViLT (CLIP-g and B/32 trunks, MLM + ITM + WPA) in the PyTorch port
against the JAX model.

Narrow on both sides: 2 trunk layers, hidden 176 = 2 heads of 88 (the
CLIP-g trunk's own head dim), ffn 256, a 512-token vocab with 64-wide word
embeddings, 16 text tokens and 28-px images at patch 14 (4 patches and the
class token: 21 positions). The JAX module takes these as fields. Weights
are made once by the JAX init and carried across with
``vilt_params_from_jax``; the batch comes from the port's dataset (numpy)
with ragged ITM text masks. The JAX attention is its Pallas flash kernel in
interpret mode (``attn_impl="pallas"``: it takes head dim 88), the port's
the "flash" path, whose plain versions run on CPU tensors, under either
backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_llm_pretraining_tpu import native
from multimodal_llm_pretraining_tpu.models import get_model_class as jax_get_model_class
from multimodal_llm_pretraining_tpu.models import vilt as jvilt
from multimodal_llm_pretraining_tpu_torch.benchmarking import data as tdata
from multimodal_llm_pretraining_tpu_torch.models import get_model_class
from multimodal_llm_pretraining_tpu_torch.models import vilt as tvilt
from multimodal_llm_pretraining_tpu_torch.models.from_jax import vilt_params_from_jax
from multimodal_llm_pretraining_tpu_torch.ops import flash_attention as tfa
from multimodal_llm_pretraining_tpu_torch.profile_step import make_plan

torch.set_num_threads(2)
torch.exp(torch.ones(4096))  # one-threaded first exp (tests/test_torch_flash_attention.py says why)

NARROW = dict(hidden=176, num_layers=2, num_heads=2, intermediate=256, patch=14, image_size=28, vocab_size=512,
              token_embed_dim=64)
TEXT, BATCH = 16, 3
VILT_TYPES = ("vilt-pretrain", "vilt-finetune", "vilt-original-pretrain", "vilt-original-finetune")
FULL_COUNTS = {"vilt-pretrain": 1_464_333_826, "vilt-finetune": 1_464_331_008,
               "vilt-original-pretrain": 137_719_868, "vilt-original-finetune": 137_718_330}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seed=0) -> dict[str, np.ndarray]:
    """The port's ViLT batch at the narrow size, the ITM text of rows 1 and
    2 right-padded after 9 and 4 tokens (WPA's ragged keep-masks), and both
    ITM labels present."""
    b = tdata.DummyMultimodalLanguageModelingForViltDataset(NARROW["vocab_size"], TEXT, NARROW["image_size"],
                                                           mask_token=NARROW["vocab_size"] - 1).sample_batch(BATCH, seed)
    b["itm_attention_mask"][1, 9:] = 0
    b["itm_attention_mask"][2, 4:] = 0
    b["itm_labels"] = np.array([1, 0, 1], np.int32)
    return b


def _torch_batch(b: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v) if v.dtype == np.float32 else torch.from_numpy(v).long() for k, v in b.items()}


@pytest.fixture(scope="module")
def jax_vilt():
    """JAX params (numpy), the loss, its three terms and the grads, f32
    under "highest" precision."""
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    model = jvilt.ViltForPretrainModule(attn_impl="pallas", **NARROW)
    params = jax.jit(model.init)(jax.random.key(0), batch)["params"]
    with jax.default_matmul_precision("highest"):
        (loss, metrics), grads = jax.jit(jax.value_and_grad(lambda p: model.apply({"params": p}, batch), has_aux=True))(params)
    return _np(params), {k: float(v) for k, v in metrics.items()}, vilt_params_from_jax(_np(grads))


def test_vilt_params_from_jax_fills_the_state_dict(jax_vilt):
    """Every port parameter gets a JAX leaf of its shape: the trunk's stack
    split, Dense kernels transposed (``patch_embed`` with its bias),
    LayerNorm scales as weights, ``mlm_decoder`` kept [H, V]."""
    params = jax_vilt[0]
    converted = vilt_params_from_jax(params)
    own = tvilt.ViltForPretrain(**NARROW).state_dict()
    assert converted.keys() == own.keys()
    for name, t in converted.items():
        assert t.shape == own[name].shape, name
    trunk = params["vilt"]
    np.testing.assert_array_equal(converted["vilt.layers.1.mlp.up.weight"].numpy(), trunk["layers"]["mlp"]["up"]["kernel"][1].T)
    np.testing.assert_array_equal(converted["vilt.patch_embed.bias"].numpy(), trunk["patch_embed"]["bias"])
    np.testing.assert_array_equal(converted["mlm_decoder"].numpy(), params["mlm_decoder"])
    np.testing.assert_array_equal(converted["vilt.text_ln.weight"].numpy(), trunk["text_ln"]["scale"])


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_loss_terms_and_grads_match_jax_f32(jax_vilt, fused, monkeypatch):
    """All three tasks, f32 end to end, both backwards of the port against
    the JAX kernels: each loss term to 1e-5 relative (WPA, near 0, also to
    1e-6 absolute), every grad to 1e-4 relative plus 1e-5 of that grad's
    largest entry (the attention and IPOT sums run in another order on the
    two sides)."""
    monkeypatch.setattr(tfa, "PREFER_FUSED_BWD", fused)
    params, jmetrics, jgrads = jax_vilt
    model = tvilt.ViltForPretrain(**NARROW)
    model.load_state_dict(vilt_params_from_jax(params))
    loss, metrics = model(_torch_batch(_batch()))
    loss.backward()
    assert metrics.keys() == jmetrics.keys()
    for name, want in jmetrics.items():
        np.testing.assert_allclose(float(metrics[name]), want, rtol=1e-5, atol=1e-6, err_msg=name)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert grads.keys() == jgrads.keys()
    for name, want in jgrads.items():
        want = want.numpy()
        np.testing.assert_allclose(grads[name].numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max() + 1e-9,
                                   err_msg=name)


def _ot_inputs(seed=0):
    """Text [3, 12, 8] and image [3, 7, 8] embeddings with ragged keep-masks
    (a row with every position kept, one with 5 text and 4 image positions,
    one with 2 and 6) and ITM labels [1, 0, 1]."""
    rng = np.random.default_rng(seed)
    txt, img = rng.standard_normal((3, 12, 8), np.float32), rng.standard_normal((3, 7, 8), np.float32)
    txt_keep = np.arange(12)[None, :] < np.array([12, 5, 2])[:, None]
    img_keep = np.arange(7)[None, :] < np.array([7, 4, 6])[:, None]
    return txt, img, txt_keep, img_keep, np.array([1, 0, 1], np.int32)


def test_ipot_and_wpa_loss_match_jax_f32():
    """``ipot``'s plan (50 iterations, k=1, zero on the joint pad) to 1e-5
    of its largest entry, ``wpa_loss`` to 1e-5 relative and its gradients
    (through the cosine cost only) to 1e-5 relative plus 1e-6 absolute, on
    ragged pads."""
    txt, img, txt_keep, img_keep, labels = _ot_inputs()
    pad_t, pad_i = ~txt_keep, ~img_keep
    joint = pad_t[:, :, None] | pad_i[:, None, :]
    with jax.default_matmul_precision("highest"):
        cost = jnp.where(joint, 0.0, jvilt.cost_matrix_cosine(jnp.asarray(txt), jnp.asarray(img)))
        jT = jvilt.ipot(cost, jnp.asarray(txt_keep.sum(1), jnp.float32), jnp.asarray(pad_t),
                        jnp.asarray(img_keep.sum(1), jnp.float32), jnp.asarray(pad_i), jnp.asarray(joint), 0.5, 50, 1)
        jloss, (jgt, jgi) = jax.value_and_grad(jvilt.wpa_loss, argnums=(0, 1))(
            jnp.asarray(txt), jnp.asarray(img), jnp.asarray(txt_keep), jnp.asarray(img_keep), jnp.asarray(labels))
    t_txt, t_img = torch.from_numpy(txt).requires_grad_(), torch.from_numpy(img).requires_grad_()
    tk, ik = torch.from_numpy(txt_keep), torch.from_numpy(img_keep)
    tcost = torch.where(torch.from_numpy(joint), 0.0, tvilt.cost_matrix_cosine(t_txt.detach(), t_img.detach()))
    tT = tvilt.ipot(tcost, tk.sum(1).float(), ~tk, ik.sum(1).float(), ~ik, torch.from_numpy(joint), 0.5, 50, 1)
    assert tT.shape == (3, 7, 12) and not tT.requires_grad
    assert float(tT[torch.from_numpy(joint).transpose(1, 2)].abs().max()) == 0.0
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), rtol=0, atol=1e-5 * float(np.abs(jT).max()))
    loss = tvilt.wpa_loss(t_txt, t_img, tk, ik, torch.from_numpy(labels).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(t_txt.grad.numpy(), np.asarray(jgt), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_img.grad.numpy(), np.asarray(jgi), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("model_type", VILT_TYPES)
def test_recipe_and_full_size_parameter_count_match_jax(model_type):
    """The recipe properties are the JAX class's; built on the meta device,
    the model holds exactly the JAX abstract init's parameter count (the
    finetune classes without ``itm_head``)."""
    j, t = jax_get_model_class(model_type), get_model_class(model_type)
    for attr in ("batch_size", "training_steps", "mixed_precision", "optimizer", "optimizer_kwargs",
                 "scheduler_kwargs", "max_grad_norm", "fsdp_layers_to_wrap", "supports_activation_checkpointing",
                 "image_size", "vocab_size", "sequence_length", "target_tasks", "module_kwargs"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.scheduler_type.value == j.scheduler_type.value
    module = t.build_model(device="meta").module
    count = sum(p.numel() for p in module.parameters())
    shapes = jax.eval_shape(j.build_model().init_fn, jax.random.key(0))
    assert count == FULL_COUNTS[model_type] == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert hasattr(module, "itm_head") == model_type.endswith("pretrain")
    assert module.vilt.remat_policy is None
    assert t.build_model(activation_checkpointing=True, device="meta").module.vilt.remat_policy == "flash"


@pytest.mark.parametrize("model_type", ["vilt-pretrain", "vilt-original-pretrain"])
def test_dataset_matches_jax_numpy_fallback(model_type, monkeypatch):
    """With the JAX package's C++ library made unavailable, its ViLT batch
    (through the model class, mask token clamped into the vocab) equals the
    port's leaf for leaf from the same seed."""
    monkeypatch.setattr(native, "_lib", False)
    want = jax_get_model_class(model_type).load_dummy_dataset(sequence_length=24).sample_batch(4, seed=5)
    got = get_model_class(model_type).load_dummy_dataset(sequence_length=24).sample_batch(4, seed=5)
    assert isinstance(get_model_class(model_type).load_dummy_dataset(), tdata.DummyMultimodalLanguageModelingForViltDataset)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    masked = got["mlm_labels"] != -100
    assert (got["mlm_input_ids"][masked] == min(128255, get_model_class(model_type).vocab_size - 1)).all()
    np.testing.assert_array_equal(got["mlm_labels"][masked], got["input_ids"][masked])


def test_finetune_runs_one_mlm_pass_and_has_no_itm_head(jax_vilt, monkeypatch):
    """``target_tasks=("mlm",)``: one trunk pass, the MLM loss alone (equal
    to the pretrain model's MLM term on the same weights), no ``itm_head``;
    the pooler, which that pass does not read, gets no gradient."""
    params, jmetrics, _ = jax_vilt
    model = tvilt.ViltForPretrain(("mlm",), **NARROW)
    assert "itm_head.weight" not in model.state_dict()
    state = {k: v for k, v in vilt_params_from_jax(params).items() if not k.startswith("itm_head")}
    model.load_state_dict(state)
    passes = []
    model.vilt.register_forward_hook(lambda *a: passes.append(1))
    loss, metrics = model(_torch_batch(_batch()))
    loss.backward()
    assert len(passes) == 1 and set(metrics) == {"mlm_loss", "loss"}
    np.testing.assert_allclose(loss.item(), jmetrics["mlm_loss"], rtol=1e-5)
    assert model.vilt.pooler.weight.grad is None


def test_pretrained_encoder_dir_raises_for_the_b32_trunk(monkeypatch):
    """``MLPT_VILT_DIR`` set: the 768-wide trunk's init raises with ROADMAP
    item 8 where the JAX init would graft the pretrained encoder; a trunk of
    another width, which the JAX init does not graft, inits as before."""
    monkeypatch.setenv("MLPT_VILT_DIR", "/nonexistent")
    bundle = get_model_class("vilt-original-pretrain").build_model(device="meta")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 8"):
        bundle.init_fn(bundle.module, torch.Generator())
    monkeypatch.setattr(tvilt._ViltBase, "module_kwargs", NARROW)
    bundle = get_model_class("vilt-pretrain").build_model(device="cpu")
    bundle.init_fn(bundle.module, torch.Generator().manual_seed(0))
    assert torch.isfinite(bundle.module.mlm_decoder).all()


@pytest.mark.parametrize("model_type", ["vilt-pretrain", "vilt-finetune"])
def test_one_f32_session_step(model_type, monkeypatch):
    """``get_model_class`` -> ``make_plan(..., "f32")`` -> session -> two
    steps on the CPU, narrowed: f32 params and moments, the first loss
    equal to the two micro-batch losses recomputed (there is no dropout),
    and near the init's reckoning: ln 512 + 1/2 for MLM, plus ln 2 for ITM.
    The linear schedule starts at lr 0, so the second step is what moves
    every parameter; the finetune pooler, which the loss does not read,
    takes a zero gradient (JAX's) and moves by AdamW's weight decay alone."""
    monkeypatch.setattr(tvilt._ViltBase, "module_kwargs", NARROW)
    monkeypatch.setattr(tvilt._ViltBase, "image_size", property(lambda self: NARROW["image_size"]))
    monkeypatch.setattr(tvilt._ViltBase, "vocab_size", property(lambda self: NARROW["vocab_size"]))
    mc = get_model_class(model_type)
    sess = make_plan(mc, 2, 2, False, "f32").build_session(mc, device="cpu")
    sess.dataset.sequence_length = TEXT
    state = sess.init_state()
    before = {n: p.detach().clone() for n, p in state.params.items()}
    batch = sess.make_train_batch(seed=0)
    with torch.no_grad():
        want = sum(float(sess.bundle.loss_fn(sess.module, {k: v[i] for k, v in batch.items()})[0]) for i in range(2)) / 2
    state, metrics = sess.train_step_fn()(state, batch)
    assert float(metrics["loss"]) == pytest.approx(want, rel=1e-6)
    band = np.log(512) + 0.5 + (np.log(2) if model_type == "vilt-pretrain" else 0.0)
    assert abs(want - band) < 1.0
    state, metrics = sess.train_step_fn()(state, sess.make_train_batch(seed=1))
    assert np.isfinite(float(metrics["loss"]))
    assert all(m.dtype == torch.float32 for m in state.opt_state.mu + state.opt_state.nu)
    for n, p in state.params.items():
        assert p.dtype == torch.float32, n
        if model_type == "vilt-finetune" and n.startswith("vilt.pooler"):
            # weight decay alone, to an f32 ulp: p - lr wd p
            decayed = before[n] * (1 - sess.tx.schedule(1) * mc.optimizer_kwargs["weight_decay"])
            torch.testing.assert_close(p.detach(), decayed, rtol=2.0**-23, atol=0.0)
        else:
            assert not torch.equal(p, before[n]), n
