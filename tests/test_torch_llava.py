"""LLaVA in the PyTorch port against the JAX model and session.

Module tests run the JAX package's toy dims (``models/llava.py:149-150``: a
tower of hidden 32, 2 layers, 2 heads, patch 14 on 28-pixel images; an LM of
hidden 64, 2 layers, 4 q / 2 kv heads, ffn 128) with a small vocabulary, on
weights made once by the JAX init and carried across with
``llava_params_from_jax``; inputs come from numpy. The JAX attention is its
Pallas flash kernel in interpret mode (``attn_impl="pallas"``), the port's
the "flash" path, whose plain versions run on CPU tensors. The session test
takes the JAX ``llava-pretrain`` class at the same toy dims
(``MLPT_LLAVA_TEST_DIMS``) and hands the port's class the same sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_llm_pretraining_tpu.models import get_model_class as jax_get_model_class
from multimodal_llm_pretraining_tpu.models import clip as jclip
from multimodal_llm_pretraining_tpu.models import layers as jlayers
from multimodal_llm_pretraining_tpu.models import llama as jllama
from multimodal_llm_pretraining_tpu.models import llava as jllava
from multimodal_llm_pretraining_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from multimodal_llm_pretraining_tpu.train import TrainingPlan as JaxTrainingPlan
from multimodal_llm_pretraining_tpu_torch.models import get_model_class
from multimodal_llm_pretraining_tpu_torch.models import layers as tlayers
from multimodal_llm_pretraining_tpu_torch.models import llava as tllava
from multimodal_llm_pretraining_tpu_torch.models.from_jax import llava_params_from_jax
from multimodal_llm_pretraining_tpu_torch.parallel.mesh import MeshConfig
from multimodal_llm_pretraining_tpu_torch.train import TrainingPlan

torch.set_num_threads(2)

TOWER = dict(hidden=32, num_layers=2, num_heads=2, intermediate=64, patch=14, image_size=28)
LM = dict(hidden=64, num_layers=2, num_heads=4, num_kv_heads=2, ffn=128)
VOCAB, IMAGE = 300, 299  # vocab_with_image and the <image> token
BATCH, TEXT = 2, 12  # 12 text positions + 4 patches - 1 = 15 decoder positions
LENS = [12, 8]  # right-padded text: the second row's last 4 tokens are padding


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, IMAGE, (BATCH, TEXT)).astype(np.int32)
    ids[:, 2] = IMAGE
    pix = rng.random((BATCH, 28, 28, 3), dtype=np.float32)
    mask = (np.arange(TEXT)[None, :] < np.asarray(LENS)[:, None]).astype(np.int32)
    labels = np.where(mask > 0, ids, -100).astype(np.int32)
    return ids, pix, mask, labels


def _jax_module(impl="pallas"):
    return jllava.LlavaModule(attn_impl=impl, tower_kwargs=TOWER, lm_kwargs=LM, vocab_with_image=VOCAB, image_token=IMAGE)


def _torch_module(params, attn_impl="flash"):
    mod = tllava.LlavaModule(attn_impl=attn_impl, tower_kwargs=TOWER, lm_kwargs=LM, vocab_with_image=VOCAB, image_token=IMAGE)
    mod.load_state_dict(llava_params_from_jax(params))
    return mod


@pytest.fixture(scope="module")
def jax_llava():
    """The JAX params (numpy) and the f32 loss and grads of the whole model
    on a right-padded batch, under "highest" matmul precision."""
    ids, pix, mask, labels = _inputs()
    model = _jax_module()
    params = model.init(jax.random.key(0), jnp.asarray(ids), jnp.asarray(pix))["params"]

    def loss_fn(p):
        return model.apply({"params": p}, jnp.asarray(ids), jnp.asarray(pix), labels=jnp.asarray(labels),
                           attention_mask=jnp.asarray(mask))

    with jax.default_matmul_precision("highest"):
        loss, grads = jax.value_and_grad(loss_fn)(params)
    return _np(params), float(loss), llava_params_from_jax(_np(grads))


def test_llava_params_from_jax_fills_the_state_dict(jax_llava):
    """Every port parameter gets a JAX leaf of its shape: stacked blocks
    split, Dense kernels transposed, norm scales as weights, the embedding
    kept as it is."""
    params = jax_llava[0]
    converted = llava_params_from_jax(params)
    own = tllava.LlavaModule(tower_kwargs=TOWER, lm_kwargs=LM, vocab_with_image=VOCAB).state_dict()
    assert converted.keys() == own.keys()
    for name, t in converted.items():
        assert t.shape == own[name].shape, name
    assert len([n for n in own if n.startswith("vision_tower.layers.") and n.endswith("qkv.weight")]) == 1  # 2 - 1 blocks
    np.testing.assert_array_equal(converted["language_model.layers.1.mlp.gate_up.weight"].numpy(),
                                  params["language_model"]["layers"]["mlp"]["gate_up"]["kernel"][1].T)
    np.testing.assert_array_equal(converted["language_model_embed_tokens"].numpy(), params["language_model_embed_tokens"])


def test_merge_image_features_matches_jax():
    """The static-shape gather of ``tests/test_models.py``'s case (image at
    position 1, padding at 4..5), then a two-row batch with the image at
    different positions, against the JAX function."""
    ids = np.array([[7, 99, 8, 9, 0, 0]])
    am = np.array([[1, 1, 1, 1, 0, 0]])
    labels = np.array([[-100, -100, 8, 9, -100, -100]])
    embeds = np.arange(24, dtype=np.float32).reshape(1, 6, 4)
    merged, mlab, mmask = tllava.merge_image_features(
        torch.from_numpy(embeds), torch.ones(1, 3, 4), torch.from_numpy(ids), torch.from_numpy(labels), 99,
        torch.from_numpy(am))
    assert merged.shape == (1, 8, 4)
    np.testing.assert_array_equal(mmask.numpy(), [[1, 1, 1, 1, 1, 1, 0, 0]])
    np.testing.assert_array_equal(mlab.numpy(), [[-100, -100, -100, -100, 8, 9, -100, -100]])

    rng = np.random.default_rng(1)
    ids = rng.integers(0, 99, (2, 7))
    ids[0, 0], ids[1, 4] = 99, 99
    am = np.array([[1] * 7, [1] * 5 + [0] * 2])
    embeds, feats = rng.normal(size=(2, 7, 4)).astype(np.float32), rng.normal(size=(2, 3, 4)).astype(np.float32)
    want = jllava.merge_image_features(jnp.asarray(embeds), jnp.asarray(feats), jnp.asarray(ids), jnp.asarray(ids), 99,
                                       jnp.asarray(am))
    got = tllava.merge_image_features(torch.from_numpy(embeds), torch.from_numpy(feats), torch.from_numpy(ids),
                                      torch.from_numpy(ids), 99, torch.from_numpy(am))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_clip_tower_matches_jax(jax_llava):
    """The tower (NHWC patchify, bias-free patch embed, cls and positions,
    pre-LN, the one block of feature layer -2, quick-GELU) in f32 under
    "highest" precision; the outputs are of order 1 and differ in
    summation order: 1e-5 relative plus 1e-5."""
    params = jax_llava[0]
    _, pix, _, _ = _inputs()
    tower = jclip.CLIPVisionEncoder(**TOWER, activation=jclip.quick_gelu, feature_layer=-2, attn_impl="pallas")
    with jax.default_matmul_precision("highest"):
        want = np.asarray(tower.apply({"params": params["vision_tower"]}, jnp.asarray(pix)))
    with torch.no_grad():
        got = _torch_module(params).vision_tower(torch.from_numpy(pix)).numpy()
    assert got.shape == (BATCH, 5, 32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_llama_decoder_matches_jax(jax_llava):
    """The decoder with GQA (4 q heads on 2 kv heads), llama-3 rope scaling
    and a right-padded key mask, on random input embeddings; f32 under
    "highest" precision, every position compared (padded rows attend the
    keys below their row's length on both sides): 1e-5 relative plus 1e-6."""
    params = jax_llava[0]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(BATCH, 15, 64)).astype(np.float32)
    mask = (np.arange(15)[None, :] < np.array([[15], [11]])).astype(np.int32)
    dec = jllama.LlamaDecoder(**LM, attn_impl="pallas")
    with jax.default_matmul_precision("highest"):
        want = np.asarray(dec.apply({"params": params["language_model"]}, jnp.asarray(x), mask=jnp.asarray(mask)))
    with torch.no_grad():
        got = _torch_module(params).language_model(torch.from_numpy(x), mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_llama3_rope_scaling_matches_jax():
    """Inverse frequencies through ``llama3_rope_scaling`` at Llama-3.2-1B's
    head_dim 64 and theta 5e5, which spans all three bands (scaled, kept,
    interpolated): the angle tables to 1e-6 at positions up to 1086."""
    pos = np.arange(0, 1087, 7)
    jcos, jsin = jlayers.rotary_angles(jnp.asarray(pos), 64, 5e5, jlayers.llama3_rope_scaling(32.0))
    cos, sin = tlayers.rotary_angles(torch.from_numpy(pos), 64, 5e5, tlayers.llama3_rope_scaling)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)


@pytest.mark.parametrize("impl", ["flash", "naive"])
def test_llava_loss_and_grads_match_jax_f32(jax_llava, impl):
    """The whole model on a right-padded batch (-100 labels at the padding),
    f32 under "highest" precision, with the "flash" (varlen plain versions)
    and the "naive" (additive key bias) attention: the loss to 1e-5
    relative, every grad, the projector's included, to 1e-4 relative plus
    1e-5 of that grad's largest entry."""
    params, jloss, jgrads = jax_llava
    ids, pix, mask, labels = _inputs()
    mod = _torch_module(params, impl)
    loss = mod(torch.from_numpy(ids).long(), torch.from_numpy(pix), labels=torch.from_numpy(labels).long(),
               attention_mask=torch.from_numpy(mask).long())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-5)
    grads = {n: p.grad for n, p in mod.named_parameters()}
    assert grads.keys() == jgrads.keys()
    for name, want in jgrads.items():
        want = want.numpy()
        np.testing.assert_allclose(grads[name].numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max() + 1e-9, err_msg=name)
    assert np.abs(jgrads["projector_in.weight"].numpy()).max() > 0


# ---------------------------------------------------------------- classes and the session


def _torch_class(model_type):
    mc = get_model_class(model_type)
    mc.tower_kwargs, mc.lm_kwargs = TOWER, LM
    return mc


def _jax_mask_names(model_type, monkeypatch):
    """{port parameter name: trainable} from the JAX bundle's mask at the toy dims."""
    monkeypatch.setenv("MLPT_LLAVA_TEST_DIMS", "1")
    bundle = jax_get_model_class(model_type).build_model(use_custom_kernels=False)
    shapes = jax.eval_shape(bundle.init_fn, jax.random.key(0))
    marked = jax.tree.map(lambda s, m: np.full(s.shape, m), shapes, bundle.trainable_mask)
    return {n: bool(t.all()) for n, t in llava_params_from_jax(marked).items()}


@pytest.mark.parametrize("model_type", ["llava-pretrain", "llava-finetune"])
def test_trainable_names_equal_the_jax_mask(model_type, monkeypatch):
    """pretrain trains only the projector; finetune everything but the tower."""
    want = _jax_mask_names(model_type, monkeypatch)
    bundle = _torch_class(model_type).build_model(device="meta")
    assert bundle.trainable_mask == want
    trainable = {n for n, t in want.items() if t}
    if model_type == "llava-pretrain":
        assert trainable == {"projector_in.weight", "projector_in.bias", "projector_out.weight", "projector_out.bias"}
    else:
        assert trainable == {n for n in want if not n.startswith("vision_tower")}


@pytest.mark.parametrize("model_type", ["llava-pretrain", "llava-finetune"])
def test_recipe_matches_jax(model_type):
    """The whole training recipe is a copy of the JAX package's."""
    j, t = jax_get_model_class(model_type), get_model_class(model_type)
    for attr in (
        "batch_size", "training_steps", "mixed_precision", "optimizer", "optimizer_kwargs", "scheduler_kwargs",
        "max_grad_norm", "vocab_size", "sequence_length", "image_size", "fsdp_layers_to_wrap", "image_token_index",
    ):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.scheduler_type.value == j.scheduler_type.value
    for name in ("IMAGE_TOKEN", "VOCAB_WITH_IMAGE", "NUM_PATCHES", "TOWER_HIDDEN"):
        assert getattr(tllava, name) == getattr(jllava, name), name


def test_full_size_parameter_count():
    """llava-pretrain built on the meta device: the parameter count of the
    JAX model's abstract init (about 1.53B; 23 tower blocks, 16 decoder
    blocks), of which the projector's 6,295,552 train."""
    bundle = get_model_class("llava-pretrain").build_model(device="meta")
    params = dict(bundle.module.named_parameters())
    module = jllava.LlavaModule()
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32),
                                                jnp.zeros((1, 336, 336, 3), jnp.float32)))["params"]
    count = sum(p.numel() for p in params.values())
    assert count == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert 1.5e9 < count < 1.56e9
    assert sum(params[n].numel() for n, t in bundle.trainable_mask.items() if t) == 6_295_552
    assert len(bundle.module.vision_tower.layers) == 23 and len(bundle.module.language_model.layers) == 16


@pytest.mark.parametrize("frozen_head", [False, True])
def test_chunked_loss_with_an_odd_vocab_matches_plain_cross_entropy(frozen_head):
    """A vocab that is not a multiple of 8 (llava's 128257; 13 here) takes
    zero-padded head columns that are sliced off before the softmax: the
    loss and grads equal plain f32 cross entropy over the unpadded logits
    (1e-6 relative, summation order), and a frozen head gets no grad."""
    from multimodal_llm_pretraining_tpu_torch.ops.xent import lm_head_loss

    rng = np.random.default_rng(8)
    hidden = torch.from_numpy(rng.normal(size=(2, 9, 16)).astype(np.float32)).requires_grad_()
    kernel = torch.from_numpy(rng.normal(size=(13, 16)).astype(np.float32)).t().requires_grad_(not frozen_head)
    labels = torch.from_numpy(rng.integers(0, 13, (2, 9)))
    labels[1, 5:] = -100
    loss = lm_head_loss(hidden, kernel, labels, chunk_size=4)
    loss.backward()
    h = hidden.detach().clone().requires_grad_()
    want = torch.nn.functional.cross_entropy((h[:, :-1] @ kernel.detach()).reshape(-1, 13), labels[:, 1:].reshape(-1))
    want.backward()
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=0)
    torch.testing.assert_close(hidden.grad, h.grad, rtol=1e-6, atol=1e-7)
    assert (kernel.grad is None) == frozen_head


def test_dummy_dataset_matches_jax():
    """Seq 512 with a leading <image> token, random text below 128256, an
    all-ones mask and float32 NHWC pixels: the JAX fixture's arrays exactly."""
    t = get_model_class("llava-pretrain").load_dummy_dataset().sample_batch(2, seed=3)
    j = jax_get_model_class("llava-pretrain").load_dummy_dataset().sample_batch(2, seed=3)
    assert t.keys() == j.keys()
    for k in j:
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert t["input_ids"].shape == (2, 512) and (t["input_ids"][:, 0] == 128256).all()
    assert t["pixel_values"].shape == (2, 336, 336, 3)


STEP_SEQ, ACC, MBS = 12, 2, 2


def _plan_kwargs(mc):
    return dict(
        num_training_steps=5, micro_batch_size=MBS, gradient_accumulation_steps=ACC, optimizer=mc.optimizer,
        optimizer_kwargs=mc.optimizer_kwargs, scheduler_type=mc.scheduler_type, scheduler_kwargs=mc.scheduler_kwargs,
        max_grad_norm=mc.max_grad_norm, bf16=True,
    )


def _step_batches(sess, n):
    """[acc, mbs, ...] batches from the port session's own dataset and
    ``make_train_batch``, with the second row of each micro-batch padded."""
    sess.dataset.sequence_length = STEP_SEQ
    out = []
    for i in range(n):
        batch = sess.make_train_batch(seed=i)
        batch["attention_mask"][:, 1, 9:] = 0
        batch["labels"][:, 1, 9:] = -100
        out.append(batch)
    return out


def test_llava_pretrain_session_steps_match_jax(monkeypatch):
    """The slice end to end: ``get_model_class("llava-pretrain")`` -> plan
    (bf16, no SR) -> session -> two steps, at the toy dims on both sides,
    from the JAX ``init_state()`` params and the same padded batches. The
    layout is JAX's: bf16 frozen leaves, f32 projector and moments. The
    first step's LR is schedule(0) = 0, so the projector moves at the second
    step, by about lr = 2.5e-4 per element. Losses to 2e-2 (bf16 compute,
    rounded at other points by the two frameworks). The projector: every
    element within lr of the JAX one and at least 97% within 0.1 * lr; Adam
    normalises a gradient that bf16 rounding dominates to an update of up
    to lr whose sign depends on that rounding, while a wrong or missing
    update is off by about lr nearly everywhere. Every frozen leaf is
    bit-identical to its initial value."""
    monkeypatch.setenv("MLPT_LLAVA_TEST_DIMS", "1")
    mc = _torch_class("llava-pretrain")
    sess = TrainingPlan(mesh=MeshConfig(1, 1), **_plan_kwargs(mc)).build_session(mc, device="cpu")
    batches = _step_batches(sess, 2)
    jmc = jax_get_model_class("llava-pretrain")
    jsess = JaxTrainingPlan(mesh=JaxMeshConfig(1, 1), **_plan_kwargs(jmc)).build_session(jmc)
    jstate = jsess.init_state()
    init = llava_params_from_jax(_np(jstate.params))
    jstep = jsess.train_step_fn()
    jlosses = []
    for batch in batches:
        jstate, m = jstep(jstate, {k: jnp.asarray(v.numpy().astype(np.float32 if v.is_floating_point() else np.int32))
                                   for k, v in batch.items()}, jax.random.key(0))
        jlosses.append(float(m["loss"]))
    want = llava_params_from_jax(_np(jstate.params))

    state = sess.init_state(state_dict=init)
    assert sess.trainable == ["projector_in.weight", "projector_in.bias", "projector_out.weight", "projector_out.bias"]
    assert len(state.opt_state.mu) == 4
    step = sess.train_step_fn()
    losses = []
    for batch in batches:
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, atol=2e-2)
    lr = sess.tx.schedule(1)
    for name, p in state.params.items():
        if name in sess.trainable:
            assert p.dtype == torch.float32 and p.requires_grad, name
            assert (want[name] - init[name]).abs().max() > 0.5 * lr, name  # the comparison sees a real update
            diff = (p.detach() - want[name]).abs()
            assert diff.max() <= lr and (diff <= 0.1 * lr).float().mean() >= 0.97, name
        else:
            assert p.dtype == torch.bfloat16 and not p.requires_grad and p.grad is None, name
            assert torch.equal(p, init[name]), name
            assert torch.equal(want[name], init[name]), name


def test_session_batches_keep_float_pixels():
    """``make_micro_batch`` puts integer leaves on the device as long and the
    pixels as float32, values unchanged (a cast to long would truncate
    them)."""
    mc = _torch_class("llava-pretrain")
    sess = TrainingPlan(mesh=MeshConfig(1, 1), **_plan_kwargs(mc)).build_session(mc, device="cpu")
    sess.dataset.sequence_length = STEP_SEQ
    batch = sess.make_micro_batch(seed=4)
    host = sess.dataset.sample_batch(MBS, seed=4)
    assert batch["pixel_values"].dtype == torch.float32
    np.testing.assert_array_equal(batch["pixel_values"].numpy(), host["pixel_values"])
    for k in ("input_ids", "labels", "attention_mask"):
        assert batch[k].dtype == torch.long, k
        np.testing.assert_array_equal(batch[k].numpy(), host[k])
