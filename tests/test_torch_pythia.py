"""GPTNeoX (pythia) in the PyTorch port against the JAX model.

Both sides run on weights made once by the JAX init and carried across with
``params_from_jax``; token ids come from numpy. The JAX model takes its
Pallas attention (``attn_impl="pallas"``, interpret mode on the CPU), the
port its "flash" path (the plain versions on CPU tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_llm_pretraining_tpu.models import get_model_class as jax_get_model_class
from multimodal_llm_pretraining_tpu.models import layers as jlayers
from multimodal_llm_pretraining_tpu.models.pythia import GPTNeoXLM as JaxGPTNeoXLM
from multimodal_llm_pretraining_tpu.models.pythia import PYTHIA_SIZES as JAX_SIZES
from multimodal_llm_pretraining_tpu.ops import xent as jxent
from multimodal_llm_pretraining_tpu_torch.models import get_model_class
from multimodal_llm_pretraining_tpu_torch.models import layers as tlayers
from multimodal_llm_pretraining_tpu_torch.models.from_jax import params_from_jax
from multimodal_llm_pretraining_tpu_torch.models.pythia import PYTHIA_SIZES, GPTNeoXLM
from multimodal_llm_pretraining_tpu_torch.ops import xent as txent

torch.set_num_threads(2)

LAYERS, HIDDEN, HEADS, VOCAB, SEQ, BATCH = 2, 64, 4, 512, 33, 2
BF16_ULP = 2.0**-7  # spacing of bf16 just above 1.0: one ulp relative to the value


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def model_and_data():
    ids = np.random.default_rng(0).integers(0, VOCAB, (BATCH, SEQ), dtype=np.int32)
    jmodel = JaxGPTNeoXLM(num_layers=LAYERS, hidden=HIDDEN, num_heads=HEADS, vocab_size=VOCAB, attn_impl="pallas")
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return params, ids


def _jax_loss_and_grads(params, ids, dtype):
    model = JaxGPTNeoXLM(num_layers=LAYERS, hidden=HIDDEN, num_heads=HEADS, vocab_size=VOCAB, attn_impl="pallas", dtype=dtype)

    def loss_fn(p):
        return model.apply({"params": p}, jnp.asarray(ids), labels=jnp.asarray(ids))

    with jax.default_matmul_precision("highest"):
        loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), params_from_jax(_np(grads))


def _torch_loss_and_grads(params, ids, dtype):
    model = GPTNeoXLM(LAYERS, HIDDEN, HEADS, vocab_size=VOCAB, attn_impl="flash", dtype=dtype)
    model.load_state_dict(params_from_jax(_np(params)))
    t_ids = torch.from_numpy(ids).long()
    loss = model(t_ids, labels=t_ids)
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}


def test_params_from_jax_fills_the_state_dict(model_and_data):
    params, _ = model_and_data
    model = GPTNeoXLM(LAYERS, HIDDEN, HEADS, vocab_size=VOCAB)
    converted = params_from_jax(_np(params))
    own = model.state_dict()
    assert converted.keys() == own.keys()
    for name, t in converted.items():
        assert t.shape == own[name].shape, name
    # Dense kernels transpose; qkv stays [q | k | v] head-major along the output axis
    np.testing.assert_array_equal(
        converted["layers.1.attn.qkv.weight"].numpy(), np.asarray(params["layers"]["attn"]["qkv"]["kernel"])[1].T
    )


def test_gptneox_loss_and_grads_match_jax_f32(model_and_data):
    """f32 end to end under "highest" precision: the loss to 1e-5 relative,
    every grad to 1e-4 relative plus 1e-6 of that grad's largest entry."""
    params, ids = model_and_data
    jl, jg = _jax_loss_and_grads(params, ids, jnp.float32)
    tl, tg = _torch_loss_and_grads(params, ids, torch.float32)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert jg.keys() == tg.keys()
    for name in jg:
        want = jg[name].numpy()
        np.testing.assert_allclose(tg[name].numpy(), want, rtol=1e-4, atol=1e-6 * np.abs(want).max() + 1e-9, err_msg=name)


def test_gptneox_loss_and_grads_match_jax_bf16_compute(model_and_data):
    """bf16 compute over f32 params (weights cast at use on both sides). The
    two frameworks round bf16 intermediates at different points (XLA may
    keep excess precision inside a fusion), so: the loss to 1e-2 absolute,
    each grad within 5% of its norm."""
    params, ids = model_and_data
    jl, jg = _jax_loss_and_grads(params, ids, jnp.bfloat16)
    tl, tg = _torch_loss_and_grads(params, ids, torch.bfloat16)
    assert abs(tl - jl) < 1e-2
    for name in jg:
        assert tg[name].dtype == torch.float32, name
        want = jg[name].float()
        assert (tg[name] - want).norm() <= 5e-2 * want.norm() + 1e-6, name


@pytest.mark.parametrize("model_type", sorted(JAX_SIZES))
def test_recipe_matches_jax(model_type):
    """Sizes and the whole training recipe are copies of the JAX package's."""
    j, t = jax_get_model_class(model_type), get_model_class(model_type)
    assert PYTHIA_SIZES[model_type] == JAX_SIZES[model_type]
    for attr in (
        "batch_size", "training_steps", "mixed_precision", "optimizer", "optimizer_kwargs", "scheduler_kwargs",
        "max_grad_norm", "vocab_size", "sequence_length", "fsdp_layers_to_wrap",
    ):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.scheduler_type.value == j.scheduler_type.value


@pytest.mark.parametrize("model_type", ["roberta", "mamba", "convnext-large-1k", "vit", "llava-pretrain", "vilt-pretrain"])
def test_unported_families_raise_with_roadmap_item(model_type):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model_class(model_type)


def test_init_matches_jax_init_in_distribution():
    """The port's own init mirrors the JAX initializers in distribution, not
    in bits: at 2 layers, hidden 256, full vocab, every parameter's mean and
    standard deviation agree with the JAX init's (to 3% of the std, far
    outside the sampling error of the smallest tensor's 65k draws), and the
    init loss sits near ln 50304 = 10.83 as the JAX one does (11.20 on the
    JAX side at this size)."""
    jmodel = JaxGPTNeoXLM(num_layers=2, hidden=256, num_heads=4)
    jparams = params_from_jax(_np(jmodel.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]))
    model = GPTNeoXLM(2, 256, 4)
    model.reset_parameters(torch.Generator().manual_seed(0))
    for name, p in model.named_parameters():
        want = jparams[name]
        if want.std() == 0:
            torch.testing.assert_close(p.detach(), want, rtol=0, atol=0, msg=name)
        else:
            assert abs(p.std().item() - want.std().item()) < 0.03 * want.std().item(), name
            assert abs(p.mean().item() - want.mean().item()) < 0.03 * want.std().item(), name
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 50304, (2, SEQ))).long()
    with torch.no_grad():
        assert 10.8 < float(model(ids, labels=ids)) < 11.8


# ---------------------------------------------------------------- parity traps


def test_mlp_uses_tanh_gelu():
    """flax ``nn.gelu`` defaults to approximate=True: the port's Mlp must use
    the tanh GELU, and differs measurably from the exact one."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32) * 3
    jmlp = jlayers.Mlp(intermediate=32)
    p = jmlp.init(jax.random.key(1), jnp.asarray(x))["params"]
    want = np.asarray(jmlp.apply({"params": p}, jnp.asarray(x)))
    mlp = tlayers.Mlp(16, 32)
    with torch.no_grad():
        for name in ("up", "down"):
            getattr(mlp, name).weight.copy_(torch.from_numpy(np.asarray(p[name]["kernel"]).T.copy()))
            getattr(mlp, name).bias.copy_(torch.from_numpy(np.array(p[name]["bias"])))
        got = mlp(torch.from_numpy(x)).numpy()
        exact = mlp.down(torch.nn.functional.gelu(mlp.up(torch.from_numpy(x)))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.abs(exact - want).max() > 1e-4


def test_layernorm_f32_statistics_at_bf16():
    """flax LayerNorm computes its statistics and the normalisation in f32
    even at dtype=bf16 (eps 1e-5). A large common offset would wreck bf16
    statistics; the outputs agree to one bf16 ulp."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4, 64)) + 100.0).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    import flax.linen as nn

    jln = nn.LayerNorm(epsilon=1e-5, dtype=jnp.bfloat16)
    p = jln.init(jax.random.key(0), xb)
    want = np.asarray(jln.apply(p, xb).astype(jnp.float32))
    tln = tlayers.LayerNorm(64, dtype=torch.bfloat16)
    got = tln(torch.from_numpy(x).to(torch.bfloat16)).float().detach().numpy()
    assert tln(torch.from_numpy(x).to(torch.bfloat16)).dtype == torch.bfloat16
    np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=BF16_ULP)


def test_apply_rotary_in_input_dtype():
    """Rotary covers the first 64 of 256 head dims (rotate-half) and works in
    x's dtype, cos/sin cast to bf16 first, as in the JAX version."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 2, 9, 256)).astype(np.float32)
    jcos, jsin = jlayers.rotary_angles(jnp.arange(9), 64)
    want = np.asarray(jlayers.apply_rotary(jnp.asarray(x, jnp.bfloat16), jcos, jsin).astype(jnp.float32))
    cos, sin = tlayers.rotary_angles(torch.arange(9), 64)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=1e-6, atol=1e-6)
    got = tlayers.apply_rotary(torch.from_numpy(x).to(torch.bfloat16), cos, sin)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got[..., 64:].float().numpy(), want[..., 64:])  # pass-through dims untouched
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 * BF16_ULP, atol=2 * BF16_ULP)


def test_lm_head_logits_are_f32_from_bf16_operands():
    """The LM head asks for f32 logits from bf16 operands. ``matmul_f32``
    widens the operands on the CPU (exact products, f32 sums), which is what
    ``preferred_element_type=f32`` gives; a plain bf16 matmul would round
    the logits to bf16."""
    rng = np.random.default_rng(5)
    h = rng.normal(size=(37, 64)).astype(np.float32)
    w = rng.normal(size=(64, 100)).astype(np.float32)
    want = np.asarray(jnp.dot(jnp.asarray(h, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), preferred_element_type=jnp.float32))
    got = txent.matmul_f32(torch.from_numpy(h).to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_bias", [False, True])
def test_chunked_lm_loss_matches_jax(with_bias):
    """Chunk 16 over 2 x 36 shifted tokens: several chunks and a ragged last
    one, plus ignore_index labels and the bias fold; f32 loss and grads."""
    rng = np.random.default_rng(6)
    hidden = rng.normal(size=(2, 37, 32)).astype(np.float32)
    kernel = rng.normal(size=(32, 50)).astype(np.float32) * 0.2
    bias = rng.normal(size=(50,)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 37)).astype(np.int32)
    labels[0, 5:9] = -100
    b = bias if with_bias else None

    def jloss(h, k, bb):
        return jxent.lm_head_loss(h, k, jnp.asarray(labels), chunk_size=16, bias=bb)

    with jax.default_matmul_precision("highest"):
        jl, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2) if with_bias else (0, 1))(
            jnp.asarray(hidden), jnp.asarray(kernel), None if b is None else jnp.asarray(b)
        )
    th, tk = torch.from_numpy(hidden).requires_grad_(), torch.from_numpy(kernel).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_() if with_bias else None
    tl = txent.lm_head_loss(th, tk, torch.from_numpy(labels).long(), chunk_size=16, bias=tb)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    for got, want in zip([th.grad, tk.grad] + ([tb.grad] if with_bias else []), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
