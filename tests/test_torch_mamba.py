"""Mamba in the PyTorch port against the JAX model and session.

The JAX model reads its sizes as module constants at call time
(``models/mamba.py:26-34``), so it is narrowed with pytest's ``MonkeyPatch``
while it traces, as ``__graft_entry__.py`` narrows ``N_LAYER``; the port takes
the same sizes as constructor arguments (and its ``build_model`` reads its own
module constants the same way). Weights are made once by the JAX init and
carried across with ``mamba_params_from_jax``; token ids come from numpy. On
the CPU the JAX scan runs its XLA chunked path and the port's the plain
versions of its kernels.

The JAX model carries the residual stream in the compute dtype and rounds
its conv and gate there; the port's published default (``residual_in_fp32``)
does not, so the comparisons at bf16 compute build the port through
``get_model_class("mamba")`` with ``RESIDUAL_IN_FP32`` narrowed to False,
as the sizes are narrowed. At f32 compute the two settings compute the
same. The published setting is held to the benchmark's plain reference
(``bench_port/reference/mamba.py``) instead, on one seeded draw of its own
weights (``bench_port/yardstick``'s ``make_weights`` and ``token_batch``):
those tests depend on the reference, and a change to it changes what they
hold the port to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_llm_pretraining_tpu.models import get_model_class as jax_get_model_class
from multimodal_llm_pretraining_tpu.models import mamba as jmamba
from multimodal_llm_pretraining_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from multimodal_llm_pretraining_tpu.train import TrainingPlan as JaxTrainingPlan
from multimodal_llm_pretraining_tpu_torch.models import get_model_class
from multimodal_llm_pretraining_tpu_torch.models import layers as tlayers
from multimodal_llm_pretraining_tpu_torch.models import mamba as tmamba
from multimodal_llm_pretraining_tpu_torch.models.from_jax import mamba_params_from_jax
from multimodal_llm_pretraining_tpu_torch.models.mamba import MambaLM
from multimodal_llm_pretraining_tpu_torch.parallel.mesh import MeshConfig
from multimodal_llm_pretraining_tpu_torch.train import TrainingPlan

torch.set_num_threads(2)

# 2 layers, d_model 64, d_inner 128, dt_rank 4, d_state 16, vocab 256; seq 300
# crosses the scan's 256-step chunk
NARROW = dict(N_LAYER=2, D_MODEL=64, D_INNER=128, DT_RANK=4, D_STATE=16, VOCAB=256)
SEQ, BATCH = 300, 2
BF16_ULP = 2.0**-7


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _narrow(mp: pytest.MonkeyPatch, module, sizes=NARROW) -> None:
    for name, value in sizes.items():
        mp.setattr(module, name, value)


def _torch_model(dtype=torch.float32, **kw) -> MambaLM:
    return MambaLM(64, 2, 128, 16, 4, 4, 256, dtype=dtype, **kw)


@pytest.fixture(scope="module")
def jax_runs():
    """Initial params, ids, and JAX (loss, grads) at f32 and bf16 compute."""
    ids = np.random.default_rng(0).integers(0, 256, (BATCH, SEQ), dtype=np.int32)
    out = {"ids": ids}
    with pytest.MonkeyPatch.context() as mp:
        _narrow(mp, jmamba)
        params = jmamba.MambaLM().init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
        out["params"] = _np(params)
        for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            model = jmamba.MambaLM(dtype=dtype)

            def loss_fn(p, model=model):
                return model.apply({"params": p}, jnp.asarray(ids), labels=jnp.asarray(ids))

            with jax.default_matmul_precision("highest"):
                loss, grads = jax.value_and_grad(loss_fn)(params)
            out[name] = (float(loss), mamba_params_from_jax(_np(grads)))
    return out


def _jax_arithmetic_model(dtype: torch.dtype) -> MambaLM:
    """The port as ``get_model_class("mamba")`` builds it on the CPU,
    narrowed to ``NARROW`` and to the JAX package's arithmetic
    (``RESIDUAL_IN_FP32`` False) through the module constants, as the step
    test narrows its session."""
    with pytest.MonkeyPatch.context() as mp:
        _narrow(mp, tmamba, {**NARROW, "RESIDUAL_IN_FP32": False})
        return get_model_class("mamba").build_model(compute_dtype=dtype, device="cpu").module


def _torch_loss_and_grads(params, ids, dtype=torch.float32, model: MambaLM | None = None, **kw):
    model = model or _torch_model(dtype, **kw)
    model.load_state_dict(mamba_params_from_jax(params))
    t_ids = torch.from_numpy(ids).long()
    loss = model(t_ids, labels=t_ids)
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}


def test_mamba_params_from_jax_fills_the_state_dict(jax_runs):
    """The JAX tree as ``jax.eval_shape`` reads it maps onto every port
    parameter with its shape: Dense kernels transposed, conv_weight kept."""
    params = jax_runs["params"]
    with pytest.MonkeyPatch.context() as mp:
        _narrow(mp, jmamba)
        shapes = jax.eval_shape(lambda: jmamba.MambaLM().init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    assert jax.tree.map(lambda s: s.shape, shapes) == jax.tree.map(np.shape, params)
    converted = mamba_params_from_jax(params)
    own = _torch_model().state_dict()
    assert converted.keys() == own.keys()
    for name, t in converted.items():
        assert t.shape == own[name].shape, name
    np.testing.assert_array_equal(converted["layers.1.in_proj.weight"].numpy(), params["layers"]["in_proj"]["kernel"][1].T)
    np.testing.assert_array_equal(converted["layers.0.conv_weight"].numpy(), params["layers"]["conv_weight"][0])
    np.testing.assert_array_equal(converted["layers.1.dt_proj.bias"].numpy(), params["layers"]["dt_proj"]["bias"][1])


def test_mamba_loss_and_grads_match_jax_f32(jax_runs):
    """f32 end to end under "highest" precision: the loss to 1e-5 relative,
    every grad to 1e-4 relative plus 1e-5 of that grad's largest entry (the
    scan's chunked sums differ in order on the two sides)."""
    jl, jg = jax_runs["f32"]
    tl, tg = _torch_loss_and_grads(jax_runs["params"], jax_runs["ids"])
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert jg.keys() == tg.keys()
    for name in jg:
        want = jg[name].numpy()
        np.testing.assert_allclose(tg[name].numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max() + 1e-9, err_msg=name)


def test_mamba_loss_and_grads_match_jax_bf16_compute(jax_runs):
    """bf16 compute over f32 params. The two frameworks round bf16
    intermediates at different points, and at this size bf16 rounding alone
    moves each grad by 2-7% of its norm (JAX bf16 against JAX f32). So: the
    loss to 1e-2 absolute; each grad within 8% of its norm of the JAX bf16
    grad, and no farther from it than 1.25 times that rounding floor."""
    jl, jg = jax_runs["bf16"]
    _, jg32 = jax_runs["f32"]
    tl, tg = _torch_loss_and_grads(jax_runs["params"], jax_runs["ids"], model=_jax_arithmetic_model(torch.bfloat16))
    assert abs(tl - jl) < 1e-2
    for name in jg:
        assert tg[name].dtype == torch.float32, name
        want = jg[name].float()
        err = (tg[name] - want).norm() / want.norm()
        floor = (want - jg32[name]).norm() / want.norm()
        assert err <= 8e-2 and err <= 1.25 * floor, (name, err.item(), floor.item())


@pytest.mark.parametrize("kw", [dict(remat=True), dict(use_custom_kernels=False)])
def test_remat_and_plain_scan_give_the_same_loss_and_grads(jax_runs, kw):
    """Whole-block remat recomputes the same ops on the same inputs: equal
    bit for bit. The plain scan under autograd (``use_custom_kernels=False``)
    against the fused Function's plain versions: 1e-5 relative."""
    params, ids = jax_runs["params"], jax_runs["ids"]
    base_l, base_g = _torch_loss_and_grads(params, ids)
    l, g = _torch_loss_and_grads(params, ids, **kw)
    exact = kw.get("remat", False)
    tol = dict(rtol=0, atol=0) if exact else dict(rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(l, base_l, **tol)
    for name in base_g:
        torch.testing.assert_close(g[name], base_g[name], **tol, msg=name)


def test_recipe_matches_jax():
    """The whole training recipe is a copy of the JAX package's."""
    j, t = jax_get_model_class("mamba"), get_model_class("mamba")
    for attr in (
        "batch_size", "training_steps", "mixed_precision", "optimizer", "optimizer_kwargs", "scheduler_kwargs",
        "max_grad_norm", "vocab_size", "sequence_length", "fsdp_layers_to_wrap", "supports_activation_checkpointing",
    ):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.scheduler_type.value == j.scheduler_type.value
    for name in ("D_MODEL", "N_LAYER", "D_STATE", "D_CONV", "EXPAND", "D_INNER", "DT_RANK", "VOCAB", "LN_EPS"):
        assert getattr(tmamba, name) == getattr(jmamba, name), name


def test_full_size_parameter_count():
    """mamba-2.8b built on the meta device: 2,768,345,600 parameters, the
    count of the JAX model's abstract init."""
    bundle = get_model_class("mamba").build_model(device="meta")
    count = sum(p.numel() for p in bundle.module.parameters())
    shapes = jax.eval_shape(lambda: jmamba.MambaLM().init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    assert count == 2_768_345_600 == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert len(bundle.module.layers) == 64 and not bundle.module.remat
    assert get_model_class("mamba").build_model(activation_checkpointing=True, device="meta").module.remat


def test_init_matches_jax_init_in_distribution():
    """The port's own init mirrors the JAX initializers in distribution, not
    in bits: at 2 layers, d_model 256, d_inner 2048, dt_rank 16 and the full
    vocab, every drawn tensor's mean and standard deviation agree with the
    JAX init's to 3% of the std (the smallest, conv_weight, has 8192 draws);
    the constant ones (norms, A_log, D, biases) are equal; the init loss sits
    near ln 50280 = 10.83."""
    sizes = dict(N_LAYER=2, D_MODEL=256, D_INNER=2048, DT_RANK=16)
    with pytest.MonkeyPatch.context() as mp:
        _narrow(mp, jmamba, sizes)
        jparams = mamba_params_from_jax(_np(jmamba.MambaLM().init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]))
    model = MambaLM(256, 2, 2048, 16, 4, 16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    for name, p in model.named_parameters():
        want = jparams[name]
        if want.std() == 0 or name.endswith("A_log"):
            torch.testing.assert_close(p.detach(), want, rtol=0, atol=0, msg=name)
        else:
            assert abs(p.std().item() - want.std().item()) < 0.03 * want.std().item(), name
            assert abs(p.mean().item() - want.mean().item()) < 0.03 * want.std().item(), name
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 50280, (2, 33))).long()
    with torch.no_grad():
        assert 10.8 < float(model(ids, labels=ids)) < 11.8


def test_rmsnorm_f32_statistics_at_bf16():
    """flax RMSNorm takes its mean square in f32 even at dtype=bf16 (eps
    1e-5), and scales in f32; the outputs agree to one bf16 ulp."""
    import flax.linen as nn

    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4, 64)) * 30 + 100.0).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    jnorm = nn.RMSNorm(epsilon=1e-5, dtype=jnp.bfloat16)
    want = np.asarray(jnorm.apply({"params": {"scale": jnp.asarray(scale)}}, xb).astype(jnp.float32))
    tnorm = tlayers.RMSNorm(64, dtype=torch.bfloat16)
    with torch.no_grad():
        tnorm.weight.copy_(torch.from_numpy(scale))
        got = tnorm(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_ULP, atol=BF16_ULP)


# ---------------------------------------------------------------- the session step

STEP_SEQ, ACC, MBS = 40, 2, 2
BF16_SR = dict(bf16=True, master_weights="sr", opt_state_dtype="bf16", grad_accum_dtype="bf16")


def _plan_kwargs(mc):
    return dict(
        num_training_steps=5, micro_batch_size=MBS, gradient_accumulation_steps=ACC, optimizer=mc.optimizer,
        optimizer_kwargs=mc.optimizer_kwargs, scheduler_type=mc.scheduler_type, scheduler_kwargs=mc.scheduler_kwargs,
        max_grad_norm=mc.max_grad_norm, activation_checkpointing=True, **BF16_SR,
    )


def test_one_bf16_sr_step_matches_jax():
    """The whole slice: ``get_model_class("mamba")`` -> plan -> session ->
    one bf16_sr step with block remat, narrowed on both sides (the port to
    the JAX package's arithmetic, ``RESIDUAL_IN_FP32`` False), from the JAX
    ``init_state()`` params and the same batch. The tolerances of the
    pythia step test: the two sides draw different SR bits and round bf16
    compute differently, so every element within 2 bf16 ulps of its
    magnitude plus 2 * lr, at least 99% within 1 ulp plus lr; the loss to
    2e-2."""
    ds = get_model_class("mamba").load_dummy_dataset()
    ds.sequence_length, ds.vocab_size = STEP_SEQ, NARROW["VOCAB"]
    batch = {k: v.reshape(ACC, MBS, STEP_SEQ) for k, v in ds.sample_batch(ACC * MBS, seed=0).items()}
    with pytest.MonkeyPatch.context() as mp:
        _narrow(mp, jmamba)
        _narrow(mp, tmamba, {**NARROW, "RESIDUAL_IN_FP32": False})
        jmc = jax_get_model_class("mamba")
        jsess = JaxTrainingPlan(mesh=JaxMeshConfig(1, 1), **_plan_kwargs(jmc)).build_session(jmc)
        jstate = jsess.init_state()
        init = _np(jstate.params)
        jstate, jm = jsess.train_step_fn()(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0))
        jfinal = mamba_params_from_jax(_np(jstate.params))

        mc = get_model_class("mamba")
        sess = TrainingPlan(mesh=MeshConfig(1, 1), **_plan_kwargs(mc)).build_session(mc, device="cpu")
        state = sess.init_state(state_dict=mamba_params_from_jax(init))
        state, m = sess.train_step_fn()(state, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    assert sess.module.remat and len(sess.module.layers) == 2
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=2e-2)
    lr = sess.tx.schedule(1)
    total = inside = 0
    for name, p in state.params.items():
        assert p.dtype == torch.bfloat16, name
        a, b = p.detach().float(), jfinal[name].float()
        ulp = torch.maximum(a.abs(), b.abs()) * BF16_ULP
        diff = (a - b).abs()
        assert bool((diff <= 2 * ulp + 2 * lr).all()), name
        inside += int((diff <= ulp + lr).sum())
        total += diff.numel()
    assert inside >= 0.99 * total, inside / total


# ---------------------------------------------------------------- the published residual

# d_model 64, 4 blocks, d_inner 128, d_state 16, dt_rank 4, vocab 256; 2 rows of 128 tokens
REF_CFG = {"d_model": 64, "n_layer": 4, "d_inner": 128, "d_state": 16, "d_conv": 4, "dt_rank": 4, "norm_eps": 1e-5,
           "padded_vocab_size": 256}
REF_SEQ = 128


@pytest.fixture(scope="module")
def reference_runs():
    """One seeded draw of the benchmark's weights (mamba_ssm's
    initialisation) and tokens; the plain reference's loss and gradients
    with f32 products and with bf16 operands."""
    from bench_port.reference import mamba as ref_mamba
    from bench_port.yardstick import data, weights

    w = weights.make_weights(ref_mamba.init_spec(REF_CFG), 17, "cpu", torch.float32)
    ids = torch.from_numpy(data.token_batch(17, 0, 2, REF_SEQ, 256)).long()
    out = {"weights": w, "ids": ids}
    for precision in ("f32", "bf16"):
        params = {n: t.clone().requires_grad_() for n, t in w.items()}
        loss = ref_mamba.loss(params, ids, REF_CFG, precision)
        loss.backward()
        out[precision] = (float(loss.detach()), {n: p.grad for n, p in params.items()})
    return out


def _port_on(reference_runs, dtype, **kw):
    model = MambaLM(64, 4, 128, 16, 4, 4, 256, dtype=dtype, **kw)
    model.load_state_dict(reference_runs["weights"])
    ids = reference_runs["ids"]
    loss = model(ids, labels=ids)
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}


def _grad_gaps(got: dict, want: dict) -> tuple[float, float]:
    """(all leaves together, the median leaf): |got - want| / |want|."""
    total = sum(float((got[n] - want[n]).square().sum()) for n in want) / sum(float(want[n].square().sum()) for n in want)
    per_leaf = sorted(float((got[n] - want[n]).norm() / want[n].norm()) for n in want)
    return total**0.5, per_leaf[len(per_leaf) // 2]


def test_published_residual_matches_the_plain_reference_f32(reference_runs):
    """At f32 compute the port as published equals the plain reference up to
    f32 summation order (the scans' chunks of 256 against 64, the products'
    blocking): the loss to 1e-6 relative, every gradient to 1e-5 of its
    norm."""
    want_l, want_g = reference_runs["f32"]
    got_l, got_g = _port_on(reference_runs, torch.float32)
    assert got_l == pytest.approx(want_l, rel=1e-6)
    assert got_g.keys() == want_g.keys()
    for name, want in want_g.items():
        assert float((got_g[name] - want).norm() / want.norm()) < 1e-5, name


def test_published_residual_is_nearer_the_reference_at_bf16(reference_runs):
    """At bf16 compute against the reference's bf16 operands: the port as
    published (f32 stream, conv and gate in f32), which the benchmark runs.

    - Its gradients over all leaves together within 1.1e-2 of the
      reference's: at this draw 0.89e-2, where the reference's own bf16
      operands move its gradients 0.78e-2 from its f32 products; the two
      round at the same products but sum in other orders (the scan's
      chunks, the products' blocking), and 1.1e-2 is 1.25 times the reading.
    - Its loss within 5e-6 relative of the reference's: at this draw 1.5e-6,
      against 1.7e-5 between the reference's bf16 and f32 operands; the
      bound is three times the reading.
    - Nearer the reference's gradients than the same port with
      ``residual_in_fp32=False``, over all leaves together and at the
      median leaf (1.24e-2 over all leaves at this draw)."""
    want_l, want_g = reference_runs["bf16"]
    got_l, published = _port_on(reference_runs, torch.bfloat16)
    _, jax_like = _port_on(reference_runs, torch.bfloat16, residual_in_fp32=False)
    (tot_p, med_p), (tot_j, med_j) = _grad_gaps(published, want_g), _grad_gaps(jax_like, want_g)
    assert tot_p < 1.1e-2, tot_p
    assert got_l == pytest.approx(want_l, rel=5e-6)
    assert tot_p < tot_j and med_p < med_j, (tot_p, tot_j, med_p, med_j)


def test_the_stream_is_f32_and_remat_keeps_it_alone():
    """At bf16 compute the stream enters and leaves every block in f32, and
    the final norm reads it in f32; under whole-block remat each block's
    checkpoint saves one tensor, the f32 stream it was given."""
    model = MambaLM(64, 4, 128, 16, 4, 4, 256, dtype=torch.bfloat16, remat=True)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(torch.bfloat16)
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 40))).long()
    seen = []
    for block in model.layers:
        block.register_forward_hook(lambda mod, args, out: seen.append((args[0].dtype, out.dtype)))
    final = []
    model.final_norm.register_forward_hook(lambda mod, args, out: final.append(args[0].dtype))
    saved, remat = [], tlayers.remat

    def recording_remat(block, x, **kw):
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append((t, x)) or t, lambda t: t):
            out = remat(block, x, **kw)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmamba, "remat", recording_remat)
        model(ids, labels=ids).backward()
    assert seen == [(torch.float32, torch.float32)] * 4 and final == [torch.float32]
    kept = [(t, x) for t, x in saved if t.numel()]
    assert len(kept) == 4 and all(t is x and t.dtype == torch.float32 for t, x in kept)
