"""The state layouts the method grid names, against the JAX ``TrainSession``:
the f32 master (``master_weights="device"`` and ``True`` with bf16 compute;
the grid's ``bf16_master``) and gradient accumulators of another dtype than
the params (``grad_accum_dtype``), at pythia-14m and sequence 33 from the
JAX ``init_state()`` params (through ``params_from_jax``) and the same
token batches, and the master layout under llava's trainable mask at the
JAX toy dims.

Two tolerances, for two kinds of input:

- **The same gradients** (``test_master_update_matches_jax``): both update
  functions take one f32 gradient tree; the masters must meet the f32
  tolerance of ``tests/test_torch_step.py`` (every element to 0.1 * lr,
  99% to 1e-3 * lr) and the moments agree to f32 rounding of each leaf's
  largest element.
- **Whole steps** in bf16 compute: the two frameworks round bf16 products
  and elementwise work at other points, so the gradients differ by bf16
  noise, and Adam turns a gradient that is only noise (the k-bias gradient
  vanishes in exact arithmetic) into an update of up to a step's lr of
  either sign. Measured at pythia-14m: 99.9-99.98% of master elements lie
  within 0.1 * lr, the worst 2 * (lr_1 + lr_2) off (both steps' updates of
  a qkv bias flipped). So: at least 99% within 0.1 * lr, every element
  within 3 * (lr_1 + lr_2), losses to 2e-2; a missing or wrong update is
  off by about lr nearly everywhere. The f32 layout with bf16 accumulators
  rounds its f32 gradients at accumulator boundaries: 99.9% within 0.1 *
  lr, every element within lr. llava's projector (6,272 elements, 98.2%
  measured) is held to ``tests/test_torch_llava.py``'s share, 97%.

In every master layout the live bf16 params equal ``master.to(bf16)`` bit
for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_llm_pretraining_tpu.models import get_model_class as jax_get_model_class
from multimodal_llm_pretraining_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from multimodal_llm_pretraining_tpu.train import TrainingPlan as JaxTrainingPlan
from multimodal_llm_pretraining_tpu_torch.benchmarking.utils import BenchmarkHarness
from multimodal_llm_pretraining_tpu_torch.models import get_model_class
from multimodal_llm_pretraining_tpu_torch.models.from_jax import llava_params_from_jax, params_from_jax
from multimodal_llm_pretraining_tpu_torch.parallel.mesh import MeshConfig
from multimodal_llm_pretraining_tpu_torch.train import TrainingPlan
from multimodal_llm_pretraining_tpu_torch.training.optimizer import AdamChain

torch.set_num_threads(2)

SEQ, ACC, MBS = 33, 2, 2
BF16_MASTER = dict(bf16=True, master_weights="device", opt_state_dtype="bf16", grad_accum_dtype="bf16")


def _plan_kwargs(mc, **kw):
    return dict(
        num_training_steps=5, micro_batch_size=MBS, gradient_accumulation_steps=ACC, optimizer=mc.optimizer,
        optimizer_kwargs=mc.optimizer_kwargs, scheduler_type=mc.scheduler_type, scheduler_kwargs=mc.scheduler_kwargs,
        max_grad_norm=mc.max_grad_norm, **kw,
    )


def _batches(n):
    ds = get_model_class("pythia-14m").load_dummy_dataset()
    ds.sequence_length = SEQ
    return [{k: v.reshape(ACC, MBS, SEQ) for k, v in ds.sample_batch(ACC * MBS, seed=i).items()} for i in range(n)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _adam(opt_state) -> optax.ScaleByAdamState:
    """The Adam moments inside a JAX optimizer state, master layout or not."""
    inner = opt_state["inner"] if isinstance(opt_state, dict) else opt_state
    return next(s for s in jax.tree_util.tree_leaves(inner, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
                if isinstance(s, optax.ScaleByAdamState))


def _jax_session(**kw):
    mc = jax_get_model_class("pythia-14m")
    sess = JaxTrainingPlan(mesh=JaxMeshConfig(1, 1), **_plan_kwargs(mc, **kw)).build_session(mc)
    sess.dataset.sequence_length = SEQ
    return sess


def _torch_session(init, **kw):
    mc = get_model_class("pythia-14m")
    sess = TrainingPlan(mesh=MeshConfig(1, 1), **_plan_kwargs(mc, **kw)).build_session(mc, device="cpu")
    sess.dataset.sequence_length = SEQ
    return sess, sess.init_state(state_dict=params_from_jax(init))


def _two_steps(**kw):
    """Two steps on each side: (port session, port state, JAX state, losses
    of each)."""
    jsess = _jax_session(**kw)
    jstate = jsess.init_state()
    init = _np(jstate.params)
    jstep, jlosses = jsess.train_step_fn(), []
    for batch in _batches(2):
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0))
        jlosses.append(float(m["loss"]))
    sess, state = _torch_session(init, **kw)
    losses = []
    for batch in _batches(2):
        state, m = sess.train_step_fn()(state, {k: torch.from_numpy(v).long() for k, v in batch.items()})
        losses.append(float(m["loss"]))
    return sess, state, jstate, losses, jlosses


def _step_lrs(sess) -> tuple[float, float]:
    """The lr each of the first two steps applied (the optax chain reads the
    schedule one count behind the fused Adam)."""
    lag = 0 if isinstance(sess.tx, AdamChain) else 1
    return sess.tx.schedule(lag), sess.tx.schedule(1 + lag)


def _hold_to_bf16_tolerance(got: dict, want: dict, lrs: tuple[float, float], share: float = 0.99):
    lr, total = lrs[1], sum(lrs)
    inside = count = 0
    for name, w in want.items():
        diff = (got[name].float() - w.float()).abs()
        assert diff.max() <= 3 * total, name
        inside += int((diff <= 0.1 * lr).sum())
        count += diff.numel()
    assert inside >= share * count, inside / count


def _assert_master_layout(sess, state):
    """bf16 live params, f32 masters, each param the master rounded once."""
    master = state.opt_state.master
    assert master is not None and len(master) == len(sess.trainable)
    for name, m in zip(sess.trainable, master):
        p = state.params[name]
        assert p.dtype == torch.bfloat16 and m.dtype == torch.float32, name
        assert torch.equal(p.detach(), m.to(torch.bfloat16)), name


@pytest.mark.parametrize("kw", [BF16_MASTER, dict(bf16=True, master_weights=True)], ids=["bf16_master", "true"])
def test_master_layout_steps_match_jax(kw):
    """Two steps: the grid's ``bf16_master`` (bf16 moments, fused Adam) and
    ``master_weights=True`` (f32 moments, the optax chain, bf16
    accumulators as the params)."""
    sess, state, jstate, losses, jlosses = _two_steps(**kw)
    np.testing.assert_allclose(losses, jlosses, atol=2e-2)
    assert state.step == 2 and state.opt_state.count == 2
    _assert_master_layout(sess, state)
    want = params_from_jax(_np(jstate.opt_state["master"]))
    _hold_to_bf16_tolerance(dict(zip(sess.trainable, state.opt_state.master)), want, _step_lrs(sess))
    moments = _adam(jstate.opt_state)
    for ours, theirs in ((state.opt_state.mu, moments.mu), (state.opt_state.nu, moments.nu)):
        theirs = params_from_jax(_np(theirs))
        for name, t in zip(sess.trainable, ours):
            assert t.dtype == (torch.bfloat16 if "opt_state_dtype" in kw else torch.float32), name
            w = theirs[name].float()
            assert (t.float() - w).norm() <= 5e-2 * w.norm(), name


@pytest.mark.parametrize("master_weights", ["device", True])
def test_master_update_matches_jax(master_weights):
    """The same f32 gradient trees (f32 accumulators) through two updates on
    each side: masters to the f32 tolerance, moments to f32 rounding, and
    the bf16 params their masters rounded."""
    kw = dict(bf16=True, master_weights=master_weights, grad_accum_dtype="f32")
    jsess = _jax_session(**kw)
    jstate = jsess.init_state()
    sess, state = _torch_session(_np(jstate.params), **kw)
    update, rng = jsess.optimizer_update_fn(), np.random.default_rng(0)
    params, opt_state = jstate.params, jstate.opt_state
    for _ in range(2):
        grads = jax.tree.map(lambda s: rng.normal(0.0, 1e-2, s.shape).astype(np.float32), jsess.grad_shapes)
        sess.accumulators = {n: g.clone() for n, g in params_from_jax(grads).items()}
        sess.optimizer_update_fn()(state, float(ACC))
        params, opt_state = update(params, opt_state, jax.tree.map(jnp.asarray, grads), float(ACC))
    _assert_master_layout(sess, state)
    lr = _step_lrs(sess)[1]
    want = params_from_jax(_np(opt_state["master"]))
    inside = count = 0
    for name, m in zip(sess.trainable, state.opt_state.master):
        diff = (m - want[name]).abs()
        assert diff.max() <= 0.1 * lr, name
        inside += int((diff <= 1e-3 * lr).sum())
        count += diff.numel()
    assert inside >= 0.99 * count, inside / count
    moments = _adam(opt_state)
    for ours, theirs in ((state.opt_state.mu, moments.mu), (state.opt_state.nu, moments.nu)):
        theirs = params_from_jax(_np(theirs))
        for name, t in zip(sess.trainable, ours):
            # to f32 rounding of the leaf's scale: an element where the
            # moment's two terms cancel keeps their rounding, not its own
            assert (t - theirs[name]).abs().max() <= 1e-5 * theirs[name].abs().max(), name


@pytest.mark.parametrize(
    "kw", [dict(grad_accum_dtype="bf16"), dict(BF16_MASTER, grad_accum_dtype="f32")],
    ids=["f32_params_bf16_acc", "bf16_params_f32_acc"],
)
def test_mixed_accumulators_match_jax(kw):
    """Accumulators of another dtype than the params, both ways, two steps
    against JAX; the port keeps them apart from ``.grad``."""
    sess, state, jstate, losses, jlosses = _two_steps(**kw)
    assert sess.grad_dtype != sess.param_dtype
    assert sess.accumulators == {} and all(p.grad is None for p in state.params.values())
    np.testing.assert_allclose(losses, jlosses, atol=2e-2 if kw.get("bf16") else 1e-5)
    lrs = _step_lrs(sess)
    if "master_weights" in kw:
        _assert_master_layout(sess, state)
        _hold_to_bf16_tolerance(dict(zip(sess.trainable, state.opt_state.master)),
                                params_from_jax(_np(jstate.opt_state["master"])), lrs)
        return
    want, lr = params_from_jax(_np(jstate.params)), lrs[1]
    inside = count = 0
    for name, p in state.params.items():
        assert p.dtype == torch.float32, name
        diff = (p.detach() - want[name]).abs()
        assert diff.max() <= lr, name
        inside += int((diff <= 0.1 * lr).sum())
        count += diff.numel()
    assert inside >= 0.999 * count, inside / count


@pytest.mark.parametrize("grad_accum_dtype", ["bf16", "f32"])
def test_accumulators_round_once_per_micro_batch(grad_accum_dtype):
    """``accumulate_fn`` twice: each accumulator is ``(a + g).to(a.dtype)``
    of the micro-batches' own gradients, bit for bit; the params' ``.grad``
    is dropped after each backward; the harness counts the accumulators in
    the state it keeps. At ``acc == 1`` the fused step keeps the gradient
    unrounded in ``.grad``."""
    bf16_params = grad_accum_dtype == "f32"
    kw = dict(BF16_MASTER, grad_accum_dtype="f32") if bf16_params else dict(grad_accum_dtype="bf16")
    mc = get_model_class("pythia-14m")
    plan = TrainingPlan(mesh=MeshConfig(1, 1), **_plan_kwargs(mc, **kw))
    harness = BenchmarkHarness(plan, mc, device="cpu")
    sess = harness.session
    sess.dataset.sequence_length = SEQ
    harness.setup()
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[grad_accum_dtype]
    micro = [sess.make_micro_batch(MBS, seed=i) for i in range(2)]
    singles = []
    for mb in micro:  # each micro-batch's gradient alone, in the params' dtype
        sess._route_grads = False
        sess._accumulate(harness.state, mb)
        singles.append({n: p.grad.clone() for n, p in harness.state.params.items()})
        sess.zero_grads()
    sess._route_grads = True
    for mb in micro:
        sess.accumulate_fn()(harness.state, mb)
        assert all(p.grad is None for p in harness.state.params.values())
    for name, acc in sess.accumulators.items():
        want = singles[0][name].to(dtype)
        want = (want.float() + singles[1][name].float()).to(dtype)
        assert acc.dtype == dtype and torch.equal(acc, want), name
    n = sum(p.numel() for p in sess.module.parameters())
    moments = 2 * n * (2 if bf16_params else 4)
    assert harness.persistent_state_bytes() == moments + (4 * n if bf16_params else 0) + n * dtype.itemsize
    harness.manual_optimization_step()
    assert sess.accumulators == {}

    one = TrainingPlan(mesh=MeshConfig(1, 1), **{**_plan_kwargs(mc, **kw), "gradient_accumulation_steps": 1})
    sess1 = one.build_session(mc, device="cpu")
    sess1.dataset.sequence_length = SEQ
    state1 = sess1.init_state()
    sess1.grads_fn()(state1, {k: v[None] for k, v in micro[0].items()})
    assert sess1.accumulators == {} and all(p.grad is not None for p in state1.params.values())


def test_llava_master_layout_keeps_the_frozen_leaves(monkeypatch):
    """llava-pretrain at the JAX toy dims in ``bf16_master``, two steps from
    the JAX params: masters only for the 4 trainable projector leaves, every
    frozen leaf bit for bit, the projector's masters to JAX's within the
    whole-step tolerance above."""
    monkeypatch.setenv("MLPT_LLAVA_TEST_DIMS", "1")
    tower = dict(hidden=32, num_layers=2, num_heads=2, intermediate=64, patch=14, image_size=28)
    lm = dict(hidden=64, num_layers=2, num_heads=4, num_kv_heads=2, ffn=128)
    mc = get_model_class("llava-pretrain")
    mc.tower_kwargs, mc.lm_kwargs = tower, lm
    sess = TrainingPlan(mesh=MeshConfig(1, 1), **_plan_kwargs(mc, **BF16_MASTER)).build_session(mc, device="cpu")
    sess.dataset.sequence_length = 12
    batches = [sess.make_train_batch(seed=i) for i in range(2)]
    jmc = jax_get_model_class("llava-pretrain")
    jsess = JaxTrainingPlan(mesh=JaxMeshConfig(1, 1), **_plan_kwargs(jmc, **BF16_MASTER)).build_session(jmc)
    jstate = jsess.init_state()
    init = llava_params_from_jax(_np(jstate.params))
    jstep = jsess.train_step_fn()
    jlosses = []
    for batch in batches:
        jstate, m = jstep(jstate, {k: jnp.asarray(v.numpy().astype(np.float32 if v.is_floating_point() else np.int32))
                                   for k, v in batch.items()}, jax.random.key(0))
        jlosses.append(float(m["loss"]))
    state = sess.init_state(state_dict=init)
    losses = []
    for batch in batches:
        state, m = sess.train_step_fn()(state, batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, atol=2e-2)
    assert sess.trainable == ["projector_in.weight", "projector_in.bias", "projector_out.weight", "projector_out.bias"]
    _assert_master_layout(sess, state)
    masters = llava_params_from_jax(_np(jstate.opt_state["master"]))
    _hold_to_bf16_tolerance(dict(zip(sess.trainable, state.opt_state.master)),
                            {n: masters[n] for n in sess.trainable}, _step_lrs(sess), share=0.97)
    for name, p in state.params.items():
        if name not in sess.trainable:
            assert p.dtype == torch.bfloat16 and torch.equal(p, init[name]), name
