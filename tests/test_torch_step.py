"""The port's training slice as a whole against the JAX ``TrainSession``:
pythia-14m at sequence 33, one device, the same initial params (the JAX
``init_state()``, through ``params_from_jax``) and the same token batches
(numpy, fed to both)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_llm_pretraining_tpu.models import get_model_class as jax_get_model_class
from multimodal_llm_pretraining_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from multimodal_llm_pretraining_tpu.train import TrainingPlan as JaxTrainingPlan
from multimodal_llm_pretraining_tpu_torch.models import get_model_class
from multimodal_llm_pretraining_tpu_torch.models.from_jax import params_from_jax
from multimodal_llm_pretraining_tpu_torch.parallel.mesh import MeshConfig
from multimodal_llm_pretraining_tpu_torch.train import TrainingPlan

torch.set_num_threads(2)

SEQ, ACC, MBS = 33, 2, 2
BF16_SR = dict(bf16=True, master_weights="sr", opt_state_dtype="bf16", grad_accum_dtype="bf16")


def _plan_kwargs(mc, **kw):
    return dict(
        num_training_steps=5, micro_batch_size=MBS, gradient_accumulation_steps=ACC, optimizer=mc.optimizer,
        optimizer_kwargs=mc.optimizer_kwargs, scheduler_type=mc.scheduler_type, scheduler_kwargs=mc.scheduler_kwargs,
        max_grad_norm=mc.max_grad_norm, **kw,
    )


def _batches(n):
    """[acc, mbs, S] id batches from the port's dataset formula."""
    ds = get_model_class("pythia-14m").load_dummy_dataset()
    ds.sequence_length = SEQ
    return [{k: v.reshape(ACC, MBS, SEQ) for k, v in ds.sample_batch(ACC * MBS, seed=i).items()} for i in range(n)]


def _jax_run(steps, **kw):
    """(initial params as numpy, losses, final params as numpy)."""
    mc = jax_get_model_class("pythia-14m")
    sess = JaxTrainingPlan(mesh=JaxMeshConfig(1, 1), **_plan_kwargs(mc, **kw)).build_session(mc)
    sess.dataset.sequence_length = SEQ
    state = sess.init_state()
    init = jax.tree.map(np.asarray, state.params)
    step = sess.train_step_fn()
    losses = []
    for batch in _batches(steps):
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0))
        losses.append(float(m["loss"]))
    return init, losses, jax.tree.map(np.asarray, state.params)


def _torch_session(init, **kw):
    mc = get_model_class("pythia-14m")
    sess = TrainingPlan(mesh=MeshConfig(1, 1), **_plan_kwargs(mc, **kw)).build_session(mc, device="cpu")
    sess.dataset.sequence_length = SEQ
    return sess, sess.init_state(state_dict=params_from_jax(init))


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_f32_run():
    return _jax_run(2)


@pytest.fixture(scope="module")
def jax_bf16_sr_run():
    return _jax_run(1, **BF16_SR)


def test_two_f32_steps_match_jax(jax_f32_run):
    """f32 layout, acc 2, two steps. The first step's LR is schedule(0) = 0
    (optax chain), so the params move at step 2 only, by about lr * sign(g)
    = 2.5e-4 per element. Losses to 1e-5 relative. Params: every element
    to 0.1 * lr, and 99% of them to 1e-3 * lr. Adam normalises a gradient
    that is only rounding noise (the k-bias gradient vanishes in exact
    arithmetic) to an update of up to lr whose value depends on that noise,
    while a wrong or missing update would be off by lr or more."""
    init, jlosses, jfinal = jax_f32_run
    sess, state = _torch_session(init)
    step = sess.train_step_fn()
    losses = []
    for batch in _batches(2):
        state, m = step(state, _torch_batch(batch))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert state.step == 2 and state.opt_state.count == 2
    want, start = params_from_jax(jfinal), params_from_jax(init)
    lr = sess.tx.schedule(1)
    total = close = 0
    for name, p in state.params.items():
        assert p.dtype == torch.float32
        assert (want[name] - start[name]).abs().max() > 0.5 * lr, name  # the comparison sees a real update
        diff = (p.detach() - want[name]).abs()
        assert diff.max() <= 0.1 * lr, name
        close += int((diff <= 1e-3 * lr).sum())
        total += diff.numel()
    assert close >= 0.99 * total, close / total


def test_one_bf16_sr_step_matches_jax(jax_bf16_sr_run):
    """bf16_sr layout, one step: bf16 params, grads, accumulators and
    moments, stochastic rounding of p + d. The two sides draw different SR
    bits and round bf16 compute differently, and the step-1 update (lr
    2.5e-4) is below one bf16 ulp of most weights, so SR decides each
    element's last bit. Allowed: every element within 2 bf16 ulps of its
    magnitude plus 2 * lr; at least 99% within 1 ulp plus lr."""
    init, jlosses, jfinal = jax_bf16_sr_run
    sess, state = _torch_session(init, **BF16_SR)
    state, m = sess.train_step_fn()(state, _torch_batch(_batches(1)[0]))
    np.testing.assert_allclose(float(m["loss"]), jlosses[0], atol=2e-2)
    lr = sess.tx.schedule(1)
    want = params_from_jax(jfinal)
    total = inside = 0
    for name, p in state.params.items():
        assert p.dtype == torch.bfloat16, name
        a, b = p.detach().float(), want[name].float()
        ulp = torch.maximum(a.abs(), b.abs()) * 2.0**-7
        diff = (a - b).abs()
        assert bool((diff <= 2 * ulp + 2 * lr).all()), name
        inside += int((diff <= ulp + lr).sum())
        total += diff.numel()
    assert inside >= 0.99 * total, inside / total


def test_accumulate_and_update_equal_the_train_step(jax_f32_run):
    """``accumulate_fn`` per micro-batch then ``optimizer_update_fn`` is the
    same computation as ``train_step_fn``: bit for bit on the CPU."""
    init, _, _ = jax_f32_run
    batch = _torch_batch(_batches(1)[0])
    sess_a, state_a = _torch_session(init)
    sess_b, state_b = _torch_session(init)
    for _ in range(2):  # two steps, so the second one moves the params
        state_a, m = sess_a.train_step_fn()(state_a, batch)
        acc, upd = sess_b.accumulate_fn(), sess_b.optimizer_update_fn()
        loss_sum = sum(acc(state_b, {k: v[i] for k, v in batch.items()}) for i in range(ACC))
        upd(state_b, float(ACC))
        assert torch.equal(m["loss"], loss_sum / ACC)
    for name in state_a.params:
        assert torch.equal(state_a.params[name], state_b.params[name]), name
    assert all(p.grad is None for p in state_b.params.values())


def test_grads_fn_sums_the_micro_batch_grads(jax_f32_run):
    """``grads_fn`` accumulates every micro-batch into ``.grad`` in the
    params' dtype and returns the summed loss."""
    init, _, _ = jax_f32_run
    batch = _torch_batch(_batches(1)[0])
    sess, state = _torch_session(init)
    loss_sum = sess.grads_fn()(state, batch)
    summed = {n: p.grad.clone() for n, p in state.params.items()}
    sess.zero_grads()
    singles = [sess.accumulate_fn()(state, {k: v[i : i + 1][0] for k, v in batch.items()}) for i in range(ACC)]
    torch.testing.assert_close(loss_sum, sum(singles))
    for n, p in state.params.items():
        torch.testing.assert_close(p.grad, summed[n], rtol=0, atol=0)


@pytest.mark.parametrize("policy", ["flash", "dots"])
def test_activation_checkpointing_plan_takes_a_step(jax_f32_run, policy):
    """The plan with ``activation_checkpointing=True`` (once refused with
    ROADMAP Queue 1 item 2) builds, hands its ``checkpoint_policy`` to
    pythia, and takes one CPU step equal bit for bit to the step without
    remat from the same params and batch."""
    init, _, _ = jax_f32_run
    batch = _torch_batch(_batches(1)[0])
    runs = []
    for remat in (False, True):
        sess, state = _torch_session(init, activation_checkpointing=remat, checkpoint_policy=policy)
        assert sess.module.remat_policy == (policy if remat else None)
        state, m = sess.train_step_fn()(state, batch)
        runs.append((m["loss"], state.params))
    assert torch.isfinite(runs[1][0]) and torch.equal(runs[1][0], runs[0][0])
    for name, p in runs[0][1].items():
        assert torch.equal(runs[1][1][name], p), name


@pytest.mark.parametrize(
    "kw,item",
    [
        (dict(sharding="zero_2"), "Queue 1 items 7"),
        (dict(mesh=MeshConfig(1, 4)), "Queue 1 item 7"),
    ],
)
def test_unported_plan_fields_raise_with_roadmap_item(kw, item):
    mc = get_model_class("pythia-14m")
    args = _plan_kwargs(mc, **{k: v for k, v in kw.items() if k != "mesh"})
    with pytest.raises(NotImplementedError, match=item):
        TrainingPlan(mesh=kw.get("mesh", MeshConfig(1, 1)), **args).build_session(mc, device="cpu")


@pytest.mark.parametrize("precision,allow", [("highest", False), ("high", True), ("default", True)])
def test_matmul_precision_sets_tf32_explicitly(precision, allow):
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        TrainingPlan(num_training_steps=1, micro_batch_size=1, gradient_accumulation_steps=1,
                     matmul_precision=precision).apply_matmul_precision()
        assert torch.backends.cuda.matmul.allow_tf32 is allow and torch.backends.cudnn.allow_tf32 is allow
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_cuda_session_without_a_gpu_raises():
    """A session asked for the GPU on a machine without one fails; it never
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    mc = get_model_class("pythia-14m")
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainingPlan(mesh=MeshConfig(1, 1), **_plan_kwargs(mc)).build_session(mc)


@pytest.mark.parametrize("model_type", ["pythia-14m", "mamba", "llava-pretrain", "vit"])
def test_build_model_defaults_to_the_card(model_type):
    """Every ported family's ``build_model`` builds on the card unless the
    caller asks for the CPU, as the session does; without a GPU such a call
    raises, it never builds on the CPU instead."""
    import inspect

    mc = get_model_class(model_type)
    assert inspect.signature(mc.build_model).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
            mc.build_model()


def test_training_plan_fields_and_defaults_match_jax():
    """Same field names, order and defaults as the JAX ``TrainingPlan``
    (the mesh default is each package's own ``MeshConfig()``)."""
    import dataclasses

    jf, tf = dataclasses.fields(JaxTrainingPlan), dataclasses.fields(TrainingPlan)
    assert [f.name for f in tf] == [f.name for f in jf]
    for a, b in zip(tf, jf):
        if a.name == "mesh":
            assert dataclasses.asdict(a.default_factory()) == dataclasses.asdict(b.default_factory())
        elif a.default_factory is not dataclasses.MISSING:
            assert a.default_factory() == b.default_factory(), a.name
        else:
            assert a.default == b.default, a.name


def test_dummy_text_dataset_is_seeded_numpy():
    """Batches are ``default_rng(seed).integers(0, vocab, (B, S))`` (the JAX
    package's formula without its C++ library), labels equal to the ids."""
    ds = get_model_class("pythia-14m").load_dummy_dataset()
    batch = ds.sample_batch(3, seed=11)
    want = np.random.default_rng(11).integers(0, 50304, (3, 2049), dtype=np.int32)
    np.testing.assert_array_equal(batch["input_ids"], want)
    np.testing.assert_array_equal(batch["labels"], want)
    np.testing.assert_array_equal(ds[5]["input_ids"], ds.sample_batch(1, seed=5)["input_ids"][0])
