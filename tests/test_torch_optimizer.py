"""The port's optimizer pieces against the JAX / optax ones on identical
inputs (made with numpy)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_llm_pretraining_tpu.models import SchedulerType as JaxSchedulerType
from multimodal_llm_pretraining_tpu.training import optimizer as jopt
from multimodal_llm_pretraining_tpu_torch.models import SchedulerType
from multimodal_llm_pretraining_tpu_torch.training import optimizer as topt

torch.set_num_threads(2)

SHAPES = [(7, 5), (11,), (3, 4, 2)]
B1, B2, EPS, WD, LR = 0.9, 0.95, 1e-8, 0.01, 1e-3


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in SHAPES]


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize(
    "stype,kwargs,steps",
    [
        ("linear", {"num_warmup_steps": 3}, 10),
        ("cosine", {"num_warmup_steps": 3}, 10),
        ("cosine_with_min_lr", {"num_warmup_steps": 1430, "min_lr_rate": 0.1}, 143000),
        # warmup clamped to steps - 1: the recipe's 1430 warmup steps in an 8-step plan
        ("cosine_with_min_lr", {"num_warmup_steps": 1430, "min_lr_rate": 0.1}, 8),
        ("cosine_with_min_lr", {"num_warmup_steps": 2, "min_lr": 1e-5}, 6),
        ("cosine", {}, 5),  # no warmup
        ("linear", {"num_warmup_steps": 0}, 1),
    ],
)
def test_schedule_matches_jax(stype, kwargs, steps):
    want = jopt.build_schedule(JaxSchedulerType(stype), kwargs, LR, steps)
    got = topt.build_schedule(SchedulerType(stype), kwargs, LR, steps)
    for count in sorted({0, 1, 2, 3, 4, 5, 7, 8, 9, steps - 1, steps, steps + 3, 1429, 1430, 1431, 71500}):
        # optax evaluates in f32, the port in Python floats: a few f32 ulps of
        # the peak LR (1 - count/T rounds to f32 before it scales the peak)
        np.testing.assert_allclose(got(count), float(want(count)), rtol=2e-6, atol=4 * 2.0**-24 * LR, err_msg=str(count))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("scale", [1.0, 1e-3])
def test_clip_by_global_norm_keep_dtype_matches_jax(dtype, scale):
    """Above and below max_norm 1.0. The norm follows optax's dtypes (a bf16
    leaf's sum of squares rounds to bf16): at bf16 the clipped grads may
    differ by one bf16 ulp where XLA keeps excess precision inside the
    fused square-and-sum."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    grads = _np_tree(0, scale)
    tx = jopt.clip_by_global_norm_keep_dtype(1.0)
    want, _ = tx.update([jnp.asarray(g, jdt) for g in grads], tx.init(None))
    got = [torch.from_numpy(g).to(tdt) for g in grads]
    topt.clip_by_global_norm_keep_dtype(got, 1.0)
    tol = 1e-6 if dtype == "f32" else 2.0**-7
    for g, w in zip(got, want):
        assert g.dtype == tdt
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=tol, atol=0)


@pytest.mark.parametrize("state_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("decoupled", [False, True])
def test_fused_adam_lowp_matches_jax(state_dtype, decoupled):
    """Three steps of the per-leaf Adam on bf16 params and grads, after the
    dtype-keeping clip. Its math is f32 on both sides; stored moments
    round to ``state_dtype`` once per step. Updates agree to 1e-5 relative
    (f32 order of operations), moments to one ulp of their dtype."""
    jdt_state, tdt_state = (jnp.float32, torch.float32) if state_dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    schedule_j = jopt.build_schedule(JaxSchedulerType.COSINE_WITH_MIN_LR, {"num_warmup_steps": 2, "min_lr_rate": 0.1}, LR, 10)
    schedule_t = topt.build_schedule(SchedulerType.COSINE_WITH_MIN_LR, {"num_warmup_steps": 2, "min_lr_rate": 0.1}, LR, 10)
    jtx = optax.chain(jopt.clip_by_global_norm_keep_dtype(1.0), jopt.fused_adam_lowp(B1, B2, EPS, schedule_j, WD, decoupled, jdt_state))
    ttx = topt.FusedAdamLowp(B1, B2, EPS, schedule_t, WD, decoupled, tdt_state, 1.0)
    params = _np_tree(1)
    jparams = [jnp.asarray(p, jnp.bfloat16) for p in params]
    tparams = [torch.from_numpy(p).to(torch.bfloat16) for p in params]
    jstate, tstate = jtx.init(jparams), ttx.init(tparams)
    mom_tol = 1e-6 if state_dtype == "f32" else 2.0**-7
    for step in range(3):
        grads = _np_tree(10 + step, 0.5)
        jupd, jstate = jtx.update([jnp.asarray(g, jnp.bfloat16) for g in grads], jstate, jparams)
        tupd = ttx.update([torch.from_numpy(g).to(torch.bfloat16) for g in grads], tstate, tparams)
        for u, w in zip(tupd, jupd):
            np.testing.assert_allclose(_f32(u), _f32(w), rtol=1e-5, atol=1e-9, err_msg=f"step {step}")
        adam = jstate[1]
        assert tstate.count == int(adam.count)
        for m, jm in zip(tstate.mu + tstate.nu, list(adam.mu) + list(adam.nu)):
            assert m.dtype == tdt_state
            np.testing.assert_allclose(_f32(m), _f32(jm), rtol=mom_tol, atol=1e-12)


@pytest.mark.parametrize("optimizer", ["adam", "adamw"])
def test_adam_chain_matches_optax_chain(optimizer):
    """The f32 layout's optax chain (clip, L2 or decoupled decay, Adam, LR),
    three steps, params updated between them: to 1e-5 relative."""
    kwargs = {"lr": LR, "betas": (B1, B2), "eps": EPS, "weight_decay": WD}
    skw = {"num_warmup_steps": 2, "min_lr_rate": 0.1}
    jtx = jopt.build_optimizer(optimizer, kwargs, JaxSchedulerType.COSINE_WITH_MIN_LR, skw, 10, max_grad_norm=1.0)
    ttx = topt.build_optimizer(optimizer, kwargs, SchedulerType.COSINE_WITH_MIN_LR, skw, 10, max_grad_norm=1.0)
    assert isinstance(ttx, topt.AdamChain)
    params = _np_tree(2)
    jparams = [jnp.asarray(p) for p in params]
    tparams = [torch.from_numpy(p.copy()) for p in params]
    jstate, tstate = jtx.init(jparams), ttx.init(tparams)
    for step in range(3):
        grads = _np_tree(20 + step, 0.7)
        jupd, jstate = jtx.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, jupd)
        for p, d in zip(tparams, ttx.update([torch.from_numpy(g) for g in grads], tstate, tparams)):
            p.add_(d)
        for p, w in zip(tparams, jparams):
            np.testing.assert_allclose(p.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7, err_msg=f"step {step}")


def test_adam_weight_decay_is_l2_into_the_grad():
    """"adam" adds wd * p to the gradient before the moments (L2), "adamw"
    adds it to the update (decoupled): with a zero gradient only the second
    leaves the first moment at zero."""
    p = [torch.full((4,), 2.0)]
    for optimizer, mu_nonzero in (("adam", True), ("adamw", False)):
        tx = topt.build_optimizer(optimizer, {"lr": 1.0, "weight_decay": 0.5}, SchedulerType.LINEAR, {}, 10)
        state = tx.init(p)
        tx.update([torch.zeros(4)], state, p)
        assert bool((state.mu[0] != 0).all()) == mu_nonzero


def test_optimizer_paths_read_the_schedule_one_step_apart():
    """The optax chain reads schedule(count) before its increment, so under
    warmup step 1 has LR schedule(0) = 0 and moves nothing; fused_adam_lowp
    reads schedule(count + 1) and moves at step 1. The JAX functions behave
    the same way."""
    kwargs = {"lr": LR, "betas": (B1, B2), "eps": EPS, "weight_decay": 0.0}
    skw = {"num_warmup_steps": 1430, "min_lr_rate": 0.1}
    params = [torch.ones(5)]
    grads = [torch.full((5,), 0.1)]
    chain = topt.build_optimizer("adam", kwargs, SchedulerType.COSINE_WITH_MIN_LR, skw, 8, max_grad_norm=1.0)
    fused = topt.build_optimizer("adam", kwargs, SchedulerType.COSINE_WITH_MIN_LR, skw, 8, 1.0, opt_state_dtype=torch.bfloat16)
    assert (chain.update([g.clone() for g in grads], chain.init(params), params)[0] == 0).all()
    step1 = fused.update([g.clone() for g in grads], fused.init(params), params)[0]
    sched = topt.build_schedule(SchedulerType.COSINE_WITH_MIN_LR, skw, LR, 8)
    torch.testing.assert_close(step1, torch.full((5,), -sched(1)), rtol=1e-5, atol=0)

    jchain = jopt.build_optimizer("adam", kwargs, JaxSchedulerType.COSINE_WITH_MIN_LR, skw, 8, max_grad_norm=1.0)
    jfused = jopt.build_optimizer("adam", kwargs, JaxSchedulerType.COSINE_WITH_MIN_LR, skw, 8, 1.0, opt_state_dtype=jnp.bfloat16)
    jp, jg = [jnp.ones(5)], [jnp.full((5,), 0.1)]
    assert float(jnp.abs(jchain.update(jg, jchain.init(jp), jp)[0][0]).max()) == 0.0
    np.testing.assert_allclose(np.asarray(jfused.update(jg, jfused.init(jp), jp)[0][0]), step1.numpy(), rtol=1e-5)


def test_stochastic_round_to_is_bit_identical_given_the_same_draws():
    """Handed JAX's own 16-bit draws, the port rounds to the same bf16 bits
    (including negatives, exact values, huge values that carry into inf,
    and zero)."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(size=4000).astype(np.float32) * 10.0 ** rng.integers(-6, 6, size=4000),
                        np.array([0.0, -0.0, 1.0, -2.5, 3.4e38, -3.4e38], np.float32)])
    key = jax.random.key(5)
    want = np.asarray(jopt.stochastic_round_to(jnp.asarray(x), jnp.bfloat16, key).astype(jnp.float32))
    bits = np.asarray(jax.random.bits(key, x.shape, jnp.uint16)).astype(np.int32)
    got = topt.stochastic_round_to(torch.from_numpy(x), torch.bfloat16, bits=torch.from_numpy(bits))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy().view(np.uint32), want.view(np.uint32))


def test_stochastic_round_is_unbiased_and_exact():
    """Exact on bf16-representable values; unbiased in the mean at a half
    and a quarter ulp (the statistical check of tests/test_train_step.py,
    with draws from a seeded torch.Generator)."""
    g = torch.Generator().manual_seed(0)
    exact = torch.tensor([1.0, -2.5, 0.0, 3.140625])
    torch.testing.assert_close(topt.stochastic_round_to(exact, generator=g).float(), exact, rtol=0, atol=0)
    half = torch.full((4096,), 1.0 + 2.0**-8)
    rounded = topt.stochastic_round_to(half, generator=g).float()
    assert 0.4 < (rounded > 1.0).float().mean().item() < 0.6
    assert abs(rounded.mean().item() - (1.0 + 2.0**-8)) < 4e-4
    quarter = torch.full((4096,), 1.0 + 2.0**-9)
    assert 0.17 < (topt.stochastic_round_to(quarter, generator=g) > 1.0).float().mean().item() < 0.33
