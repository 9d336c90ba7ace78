"""The port's benchmark harness on the CPU, at pythia-14m and sequence 33:
the plan's ``is_valid`` and ``sharding_policy`` against the JAX plan's, the
closed-form FLOPs against the JAX package's, the FLOP counter against the
closed form (pythia, and a narrowed mamba through the scan ops' formulas),
the max-micro-batch search (in process with an out-of-memory
error faked past a threshold, and through the worker process), the phase and
fused step timers, and the GPU registry.

The FLOP counter at pythia-14m and sequence 2049 counts what runs, which
differs from the closed form by two known terms, so the count must equal

    closed + 2·H·V·(S − 4) − 6·H·L·S·(S − 1)

exactly (integer FLOPs), and lie within 6% of the closed form (5.3% here):

- the head's term, 2·H·V·(S − 4): the chunked cross entropy keeps no
  logits and computes them again in its backward, 4·2·H·V a token where the
  closed form counts 3; the shifted loss has S − 1 tokens, not S;
- the attention's, −6·H·L·S·(S − 1): causal masking leaves S·(S + 1)/2 of
  the S² (query, key) pairs, and the flash formulas count those the call
  computes, where the closed form counts all S² (4·S·H a token a layer).

Rotary embedding, the norms, the activations and the biases are elementwise
work: neither count has them.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from multimodal_llm_pretraining_tpu.benchmarking import flops as jflops
from multimodal_llm_pretraining_tpu.models import get_model_class as jax_get_model_class
from multimodal_llm_pretraining_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from multimodal_llm_pretraining_tpu.train import TrainingPlan as JaxTrainingPlan
from multimodal_llm_pretraining_tpu_torch import bench, gpus
from multimodal_llm_pretraining_tpu_torch.benchmarking import flops as tflops
from multimodal_llm_pretraining_tpu_torch.benchmarking import max_batch_size as mbs_search
from multimodal_llm_pretraining_tpu_torch.benchmarking import probe_worker, step_time
from multimodal_llm_pretraining_tpu_torch.benchmarking.utils import BenchmarkHarness, OutOfMemory, is_oom_error, timed
from multimodal_llm_pretraining_tpu_torch.models import get_model_class
from multimodal_llm_pretraining_tpu_torch.models.pythia import PYTHIA_SIZES
from multimodal_llm_pretraining_tpu_torch.parallel.mesh import MeshConfig
from multimodal_llm_pretraining_tpu_torch.parallel.sharding import ShardingPolicy
from multimodal_llm_pretraining_tpu_torch.train import TrainingPlan

torch.set_num_threads(2)

SEQ = 33
METHODS = ["", "zero_1", "zero_2", "zero_3", "zero_3++", "fsdp_shard_grad_op", "fsdp_full_shard",
           "fsdp_hybrid_shard_zero2", "fsdp_hybrid_shard", "zero_4"]


def _plan_kwargs(mc, **kw):
    return dict(num_training_steps=5, micro_batch_size=2, gradient_accumulation_steps=2, optimizer=mc.optimizer,
                optimizer_kwargs=mc.optimizer_kwargs, scheduler_type=mc.scheduler_type,
                scheduler_kwargs=mc.scheduler_kwargs, max_grad_norm=mc.max_grad_norm, **kw)


def _harness(**kw) -> BenchmarkHarness:
    mc = get_model_class("pythia-14m")
    harness = BenchmarkHarness(TrainingPlan(mesh=MeshConfig(1, 1), **_plan_kwargs(mc, **kw)), mc, device="cpu")
    harness.session.dataset.sequence_length = SEQ
    return harness


# ---------------------------------------------------------------- plan


@pytest.mark.parametrize("offloading,hosts", [(False, 1), (True, 1), (False, 2), (True, 2)])
def test_is_valid_and_sharding_policy_match_jax(offloading, hosts):
    """Every sharding method (and an unknown one) with and without
    offloading, on one host and two, with bad counts and bf16 with fp16."""
    for method, (steps, mbs, bf16, fp16) in itertools.product(
            METHODS, [(5, 2, True, False), (0, 2, False, False), (5, 0, False, False), (5, 2, True, True)]):
        kw = dict(num_training_steps=steps, micro_batch_size=mbs, gradient_accumulation_steps=1, bf16=bf16, fp16=fp16,
                  sharding=method, offloading=offloading)
        ours = TrainingPlan(mesh=MeshConfig(num_hosts=hosts), **kw)
        theirs = JaxTrainingPlan(mesh=JaxMeshConfig(num_hosts=hosts), **kw)
        assert ours.is_valid() == theirs.is_valid(), kw
        if method != "zero_4":
            assert dataclasses.asdict(ours.sharding_policy()) == dataclasses.asdict(theirs.sharding_policy()), kw
    with pytest.raises(KeyError):
        ShardingPolicy.from_method("zero_4")  # type: ignore[arg-type]


# ---------------------------------------------------------------- FLOPs


@pytest.mark.parametrize("model_type", [*PYTHIA_SIZES, "vit", "llava-pretrain", "llava-finetune", "mamba"])
def test_analytic_flops_match_jax(model_type):
    ours, theirs = get_model_class(model_type), jax_get_model_class(model_type)
    for backward, remat in ((True, False), (True, True), (False, False)):
        assert tflops.analytic_flops_per_example(ours, backward, remat) == \
            jflops.analytic_flops_per_example(theirs, backward, remat)
    assert (tflops.analytic_flops_per_example(ours) is None) == (model_type == "mamba")


def test_counted_flops_match_the_closed_form_but_for_the_known_terms():
    """pythia-14m at its sequence of 2049 (see the module docstring)."""
    mc = get_model_class("pythia-14m")
    layers, hidden, _ = PYTHIA_SIZES["pythia-14m"]
    seq, vocab = mc.sequence_length, mc.vocab_size
    counted = tflops.count_flops_per_example(mc, device="cpu")
    closed = tflops.analytic_flops_per_example(mc)
    assert counted == closed + 2 * hidden * vocab * (seq - 4) - 6 * hidden * layers * seq * (seq - 1)
    assert abs(counted / closed - 1) < 0.06


@pytest.mark.parametrize("causal,lens", [(True, None), (False, None), (True, [5, 0, 9, 1]), (False, [5, 0, 9, 1])])
def test_flash_formulas_count_the_visible_pairs(causal, lens):
    """4·D a visible pair forward and 8·D backward, fused or split."""
    q = torch.randn(4, 9, 16)
    kv_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    pairs = sum(min(i + 1 if causal else 9, n) for n in (lens or [9] * 4) for i in range(9))
    out, lse = torch.ops.mlpt.flash_fwd(q, q, q, causal, 0.25, kv_lens)
    assert tflops._flash_fwd_flops(q, q, q, causal, 0.25, kv_lens) == 4 * 16 * pairs
    assert tflops._flash_bwd_flops(q, q, q, out, lse, q, causal, 0.25, kv_lens) == 8 * 16 * pairs
    with torch.utils.flop_counter.FlopCounterMode(display=False) as counter:
        torch.ops.mlpt.flash_bwd_split(q, q, q, out, lse, q, causal, 0.25, kv_lens)
    assert counter.get_total_flops() == 8 * 16 * pairs


MAMBA_NARROW = dict(N_LAYER=2, D_MODEL=64, D_INNER=128, DT_RANK=4, D_STATE=16, VOCAB=256)


def test_counted_mamba_flops_equal_the_closed_form():
    """mamba narrowed to 2 layers, d_model 64, d_inner 128, dt_rank 4,
    d_state 16, vocab 256, at sequence 300 (the scan crosses its 256-step
    chunk): the count equals, exactly, three times (forward and backward)
    each layer's products (in_proj, x_proj, dt_proj, out_proj: 2·S·in·out),
    its depthwise conv (2·S·I·K) and its scan through the ``mlpt::`` ops'
    formulas (9·S·I·N + S·I for the skip), plus the chunked head's 4·2·H·V
    a token over the S − 1 shifted tokens (the pythia count's head term)."""
    from multimodal_llm_pretraining_tpu_torch.models import mamba as tmamba

    S, H, I, N, R, K, V, L = 300, 64, 128, 16, 4, 4, 256, 2
    with pytest.MonkeyPatch.context() as mp:
        for name, value in MAMBA_NARROW.items():
            mp.setattr(tmamba, name, value)
        mp.setattr(tmamba.MambaModelClass, "vocab_size", property(lambda self: V))
        mp.setattr(tmamba.MambaModelClass, "sequence_length", property(lambda self: S))
        counted = tflops.count_flops_per_example(get_model_class("mamba"), device="cpu")
    per_layer = 2 * S * (H * 2 * I + I * (R + 2 * N) + R * I + I * H) + 2 * S * I * K + 9 * S * I * N + S * I
    assert counted == 3 * L * per_layer + 8 * H * V * (S - 1)


def test_scan_formulas_and_the_grouped_conv_backward():
    """The scan ops' formulas: 9·B·L·I·N (+ B·L·I with D) forward, twice
    that backward; the convolution backward counts each gradient it takes
    as its forward, ``groups`` included."""
    u = torch.randn(2, 40, 24)
    A, B = -torch.rand(24, 16), torch.randn(2, 40, 16)
    fwd = 9 * 2 * 40 * 24 * 16
    assert tflops._scan_fwd_flops(u, u, A, B, B) == fwd
    assert tflops._scan_fwd_flops(u, u, A, B, B, torch.ones(24)) == fwd + 2 * 40 * 24
    assert tflops._scan_bwd_flops(u, u, A, B, B, u, None) == 2 * (fwd + 2 * 40 * 24)
    x = torch.randn(2, 24, 43, requires_grad=True)
    w = torch.randn(24, 1, 4, requires_grad=True)
    with torch.utils.flop_counter.FlopCounterMode(
            display=False, custom_mapping={torch.ops.aten.convolution_backward: tflops._conv_backward_flops}) as c:
        torch.nn.functional.conv1d(x, w, groups=24).sum().backward()
    assert c.get_total_flops() == 3 * 2 * (2 * 24 * 40) * 4


# ---------------------------------------------------------------- max micro-batch


def _oom_past(harness, threshold, error=None):
    """Make the harness's accumulate step fail past ``threshold`` examples:
    with a CUDA out-of-memory error, or with ``error``."""
    accumulate = harness.session._accumulate

    def step(state, batch):
        if batch["input_ids"].shape[0] > threshold:
            raise error or torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return accumulate(state, batch)

    harness.session._accumulate = step


@pytest.mark.parametrize("threshold,limit,expected", [(5, 64, 4), (1, 64, 1), (0, 64, 0), (100, 8, 8), (16, 64, 16)])
def test_find_max_mbs_pow2_in_process(threshold, limit, expected):
    harness = _harness()
    _oom_past(harness, threshold)
    assert mbs_search.find_max_mbs_pow2(limit, mbs_search.inprocess_confirm(harness)) == expected
    if expected:  # the harness set itself up again after the out-of-memory error and steps at what fits
        harness.manual_training_step(expected)
        harness.manual_optimization_step()


def test_a_failure_that_is_not_out_of_memory_raises():
    harness = _harness()
    _oom_past(harness, 2, error=RuntimeError("flash attention forward kernel: CUDA error 700"))
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        mbs_search.find_max_mbs_pow2(64, mbs_search.inprocess_confirm(harness))
    assert not is_oom_error(RuntimeError("CUDA error 700")) and is_oom_error(torch.cuda.OutOfMemoryError("x"))


def test_subprocess_confirm_runs_a_worker():
    """One accumulate and one optimizer step (pythia-14m, its sequence of
    2049) in a fresh process on the CPU: True; a worker that fails for
    another reason than memory raises."""
    mc = get_model_class("pythia-14m")
    plan = TrainingPlan(mesh=MeshConfig(1, 1), **_plan_kwargs(mc))
    confirm = mbs_search.subprocess_confirm(plan, "pythia-14m", device="cpu", timeout=300)
    assert confirm(1) is True
    broken = mbs_search.subprocess_confirm(plan, "pythia-0m", device="cpu", timeout=300)
    with pytest.raises(RuntimeError, match="probe worker at mbs=1 failed"):
        broken(1)


def test_worker_plan_round_trips():
    mc = get_model_class("pythia-1b")
    plan = bench.make_plan(mc, 32)
    assert probe_worker.plan_from_dict(dataclasses.asdict(plan)) == plan


# ---------------------------------------------------------------- timers


def test_measure_phase_times_extrapolates_the_step():
    harness = _harness()
    harness.setup()
    times = step_time.measure_phase_times(harness, 2, samples=2)
    assert times.accumulate_s > 0 and times.optimizer_s > 0 and times.samples == 2
    assert times.step_time(8) == 8 * times.accumulate_s + times.optimizer_s
    assert step_time.estimate_step_time(harness, 2, 16, 1) > 0
    assert harness.persistent_state_bytes() == 2 * 4 * sum(p.numel() for p in harness.session.module.parameters())


def test_measure_fused_step_time_takes_the_median():
    harness = _harness()
    fused = step_time.measure_fused_step_time(harness.session, 2, samples=3, warmups=1)
    assert len(fused.times) == 3 and fused.step_s == float(np.median(fused.times)) and np.isfinite(fused.loss)
    with pytest.raises(ValueError, match="accumulates 2"):
        step_time.measure_fused_step_time(harness.session, 32)


def test_timed_measures_host_seconds():
    assert timed(sum, range(1000), device="cpu") >= 0.0
    with pytest.raises(OutOfMemory):
        harness = _harness()
        harness.setup()
        _oom_past(harness, 0)
        harness.manual_training_step(1)


# ---------------------------------------------------------------- GPU registry


def test_gpu_registry_holds_the_h100_data_sheet():
    assert gpus.GPU_TYPES == ("h100-sxm",)
    assert [gpus.peak_tflops("h100-sxm", d) for d in ("bf16", "tf32", "fp32")] == [989.0, 494.7, 67.0]
    spec = gpus.gpu_spec("h100-sxm")
    assert spec.hbm_bytes == 80 * 10**9 and spec.hbm_bandwidth_gbps == 3350.0 and spec.nvlink_bandwidth_gbps == 900.0
    with pytest.raises(ValueError):
        gpus.peak_tflops("h100-sxm", "fp8")  # type: ignore[arg-type]


def test_no_card_is_detected_without_one():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert gpus.detect_local_gpu() is None
    with pytest.raises(RuntimeError, match="CUDA"):
        gpus.device_hbm_bytes()
