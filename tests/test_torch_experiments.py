"""The port's experiment layer against the JAX package's: the method grid
(every valid arm, arm for arm, at 1 and 8 cards), each arm's plan and
measurement class, the step cache, the timing protocol fed the same
scripted worker outcomes on both sides, the worker ops, the analytic days
and the whole empirical experiment on the CPU with an in-process worker.

The port's grid is JAX's without the ``unroll_layers=True`` arms: the port's
``build_model`` takes no ``unroll_layers``, so JAX's own validity rule drops
them. ``tpu_type`` becomes ``gpu_type``."""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

from multimodal_llm_pretraining_tpu.experiments.base_classes import Sweep as JaxSweep
from multimodal_llm_pretraining_tpu.experiments.config import TrainingConfig as JaxTrainingConfig
from multimodal_llm_pretraining_tpu.experiments.training_time_empirical import (
    benchmark_step_time as jax_benchmark_step_time,
)
from multimodal_llm_pretraining_tpu_torch import benchmark as cli
from multimodal_llm_pretraining_tpu_torch import gpus
from multimodal_llm_pretraining_tpu_torch.benchmarking import max_batch_size, probe_worker
from multimodal_llm_pretraining_tpu_torch.experiments import cache
from multimodal_llm_pretraining_tpu_torch.experiments import training_time_empirical as tte
from multimodal_llm_pretraining_tpu_torch.experiments.base_classes import format_table
from multimodal_llm_pretraining_tpu_torch.experiments.cache import MemoryWorkspace, StepFailure, set_workspace, step
from multimodal_llm_pretraining_tpu_torch.experiments.config import BaseConfig, TrainingConfig
from multimodal_llm_pretraining_tpu_torch.experiments.count_flops import CountFlopsExperiment, training_flops
from multimodal_llm_pretraining_tpu_torch.experiments.sweeps import (
    CountFlopsSweep,
    TrainingTimeAnalyticSweep,
    TrainingTimeEmpiricalSweep,
)
from multimodal_llm_pretraining_tpu_torch.experiments.training_time_analytic import (
    TrainingTimeAnalytic,
    estimate_training_days_from_flops,
)

torch.set_num_threads(2)

GRID_MODELS = ["pythia-160m", "pythia-1b", "mamba", "llava-pretrain", "vit"]


@pytest.fixture(autouse=True)
def fresh_workspace():
    ws = MemoryWorkspace()
    set_workspace(ws)
    yield ws
    set_workspace(MemoryWorkspace())


# ---------------------------------------------------------------- the grid


def _jax_grid(monkeypatch, chips: int, model: str) -> list:
    """The JAX CLI's ``--methods all`` sweep for (1 host, ``chips``, v5e,
    ``model``), taken from ``scripts/benchmark.py`` as it would run it."""
    from scripts import benchmark as jax_cli

    seen = []
    monkeypatch.setattr(JaxSweep, "run", staticmethod(lambda experiment_sweep, cmd="run", slurm=False:
                                                      seen.append(experiment_sweep)))
    jax_cli.run_benchmark(1, chips, "v5e", model, methods="all")
    return seen[0].experiments()


def _as_gpu(config: dict) -> dict:
    out = dict(config)
    del out["tpu_type"]
    return {**out, "gpu_type": "h100-sxm"}


@pytest.mark.parametrize("chips", [1, 8])
@pytest.mark.parametrize("model", GRID_MODELS)
def test_grid_plans_and_measurements_match_jax(monkeypatch, model, chips):
    """Arm for arm: the port's valid arms are JAX's without unroll_layers;
    each arm's ``training_plan()`` has JAX's fields (the mesh and the
    schedule compared by value) and its ``measurement_equivalent`` JAX's
    class."""
    theirs = [e for e in _jax_grid(monkeypatch, chips, model) if not e.config.unroll_layers]
    ours = cli.method_sweep(1, chips, "h100-sxm", model, "all").experiments()
    assert [dataclasses.asdict(e.config) for e in ours] == [_as_gpu(dataclasses.asdict(e.config)) for e in theirs]
    assert len(ours) > 0
    for o, t in zip(ours, theirs):
        po, pt = dataclasses.asdict(o.config.training_plan()), dataclasses.asdict(t.config.training_plan())
        assert po.pop("scheduler_type").value == pt.pop("scheduler_type").value
        assert po == pt, o.config
        assert dataclasses.asdict(o.config.measurement_equivalent()) == \
            _as_gpu(dataclasses.asdict(t.config.measurement_equivalent()))
        assert o.target_micro_batch_size == t.target_micro_batch_size


@pytest.mark.parametrize("methods,count", [("naive", 1), ("free-lunch", 1), ("all", 24)])
def test_grid_counts_at_one_card(methods, count):
    """pythia-1b on one card: the naive and free-lunch arms, and the 24 arms
    of the full grid (JAX's 36 less its 12 unroll_layers arms)."""
    assert len(cli.method_sweep(1, 1, "h100-sxm", "pythia-1b", methods).experiments()) == count


def test_training_config_expansion():
    cfg = TrainingConfig(num_hosts=1, chips_per_host=8, gpu_type="h100-sxm", model="pythia-160m", free_lunch=True,
                         sharding="zero_2")
    plan = cfg.training_plan()
    assert plan.fp16 and not plan.bf16  # pythia-160m declares fp16
    assert plan.matmul_precision == "high" and plan.use_custom_kernels
    policy = plan.sharding_policy()
    assert policy.opt_state == "sharded" and policy.grads == "sharded" and policy.params == "replicated"
    assert plan.is_valid()
    naive = TrainingConfig(num_hosts=1, chips_per_host=1, gpu_type="h100-sxm", model="pythia-1b").training_plan()
    assert naive.matmul_precision == "highest" and not naive.use_custom_kernels
    master = dataclasses.replace(cfg, chips_per_host=1, sharding="", state_layout="bf16_master").training_plan()
    assert (master.master_weights, master.opt_state_dtype, master.grad_accum_dtype) == ("device", "bf16", "bf16")


def test_validity_rules():
    def make(**kw):
        base = dict(num_hosts=1, chips_per_host=8, gpu_type="h100-sxm", model="pythia-160m")
        return tte.TrainingTimeEmpirical(config=TrainingConfig(**{**base, **kw}))

    assert make().is_valid()
    assert not make(offloading=True).is_valid()
    assert not make(chips_per_host=1, sharding="zero_1").is_valid()
    assert make(chips_per_host=1, sharding="zero_1", offloading=True).is_valid()
    assert not make(sharding="fsdp_hybrid_shard").is_valid()
    assert make(num_hosts=2, chips_per_host=4, sharding="fsdp_hybrid_shard").is_valid()
    assert not make(checkpoint_policy="dots").is_valid()
    assert make(activation_checkpointing=True, checkpoint_policy="dots").is_valid()
    assert not make(state_layout="bf16_sr").is_valid()  # needs the free lunch
    assert make(free_lunch=True, state_layout="bf16_sr").is_valid()
    assert not make(model="vit", free_lunch=True, state_layout="bf16_master").is_valid()  # f32 model
    # no port model takes unroll_layers
    for model in GRID_MODELS:
        assert not make(model=model, free_lunch=True, unroll_layers=True).is_valid()


def test_sweep_results_and_table():
    """``Sweep.results()`` is a list of row dicts; a cached failure shows as
    None and a ``failure`` column; the table aligns every column and shows a
    value of several lines (a worker's error) as its first and last."""
    sweep = TrainingTimeEmpiricalSweep(search_space=dict(
        num_hosts=[1], chips_per_host=[1], gpu_type=["h100-sxm"], model=["pythia-14m"], free_lunch=[True]))
    (exp,) = sweep.experiments()
    steps = exp.step_dict
    ws = cache.get_workspace()
    ws.store(steps["max_micro_batch_size"].unique_id(), 4)
    ws.store(steps["benchmarking_results"].unique_id(), StepFailure("RuntimeError", "kernel launch failed"))
    ws.store(steps["training_days"].unique_id(), StepFailure("UpstreamStepFailure", "RuntimeError: kernel"))
    assert sweep.count() == (1, 1) and sweep.incomplete() == []
    (row,) = sweep.results()
    assert row["max_micro_batch_size"] == 4 and row["benchmarking_results"] is None
    assert row["training_days"] is None and row["failure"] == "RuntimeError: kernel launch failed"  # the cause
    table = format_table([{"a": 1, "bb": "x"}, {"a": 22, "c": None}, {"a": 3, "c": "worker failed:\n  trace\ncause"}])
    assert table.splitlines() == ["a   bb  c", "1   x", "22      None", "3       worker failed: ... cause"]


# ---------------------------------------------------------------- the cache


def test_step_cache_memoizes():
    calls = []

    @step(cacheable=True, version="001")
    def expensive(x):
        calls.append(x)
        return x * 2

    c1 = expensive(x=21)
    assert c1.result() == 42 and c1.result() == 42 and calls == [21]
    assert expensive(x=10).result() == 20 and calls == [21, 10]


def test_step_cache_version_invalidates():
    @step(cacheable=True, version="001")
    def f(x):
        return x

    @step(cacheable=True, version="002")
    def f2(x):
        return x + 1

    f2.__wrapped_step__.__name__ = "f"
    assert f(x=1).unique_id() != f2(x=1).unique_id()


def test_step_graph_hashing():
    @step()
    def a(x):
        return x + 1

    @step()
    def b(y):
        return y * 10

    downstream = b(y=a(x=1))
    assert downstream.result() == 20
    assert b(y=a(x=2)).unique_id() != downstream.unique_id()


def test_failures_are_cached_and_flow_downstream():
    """Every failure is the arm's (the port has no backend faults to
    spare): cached as a ``StepFailure``, never re-run, and a step fed a
    failure caches an ``UpstreamStepFailure``."""
    calls = []

    @step(cacheable=True, version="001")
    def broken(x):
        calls.append(x)
        raise RuntimeError("selective-scan forward kernel: CUDA error 700")

    @step()
    def after(y):
        return y

    call = broken(x=1)
    with pytest.raises(RuntimeError):
        call.result(record_failure=True)
    assert call.is_cached() and calls == [1]
    failure = call.result()
    assert isinstance(failure, StepFailure) and "CUDA error 700" in failure.message
    down = after(y=call).result()
    assert down.error_type == "UpstreamStepFailure" and "CUDA error 700" in down.message
    assert calls == [1]


def test_cache_defaults_to_clean_config_keys():
    """Fields marked ``cache_omit_default`` leave the key while at their
    default, so a later axis re-keys only the arms that set it."""
    base = TrainingConfig(num_hosts=1, chips_per_host=1, gpu_type="h100-sxm", model="pythia-1b")
    assert "state_layout" not in cache.stable_repr(base) and "checkpoint_policy" not in cache.stable_repr(base)
    assert "state_layout='bf16_sr'" in cache.stable_repr(dataclasses.replace(base, state_layout="bf16_sr"))


def test_disk_workspace_pickles_under_torch(monkeypatch, tmp_path):
    """``$MLPT_WORKSPACE_DIR/torch`` holds pickles; a claim left by a dead
    process is taken over, a live one's is not."""
    monkeypatch.setenv("MLPT_WORKSPACE_DIR", str(tmp_path))
    monkeypatch.setattr(cache, "_default_workspace", None)
    ws = cache.get_workspace()
    assert ws.root == os.path.join(str(tmp_path), "torch")

    @step()
    def f(x):
        return {"x": x}

    call = f(x=3)
    assert call.result() == {"x": 3}
    with open(os.path.join(ws.root, call.unique_id() + ".pkl"), "rb") as fh:
        assert pickle.load(fh) == {"x": 3}
    uid = "other-001-0"
    with open(os.path.join(ws.root, uid + ".pkl.running"), "w") as fh:
        fh.write("999999999")  # no such process
    assert ws.try_claim(uid) and ws.is_running(uid)
    with open(os.path.join(ws.root, uid + ".pkl.running"), "w") as fh:
        fh.write(str(os.getppid()))  # alive
    assert not ws.try_claim(uid)


# ---------------------------------------------------------------- the timing protocol


def _jax_cfg():
    return JaxTrainingConfig(num_hosts=1, chips_per_host=8, tpu_type="v5e", model="pythia-14m")


def _cfg():
    return TrainingConfig(num_hosts=1, chips_per_host=8, gpu_type="h100-sxm", model="pythia-14m")


def _split_oom_above(limit, accumulate_s=0.5, optimizer_s=0.1, fused=None):
    """A scripted worker: the split phases out of memory above ``limit``
    examples; the fused op answers ``fused(spec)``."""
    specs = []

    def worker(spec):
        specs.append((spec["op"], spec["micro_batch_size"], spec.get("accumulation_steps")))
        if spec["op"] == "time_fused":
            return fused(spec)
        if spec["micro_batch_size"] > limit:
            return {"oom": True}
        return {"ok": True, "accumulate_s": accumulate_s, "optimizer_s": optimizer_s,
                "micro_batch_size": spec["micro_batch_size"]}

    return worker, specs


CASES = {
    # the split phases halve 8 -> 4 -> 2; the fused step runs at 8, acc 1
    "oom_halving": (8, 8, lambda s: {"ok": True, "step_time_fused": 1.7}, 2),
    # the fused probe halves 8 -> 4 -> 2
    "fused_halving": (8, 8, lambda s: {"oom": True} if s["micro_batch_size"] > 2 else
                      {"ok": True, "step_time_fused": 1.2}, 8),
    # at mbs 16 the probe runs acc 8 (128 rows) of the target's 64
    "capped_probe": (16, 1024, lambda s: {"ok": True, "step_time_fused": 8.0}, 16),
    # every split probe out of memory: the fused step alone
    "fused_only": (4, 16, lambda s: {"ok": True, "step_time_fused": 2.0}, 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_step_time_protocol_matches_jax(case):
    """The same scripted outcomes through JAX's ``benchmark_step_time`` (its
    one-chip protocol, ``fused_primary=True``) and the port's: the same
    worker calls and the same results (JAX's ``compile_disabled`` aside)."""
    max_mbs, target, fused, split_limit = CASES[case]
    ours_worker, ours_specs = _split_oom_above(split_limit, fused=fused)
    theirs_worker, theirs_specs = _split_oom_above(split_limit, fused=fused)
    ours = tte.benchmark_step_time.__wrapped_step__(_cfg(), max_mbs, target, 3, _run_worker=ours_worker)
    theirs = jax_benchmark_step_time.__wrapped_step__(_jax_cfg(), max_mbs, target, 3, fused_primary=True,
                                                      _run_worker=theirs_worker)
    assert ours_specs == theirs_specs
    assert theirs.pop("compile_disabled") is False
    assert set(ours) == set(theirs)
    for key, value in theirs.items():
        assert ours[key] == pytest.approx(value) if value is not None else ours[key] is None, key
    if case == "capped_probe":
        assert ("time_fused", 16, 8) in ours_specs and ours["step_time"] == pytest.approx(7.9 * 8 + 0.1)


def test_step_time_gives_up_below_mbs_one():
    assert tte.benchmark_step_time.__wrapped_step__(_cfg(), 2, 2, 1, _run_worker=lambda spec: {"oom": True}) is None


def test_kernel_failure_raises_and_is_cached_as_step_failure():
    """A worker that dies for another reason than memory (a kernel that
    does not build or launch) raises; the arm caches a ``StepFailure`` with
    the cause, and there is no retry on plain kernels."""
    specs = []

    def broken(spec):
        specs.append(spec)
        raise RuntimeError("probe worker at mbs=4 failed (time_phases, exit code 1): flash attention forward "
                           "kernel: CUDA error 700")

    call = tte.benchmark_step_time(config=_cfg(), max_micro_batch_size=4, target_micro_batch_size=8,
                                   num_benchmarking_steps=1, _run_worker=broken)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        call.result(record_failure=True)
    assert len(specs) == 1  # no second attempt on other kernels
    failure = call.result()
    assert isinstance(failure, StepFailure) and "CUDA error 700" in failure.message
    days = tte.compute_training_days(benchmarking_results=call, num_steps=10).result()
    assert days.error_type == "UpstreamStepFailure"


def test_refused_arm_names_its_roadmap_item():
    """An offload arm reaches one real worker (on the CPU), whose session
    refuses it; the search caches a ``StepFailure`` naming the item."""
    cfg = TrainingConfig(num_hosts=1, chips_per_host=1, gpu_type="h100-sxm", model="pythia-14m", free_lunch=True,
                         sharding="zero_1", offloading=True)

    def on_cpu(spec):
        return max_batch_size.run_probe_worker({**spec, "device": "cpu"}, timeout=300)

    call = tte.find_largest_batch_size(config=cfg, limit=8, _run_worker=on_cpu)
    with pytest.raises(RuntimeError, match="ROADMAP Queue 1 items 7 and 8"):
        call.result(record_failure=True)
    assert "items 7 and 8" in call.result().message


# ---------------------------------------------------------------- worker ops and the experiment on the CPU

SEQ = 33


def _in_process(oom_above: int, once: bool = False):
    """``run_probe_worker`` in this process on the CPU at sequence 33, out of
    memory above ``oom_above`` examples; with ``once``, each timing op
    times one sample, to keep the CPU run short."""
    calls = []

    def worker(spec):
        calls.append(spec["op"])
        if spec["micro_batch_size"] > oom_above:
            return {"oom": True, "micro_batch_size": spec["micro_batch_size"]}
        spec = {**spec, "device": "cpu", "dataset_overrides": {"sequence_length": SEQ}}
        return probe_worker.run({**spec, "samples": 1} if once else spec)

    return worker, calls


def test_worker_ops_on_the_cpu():
    cfg = TrainingConfig(num_hosts=1, chips_per_host=1, gpu_type="h100-sxm", model="pythia-14m", free_lunch=True,
                         state_layout="bf16_master")
    plan = cfg.training_plan(num_training_steps=1)
    worker, _ = _in_process(64)
    assert worker(max_batch_size.worker_spec("confirm", plan, cfg.model, 2))["ok"]
    phases = worker(max_batch_size.worker_spec("time_phases", plan, cfg.model, 2, samples=1))
    assert phases["ok"] and phases["accumulate_s"] > 0 and phases["optimizer_s"] > 0 and phases["samples"] == 1
    fused = worker(max_batch_size.worker_spec("time_fused", plan, cfg.model, 2, accumulation_steps=2, samples=1))
    assert fused["ok"] and fused["step_time_fused"] > 0 and np.isfinite(fused["loss"]) and len(fused["times"]) == 1
    with pytest.raises(ValueError, match="unknown op"):
        worker(max_batch_size.worker_spec("time_everything", plan, cfg.model, 2))


def test_empirical_experiment_end_to_end_on_the_cpu(monkeypatch):
    """pythia-14m's ``bf16_sr`` arm through the whole graph, workers in this
    process on the CPU with memory faked to end above 4 examples: the search
    finds 4, the phases and the fused probe (acc 32 of the target's 256) run,
    the days follow from the fused step; a second sweep starts no worker."""
    worker, calls = _in_process(4, once=True)
    monkeypatch.setattr(tte, "run_probe_worker", worker)
    sweep = TrainingTimeEmpiricalSweep(search_space=dict(
        num_hosts=[1], chips_per_host=[1], gpu_type=["h100-sxm"], model=["pythia-14m"], free_lunch=[True],
        activation_checkpointing=[True], checkpoint_policy=["dots"], state_layout=["bf16_sr"]))
    sweep.sweep()
    assert calls == ["confirm"] * 4 + ["time_phases", "time_fused"]
    (row,) = sweep.results()
    assert row["max_micro_batch_size"] == 4 and row["micro_batch_size"] == 4 and row["micro_batch_size_split"] == 4
    assert row["step_time"] == row["step_time_fused"] > 0 and row["step_time_split"] > 0
    assert row["training_days"] == pytest.approx(143_000 * row["step_time"] / 86400)
    sweep.sweep()
    assert len(calls) == 6 and sweep.count() == (1, 1)


# ---------------------------------------------------------------- FLOPs and the analytic days


@pytest.mark.parametrize("model,free_lunch,peak", [("pythia-1b", False, 989.0), ("pythia-160m", True, 989.0),
                                                   ("vit", True, 494.7), ("vit", False, 67.0)])
def test_analytic_days_equal_the_formula(model, free_lunch, peak):
    """bf16 and fp16 models at the bf16 peak, f32 ones at TF32 under the
    free lunch and at f32 otherwise; 8 cards, an MFU of 0.5."""
    cfg = TrainingConfig(num_hosts=1, chips_per_host=8, gpu_type="h100-sxm", model=model, free_lunch=free_lunch)
    mixed = cfg.model_class().mixed_precision
    assert gpus.analytic_peak_tflops("h100-sxm", mixed, free_lunch) == peak and gpus.supports_bf16("h100-sxm")
    days = estimate_training_days_from_flops.__wrapped_step__(3e23, cfg, 0.5)
    assert days == pytest.approx(3e23 / (8 * peak * 1e12 * 0.5 * 86400), rel=1e-12)


def test_analytic_experiment_reads_the_cached_count():
    """``TrainingTimeAnalytic`` runs its count dependency and divides the
    cached total; ``CountFlopsExperiment`` counts examples and tokens."""
    base = BaseConfig(num_hosts=1, chips_per_host=1, gpu_type="h100-sxm", model="pythia-1b")
    cache.get_workspace().store(training_flops(config=base).unique_id(), 1e22)
    exp = TrainingTimeAnalytic(config=TrainingConfig(**dataclasses.asdict(base)), assumed_mfu=1.0)
    exp.run()
    assert exp.results()["training_days"] == pytest.approx(1e22 / (989.0e12 * 86400))
    counts = CountFlopsExperiment(config=base).results()
    assert counts["training_examples"] == 1024 * 143_000
    assert counts["training_tokens"] == 1024 * 143_000 * 2049
    assert len(CountFlopsSweep({"num_hosts": [1], "chips_per_host": [1], "gpu_type": ["h100-sxm"],
                                "model": ["pythia-1b", "vit"]}).experiments()) == 2
    analytic = TrainingTimeAnalyticSweep({"num_hosts": [1], "chips_per_host": [1], "gpu_type": ["h100-sxm"],
                                          "model": ["pythia-1b"], "assumed_mfu": [0.5]}).experiments()
    assert analytic[0].assumed_mfu == 0.5


def test_count_experiment_on_the_cpu():
    """pythia-14m's count through the experiment, on the CPU: the per-example
    count (``tests/test_torch_harness.py``'s closed form and its two terms)
    times batch and steps."""
    from multimodal_llm_pretraining_tpu_torch.benchmarking.flops import analytic_flops_per_example
    from multimodal_llm_pretraining_tpu_torch.models import get_model_class
    from multimodal_llm_pretraining_tpu_torch.models.pythia import PYTHIA_SIZES

    mc = get_model_class("pythia-14m")
    (layers, hidden, _), seq, vocab = PYTHIA_SIZES["pythia-14m"], mc.sequence_length, mc.vocab_size
    per_example = analytic_flops_per_example(mc) + 2 * hidden * vocab * (seq - 4) - 6 * hidden * layers * seq * (seq - 1)
    base = BaseConfig(num_hosts=1, chips_per_host=1, gpu_type="h100-sxm", model="pythia-14m")
    assert training_flops(config=base, device="cpu").result() == per_example * 1024 * 143_000


def test_cli_validates_and_counts(capsys):
    cli.main(["--num-hosts", "1", "--chips-per-host", "1", "--gpu-type", "h100-sxm", "--model", "mamba",
              "--methods", "free-lunch", "--cmd", "count"])
    assert capsys.readouterr().out.strip() == "0 / 1 experiments cached"
    with pytest.raises(ValueError, match="evenly divisible"):
        cli.validate_arguments(1, 3, "h100-sxm", "pythia-1b")
    with pytest.raises(SystemExit):
        cli.main(["--num-hosts", "1", "--chips-per-host", "1", "--gpu-type", "h100-sxm", "--model", "gpt-5"])
