"""Empirical training time (counterpart of
``experiments/training_time_empirical.py``): a cached three-step graph,
largest micro-batch, measured step time and projected training days, over
the same validity predicate as the JAX package's method grid.

    python -m multimodal_llm_pretraining_tpu_torch.experiments.training_time_empirical \\
        --config '{"num_hosts": 1, "chips_per_host": 1, "gpu_type": "h100-sxm", "model": "pythia-1b",
                   "free_lunch": true, "activation_checkpointing": true, "checkpoint_policy": "dots",
                   "state_layout": "bf16_sr"}'

Every probe runs in a fresh worker process (``benchmarking/probe_worker.py``),
since running out of memory on the card can leave a process unfit to go on;
the parent runs nothing on the card meanwhile.

- **Search**: ``find_max_mbs_pow2`` with ``subprocess_confirm`` (one
  accumulate and one optimizer step a candidate), doubling from 1 up to
  ``target_micro_batch_size``.
- **Timing**: a ``time_phases`` worker at the largest micro-batch, halving
  it on out-of-memory, gives the split step, accumulate x accumulation +
  optimizer. Then a ``time_fused`` worker times the production step at
  the largest micro-batch, halving on out-of-memory too, and the arm's
  ``step_time`` is the fused one where it exists (the JAX package's
  ``fused_primary`` protocol, which its grid runs for every arm measured on
  one chip). The fused probe runs at most ``FUSED_PROBE_MAX_ROWS``
  in-program rows (micro-batch x accumulation) and extrapolates to the
  target accumulation as ``(t_probe - optim) * fused_acc / probe_acc +
  optim``: the micro-batches of a step are identical work. On the card the
  cap bounds an arm's time (pythia-1b's full acc-256 step takes about a
  minute, and a worker runs 5 of them); the TPU's per-execution deadline,
  the JAX package's reason, does not apply.

What the JAX module has and this one leaves out, and why:

- the static AOT fit table and ``fused_ground_truth``: eager PyTorch has no
  static fit check, so every candidate runs;
- ``_static_probe_harness``: nothing is compiled ahead of time;
- ``InfrastructureError``: it stands for remote-TPU backend faults;
- ``distribute``: the port runs on one card;
- the retry on plain kernels after a "lowering failure", and with it
  ``compile_disabled``: a kernel that fails to build or launch raises, and
  the arm is cached as a ``StepFailure`` with that cause. No fallback hides
  a kernel.

The port's ``build_model`` takes no ``unroll_layers``, so JAX's own rule
drops every ``unroll_layers=True`` arm: the port's grid is JAX's grid
without them. Arms a one-card session refuses (offloading, ROADMAP Queue 1
item 8; more than one card, item 7) reach the first worker, which raises
with the item; the arm is cached as a ``StepFailure`` naming it, at the
cost of one worker start.
"""

import inspect
import math
from dataclasses import dataclass
from typing import Any, TypedDict

from ..benchmarking.max_batch_size import find_max_mbs_pow2, run_probe_worker, subprocess_confirm, worker_spec
from ..utils import get_logger
from .base_classes import Experiment
from .cache import step
from .config import TrainingConfig

logger = get_logger()

# in-program rows (micro_batch_size x accumulation_steps) of a fused probe
FUSED_PROBE_MAX_ROWS = 128


def _fused_probe_acc(target_acc: int, mbs: int) -> int:
    return max(1, min(target_acc, FUSED_PROBE_MAX_ROWS // max(mbs, 1)))


class BenchmarkingResults(TypedDict):
    micro_batch_size: int  # the arm's micro-batch (the fused step's where it was measured)
    micro_batch_size_split: int  # the micro-batch the split phases ran at (0: none ran)
    step_time: float  # the fused step where measured, else the split one
    step_time_split: float | None  # accumulate_s x accumulation + optimizer_s
    step_time_fused: float | None  # the production step at the target accumulation


def _probe_plan(config: TrainingConfig):
    return config.training_plan(num_training_steps=1, micro_batch_size=1, gradient_accumulation_steps=1)


@step(cacheable=True, version="001")
def find_largest_batch_size(config: TrainingConfig, limit: int, _run_worker=None) -> int:
    """The largest power-of-2 micro-batch up to ``limit`` whose accumulate
    and optimizer steps run in a fresh worker (``_run_worker(spec)``, in
    place of ``run_probe_worker``, is injectable for tests)."""
    confirm = subprocess_confirm(_probe_plan(config), config.model, run_worker=_run_worker or run_probe_worker)
    return find_max_mbs_pow2(limit, confirm)


@step(cacheable=True, version="001")
def benchmark_step_time(
    config: TrainingConfig,
    max_micro_batch_size: int,
    target_micro_batch_size: int,
    num_benchmarking_steps: int,
    trial: int = 0,
    _run_worker=None,  # in place of run_probe_worker, for tests
) -> BenchmarkingResults | None:
    """Step time at the largest micro-batch: the split phases (halving on
    out-of-memory), then the fused step (halving on out-of-memory), each in
    a worker of its own. None when nothing runs even at micro-batch 1."""
    del trial  # cache-key salt only
    plan = _probe_plan(config)
    run = _run_worker or run_probe_worker

    def worker(op: str, mbs: int, **extra) -> dict:
        return run(worker_spec(op, plan, config.model, mbs, **extra))

    def fused_probe(fused_mbs: int) -> tuple[int, int, int, dict]:
        """(mbs, target acc, probe acc, result) of the first fused probe that
        does not run out of memory, halving from ``fused_mbs``."""
        fused: dict = {}
        while fused_mbs >= 1:
            fused_acc = target_micro_batch_size // fused_mbs
            probe_acc = _fused_probe_acc(fused_acc, fused_mbs)
            fused = worker("time_fused", fused_mbs, accumulation_steps=probe_acc, samples=3)
            if not fused.get("oom"):
                return fused_mbs, fused_acc, probe_acc, fused
            logger.info(f"fused-step probe out of memory at mbs={fused_mbs}; halving")
            fused_mbs //= 2
        return 0, 0, 0, fused

    micro_batch_size = max_micro_batch_size
    while micro_batch_size > 0:
        result = worker("time_phases", micro_batch_size, samples=num_benchmarking_steps)
        if result.get("oom"):
            logger.info(f"timing worker out of memory at mbs={micro_batch_size}; halving")
            micro_batch_size //= 2
            continue
        split_time = result["accumulate_s"] * (target_micro_batch_size // micro_batch_size) + result["optimizer_s"]
        fused_mbs, fused_acc, probe_acc, fused = fused_probe(max_micro_batch_size)
        fused_time = None
        if fused.get("ok"):
            t_probe = fused["step_time_fused"]
            optim = min(result["optimizer_s"], 0.5 * t_probe)
            fused_time = (t_probe - optim) * (fused_acc / probe_acc) + optim
        else:
            logger.info("fused-step timing unavailable: every micro-batch ran out of memory; keeping the split step")
        return BenchmarkingResults(
            micro_batch_size=fused_mbs if fused_time is not None else micro_batch_size,
            micro_batch_size_split=micro_batch_size,
            step_time=fused_time if fused_time is not None else split_time,
            step_time_split=split_time,
            step_time_fused=fused_time,
        )

    if max_micro_batch_size > 0:
        # every split probe ran out of memory but the step was confirmed to
        # run: time the fused step alone (no optimizer intercept; the whole
        # probe scales)
        fused_mbs, fused_acc, probe_acc, fused = fused_probe(max_micro_batch_size)
        if fused.get("ok"):
            fused_time = fused["step_time_fused"] * (fused_acc / probe_acc)
            return BenchmarkingResults(
                micro_batch_size=fused_mbs,
                micro_batch_size_split=0,
                step_time=fused_time,
                step_time_split=None,
                step_time_fused=fused_time,
            )
    return None


@step(cacheable=True, version="001")
def compute_training_days(benchmarking_results: BenchmarkingResults | None, num_steps: int) -> float | None:
    if benchmarking_results is None:
        return None
    return (num_steps * benchmarking_results["step_time"]) / (24 * 60 * 60)


@dataclass
class TrainingTimeEmpirical(Experiment):
    config: TrainingConfig = None  # type: ignore[assignment]
    benchmarking_steps: int = 3
    trial: int = 0

    def to_dict(self) -> dict[str, Any]:
        return {"trial": self.trial, **self.config.__dict__, "benchmarking_steps": self.benchmarking_steps}

    def __post_init__(self):
        self.model_cls = self.config.model_class()
        self.plan = self.config.training_plan()

    def is_valid(self) -> bool:
        """The JAX method grid's validity predicate, rule for rule
        (``experiments/training_time_empirical.py:275-329``)."""
        if any(
            [
                self.benchmarking_steps <= 0,
                self.trial < 0,
                # the batch divides evenly over the cards
                self.model_cls.batch_size % self.config.num_chips > 0,
                # a card's batch is a power of two
                not math.log2(self.model_cls.batch_size // self.config.num_chips).is_integer(),
                self.config.activation_checkpointing and not self.model_cls.supports_activation_checkpointing,
                # the policy is a remat knob: without remat only its default
                not self.config.activation_checkpointing and self.config.checkpoint_policy != "flash",
                self.model_cls.mixed_precision == "bf16" and not self.config.supports_bf16(),
                # no sharding on one card unless offloading
                self.config.num_chips == 1 and self.config.sharding != "" and not self.config.offloading,
                # offloading needs sharding
                self.config.offloading and self.config.sharding == "",
                # hybrid methods need more than one host
                "hybrid" in self.config.sharding and self.config.num_hosts <= 1,
                "3++" in self.config.sharding and self.config.num_hosts <= 1,
                self.config.num_chips % self.config.tensor_parallel != 0,
                # the bf16 state layouts need bf16 (or fp16) compute and the
                # free lunch, and are the alternative to an offloaded optimizer
                self.config.state_layout != ""
                and (
                    self.model_cls.mixed_precision not in ("bf16", "fp16")
                    or not self.config.free_lunch
                    or self.config.offloading
                ),
                # unrolling is an arm only for a build_model that takes it
                # under the free lunch; no port model does
                self.config.unroll_layers
                and (
                    not self.config.free_lunch
                    or "unroll_layers" not in inspect.signature(self.model_cls.build_model).parameters
                ),
            ]
        ):
            return False
        return self.plan.is_valid()

    @property
    def target_micro_batch_size(self) -> int:
        return self.model_cls.batch_size // self.config.num_chips

    @property
    def step_dict(self):
        # the measurement steps key on the one-card-equivalent config, so
        # labels that run the same program share one measurement
        meas_config = self.config.measurement_equivalent()
        steps = {}
        steps["max_micro_batch_size"] = find_largest_batch_size(config=meas_config, limit=self.target_micro_batch_size)
        steps["benchmarking_results"] = benchmark_step_time(
            config=meas_config,
            max_micro_batch_size=steps["max_micro_batch_size"],
            target_micro_batch_size=self.target_micro_batch_size,
            num_benchmarking_steps=self.benchmarking_steps,
            trial=self.trial,
        )
        steps["training_days"] = compute_training_days(
            benchmarking_results=steps["benchmarking_results"],
            num_steps=self.model_cls.training_steps,
        )
        return steps

    def results(self):
        br = self.step_result("benchmarking_results")
        out = {
            "max_micro_batch_size": self.step_result("max_micro_batch_size"),
            "training_days": self.step_result("training_days"),
        }
        if isinstance(br, dict):
            out.update(br)
        elif br is not None:  # a StepFailure; Sweep.results shows it
            out["benchmarking_results"] = br
        return out


if __name__ == "__main__":
    TrainingTimeEmpirical.cli()
