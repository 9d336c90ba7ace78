"""Disposable probe worker (counterpart of ``benchmarking/probe_worker.py``).

    python -m multimodal_llm_pretraining_tpu_torch.benchmarking.probe_worker < spec.json

Reads one JSON spec from standard input: ``op``, ``model_type``, ``plan``
(the ``TrainingPlan``'s fields, as ``dataclasses.asdict`` gives them),
``micro_batch_size``, ``device`` and, by op:

- ``"confirm"`` (the default): one accumulate and one optimizer step at the
  micro-batch size, the max-micro-batch search's probe;
- ``"time_phases"``: ``measure_phase_times`` at the micro-batch size, over
  ``samples`` (default 3) timed pairs;
- ``"time_fused"``: ``measure_fused_step_time`` of the plan's step at the
  micro-batch size and ``accumulation_steps``, 2 untimed steps and the
  median of ``samples`` (default 3);
- ``dataset_overrides``: attributes set on the dataset (the tests shorten
  the sequence).

Prints one line ``MLPT_RESULT:{json}``: ``{"ok": true, ...}`` with the op's
times and the card's peak memory, or ``{"oom": true, ...}`` when the op ran
out of memory. Any other failure raises and exits non-zero, with no result
line.
"""

import dataclasses
import json
import sys

import torch

from ..models import SchedulerType, get_model_class
from ..parallel.mesh import MeshConfig
from ..train import TrainingPlan
from .max_batch_size import RESULT_PREFIX
from .step_time import measure_fused_step_time, measure_phase_times
from .utils import BenchmarkHarness, OutOfMemory, is_oom_error


def plan_from_dict(fields: dict) -> TrainingPlan:
    """The plan ``dataclasses.asdict`` turned into ``fields``."""
    return TrainingPlan(**{**fields, "mesh": MeshConfig(**fields["mesh"]),
                           "scheduler_type": SchedulerType(fields["scheduler_type"])})


def _run_op(spec: dict, plan: TrainingPlan, model_class, mbs: int, device: torch.device) -> dict:
    op = spec.get("op", "confirm")
    overrides = spec.get("dataset_overrides", {})
    if op == "time_fused":
        acc = int(spec["accumulation_steps"])
        session = dataclasses.replace(plan, micro_batch_size=mbs, gradient_accumulation_steps=acc).build_session(
            model_class, device=device)
        for attr, value in overrides.items():
            setattr(session.dataset, attr, value)
        fused = measure_fused_step_time(session, acc, samples=int(spec.get("samples", 3)))
        return {"step_time_fused": fused.step_s, "times": list(fused.times), "loss": fused.loss,
                "accumulation_steps": acc}
    if op not in ("confirm", "time_phases"):
        raise ValueError(f"unknown op {op!r}")
    harness = BenchmarkHarness(plan, model_class, device=device)
    for attr, value in overrides.items():
        setattr(harness.session.dataset, attr, value)
    harness.setup()
    if op == "confirm":
        harness.manual_training_step(mbs, seed=0)
        harness.manual_optimization_step()
        return {}
    times = measure_phase_times(harness, mbs, samples=int(spec.get("samples", 3)))
    return {"accumulate_s": times.accumulate_s, "optimizer_s": times.optimizer_s, "samples": times.samples}


def run(spec: dict) -> dict:
    mbs = int(spec["micro_batch_size"])
    device = torch.device(spec.get("device", "cuda"))
    plan = plan_from_dict(spec["plan"])
    try:
        out = _run_op(spec, plan, get_model_class(spec["model_type"]), mbs, device)
    except Exception as e:
        if isinstance(e, OutOfMemory) or is_oom_error(e):  # the fused step's own errors are not normalised
            return {"oom": True, "micro_batch_size": mbs, "error": str(e)[:1000]}
        raise
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return {"ok": True, "micro_batch_size": mbs, "peak_bytes": peak, **out}


def main() -> None:
    result = run(json.loads(sys.stdin.read()))
    print(RESULT_PREFIX + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
