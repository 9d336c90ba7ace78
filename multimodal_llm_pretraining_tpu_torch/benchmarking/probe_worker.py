"""Disposable probe worker for the max-micro-batch search (counterpart of
``benchmarking/probe_worker.py:1-103``).

    python -m multimodal_llm_pretraining_tpu_torch.benchmarking.probe_worker < spec.json

Reads one JSON spec from standard input: ``model_type``, ``plan`` (the
``TrainingPlan``'s fields, as ``dataclasses.asdict`` gives them),
``micro_batch_size`` and ``device``. Builds the harness, runs one
accumulate and one optimizer step at the micro-batch size, and prints one
line ``MLPT_RESULT:{json}``: ``{"ok": true, ...}`` with the card's peak
memory, or ``{"oom": true, ...}`` when the step ran out of memory. Any other
failure raises and exits non-zero, with no result line.
"""

import json
import sys

import torch

from ..models import SchedulerType, get_model_class
from ..parallel.mesh import MeshConfig
from ..train import TrainingPlan
from .max_batch_size import RESULT_PREFIX
from .utils import BenchmarkHarness, OutOfMemory


def plan_from_dict(fields: dict) -> TrainingPlan:
    """The plan ``dataclasses.asdict`` turned into ``fields``."""
    return TrainingPlan(**{**fields, "mesh": MeshConfig(**fields["mesh"]),
                           "scheduler_type": SchedulerType(fields["scheduler_type"])})


def run(spec: dict) -> dict:
    mbs = int(spec["micro_batch_size"])
    device = torch.device(spec.get("device", "cuda"))
    harness = BenchmarkHarness(plan_from_dict(spec["plan"]), get_model_class(spec["model_type"]), device=device)
    try:
        harness.setup()
        harness.manual_training_step(mbs, seed=0)
        harness.manual_optimization_step()
    except OutOfMemory as e:
        return {"oom": True, "micro_batch_size": mbs, "error": str(e)[:1000]}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return {"ok": True, "micro_batch_size": mbs, "peak_bytes": peak}


def main() -> None:
    result = run(json.loads(sys.stdin.read()))
    print(RESULT_PREFIX + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
