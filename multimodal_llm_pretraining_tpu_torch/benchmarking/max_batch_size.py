"""Largest power-of-2 micro-batch search (counterpart of
``benchmarking/max_batch_size.py:64-170``).

The reference's contract (``src/benchmarking/max_batch_size.py:11-25``):
double the micro-batch until a step fails for lack of memory, and return
the last size that ran. Eager PyTorch has no static fit check, so every
candidate runs: ``subprocess_confirm`` runs one accumulate and one optimizer
step in a fresh worker process (``probe_worker.py``), since an out-of-memory
error on the card can leave a process unfit to go on. The parent runs
nothing on the card while a worker runs. A worker that fails for any other
reason than memory raises: it does not mean "does not fit".
"""

import dataclasses
import json
import os
import subprocess
import sys
from typing import Callable

from ..utils import get_logger
from .utils import BenchmarkHarness, OutOfMemory

logger = get_logger()

RESULT_PREFIX = "MLPT_RESULT:"
# probe worker processes started in this process (``run_probe_worker``)
WORKER_STARTS = 0
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def find_max_mbs_pow2(limit: int, confirm: Callable[[int], bool]) -> int:
    """The largest power of 2 up to ``limit`` for which ``confirm(mbs)``
    holds, trying 1, 2, 4, ... and stopping at the first that does not (0
    when 1 does not)."""
    best, mbs = 0, 1
    while mbs <= limit:
        fits = confirm(mbs)
        logger.info(f"max micro-batch search: mbs={mbs} {'fits' if fits else 'out of memory'}")
        if not fits:
            break
        best, mbs = mbs, mbs * 2
    return best


def run_probe_worker(spec: dict, timeout: float = 900.0) -> dict:
    """Run ``spec`` (see ``probe_worker.py``) in a fresh ``probe_worker``
    process and return its result line: ``{"ok": true, ...}`` or ``{"oom":
    true, ...}``. Anything else (a crash, a kernel error, a refused plan, a
    worker past ``timeout`` seconds, which is killed) raises, with the end of
    the worker's standard error. Counts every worker it starts in
    ``WORKER_STARTS``."""
    global WORKER_STARTS
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [_REPO_ROOT, os.environ.get("PYTHONPATH")]))}
    WORKER_STARTS += 1
    proc = subprocess.run(
        [sys.executable, "-m", "multimodal_llm_pretraining_tpu_torch.benchmarking.probe_worker"],
        input=json.dumps(spec), capture_output=True, text=True, timeout=timeout, cwd=_REPO_ROOT, env=env,
    )
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(RESULT_PREFIX)]
    result = json.loads(lines[-1][len(RESULT_PREFIX):]) if lines else {}
    if proc.returncode == 0 and (result.get("oom") or result.get("ok")):
        return result
    raise RuntimeError(f"probe worker at mbs={spec.get('micro_batch_size')} failed ({spec.get('op', 'confirm')}, "
                       f"exit code {proc.returncode}, result {result!r}):\n{proc.stderr[-4000:]}")


def worker_spec(op: str, plan, model_type: str, micro_batch_size: int, device: str = "cuda", **extra) -> dict:
    """The JSON spec of one ``probe_worker`` op."""
    return {"op": op, "model_type": model_type, "plan": dataclasses.asdict(plan),
            "micro_batch_size": micro_batch_size, "device": device, **extra}


def subprocess_confirm(plan, model_type: str, device: str = "cuda", timeout: float = 900.0,
                       run_worker: Callable[[dict], dict] | None = None) -> Callable[[int], bool]:
    """``confirm(mbs)`` for ``find_max_mbs_pow2``: one accumulate and one
    optimizer step of ``model_type`` under ``plan`` at micro-batch ``mbs``
    in a fresh ``probe_worker`` process (or through ``run_worker(spec)``,
    which tests inject). True when the step ran, False when it ran out of
    memory; anything else raises."""

    def confirm(mbs: int) -> bool:
        spec = worker_spec("confirm", plan, model_type, mbs, device)
        result = run_worker(spec) if run_worker is not None else run_probe_worker(spec, timeout)
        return not result.get("oom")

    return confirm


def inprocess_confirm(harness: BenchmarkHarness) -> Callable[[int], bool]:
    """``confirm(mbs)`` in this process, for a device where running out of
    memory is a clean exception (the CPU tests); on the card use
    ``subprocess_confirm``."""

    def confirm(mbs: int) -> bool:
        if harness.state is None:
            harness.setup()
        try:
            harness.manual_training_step(mbs, seed=0)
            harness.manual_optimization_step()
            return True
        except OutOfMemory:
            harness.reset()
            return False

    return confirm
