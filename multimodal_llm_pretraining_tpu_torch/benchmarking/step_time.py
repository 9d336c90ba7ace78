"""Phase timing for one training configuration (counterpart of
``benchmarking/step_time.py:30-121``).

The accumulate phase (forward and backward into the gradients) and the
optimizer phase are timed apart, as the reference does
(``src/benchmarking/step_time.py:33-97``), and a full step extrapolates as

    step_time = accumulate_s * accumulation_steps + optimizer_s

``measure_fused_step_time`` times what training runs instead: the session's
``train_step_fn`` at the target accumulation, median of ``samples``. Every
timed call is host time ending in a device synchronise; inputs are made and
moved to the device before the clock starts.
"""

import statistics
from dataclasses import dataclass

from ..utils import block_on, get_logger
from .utils import BenchmarkHarness, timed

logger = get_logger()


@dataclass(frozen=True)
class PhaseTimes:
    """Mean seconds per phase over ``samples`` measured (accumulate,
    optimize) pairs."""

    accumulate_s: float
    optimizer_s: float
    samples: int

    def step_time(self, accumulation_steps: int) -> float:
        return self.accumulate_s * accumulation_steps + self.optimizer_s


def measure_phase_times(harness: BenchmarkHarness, micro_batch_size: int, samples: int = 3) -> PhaseTimes:
    """Time ``samples`` (accumulate, optimize) pairs after one untimed
    warmup pair; each micro-batch is pre-fetched outside the timed call
    (``step_time.py:47-58`` of the reference)."""
    if samples < 1:
        raise ValueError(f"samples must be at least 1, got {samples}")
    harness.manual_training_step(micro_batch_size, seed=0)
    harness.manual_optimization_step()
    acc_total = opt_total = 0.0
    for i in range(samples):
        batch = harness.prefetch_micro_batch(micro_batch_size, seed=i + 1)
        acc_total += timed(harness.manual_training_step, micro_batch_size, prefetched=batch, device=harness.device)
        opt_total += timed(harness.manual_optimization_step, device=harness.device)
    times = PhaseTimes(acc_total / samples, opt_total / samples, samples)
    logger.info(f"phase times @ mbs={micro_batch_size}: accumulate {times.accumulate_s:.4f}s, "
                f"optimizer {times.optimizer_s:.4f}s (n={samples})")
    return times


@dataclass(frozen=True)
class FusedStepTime:
    """The median of the timed fused steps, every timed step's seconds and
    the last step's loss."""

    step_s: float
    times: tuple[float, ...]
    loss: float


def measure_fused_step_time(session, accumulation_steps: int, samples: int = 3, warmups: int = 2) -> FusedStepTime:
    """Time the production step (``TrainSession.train_step_fn``) at the
    target accumulation: fresh state, ``warmups`` untimed steps, then the
    median of ``samples`` timed ones (``bench.py``'s protocol).
    ``session.plan`` must already carry the target micro-batch size and
    accumulation count."""
    if session.plan.gradient_accumulation_steps != accumulation_steps:
        raise ValueError(f"the session's plan accumulates {session.plan.gradient_accumulation_steps} "
                         f"micro-batches, not {accumulation_steps}")
    if samples < 1:
        raise ValueError(f"samples must be at least 1, got {samples}")
    state = session.init_state()
    step = session.train_step_fn()
    times, loss = [], float("nan")
    for i in range(warmups + samples):
        batch = session.make_train_batch(seed=i)
        block_on(session.device)
        out: dict = {}

        def one_step():
            nonlocal state
            state, out["metrics"] = step(state, batch)

        seconds = timed(one_step, device=session.device)
        loss = float(out["metrics"]["loss"])
        if i >= warmups:
            times.append(seconds)
    fused = FusedStepTime(statistics.median(times), tuple(times), loss)
    logger.info(f"fused step @ acc={accumulation_steps}: {fused.step_s:.4f}s (median of {samples})")
    return fused


def estimate_step_time(
    harness: BenchmarkHarness,
    micro_batch_size: int,
    target_micro_batch_size: int,
    num_benchmarking_steps: int,
) -> float:
    """Full-step seconds at ``micro_batch_size``, extrapolated to the
    gradient-accumulation count that reaches ``target_micro_batch_size``."""
    accumulation_steps = target_micro_batch_size // micro_batch_size
    times = measure_phase_times(harness, micro_batch_size, samples=num_benchmarking_steps)
    return times.step_time(accumulation_steps)
