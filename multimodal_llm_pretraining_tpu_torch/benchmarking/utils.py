"""Benchmark harness: the ``ManualTrainer`` analog (counterpart of
``benchmarking/utils.py:36-222``).

The reference drives HF ``Trainer``'s accumulation and optimizer phases by
hand (``src/benchmarking/utils.py:40-80``). The port's ``TrainSession``
already hands them out separately (``accumulate_fn``,
``optimizer_update_fn``), so the harness owns the state, the timing (each
timed call ends in a device synchronise) and the out-of-memory
classification. The JAX harness's static fit table (an AOT compile checked
against HBM, ``fit_check``, ``predicted_bytes``, ``analytic_floor_bytes``)
has no counterpart in eager PyTorch: whether a micro-batch fits is learnt by
running it (``max_batch_size.py``).
"""

import gc
import time

import torch

from ..train import TrainingPlan
from ..training.step import TrainSession, TrainState
from ..utils import block_on


def is_oom_error(e: BaseException) -> bool:
    """Whether ``e`` says the card ran out of memory: PyTorch's caching
    allocator raises ``torch.cuda.OutOfMemoryError`` for every allocation
    the port makes (activations, gradients, the kernels' outputs and
    scratch, which the wrappers allocate)."""
    return isinstance(e, torch.cuda.OutOfMemoryError)


class OutOfMemory(Exception):
    """Normalised out-of-memory signal: a probe that raises it did not fit."""


class BenchmarkHarness:
    def __init__(self, plan: TrainingPlan, model_class, device: torch.device | str = "cuda"):
        self.plan = plan
        self.model_class = model_class
        self.session = TrainSession(plan, model_class, device=device)
        self.state: TrainState | None = None

    @property
    def device(self) -> torch.device:
        return self.session.device

    def _live_state(self) -> TrainState:
        if self.state is None:
            raise RuntimeError("BenchmarkHarness: call setup() first")
        return self.state

    # ------------------------------------------------------------ state

    def setup(self) -> None:
        """Draw the parameters and zero the optimizer state: all expensive
        set-up happens here, never in a timed call."""
        try:
            self.state = self.session.init_state()
            block_on(self.device)
        except Exception as e:
            if is_oom_error(e):
                raise OutOfMemory(str(e)) from e
            raise

    def persistent_state_bytes(self) -> int:
        """Device bytes of the optimizer state (the moments and the master
        layout's f32 master) and of the accumulators a ``grad_accum_dtype``
        other than the params' keeps, which live beside the parameters at
        every micro-batch size."""
        opt_state = self._live_state().opt_state
        sess = self.session
        state = [*opt_state.mu, *opt_state.nu, *(opt_state.master or [])]
        nbytes = sum(t.numel() * t.element_size() for t in state)
        if sess.grad_dtype != sess.param_dtype:
            params = dict(sess.module.named_parameters())
            nbytes += sum(params[n].numel() for n in sess.trainable) * sess.grad_dtype.itemsize
        return nbytes

    def reset(self) -> None:
        """Drop the gradients, the state and the allocator's cache after an
        out-of-memory error, then set up again."""
        self.session.zero_grads()
        self.state = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.setup()

    # ------------------------------------------------------------ stepping

    def prefetch_micro_batch(self, micro_batch_size: int, seed: int = 0) -> dict[str, torch.Tensor]:
        """One micro-batch made and moved to the device outside any timed
        region (the reference times with pre-fetched inputs,
        ``src/benchmarking/step_time.py:47-58``)."""
        batch = self.session.make_micro_batch(micro_batch_size, seed=seed)
        block_on(self.device)
        return batch

    def manual_training_step(self, micro_batch_size: int, seed: int = 0, prefetched=None) -> None:
        """One forward and backward accumulated into the gradients
        (``manual_training_step``, ``src/benchmarking/utils.py:61-63``); pass
        ``prefetched`` from :meth:`prefetch_micro_batch` when timing."""
        state = self._live_state()
        try:
            batch = prefetched if prefetched is not None else self.prefetch_micro_batch(micro_batch_size, seed)
            self.session.accumulate_fn()(state, batch)
            block_on(self.device)
        except Exception as e:
            if is_oom_error(e):
                raise OutOfMemory(str(e)) from e
            raise

    def manual_optimization_step(self) -> None:
        """Clip, optimizer step, schedule and gradient reset
        (``manual_optimization_step``, ``src/benchmarking/utils.py:65-80``)."""
        state = self._live_state()
        try:
            self.session.optimizer_update_fn()(state, 1.0)
            state.step += 1
            block_on(self.device)
        except Exception as e:
            if is_oom_error(e):
                raise OutOfMemory(str(e)) from e
            raise


def timed(fn, *args, device: torch.device | str | None = None, **kwargs) -> float:
    """Host seconds of ``fn(*args, **kwargs)``, ending in a synchronise of
    ``device`` when it is a card (``perf_timer``,
    ``src/benchmarking/step_time.py:14-18``); a CPU needs none."""
    t0 = time.perf_counter()
    fn(*args, **kwargs)
    if device is not None:
        block_on(device)
    return time.perf_counter() - t0
