"""Optimizers and LR schedules (counterpart of ``training/optimizer.py:28-211``).

Two update paths, each mirroring its JAX counterpart operation for operation:

- ``AdamChain``, the optax chain of the f32 layout: ``clip_by_global_norm``,
  then L2 weight decay into the gradient (``"adam"``), ``scale_by_adam``,
  decoupled decay (``"adamw"``) and ``scale_by_learning_rate``.
- ``FusedAdamLowp``, the per-leaf Adam with low-precision stored moments of
  the ``bf16_sr`` layout, after ``clip_by_global_norm_keep_dtype``.

The two read the schedule one step apart, as in JAX: the chain's
``scale_by_learning_rate`` counts from 0 and reads ``schedule(count)`` before
its increment, so step 1 uses ``schedule(0)`` (0 under warmup);
``fused_adam_lowp`` reads ``schedule(count + 1)``.

Tensors are lists in the module's parameter order. Moments are updated in
place where the JAX versions return new trees; ``update`` returns the f32
(or leaf-dtype) update of each leaf for the caller to apply.

Frozen leaves carry no state: the session hands ``init`` and ``update`` its
trainable parameters only, so moments, the global norm of the clip and the
updates cover those alone, as the JAX chain wrapped in ``optax.masked``
(``optimizer.py:202-208``) gives.
"""

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..models import OptimizerT, SchedulerType

Schedule = Callable[[int], float]

# ---------------------------------------------------------------- schedules
# optax's schedules, computed in Python floats (optax uses f32: the two agree
# to a few f32 ulps).


def _linear(init: float, end: float, transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        c = min(max(count, 0), transition_steps)
        return (init - end) * (1 - c / transition_steps) + end

    return schedule


def _cosine_decay(init: float, decay_steps: int, alpha: float) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps)) + alpha)

    return schedule


def _join(schedules: list[Schedule], boundaries: list[int]) -> Schedule:
    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, s in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = s(count - boundary)
        return out

    return schedule


def _warmup_cosine(init: float, peak: float, warmup: int, decay_steps: int, end: float) -> Schedule:
    alpha = 0.0 if peak == 0.0 else end / peak
    return _join([_linear(init, peak, warmup), _cosine_decay(peak, decay_steps - warmup, alpha)], [warmup])


def build_schedule(
    scheduler_type: SchedulerType,
    scheduler_kwargs: dict[str, Any],
    base_lr: float,
    num_training_steps: int,
) -> Schedule:
    kwargs = dict(scheduler_kwargs)
    warmup = int(kwargs.pop("num_warmup_steps", 0))
    # benchmark plans run a handful of steps with the real recipe's warmup
    warmup = min(warmup, max(num_training_steps - 1, 0))
    match scheduler_type:
        case SchedulerType.LINEAR:
            return _join(
                [_linear(0.0, base_lr, max(warmup, 1)), _linear(base_lr, 0.0, max(num_training_steps - warmup, 1))],
                [warmup],
            )
        case SchedulerType.COSINE:
            return _warmup_cosine(0.0, base_lr, warmup, num_training_steps, 0.0)
        case SchedulerType.COSINE_WITH_MIN_LR:
            if "min_lr" in kwargs:
                end = float(kwargs.pop("min_lr"))
            else:
                end = base_lr * float(kwargs.pop("min_lr_rate", 0.0))
            return _warmup_cosine(0.0, base_lr, warmup, num_training_steps, end)
    raise ValueError(f"unknown scheduler {scheduler_type}")


# ---------------------------------------------------------------- pieces


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """optax ``global_norm``: per-leaf sum of squares in the leaf's dtype
    (a bf16 leaf's sum accumulates in f32 and rounds once), summed across
    leaves with dtype promotion, then the square root."""
    total = None
    for t in tensors:
        s = (t * t).sum()
        total = s if total is None else total + s
    return total.sqrt()


@torch.no_grad()
def clip_by_global_norm_keep_dtype(grads: list[torch.Tensor], max_norm: float) -> None:
    """Scale ``grads`` in place by min(1, max_norm / (norm + 1e-16)), the
    scale cast to each leaf's dtype so the storage never widens."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-16), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))


@torch.no_grad()
def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> None:
    """optax ``clip_by_global_norm``, in place: leaves unchanged below
    ``max_norm``, else ``g / norm * max_norm``. Decided on the device, with
    no host read of the norm."""
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))


def stochastic_round_to(
    x32: torch.Tensor,
    dtype: torch.dtype = torch.bfloat16,
    *,
    generator: torch.Generator | None = None,
    bits: torch.Tensor | None = None,
) -> torch.Tensor:
    """Unbiased stochastic rounding f32 -> bf16: add 16 uniform random bits
    to the f32 bit pattern, then keep its top 16 bits (a carry reaches the
    kept mantissa with probability equal to the dropped fraction; the
    sign-magnitude encoding makes this right for negatives too). The
    arithmetic is on an int32 view, whose wrap-around equals the JAX
    version's uint32 one. ``bits`` (int32 in [0, 2^16)) injects the draws;
    otherwise they come from ``generator``."""
    if dtype != torch.bfloat16:
        raise ValueError(f"stochastic rounding targets bfloat16, got {dtype}")
    if bits is None:
        bits = torch.randint(0, 1 << 16, x32.shape, generator=generator, device=x32.device, dtype=torch.int32)
    u = x32.float().view(torch.int32)
    u = (u + bits) & -65536  # 0xFFFF0000 as int32
    return u.view(torch.float32).to(torch.bfloat16)


@dataclass
class AdamState:
    count: int
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    # the master layout's f32 copy of each trainable parameter (the session
    # sets it; JAX's {"master", "inner"} opt state), else None
    master: list[torch.Tensor] | None = None


class AdamChain:
    """The optax chain of the f32 layout. Moments take the params' dtype,
    as ``optax.scale_by_adam`` does."""

    def __init__(self, b1, b2, eps, schedule: Schedule, weight_decay: float, decoupled: bool, max_grad_norm: float):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.schedule, self.weight_decay, self.decoupled = schedule, weight_decay, decoupled
        self.max_grad_norm = max_grad_norm

    def init(self, params: list[torch.Tensor]) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor], state: AdamState, params: list[torch.Tensor]) -> list[torch.Tensor]:
        """Updates to add to the params. Clips ``grads`` in place and
        advances ``state`` in place."""
        b1, b2, wd = self.b1, self.b2, self.weight_decay
        if self.max_grad_norm > 0:
            clip_by_global_norm(grads, self.max_grad_norm)
        lr = self.schedule(state.count)  # scale_by_learning_rate: its count before the increment
        state.count += 1
        bc1, bc2 = 1 - b1**state.count, 1 - b2**state.count
        updates = []
        for g, m, v, p in zip(grads, state.mu, state.nu, params):
            if wd and not self.decoupled:
                g = g + wd * p
            m.copy_((1 - b1) * g + b1 * m)
            v.copy_((1 - b2) * (g * g) + b2 * v)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if wd and self.decoupled:
                u = u + wd * p
            updates.append(-lr * u)
        return updates


class FusedAdamLowp:
    """``fused_adam_lowp``: per-leaf Adam whose math runs in f32 every step
    and whose moments round to ``state_dtype`` once when stored; weight
    decay is L2 into the gradient for "adam", decoupled for "adamw". The
    clip (``clip_by_global_norm_keep_dtype``) runs first, as in the JAX
    chain."""

    def __init__(self, b1, b2, eps, schedule: Schedule, weight_decay: float, decoupled: bool,
                 state_dtype: torch.dtype, max_grad_norm: float):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.schedule, self.weight_decay, self.decoupled = schedule, weight_decay, decoupled
        self.state_dtype, self.max_grad_norm = state_dtype, max_grad_norm

    def init(self, params: list[torch.Tensor]) -> AdamState:
        def zeros():
            return [torch.zeros(p.shape, dtype=self.state_dtype, device=p.device) for p in params]

        return AdamState(0, zeros(), zeros())

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor], state: AdamState, params: list[torch.Tensor]) -> list[torch.Tensor]:
        """f32 updates to add to the params. Clips ``grads`` in place and
        advances ``state`` in place."""
        b1, b2, wd = self.b1, self.b2, self.weight_decay
        if self.max_grad_norm > 0:
            clip_by_global_norm_keep_dtype(grads, self.max_grad_norm)
        state.count += 1
        neg_lr = -self.schedule(state.count)
        bc1, bc2 = 1 - b1**state.count, 1 - b2**state.count
        updates = []
        for g, m, v, p in zip(grads, state.mu, state.nu, params):
            g32 = g.float()
            if wd and not self.decoupled:
                g32 = g32 + wd * p.float()
            m32 = b1 * m.float() + (1 - b1) * g32
            v32 = b2 * v.float() + (1 - b2) * torch.square(g32)
            d = (m32 / bc1) / (torch.sqrt(v32 / bc2) + self.eps)
            if wd and self.decoupled:
                d = d + wd * p.float()
            m.copy_(m32)
            v.copy_(v32)
            updates.append(neg_lr * d)
        return updates


def build_optimizer(
    optimizer: OptimizerT,
    optimizer_kwargs: dict[str, Any],
    scheduler_type: SchedulerType,
    scheduler_kwargs: dict[str, Any],
    num_training_steps: int,
    max_grad_norm: float = 0.0,
    opt_state_dtype: torch.dtype | None = None,
) -> AdamChain | FusedAdamLowp:
    kwargs = dict(optimizer_kwargs)
    lr = float(kwargs.pop("lr"))
    b1, b2 = kwargs.pop("betas", (0.9, 0.999))
    eps = float(kwargs.pop("eps", 1e-8))
    weight_decay = float(kwargs.pop("weight_decay", 0.0))
    schedule = build_schedule(scheduler_type, scheduler_kwargs, lr, num_training_steps)
    decoupled = optimizer == "adamw"
    clip = max_grad_norm if max_grad_norm and max_grad_norm > 0 else 0.0
    if opt_state_dtype is not None and opt_state_dtype != torch.float32:
        return FusedAdamLowp(b1, b2, eps, schedule, weight_decay, decoupled, opt_state_dtype, clip)
    return AdamChain(b1, b2, eps, schedule, weight_decay, decoupled, clip)
