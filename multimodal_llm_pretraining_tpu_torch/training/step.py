"""The training step (counterpart of ``training/step.py:41-603``).

``TrainSession`` builds the model on one device and hands out the same entry
points as the JAX session: ``accumulate_fn``, ``grads_fn``,
``optimizer_update_fn`` and ``train_step_fn``. PyTorch runs eagerly, so each
returns a plain function; there is nothing to compile.

Where the JAX step donates its buffers and returns new ones
(``step.py:596-602``), this one updates in place: the parameters, the Adam
moments and the gradient accumulators (the parameters' ``.grad``) are
overwritten, and ``TrainState`` holds the live tensors.

Three state layouts, chosen by the plan as in JAX (``step.py:140-146``):

- f32: f32 params (compute in f32 or bf16; with bf16 compute the layers
  cast weights at use) and the optax-chain Adam. ``master_weights`` with
  f32 compute is this layout too.
- ``bf16_sr`` (``bf16=True, master_weights="sr"``): bf16 params, grads and
  accumulators, bf16 moments (``opt_state_dtype="bf16"``), updates applied
  with stochastic rounding and no f32 master.
- master (``bf16=True, master_weights=True`` or ``"device"``; the grid's
  ``bf16_master``): bf16 params and an f32 master of every trainable one
  in the optimizer state (``AdamState.master``, made from the bf16 params
  as JAX's ``opt_init`` makes it, ``:301-305``). Adam (either kind) updates
  against the master, so weight decay reads it; the master takes the
  update, and the live bf16 copy is re-derived by one round-to-nearest
  cast (``:461-468``).

Gradient accumulators take the params' dtype unless ``grad_accum_dtype``
names another (``:204-231``). PyTorch keeps ``.grad`` in the param's
dtype, so such a layout keeps accumulators of its own: a post-accumulate
hook on each trainable parameter adds its ``.grad`` into its accumulator
after every backward, rounding once per micro-batch as JAX's
``(a + g).astype(a.dtype)`` does (``:437-441``; ``add_`` sums in the
wider dtype and rounds into the accumulator's), then drops the ``.grad``.
The optimizer reads the accumulators. A fused step of one micro-batch
uses its gradient as it comes, unrounded, as the JAX step does at
``acc == 1`` (``:503-509``).

A model with a trainable mask (LLaVA) freezes the rest: frozen parameters
get ``requires_grad_(False)``, so autograd records nothing for them (JAX's
``stop_gradient`` and dead-code elimination, ``step.py:400-412``), and only
trainable ones get gradients and optimizer state (``step.py:200-231,
414-435``). Frozen parameters are stored in the compute dtype, trainable
ones in the layout's: with bf16 compute and no SR that is bf16 frozen
leaves beside f32 trainable ones, the layout JAX trains llava-pretrain in
(``step.py:158-169``).

Every training micro-batch hands the loss the session's dropout generator,
as the JAX step hands its loss an ``rng`` (``step.py:400-411, 501``); a
model with dropout (ViT, RoBERTa) draws its masks from it, the others ignore it. The
generator is seeded with ``DROPOUT_SEED``, like the SR generator with
``SR_SEED``, and draws on from micro-batch to micro-batch.

Activation checkpointing goes to the model's ``build_model``, and so does
``plan.checkpoint_policy`` where the model takes one (pythia's "flash" and
"dots"), as the JAX session hands it over (``step.py:60-70``): mamba remats
each whole block, the others run their blocks under ``checkpoint_block``.

A micro-batch's forward and backward record the spans ``step.forward`` and
``step.backward`` while a profiler records (``tracing.py``).

Not ported yet, and refused with the ROADMAP item: sharding, offloading
and more than one device.
"""

import functools
import inspect
from dataclasses import dataclass

import numpy as np
import torch

from ..tracing import span
from ..utils import require_cuda
from .optimizer import AdamState, build_optimizer, stochastic_round_to

# the JAX step derives its SR keys from jax.random.key(17)
SR_SEED = 17
# the JAX step's dropout keys come from the key its caller passes (key(0) in the benchmarks)
DROPOUT_SEED = 0


@dataclass
class TrainState:
    step: int
    params: dict[str, torch.nn.Parameter]  # the module's own parameters, updated in place
    opt_state: AdamState


class TrainSession:
    """Builds the model, optimizer and data for one (plan, model) pair on
    ``device``. A CUDA device with no GPU present raises; nothing falls back
    to the CPU."""

    def __init__(self, plan, model_class, device: torch.device | str = "cuda"):
        self.plan = plan
        self.model_class = model_class
        self.device = torch.device(device)
        if self.device.type == "cuda":
            self.device = require_cuda()

        plan.mesh_config().require_single_device()
        if plan.sharding or plan.offloading:
            raise NotImplementedError("sharding and offloading are ROADMAP Queue 1 items 7 and 8")
        plan.apply_matmul_precision()

        self.compute_dtype = plan.compute_dtype
        mw, bf16 = plan.master_weights, self.compute_dtype == torch.bfloat16
        self.sr_params = mw == "sr" and bf16
        self.master_params = bool(mw) and not self.sr_params and bf16
        self.param_dtype = torch.bfloat16 if self.sr_params or self.master_params else torch.float32
        self.grad_dtype = {"bf16": torch.bfloat16, "f32": torch.float32, None: self.param_dtype}[plan.grad_accum_dtype]

        # the policy goes only to a build_model that takes it; its default
        # is the plan's, so leaving it out is the same
        build_kwargs = {}
        if plan.checkpoint_policy != "flash" and "checkpoint_policy" in inspect.signature(model_class.build_model).parameters:
            build_kwargs["checkpoint_policy"] = plan.checkpoint_policy
        self.bundle = model_class.build_model(
            use_custom_kernels=plan.use_custom_kernels,
            activation_checkpointing=plan.activation_checkpointing,
            compute_dtype=self.compute_dtype,
            device=self.device,
            **build_kwargs,
        )
        self.module = self.bundle.module.to(self.param_dtype)
        mask = self.bundle.trainable_mask
        # names of the parameters the optimizer updates, in module order
        self.trainable = [n for n, _ in self.module.named_parameters() if mask is None or mask[n]]
        if mask is not None:
            for name, p in self.module.named_parameters():
                if not mask[name]:
                    p.requires_grad_(False)
                    p.data = p.data.to(self.compute_dtype)
        # the accumulators of a grad_accum_dtype other than the params', by
        # parameter name; empty until a backward fills them
        self.accumulators: dict[str, torch.Tensor] = {}
        self._route_grads = self.grad_dtype != self.param_dtype
        if self._route_grads:
            params = dict(self.module.named_parameters())
            for name in self.trainable:
                params[name].register_post_accumulate_grad_hook(functools.partial(self._into_accumulator, name))
        self.dataset = model_class.load_dummy_dataset()
        self.tx = build_optimizer(
            plan.optimizer,
            plan.optimizer_kwargs or model_class.optimizer_kwargs,
            plan.scheduler_type,
            plan.scheduler_kwargs,
            num_training_steps=plan.num_training_steps,
            max_grad_norm=plan.max_grad_norm,
            opt_state_dtype=torch.bfloat16 if plan.opt_state_dtype == "bf16" else None,
        )
        self.sr_generator = torch.Generator(device=self.device).manual_seed(SR_SEED)
        self.dropout_generator = torch.Generator(device=self.device).manual_seed(DROPOUT_SEED)

    # ----------------------------------------------------------- data

    def _to_device(self, host: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        """Integer leaves (ids, labels, masks) as long, float leaves (pixels)
        as float32."""
        return {
            k: torch.from_numpy(v).to(self.device, torch.long if np.issubdtype(v.dtype, np.integer) else torch.float32)
            for k, v in host.items()
        }

    def make_micro_batch(self, micro_batch_size: int | None = None, seed: int = 0) -> dict[str, torch.Tensor]:
        """One micro-batch [mbs, ...] on the device."""
        mbs = micro_batch_size if micro_batch_size is not None else self.plan.micro_batch_size
        return self._to_device(self.dataset.sample_batch(mbs, seed=seed))

    def make_train_batch(self, seed: int = 0) -> dict[str, torch.Tensor]:
        """[acc, mbs, ...] stacked batch for the full step."""
        acc, mbs = self.plan.gradient_accumulation_steps, self.plan.micro_batch_size
        host = self.dataset.sample_batch(acc * mbs, seed=seed)
        return self._to_device({k: v.reshape(acc, mbs, *v.shape[1:]) for k, v in host.items()})

    # ----------------------------------------------------------- state

    def init_state(self, seed: int = 0, state_dict: dict[str, torch.Tensor] | None = None) -> TrainState:
        """Fresh parameters drawn from a generator seeded with ``seed``, or
        ``state_dict`` (e.g. ``models.from_jax.params_from_jax``) cast to the
        storage dtype; then zeroed optimizer state for the trainable
        parameters and no gradients."""
        if state_dict is None:
            self.bundle.init_fn(self.module, torch.Generator(device=self.device).manual_seed(seed))
        else:
            with torch.no_grad():
                own = dict(self.module.named_parameters())
                if set(own) != set(state_dict):
                    raise ValueError(f"state_dict keys differ from the model's: {sorted(set(own) ^ set(state_dict))}")
                for name, p in own.items():
                    p.copy_(state_dict[name])
        self.zero_grads()
        params = dict(self.module.named_parameters())
        trainable = [params[n] for n in self.trainable]
        if not self.master_params:
            return TrainState(step=0, params=params, opt_state=self.tx.init(trainable))
        master = [p.detach().float() for p in trainable]
        opt_state = self.tx.init(master)
        opt_state.master = master
        return TrainState(step=0, params=params, opt_state=opt_state)

    def zero_grads(self) -> None:
        """Drop the accumulators: the next backward writes its gradient into
        fresh ``.grad`` buffers (exactly 0 + g), or into fresh accumulators."""
        self.module.zero_grad(set_to_none=True)
        self.accumulators = {}

    @torch.no_grad()
    def _into_accumulator(self, name: str, p: torch.nn.Parameter) -> None:
        """Post-accumulate hook: move ``p.grad`` into ``name``'s accumulator,
        rounded into its dtype once."""
        if not self._route_grads:
            return
        acc = self.accumulators.get(name)
        self.accumulators[name] = p.grad.to(self.grad_dtype) if acc is None else acc.add_(p.grad)
        p.grad = None

    # ----------------------------------------------------------- steps

    def _accumulate(self, state: TrainState, micro_batch: dict[str, torch.Tensor]) -> torch.Tensor:
        with span("step.forward"):
            loss, _metrics = self.bundle.loss_fn(self.module, micro_batch, self.dropout_generator)
        # autograd adds into .grad in the params' dtype: one rounding per
        # micro-batch, as the JAX accumulator's (a + g).astype(a.dtype)
        with span("step.backward"):
            loss.backward()
        return loss.detach()

    def _compute_grads(self, state: TrainState, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        acc = self.plan.gradient_accumulation_steps
        route = self._route_grads
        # one micro-batch: its gradient goes to the update unrounded, in .grad
        self._route_grads = route and acc > 1
        try:
            loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
            for i in range(acc):
                loss_sum = loss_sum + self._accumulate(state, {k: v[i] for k, v in batch.items()})
        finally:
            self._route_grads = route
        return loss_sum

    @torch.no_grad()
    def _optimizer_update(self, state: TrainState, acc_steps: float) -> None:
        params = [state.params[n] for n in self.trainable]
        grads = [self.accumulators.get(n, p.grad) for n, p in zip(self.trainable, params)]
        if all(g is None for g in grads):
            raise RuntimeError("optimizer update without gradients")
        # a trainable parameter the loss does not read (vilt-finetune's
        # pooler) takes the zero gradient JAX's grad gives it
        grads = [torch.zeros_like(p, dtype=self.grad_dtype) if g is None else g for p, g in zip(params, grads)]
        for g in grads:
            g.div_(acc_steps)
        master = state.opt_state.master
        updates = self.tx.update(grads, state.opt_state, params if master is None else master)
        for i, (p, d) in enumerate(zip(params, updates)):
            if master is not None:
                # the f32 master takes the update; the live bf16 copy is the
                # new master rounded once, to nearest
                master[i].add_(d)
                p.copy_(master[i])
            elif self.sr_params:
                # masterless bf16 params: unbiased stochastic rounding of p + d,
                # the draws coming from the session's generator leaf by leaf
                p.copy_(stochastic_round_to(p.float() + d, p.dtype, generator=self.sr_generator))
            else:
                p.add_(d)
        self.zero_grads()

    def _train_step(self, state: TrainState, batch: dict[str, torch.Tensor]):
        acc = self.plan.gradient_accumulation_steps
        self.zero_grads()
        loss_sum = self._compute_grads(state, batch)
        self._optimizer_update(state, float(acc))
        state.step += 1
        return state, {"loss": loss_sum / acc}

    # ----------------------------------------------------------- entry points

    def accumulate_fn(self):
        """``acc(state, micro_batch) -> loss``: one micro-batch forward and
        backward, its gradient added into the accumulators (``.grad``, or
        ``accumulators`` for another dtype than the params')."""
        return self._accumulate

    def grads_fn(self):
        """``grads(state, batch) -> loss_sum``: the whole accumulation pass
        over the batch's leading dim, into the current accumulators (call
        ``zero_grads()`` first for a fresh sum); with one micro-batch, its
        gradient unrounded in ``.grad``."""
        return self._compute_grads

    def optimizer_update_fn(self):
        """``update(state, acc_steps)``: divide the accumulated grads by
        ``acc_steps``, clip, step the optimizer, apply, and drop the grads."""
        return self._optimizer_update

    def train_step_fn(self):
        """``step(state, batch) -> (state, {"loss": mean micro-batch loss})``:
        accumulation over micro-batches, then the optimizer update."""
        return self._train_step
