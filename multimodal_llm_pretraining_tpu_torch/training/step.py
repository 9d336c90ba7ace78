"""The training step (counterpart of ``training/step.py:41-603``).

``TrainSession`` builds the model on one device and hands out the same entry
points as the JAX session: ``accumulate_fn``, ``grads_fn``,
``optimizer_update_fn`` and ``train_step_fn``. PyTorch runs eagerly, so each
returns a plain function; there is nothing to compile.

Where the JAX step donates its buffers and returns new ones
(``step.py:596-602``), this one updates in place: the parameters, the Adam
moments and the gradient accumulators (the parameters' ``.grad``) are
overwritten, and ``TrainState`` holds the live tensors.

Two state layouts work, chosen by the plan as in JAX:

- f32: f32 params (compute in f32 or bf16; with bf16 compute the layers
  cast weights at use) and the optax-chain Adam.
- ``bf16_sr`` (``bf16=True, master_weights="sr"``): bf16 params, grads and
  accumulators, bf16 moments (``opt_state_dtype="bf16"``), updates applied
  with stochastic rounding and no f32 master.

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
model with dropout (ViT) draws its masks from it, the others ignore it. The
generator is seeded with ``DROPOUT_SEED``, like the SR generator with
``SR_SEED``, and draws on from micro-batch to micro-batch.

Activation checkpointing goes to the model's ``build_model``: mamba remats
each whole block, pythia refuses it with the ROADMAP item. Not ported yet,
and refused with the ROADMAP item: ``master_weights`` True/"device",
sharding, offloading, and accumulators of another dtype than the params.
"""

from dataclasses import dataclass

import numpy as np
import torch

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
        mw = plan.master_weights
        if mw is True or mw == "device":
            raise NotImplementedError('master_weights True/"device" (f32 master in the optimizer state) is ROADMAP Queue 1 item 5')
        plan.apply_matmul_precision()

        self.compute_dtype = plan.compute_dtype
        self.sr_params = mw == "sr" and self.compute_dtype == torch.bfloat16
        self.param_dtype = torch.bfloat16 if self.sr_params else torch.float32
        grad_dtype = {"bf16": torch.bfloat16, "f32": torch.float32, None: self.param_dtype}[plan.grad_accum_dtype]
        if grad_dtype != self.param_dtype:
            raise NotImplementedError(
                f"gradient accumulators in {grad_dtype} beside {self.param_dtype} params are ROADMAP Queue 1 item 5"
            )

        self.bundle = model_class.build_model(
            use_custom_kernels=plan.use_custom_kernels,
            activation_checkpointing=plan.activation_checkpointing,
            compute_dtype=self.compute_dtype,
            device=self.device,
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
        return TrainState(step=0, params=params, opt_state=self.tx.init([params[n] for n in self.trainable]))

    def zero_grads(self) -> None:
        """Drop the accumulators: the next backward writes its gradient into
        fresh ``.grad`` buffers (exactly 0 + g)."""
        self.module.zero_grad(set_to_none=True)

    # ----------------------------------------------------------- steps

    def _accumulate(self, state: TrainState, micro_batch: dict[str, torch.Tensor]) -> torch.Tensor:
        loss, _metrics = self.bundle.loss_fn(self.module, micro_batch, self.dropout_generator)
        # autograd adds into .grad in the params' dtype: one rounding per
        # micro-batch, as the JAX accumulator's (a + g).astype(a.dtype)
        loss.backward()
        return loss.detach()

    def _compute_grads(self, state: TrainState, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(self.plan.gradient_accumulation_steps):
            loss_sum = loss_sum + self._accumulate(state, {k: v[i] for k, v in batch.items()})
        return loss_sum

    @torch.no_grad()
    def _optimizer_update(self, state: TrainState, acc_steps: float) -> None:
        params = [state.params[n] for n in self.trainable]
        grads = [p.grad for p in params]
        if any(g is None for g in grads):
            raise RuntimeError("optimizer update without gradients for every trainable parameter")
        for g in grads:
            g.div_(acc_steps)
        updates = self.tx.update(grads, state.opt_state, params)
        for p, d in zip(params, updates):
            if self.sr_params:
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
        backward, its gradient added into the accumulators (``.grad``)."""
        return self._accumulate

    def grads_fn(self):
        """``grads(state, batch) -> loss_sum``: the whole accumulation pass
        over the batch's leading dim, into the current accumulators (call
        ``zero_grads()`` first for a fresh sum)."""
        return self._compute_grads

    def optimizer_update_fn(self):
        """``update(state, acc_steps)``: divide the accumulated grads by
        ``acc_steps``, clip, step the optimizer, apply, and drop the grads."""
        return self._optimizer_update

    def train_step_fn(self):
        """``step(state, batch) -> (state, {"loss": mean micro-batch loss})``:
        accumulation over micro-batches, then the optimizer update."""
        return self._train_step
