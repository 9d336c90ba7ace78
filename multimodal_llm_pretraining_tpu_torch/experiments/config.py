"""Experiment configurations (counterpart of ``experiments/config.py``).

``BaseConfig`` names the hardware and the model; ``TrainingConfig`` adds the
method-search dimensions and expands them into a ``TrainingPlan``. The
fields are the JAX package's, with ``gpu_type`` in place of ``tpu_type``;
``num_hosts`` and ``chips_per_host`` keep their names, as the port's
``MeshConfig`` does (a chip here is one card).

The free lunch on the card (the reference's, ``experiments/config.py:41-48``):
TF32 products (``matmul_precision="high"`` on a card with bf16 support,
"highest" otherwise) and the hand-written kernels. ``compile`` stays the
plan's no-op.
"""

import dataclasses
from dataclasses import dataclass
from typing import Literal

from ..gpus import GpuT, supports_bf16
from ..models import BaseModelClass, ModelT, get_model_class
from ..parallel.mesh import MeshConfig
from ..parallel.sharding import ShardingMethodT, ShardingPolicy
from ..train import TrainingPlan


@dataclass
class BaseConfig:
    num_hosts: int
    chips_per_host: int
    gpu_type: GpuT
    model: ModelT

    @property
    def num_chips(self) -> int:
        return self.num_hosts * self.chips_per_host

    def supports_bf16(self) -> bool:
        return supports_bf16(self.gpu_type)

    def model_class(self) -> BaseModelClass:
        return get_model_class(model_type=self.model)


@dataclass
class TrainingConfig(BaseConfig):
    free_lunch: bool = False
    activation_checkpointing: bool = False
    # which products remat keeps ("flash" or "dots"); only meaningful with
    # activation_checkpointing, and left out of the cache key at its default
    checkpoint_policy: Literal["flash", "dots"] = dataclasses.field(
        default="flash", metadata={"cache_omit_default": True}
    )
    sharding: ShardingMethodT = ""
    offloading: bool = False
    tensor_parallel: int = 1
    # "" = the plan's default
    grad_accum_dtype: Literal["", "bf16", "f32"] = dataclasses.field(
        default="", metadata={"cache_omit_default": True}
    )
    # a no-op in the port (its blocks are a Python loop): the validity rule
    # drops every arm that sets it
    unroll_layers: bool = dataclasses.field(default=False, metadata={"cache_omit_default": True})
    matmul_precision: Literal["", "default", "high", "highest"] = dataclasses.field(
        default="", metadata={"cache_omit_default": True}
    )
    # where the optimizer state lives and at what precision:
    #   ""            -> f32 state
    #   "bf16_master" -> bf16 live params and moments, f32 master on the card
    #   "bf16_sr"     -> bf16 params updated by stochastic rounding, bf16
    #                    moments and accumulators, no master
    state_layout: Literal["", "bf16_master", "bf16_sr"] = dataclasses.field(
        default="", metadata={"cache_omit_default": True}
    )

    def measurement_equivalent(self) -> "TrainingConfig":
        """The representative of this config's one-card measurement class.

        On one card every sharding label over a data axis of 1 is the same
        program; only the offload flags would change it. zero_1 / zero_2 /
        fsdp_shard_grad_op + offload are one measurement (optimizer offload)
        and zero_3 / fsdp_full_shard + offload another (optimizer and params
        offloaded). The benchmark steps key their cache on this config, so a
        sweep measures each program once; every label keeps its own row."""
        if self.num_chips > 1 or not self.offloading or self.sharding == "":
            return self
        policy = ShardingPolicy.from_method(self.sharding, offloading=True)
        canonical = "zero_3" if policy.offload_params else "zero_1"
        return dataclasses.replace(self, sharding=canonical)

    def training_plan(self, **overrides) -> TrainingPlan:
        model_class = self.model_class()
        if self.free_lunch:
            matmul_precision = "high" if self.supports_bf16() else "highest"
            compile = model_class.supports_compilation
            use_custom_kernels = True
        else:
            matmul_precision = "highest"
            compile = False
            use_custom_kernels = False
        if self.matmul_precision:
            matmul_precision = self.matmul_precision

        plan = TrainingPlan(
            num_training_steps=model_class.training_steps,
            micro_batch_size=1,
            gradient_accumulation_steps=1,
            activation_checkpointing=self.activation_checkpointing,
            checkpoint_policy=self.checkpoint_policy,
            bf16=(model_class.mixed_precision == "bf16"),
            fp16=(model_class.mixed_precision == "fp16"),
            matmul_precision=matmul_precision,  # type: ignore[arg-type]
            compile=compile,
            use_custom_kernels=use_custom_kernels,
            optimizer=model_class.optimizer,
            optimizer_kwargs=model_class.optimizer_kwargs,
            scheduler_type=model_class.scheduler_type,
            scheduler_kwargs=model_class.scheduler_kwargs,
            sharding=self.sharding,
            offloading=self.offloading,
            grad_accum_dtype=(self.grad_accum_dtype or ("bf16" if self.state_layout else None)),  # type: ignore[arg-type]
            opt_state_dtype="bf16" if self.state_layout else None,
            master_weights={"bf16_master": "device", "bf16_sr": "sr"}.get(self.state_layout, False),  # type: ignore[arg-type]
            unroll_layers=self.unroll_layers,
            max_grad_norm=model_class.max_grad_norm,
            extra_args=model_class.extra_training_args,
            mesh=MeshConfig(
                num_hosts=self.num_hosts,
                chips_per_host=self.chips_per_host,
                tensor_parallel=self.tensor_parallel,
            ),
        )
        return dataclasses.replace(plan, **overrides)
