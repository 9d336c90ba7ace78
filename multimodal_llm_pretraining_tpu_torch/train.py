"""Training plan (counterpart of ``train.py:42-154``).

Same field names and defaults as the JAX ``TrainingPlan``, so a plan written
for one package reads the same in the other. Which fields act here:

- ``bf16`` / ``fp16``: bf16 compute (fp16 runs as bf16, as in JAX).
- ``matmul_precision``: sets ``torch.backends.cuda.matmul.allow_tf32`` and
  ``torch.backends.cudnn.allow_tf32``; "highest" turns both off.
- ``master_weights`` ("sr", True or "device"), ``opt_state_dtype``,
  ``grad_accum_dtype``: the state layouts of ``training/step.py``.
- ``activation_checkpointing`` and ``checkpoint_policy``: handed to the
  model's ``build_model``. Pythia runs every block under the plan's policy,
  "flash" (keep the flash-attention outputs, recompute the rest) or "dots"
  (also keep the products a backward reads); llava's tower and decoder and
  ViT run theirs under "flash", the JAX default for those stacks; mamba
  remats each whole block (what "flash" does to a block with no attention).
- No-ops, kept so plans stay interchangeable: ``compile`` (PyTorch runs
  eagerly; there is no compilation cache to toggle) and ``unroll_layers``
  (the blocks are a Python loop, never a scan).
- ``sharding`` and ``offloading`` name a ``ShardingPolicy``
  (``sharding_policy``), which ``is_valid`` checks as the JAX plan does;
  the session refuses any but the unsharded one.
- Refused by the session with the ROADMAP item: ``sharding``,
  ``offloading`` and meshes of more than one device.
"""

from dataclasses import dataclass, field
from typing import Any, Literal

import torch

from .models import OptimizerT, SchedulerType
from .parallel.mesh import MeshConfig
from .parallel.sharding import ShardingMethodT, ShardingPolicy
from .training.step import TrainSession

MatmulPrecisionT = Literal["default", "high", "highest"]


@dataclass
class TrainingPlan:
    num_training_steps: int
    micro_batch_size: int  # per-device, like per_device_train_batch_size
    gradient_accumulation_steps: int

    activation_checkpointing: bool = False
    checkpoint_policy: Literal["flash", "dots"] = "flash"
    bf16: bool = False
    fp16: bool = False  # runs as bf16
    matmul_precision: MatmulPrecisionT = "highest"
    compile: bool = False  # no-op: eager PyTorch
    use_custom_kernels: bool = True

    optimizer: OptimizerT = "adamw"
    optimizer_kwargs: dict[str, Any] = field(default_factory=dict)
    scheduler_type: SchedulerType = SchedulerType.LINEAR
    scheduler_kwargs: dict[str, Any] = field(default_factory=dict)

    sharding: ShardingMethodT = ""
    offloading: bool = False
    grad_accum_dtype: Literal["bf16", "f32", None] = None
    opt_state_dtype: Literal["bf16", "f32", None] = None
    master_weights: bool | Literal["device", "sr"] = False
    unroll_layers: bool = False  # no-op: the blocks are a Python loop

    max_grad_norm: float = 1.0
    extra_args: dict[str, Any] = field(default_factory=dict)

    mesh: MeshConfig = field(default_factory=MeshConfig)

    def is_valid(self) -> bool:
        """The JAX ``TrainingPlan.is_valid`` (``train.py:99-119``): positive
        counts, not bf16 and fp16 at once, a known sharding method, hybrid
        sharding only across hosts, offloading only with sharding. It only
        classifies; the session refuses what is not single-device."""
        try:
            policy = self.sharding_policy()
        except KeyError:
            return False
        return not (
            self.num_training_steps <= 0
            or self.micro_batch_size <= 0
            or self.gradient_accumulation_steps <= 0
            or (self.bf16 and self.fp16)
            or (policy.hybrid and self.mesh.num_hosts <= 1)
            or (self.offloading and self.sharding == "")
        )

    def sharding_policy(self) -> ShardingPolicy:
        return ShardingPolicy.from_method(self.sharding, self.offloading)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if (self.bf16 or self.fp16) else torch.float32

    def mesh_config(self) -> MeshConfig:
        return self.mesh

    def apply_matmul_precision(self) -> None:
        """Set the process's f32-matmul precision from the plan: TF32 off for
        "highest", on for "high" and "default"."""
        allow = self.matmul_precision != "highest"
        torch.backends.cuda.matmul.allow_tf32 = allow
        torch.backends.cudnn.allow_tf32 = allow

    def build_session(self, model_class, device: torch.device | str = "cuda"):
        """The model, optimizer and step functions for this plan on ``device``."""
        return TrainSession(self, model_class, device=device)
