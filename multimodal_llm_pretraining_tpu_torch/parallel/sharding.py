"""Sharding methods (counterpart of ``parallel/sharding.py:37-91``).

Only the method table is ported: ``ShardingPolicy.from_method`` expands a
search-grid sharding string into which of {optimizer state, gradients,
parameters} is sharded, whether the sharding is hybrid (replicated across
hosts) and what is offloaded, as the JAX package does. The port runs on one
GPU, so no policy but the unsharded one is executed yet (ROADMAP Queue 1
items 7 and 8); ``TrainingPlan.is_valid`` uses the table to classify plans.
"""

from dataclasses import dataclass
from typing import Literal

ShardModeT = Literal["replicated", "sharded"]

# "" plus fsdp_{shard_grad_op,full_shard,hybrid_shard_zero2,hybrid_shard}
# plus zero_{1,2,3,3++}
ShardingMethodT = Literal[
    "",
    "zero_1",
    "zero_2",
    "zero_3",
    "zero_3++",
    "fsdp_shard_grad_op",
    "fsdp_full_shard",
    "fsdp_hybrid_shard_zero2",
    "fsdp_hybrid_shard",
]


@dataclass(frozen=True)
class ShardingPolicy:
    params: ShardModeT = "replicated"
    grads: ShardModeT = "replicated"
    opt_state: ShardModeT = "replicated"
    hybrid: bool = False  # needs more than one host
    quantized_comms: bool = False  # ZeRO-3++: int8 parameter all-gather
    quantized_grads: bool = False  # ZeRO-3++: int8 gradient reduce-scatter
    offload_optimizer: bool = False
    offload_params: bool = False

    @staticmethod
    def from_method(method: ShardingMethodT, offloading: bool = False) -> "ShardingPolicy":
        """The policy a sharding string names; an unknown string raises
        KeyError. fsdp offloading offloads the whole unit; zero offloading
        offloads the optimizer always and the parameters only at stage 3."""
        base = {
            "": dict(),
            "zero_1": dict(opt_state="sharded"),
            "zero_2": dict(opt_state="sharded", grads="sharded"),
            "zero_3": dict(opt_state="sharded", grads="sharded", params="sharded"),
            "zero_3++": dict(
                opt_state="sharded", grads="sharded", params="sharded",
                quantized_comms=True, quantized_grads=True, hybrid=True,
            ),
            "fsdp_shard_grad_op": dict(opt_state="sharded", grads="sharded"),
            "fsdp_full_shard": dict(opt_state="sharded", grads="sharded", params="sharded"),
            "fsdp_hybrid_shard_zero2": dict(opt_state="sharded", grads="sharded", hybrid=True),
            "fsdp_hybrid_shard": dict(opt_state="sharded", grads="sharded", params="sharded", hybrid=True),
        }[method]
        if offloading:
            if method.startswith("fsdp"):
                base = {**base, "offload_optimizer": True, "offload_params": method in ("fsdp_full_shard", "fsdp_hybrid_shard")}
            elif method.startswith("zero"):
                base = {**base, "offload_optimizer": True}
                if method in ("zero_3", "zero_3++"):
                    base["offload_params"] = True
        return ShardingPolicy(**base)  # type: ignore[arg-type]
