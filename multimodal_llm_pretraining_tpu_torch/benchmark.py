"""Training-method search on the card (counterpart of
``scripts/benchmark.py``).

Enumerates the efficient-training-method grid for one (topology, GPU type,
model), runs the empirical timing experiment for every valid arm and
caches each in the workspace (``$MLPT_WORKSPACE_DIR/torch``, or memory
without the variable):

    python -m multimodal_llm_pretraining_tpu_torch.benchmark --num-hosts 1 --chips-per-host 1 \\
        --gpu-type h100-sxm --model pythia-1b --methods all --cmd run

methods: naive      -> f32 products ("highest"), no custom kernels
         free-lunch -> TF32 products ("high") and the hand-written kernels
         all        -> free-lunch x {remat, its policy} x {sharding methods}
                       x {offload} x {state layouts} x {unroll_layers}

``--cmd`` is one of run, count, print-incomplete and print-results. The
grid is the JAX CLI's (``scripts/benchmark.py:46-99``); ``unroll_layers``
stays in it, and the validity rule drops its arms, since no port model
unrolls. ``--model`` offers the ported families and the port's own model
types (``PORT_ONLY_MODEL_TYPES``). There is no ``--slurm``
(ROADMAP Queue 1 item 10) and no ``--tensor-parallel`` (item 7).
"""

import argparse
import math
import signal
import sys

from .experiments.base_classes import Sweep
from .experiments.sweeps import TrainingTimeEmpiricalSweep
from .gpus import GPU_TYPES, supports_bf16
from .models import MODEL_TYPES, PORT_ONLY_MODEL_TYPES, get_model_class


def validate_arguments(num_hosts: int, chips_per_host: int, gpu_type: str, model: str) -> None:
    model_class = get_model_class(model)
    num_chips = num_hosts * chips_per_host
    if model_class.batch_size % num_chips:
        raise ValueError(f"model batch size ({model_class.batch_size}) should be evenly divisible by total cards "
                         f"({num_chips})")
    if not math.log2(model_class.batch_size // num_chips).is_integer():
        raise ValueError(f"batch size per card ({model_class.batch_size // num_chips}) should be a power of 2")
    if model_class.mixed_precision == "bf16" and not supports_bf16(gpu_type):  # type: ignore[arg-type]
        raise ValueError(f"{gpu_type} does not compute in bf16")


def method_sweep(num_hosts: int, chips_per_host: int, gpu_type: str, model: str,
                 methods: str = "all") -> TrainingTimeEmpiricalSweep:
    """The sweep over the method grid (the reference's
    ``scripts/benchmark.py:45-63``, with the JAX package's axes)."""
    free_lunch = [False]
    activation_checkpointing = [False]
    checkpoint_policy = ["flash"]
    sharding = [""]
    offloading = [False]
    state_layout = [""]
    unroll_layers = [False]
    if methods == "free-lunch":
        free_lunch = [True]
    elif methods == "all":
        free_lunch = [True]
        activation_checkpointing = [False, True]
        checkpoint_policy = ["flash", "dots"]
        sharding = ["", "zero_1", "zero_2", "zero_3", "fsdp_shard_grad_op", "fsdp_full_shard"]
        offloading = [False, True]
        state_layout = ["", "bf16_master", "bf16_sr"]
        unroll_layers = [False, True]
    elif methods != "naive":
        raise ValueError(f"unknown methods {methods!r}")
    return TrainingTimeEmpiricalSweep(
        search_space=dict(
            num_hosts=[num_hosts],
            chips_per_host=[chips_per_host],
            gpu_type=[gpu_type],
            model=[model],
            free_lunch=free_lunch,
            activation_checkpointing=activation_checkpointing,
            checkpoint_policy=checkpoint_policy,
            sharding=sharding,
            offloading=offloading,
            tensor_parallel=[1],
            state_layout=state_layout,
            unroll_layers=unroll_layers,
        )
    )


def run_benchmark(num_hosts: int, chips_per_host: int, gpu_type: str, model: str, methods: str = "all",
                  cmd: str = "run") -> None:
    validate_arguments(num_hosts, chips_per_host, gpu_type, model)
    Sweep.run(method_sweep(num_hosts, chips_per_host, gpu_type, model, methods), cmd=cmd)


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--num-hosts", type=int, required=True)
    p.add_argument("--chips-per-host", type=int, required=True)
    p.add_argument("--gpu-type", choices=GPU_TYPES, required=True)
    p.add_argument("--model", choices=MODEL_TYPES + PORT_ONLY_MODEL_TYPES, required=True)
    p.add_argument("--methods", choices=["naive", "free-lunch", "all"], default="all")
    p.add_argument("--cmd", choices=["run", "count", "print-incomplete", "print-results"], default="run")
    a = p.parse_args(argv)
    run_benchmark(a.num_hosts, a.chips_per_host, a.gpu_type, a.model, a.methods, a.cmd)


if __name__ == "__main__":
    try:
        main()
    except KeyboardInterrupt:
        sys.exit(128 + signal.SIGINT)
