"""GPU headline: pythia-1b tokens/s on one card at the JAX ``bench.py``'s recipe.

    python -m multimodal_llm_pretraining_tpu_torch.bench

Runs ``bench.py:103-126``'s plan on one card: pythia-1b, micro-batch 4,
"dots" remat, bf16 compute, the ``bf16_sr`` state (bf16 parameters updated
with stochastic rounding, bf16 moments and accumulators), the model class's
optimizer and schedule, random weights from the session's seed.

- The fused step at accumulation 32 (bench's ``fused_acc32``): 2 warmup
  steps, then the median of 3.
- The workload step at the pythia-1b global batch of 1024, micro-batch 4 x
  accumulation 256 (``src/models/pythia.py:25-30`` of the reference): one
  ``train_step_fn`` call a step (eager PyTorch has no per-execution deadline
  to split it around), 1 warmup, then the median of 3.

Prints one JSON line in ``bench.py:203-222``'s shape: ``value`` is the
workload step's tokens/s per card; ``detail`` holds both steps' times and
MFUs, the micro-batch size, the last acc-32 step's loss, the card (``gpu``, its
``nvidia-smi`` name and power limit) and ``n_gpus``. MFU is the analytic
fwd+bwd FLOPs without remat (``benchmarking/flops.py``) over the step time
over ``gpus.py``'s bf16 peak; null on a card the registry does not hold.
``vs_baseline`` is null: the JAX bench's 0.45 is a TPU target, not this
card's. Progress goes to standard error.
"""

import gc
import json

import torch

from .benchmarking.flops import analytic_flops_per_example
from .benchmarking.step_time import measure_fused_step_time
from .gpus import detect_local_gpu, peak_tflops
from .models import get_model_class
from .parallel.mesh import MeshConfig
from .time_attention import card_line
from .train import TrainingPlan
from .utils import get_logger, require_cuda

MODEL_TYPE = "pythia-1b"
MICRO_BATCH_SIZE = 4
FUSED_ACC = 32
WORKLOAD_ACC = 256  # global batch 1024


def make_plan(mc, accumulation_steps: int) -> TrainingPlan:
    """``bench.py``'s plan at ``accumulation_steps``; ``compile`` and
    ``unroll_layers`` are no-ops here, kept so the two plans read alike."""
    return TrainingPlan(
        num_training_steps=8,
        micro_batch_size=MICRO_BATCH_SIZE,
        gradient_accumulation_steps=accumulation_steps,
        activation_checkpointing=True,
        checkpoint_policy="dots",
        bf16=True,
        compile=True,
        use_custom_kernels=True,
        matmul_precision="default",
        optimizer=mc.optimizer,
        optimizer_kwargs=mc.optimizer_kwargs,
        scheduler_type=mc.scheduler_type,
        scheduler_kwargs=mc.scheduler_kwargs,
        grad_accum_dtype="bf16",
        opt_state_dtype="bf16",
        master_weights="sr",
        unroll_layers=True,
        max_grad_norm=mc.max_grad_norm,
        mesh=MeshConfig(num_hosts=1, chips_per_host=1),
    )


def measure(mc, accumulation_steps: int, warmups: int):
    """The fused step's median at ``accumulation_steps`` in a session of
    its own, freed before returning."""
    sess = make_plan(mc, accumulation_steps).build_session(mc, device="cuda")
    result = measure_fused_step_time(sess, accumulation_steps, samples=3, warmups=warmups)
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    return result


def main() -> None:
    require_cuda()
    log = get_logger()
    card = card_line()
    log.info(f"card: {card}")
    mc = get_model_class(MODEL_TYPE)
    n_gpus = 1
    fused = measure(mc, FUSED_ACC, warmups=2)
    log.info(f"fused acc-{FUSED_ACC} step {fused.step_s:.4f} s, times {fused.times}")
    workload = measure(mc, WORKLOAD_ACC, warmups=1)
    log.info(f"workload acc-{WORKLOAD_ACC} step {workload.step_s:.4f} s, times {workload.times}")

    seq = mc.sequence_length
    tokens_per_sec_per_gpu = MICRO_BATCH_SIZE * WORKLOAD_ACC * seq / workload.step_s
    flops_per_example = analytic_flops_per_example(mc, backward=True, remat=False)
    gpu = detect_local_gpu()
    mfu = wl_mfu = None
    if flops_per_example and gpu:
        peak = peak_tflops(gpu, "bf16") * 1e12
        mfu = flops_per_example * MICRO_BATCH_SIZE * FUSED_ACC / fused.step_s / peak
        wl_mfu = flops_per_example * MICRO_BATCH_SIZE * WORKLOAD_ACC / workload.step_s / peak
    print(json.dumps({
        "metric": f"{MODEL_TYPE} tokens/sec/card (workload global batch 1024; all-on-device bf16 state, SR params, "
                  "save-dots remat)",
        "value": round(tokens_per_sec_per_gpu, 1),
        "unit": "tokens/s/card",
        "vs_baseline": None,
        "detail": {
            "workload_step_time_s": round(workload.step_s, 4),
            "workload_mfu": round(wl_mfu, 4) if wl_mfu else None,
            "workload_grad_accumulation": WORKLOAD_ACC,
            "fused_acc32_step_time_s": round(fused.step_s, 4),
            "fused_acc32_mfu": round(mfu, 4) if mfu else None,
            "gpu": torch.cuda.get_device_name(0),
            "card": card,
            "n_gpus": n_gpus,
            "micro_batch_size": MICRO_BATCH_SIZE,
            "loss": round(fused.loss, 4),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
