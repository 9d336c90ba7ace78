"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line (or a few) each; any failure exits non-zero:

1. environment: the card (``nvidia-smi`` name and power limit), torch, CUDA
   and nvcc versions. No visible GPU is a failure, never a CPU fallback.
2. build: the flash-attention kernels from ``csrc/`` with nvcc (timed).
3. kernels: each kernel against its plain PyTorch version on the same inputs,
   at the pythia-1b training shape ([4, 8, 2049, 256] bf16 causal) and at a
   small ragged shape, with the tolerances stated below; then median CUDA-event
   times of kernel and plain version at the training shape.
4. slice: a two-layer GPTNeoX, loss and grads with the kernels against the
   plain f32 attention on the same weights and tokens.
5. main path: the pythia-1b training step at full width and depth, through
   ``get_model_class`` -> ``TrainingPlan`` -> ``build_session`` ->
   ``init_state`` -> ``train_step_fn``, 1 warmup + 3 timed steps. The kernel
   launch counters are zeroed just before and read just after, and must show
   every attention call of the run on the kernels.

The last two lines are the card line and ``{"ok": true, "device": ...}``.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from multimodal_llm_pretraining_tpu_torch.ops import _build  # noqa: E402
from multimodal_llm_pretraining_tpu_torch.ops import flash_attention as fa  # noqa: E402
from multimodal_llm_pretraining_tpu_torch.utils import require_cuda  # noqa: E402

KERNEL_SOURCE = "multimodal_llm_pretraining_tpu_torch/csrc/flash_attention.cu"
JAX_FLASH = "multimodal_llm_pretraining_tpu/ops/flash_attention.py"
SLICE_SHAPE = (4, 8, 2049, 256)  # pythia-1b: mbs 4, 8 heads, seq 2049, head_dim 256
RAGGED_SHAPE = (2, 3, 77, 64)

# Kernel vs plain version, bf16 inputs. Both round the same operands to bf16
# (q*scale, p, ds) and accumulate in f32; they differ in summation order, in
# the online softmax's running rescale of p, and in dq's atomic (run-to-run
# varying) summation order. Outputs are bf16, so one rounding of 2^-9 is
# already in every element: bound the error relative to the output's norm.
TOL_NORM_REL = 1e-2  # ||kernel - plain|| / ||plain|| for out, dq, dk, dv
TOL_LSE_ABS = 1e-3  # lse is f32 and sees no bf16 output rounding
# Two-layer model, kernels vs f32 plain attention (bf16 compute both ways)
TOL_SLICE_LOSS = 2e-2
TOL_SLICE_GRAD_NORM_REL = 5e-2


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def phase_env() -> str:
    device = require_cuda()
    card = card_line()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True, text=True, check=True, timeout=60)
    say(f"[env] card: {card}")
    say(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, {nvcc.stdout.strip().splitlines()[-1]}")
    say(f"[env] device {device}: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load(verbose=True)
    built = _build.last_build_seconds
    say(f"[build] {_build.library_path().name}: nvcc {built:.1f} s, load {time.perf_counter() - t0:.1f} s"
        if built is not None else f"[build] {_build.library_path().name} already built")


def _errs(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    d = (got.float() - ref.float())
    return d.abs().max().item(), (d.norm() / ref.float().norm().clamp_min(1e-30)).item()


def cuda_ms(fn, warmup: int = 3, iters: int = 10) -> float:
    """Median milliseconds of ``fn`` on the card, one CUDA-event pair per call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _inputs(shape, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, h, s, d = shape
    q, k, v, do = (torch.randn(b * h, s, d, generator=g, device="cuda").to(torch.bfloat16) for _ in range(4))
    return q, k, v, do


def check_kernels_at(shape, causal: bool, seed: int = 0) -> dict:
    """Kernel vs plain version on identical inputs; returns the errors."""
    q, k, v, do = _inputs(shape, seed)
    scale = shape[-1] ** -0.5
    out, lse = fa.flash_fwd_cuda(q, k, v, causal, scale)
    out_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal, scale)
    grads = fa.flash_bwd_cuda(q, k, v, out_ref, lse_ref, do, causal, scale)
    grads_ref = fa.flash_bwd_reference(q, k, v, out_ref, lse_ref, do, causal, scale)
    torch.cuda.synchronize()
    res = {"out": _errs(out, out_ref), "lse": _errs(lse, lse_ref)}
    for name, got, ref in zip(("dq", "dk", "dv"), grads, grads_ref):
        res[name] = _errs(got, ref)
    for name, t in (("out", out), ("lse", lse), *zip(("dq", "dk", "dv"), grads)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{name} has non-finite values at {shape}")
    say(f"[kernels] {list(shape)} causal={causal}: " + ", ".join(
        f"{n} max_abs {a:.3e} norm_rel {r:.3e}" for n, (a, r) in res.items()))
    for name in ("out", "dq", "dk", "dv"):
        if not res[name][1] <= TOL_NORM_REL:
            raise AssertionError(f"{name} norm-relative error {res[name][1]:.3e} > {TOL_NORM_REL} at {shape}")
    if not res["lse"][0] <= TOL_LSE_ABS:
        raise AssertionError(f"lse max-abs error {res['lse'][0]:.3e} > {TOL_LSE_ABS} at {shape}")
    # dq sums by f32 atomics in an order that changes between runs: a second
    # run may differ by one bf16 ulp of the larger of the two values, plus
    # f32 summation noise (1e-6) where terms cancel to near zero; dk and dv
    # have no atomics and repeat exactly
    dq2, dk2, dv2 = fa.flash_bwd_cuda(q, k, v, out_ref, lse_ref, do, causal, scale)
    dq_diff = (dq2.float() - grads[0].float()).abs()
    dq_ulp = torch.maximum(dq2.float().abs(), grads[0].float().abs()) * 2.0**-7 + 1e-6
    say(f"[kernels] {list(shape)} second backward run: dq max_abs change {dq_diff.max().item():.3e}, "
        f"dk/dv identical {torch.equal(dk2, grads[1]) and torch.equal(dv2, grads[2])}")
    if not (torch.equal(dk2, grads[1]) and torch.equal(dv2, grads[2])):
        raise AssertionError(f"dk/dv differ between two runs at {shape}")
    if not bool((dq_diff <= dq_ulp).all()):
        raise AssertionError(f"dq differs by more than one bf16 ulp between two runs at {shape}")
    return res


def phase_kernels() -> list[dict]:
    errs = check_kernels_at(SLICE_SHAPE, causal=True)
    check_kernels_at(RAGGED_SHAPE, causal=True, seed=1)
    check_kernels_at(RAGGED_SHAPE, causal=False, seed=2)

    q, k, v, do = _inputs(SLICE_SHAPE, 3)
    scale = SLICE_SHAPE[-1] ** -0.5
    out, lse = fa.flash_fwd_reference(q, k, v, True, scale)
    def fwd_bwd(fwd, bwd):
        o, l = fwd(q, k, v, True, scale)
        bwd(q, k, v, o, l, do, True, scale)

    t = {
        "fwd": cuda_ms(lambda: fa.flash_fwd_cuda(q, k, v, True, scale)),
        "fwd_plain": cuda_ms(lambda: fa.flash_fwd_reference(q, k, v, True, scale)),
        "bwd": cuda_ms(lambda: fa.flash_bwd_cuda(q, k, v, out, lse, do, True, scale)),
        "bwd_plain": cuda_ms(lambda: fa.flash_bwd_reference(q, k, v, out, lse, do, True, scale)),
        "fwd_bwd": cuda_ms(lambda: fwd_bwd(fa.flash_fwd_cuda, fa.flash_bwd_cuda)),
        "fwd_bwd_plain": cuda_ms(lambda: fwd_bwd(fa.flash_fwd_reference, fa.flash_bwd_reference)),
    }
    say(f"[kernels] median ms at {list(SLICE_SHAPE)} bf16 causal: " + ", ".join(f"{n} {ms:.3f}" for n, ms in t.items()))
    max_grad_err = max(errs[n][0] for n in ("dq", "dk", "dv"))
    return [
        {"name": "flash_fwd", "route": "cuda", "source": KERNEL_SOURCE, "replaces": f"{JAX_FLASH}:91",
         "launches": None, "max_abs_err": errs["out"][0], "ms": t["fwd"], "plain_ms": t["fwd_plain"]},
        {"name": "flash_bwd_fused", "route": "cuda", "source": KERNEL_SOURCE, "replaces": f"{JAX_FLASH}:208",
         "launches": None, "max_abs_err": max_grad_err, "ms": t["bwd"], "plain_ms": t["bwd_plain"]},
    ]


def phase_slice() -> None:
    """Two-layer GPTNeoX at pythia-1b's head_dim: kernels vs plain attention."""
    from multimodal_llm_pretraining_tpu_torch.models.pythia import GPTNeoXLM

    torch.manual_seed(0)
    results = {}
    for impl in ("flash", "naive"):
        model = GPTNeoXLM(num_layers=2, hidden=512, num_heads=2, vocab_size=1024, attn_impl=impl, dtype=torch.bfloat16)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.to("cuda")
        ids = torch.from_numpy(np.random.default_rng(0).integers(0, 1024, (2, 257))).to("cuda")
        loss = model(ids, labels=ids)
        loss.backward()
        results[impl] = (loss.item(), {n: p.grad.float() for n, p in model.named_parameters()})
    (loss_k, g_k), (loss_n, g_n) = results["flash"], results["naive"]
    worst = max(_errs(g_k[n], g_n[n])[1] for n in g_n)
    say(f"[slice] 2-layer loss kernels {loss_k:.5f} vs plain {loss_n:.5f}; worst grad norm_rel {worst:.3e}")
    if not abs(loss_k - loss_n) <= TOL_SLICE_LOSS:
        raise AssertionError(f"slice loss differs by {abs(loss_k - loss_n):.3e} > {TOL_SLICE_LOSS}")
    if not worst <= TOL_SLICE_GRAD_NORM_REL:
        raise AssertionError(f"slice grads differ: norm_rel {worst:.3e} > {TOL_SLICE_GRAD_NORM_REL}")


def phase_main_path() -> dict:
    from multimodal_llm_pretraining_tpu_torch.models import get_model_class
    from multimodal_llm_pretraining_tpu_torch.parallel.mesh import MeshConfig
    from multimodal_llm_pretraining_tpu_torch.train import TrainingPlan
    from multimodal_llm_pretraining_tpu_torch.utils import block_on

    mc = get_model_class("pythia-1b")
    mbs, acc, layers = 4, 2, 16
    # bench.py's recipe, without remat (not ported yet) at acc 2
    plan = TrainingPlan(
        num_training_steps=8,
        micro_batch_size=mbs,
        gradient_accumulation_steps=acc,
        activation_checkpointing=False,
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
    t0 = time.perf_counter()
    sess = plan.build_session(mc, device="cuda")
    state = sess.init_state()
    step = sess.train_step_fn()
    block_on("cuda")
    say(f"[main] pythia-1b session built and initialised in {time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    losses, times = [], []
    for i in range(4):
        batch = sess.make_train_batch(seed=i)
        block_on("cuda")
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])  # reads the loss back: waits for the step
        block_on("cuda")
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        say(f"[main] step {i}{' (warmup)' if i == 0 else ''}: loss {loss:.5f}, {times[-1]:.3f} s")
    launches = {"flash_fwd": fa.FWD_LAUNCHES, "flash_bwd_fused": fa.BWD_LAUNCHES}
    peak = torch.cuda.max_memory_allocated()

    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not 10.8 <= losses[0] <= 11.8:
        raise AssertionError(f"first loss {losses[0]} outside [10.8, 11.8] (ln 50304 = 10.83)")
    for p in state.params.values():
        if not torch.isfinite(p).all():
            raise AssertionError("non-finite parameter after the steps")
    expected = layers * acc * len(losses)
    if launches != {"flash_fwd": expected, "flash_bwd_fused": expected}:
        raise AssertionError(f"kernel launches {launches}, expected {expected} each")
    step_s = statistics.median(times[1:])
    tokens = mbs * acc * mc.sequence_length
    say(f"[main] median step {step_s:.4f} s over {len(times) - 1} steps, {tokens / step_s:.1f} tokens/s, "
        f"peak memory {peak} bytes ({peak / 2**30:.2f} GiB), launches {launches}")
    return launches


def main() -> int:
    card = phase_env()
    phase_build()
    kernels = phase_kernels()
    phase_slice()
    launches = phase_main_path()
    for k in kernels:
        k["launches"] = launches[k["name"]]
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
