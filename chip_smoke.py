"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line (or a few) each; any failure exits non-zero:

1. environment: the card (``nvidia-smi`` name and power limit), torch, CUDA
   and nvcc versions. No visible GPU is a failure, never a CPU fallback.
2. build: the flash-attention and selective-scan kernels from ``csrc/``, one
   nvcc per source, all started together (timed).
3. kernels: each flash-attention kernel against its plain PyTorch version on
   the same inputs, at the pythia-1b training shape ([4, 8, 2049, 256] bf16
   causal) and at a small ragged shape, with the tolerances stated below;
   then median CUDA-event times of kernel and plain version at the training
   shape.
4. slice: a two-layer GPTNeoX, loss and grads with the kernels against the
   plain f32 attention on the same weights and tokens.
5. main path: the pythia-1b training step at full width and depth, through
   ``get_model_class`` -> ``TrainingPlan`` -> ``build_session`` ->
   ``init_state`` -> ``train_step_fn``, 1 warmup + 3 timed steps. The kernel
   launch counters are zeroed just before and read just after, and must show
   every attention call of the run on the kernels.
6. scan kernels: both selective-scan kernels against their plain versions at
   the mamba-2.8b shape ([2, 4096, 5120], d_state 16) and at a ragged shape
   ([2, 300, 96]), for f32 and bf16 inputs, plus dD through the autograd
   Function; a second backward run must repeat bit for bit; then median
   CUDA-event times of kernel and plain version at the mamba shape (bf16).
7. scan slice: a two-layer narrow Mamba, f32, loss and every grad with the
   kernels against the plain chunked scan (``use_custom_kernels=False``).
8. main path: the mamba-2.8b training step at full width and depth (64
   layers, d_inner 5120, seq 4096) with block remat, the same entry points,
   micro-batch 2 x accumulation 2, 1 warmup + 3 timed steps; every scan call
   must show on the kernels (forward twice per block: once more under remat).
9. varlen kernels: both flash-attention kernels in their varlen (padded
   batch) mode against the plain versions with the same lens, at the llava
   decoder's shape ([16, 32, 1087, 64] bf16 causal, ragged lens), at the
   tower's shape ([16, 16, 577, 64], non-causal) and at a small ragged shape
   with an empty row; dk and dv must be exactly 0 at and past each length,
   and a second backward must repeat them as phase 3 requires. Then both
   kernels in plain mode at the tower's shape, as the main path calls the
   forward there. Then median CUDA-event times of the varlen and plain-mode
   kernels and the plain versions at the decoder's shape (full lens), and
   of the plain-mode forward at the tower's shape.
10. llava slice: a two-layer narrow LLaVA in bf16 (head_dim 64 in the tower
    and the decoder), frozen as llava-pretrain freezes it, on a right-padded
    batch: loss and every projector grad with the kernels against the plain
    f32 attention.
11. main path: the llava-pretrain training step at full width and depth (23
    CLIP blocks, 16 Llama-3.2-1B blocks, 1087 merged positions), the same
    entry points, in the JAX package's layout for it (bf16 compute, f32
    projector and moments, bf16 frozen leaves), micro-batch 16 x
    accumulation 2, 1 warmup + 3 timed steps. Every decoder attention call
    must show on the varlen kernels (forward and backward), every tower call
    on the plain-mode forward, and no tower call on a backward; the frozen
    parameters stay bit for bit and the projector moves.

The last three lines are the kernels JSON line, the card line and
``{"ok": true, "device": ...}``. A kernel's ``launches`` there is the sum
over the main paths that run it.
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
from multimodal_llm_pretraining_tpu_torch.ops import selective_scan_fused as ssf  # noqa: E402
from multimodal_llm_pretraining_tpu_torch.utils import require_cuda  # noqa: E402

KERNEL_SOURCE = "multimodal_llm_pretraining_tpu_torch/csrc/flash_attention.cu"
JAX_FLASH = "multimodal_llm_pretraining_tpu/ops/flash_attention.py"
SCAN_SOURCE = "multimodal_llm_pretraining_tpu_torch/csrc/selective_scan.cu"
JAX_SCAN = "multimodal_llm_pretraining_tpu/ops/selective_scan_pallas.py"
SCAN_SHAPE = (2, 4096, 5120)  # mamba-2.8b: mbs 2, seq 4096, d_inner 5120 (d_state 16)
SCAN_RAGGED = (2, 300, 96)  # L not a multiple of 256, I not a multiple of the 32-channel tile
SLICE_SHAPE = (4, 8, 2049, 256)  # pythia-1b: mbs 4, 8 heads, seq 2049, head_dim 256
RAGGED_SHAPE = (2, 3, 77, 64)
# llava-pretrain at the main path's mbs 16: the decoder's attention (32
# heads, 512 - 1 + 576 merged positions, head_dim 64) and the CLIP tower's
# (16 heads, 576 patches + CLS, head_dim 64)
VARLEN_SHAPE = (16, 32, 1087, 64)
TOWER_SHAPE = (16, 16, 577, 64)
VARLEN_RAGGED = (4, 2, 77, 64)
LLAVA_TOKENS_PER_SAMPLE = 512 - 1 + 576
# llava's first loss: random text under a tied head whose rows are N(0, 0.02^2)
# and a final RMSNorm that gives every hidden row a square norm of 2048, so
# each logit is about N(0, 2048 * 0.02^2 = 0.82) and the loss about
# ln 128257 + 0.82 / 2 = 11.76 + 0.41 = 12.17; the band is 0.5 either side
LLAVA_LOSS_BAND = (11.67, 12.67)
TEXT_LOSS_BAND = (10.8, 11.8)  # pythia and mamba: ln vocab = 10.83

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
# Scan kernels vs plain versions: both take the same inputs to f32 and
# compute in f32; they differ in summation order (16-lane shuffle trees,
# doubling scans, per-tile partial sums) and in the kernels' fast exp
# (__expf, a few ulps), which the recurrence carries over thousands of steps.
TOL_SCAN_Y = 1e-4  # ||kernel - plain|| / ||plain|| for y
TOL_SCAN_GRAD = 1e-3  # same for the checkpoint and du, ddelta, dA, dB, dC, dD (dA, dB sum thousands of terms)
# Two-layer Mamba in f32, kernels vs the plain scan under autograd: every
# other op is the same on both sides, so only the scan's error shows
TOL_SCAN_SLICE_LOSS_REL = 1e-5
TOL_SCAN_SLICE_GRAD_NORM_REL = 1e-3


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


def check_kernels_at(shape, causal: bool, seed: int = 0, lens: list[int] | None = None) -> dict:
    """Kernel vs plain version on identical inputs; returns the errors.
    With ``lens`` (one per batch row, broadcast over heads as
    ``flash_attention`` does) both run in varlen mode, and dk and dv must
    be exactly 0 at and past each length."""
    b, h, s, _ = shape
    q, k, v, do = _inputs(shape, seed)
    scale = shape[-1] ** -0.5
    kv_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda").repeat_interleave(h)
    tag = "[kernels]" if lens is None else "[varlen]"
    out, lse = fa.flash_fwd_cuda(q, k, v, causal, scale, kv_lens)
    out_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal, scale, kv_lens)
    grads = fa.flash_bwd_cuda(q, k, v, out_ref, lse_ref, do, causal, scale, kv_lens)
    grads_ref = fa.flash_bwd_reference(q, k, v, out_ref, lse_ref, do, causal, scale, kv_lens)
    torch.cuda.synchronize()
    res = {"out": _errs(out, out_ref), "lse": _errs(lse, lse_ref)}
    for name, got, ref in zip(("dq", "dk", "dv"), grads, grads_ref):
        res[name] = _errs(got, ref)
    for name, t in (("out", out), ("lse", lse), *zip(("dq", "dk", "dv"), grads)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{tag} {name} has non-finite values at {shape}")
    past_max = 0.0
    if kv_lens is not None:
        past = torch.arange(s, device="cuda")[None, :] >= kv_lens[:, None]  # [BH, S]: keys at or past the length
        if past.any():
            past_max = max(grads[1][past].abs().max().item(), grads[2][past].abs().max().item())
    say(f"{tag} {list(shape)} causal={causal}{'' if lens is None else f' lens {lens}'}: " + ", ".join(
        f"{n} max_abs {a:.3e} norm_rel {r:.3e}" for n, (a, r) in res.items())
        + ("" if lens is None else f"; dk/dv past the lens max_abs {past_max:.1e}"))
    for name in ("out", "dq", "dk", "dv"):
        if not res[name][1] <= TOL_NORM_REL:
            raise AssertionError(f"{tag} {name} norm-relative error {res[name][1]:.3e} > {TOL_NORM_REL} at {shape}")
    if not res["lse"][0] <= TOL_LSE_ABS:
        raise AssertionError(f"{tag} lse max-abs error {res['lse'][0]:.3e} > {TOL_LSE_ABS} at {shape}")
    if past_max != 0.0:
        raise AssertionError(f"{tag} dk/dv are not exactly 0 past the lens at {shape}")
    # dq sums by f32 atomics in an order that changes between runs: a second
    # run may differ by one bf16 ulp of the larger of the two values, plus
    # f32 summation noise (1e-6) where terms cancel to near zero; dk and dv
    # have no atomics and repeat exactly
    dq2, dk2, dv2 = fa.flash_bwd_cuda(q, k, v, out_ref, lse_ref, do, causal, scale, kv_lens)
    dq_diff = (dq2.float() - grads[0].float()).abs()
    dq_ulp = torch.maximum(dq2.float().abs(), grads[0].float().abs()) * 2.0**-7 + 1e-6
    say(f"{tag} {list(shape)} second backward run: dq max_abs change {dq_diff.max().item():.3e}, "
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


def _depth(module) -> str:
    if hasattr(module, "layers"):
        return f"{len(module.layers)} layers"
    return f"{len(module.vision_tower.layers)} tower + {len(module.language_model.layers)} decoder layers"


def drive_training(model_type: str, mbs: int, acc: int, remat: bool, counters, *, loss_band: tuple[float, float],
                   layout: str = "bf16_sr", names=("FWD_LAUNCHES", "BWD_LAUNCHES"),
                   tokens_per_sample: int | None = None) -> dict:
    """The training step through the user's entry points with the model's
    own optimizer and schedule: 1 warmup + 3 timed steps. ``layout`` is one
    of ``profile_step.make_plan``'s. ``counters`` is the kernel module whose
    launch counts ``names`` are zeroed just before the steps and read just
    after. The first loss must lie in ``loss_band``. For a model with a
    trainable mask, every frozen parameter must come out bit for bit and
    every trainable one must have moved."""
    from multimodal_llm_pretraining_tpu_torch.models import get_model_class
    from multimodal_llm_pretraining_tpu_torch.profile_step import make_plan
    from multimodal_llm_pretraining_tpu_torch.utils import block_on

    mc = get_model_class(model_type)
    sr = layout == "bf16_sr"
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sess = make_plan(mc, mbs, acc, remat, layout).build_session(mc, device="cuda")
    state = sess.init_state()
    step = sess.train_step_fn()
    block_on("cuda")
    say(f"[main] {model_type} session built and initialised in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in state.params.values())} parameters, "
        f"{sum(state.params[n].numel() for n in sess.trainable)} trainable, {_depth(sess.module)})")
    masked = sess.bundle.trainable_mask is not None
    # on the host, so that the peak memory below is the steps' own
    before = {n: p.detach().cpu() for n, p in state.params.items()} if masked else {}

    torch.cuda.reset_peak_memory_stats()
    counters.reset_launch_counts()
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
        say(f"[main] {model_type} step {i}{' (warmup)' if i == 0 else ''}: loss {loss:.5f}, {times[-1]:.3f} s")
    launches = {n: getattr(counters, n) for n in names}
    peak = torch.cuda.max_memory_allocated()

    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{model_type}: non-finite loss: {losses}")
    if not loss_band[0] <= losses[0] <= loss_band[1]:
        raise AssertionError(f"{model_type}: first loss {losses[0]} outside {list(loss_band)}")
    for p in state.params.values():
        if not torch.isfinite(p).all():
            raise AssertionError(f"{model_type}: non-finite parameter after the steps")
    if masked:
        trainable = set(sess.trainable)
        for n, p in state.params.items():
            if n in trainable and torch.equal(p.cpu(), before[n]):
                raise AssertionError(f"{model_type}: trainable {n} did not move")
            if n not in trainable and not torch.equal(p.cpu(), before[n]):
                raise AssertionError(f"{model_type}: frozen {n} changed")
        layout_ok = all(p.dtype == (torch.float32 if n in trainable else torch.bfloat16) for n, p in state.params.items())
        if not sr and not (layout_ok and all(m.dtype == torch.float32 for m in state.opt_state.mu + state.opt_state.nu)):
            raise AssertionError(f"{model_type}: not the f32-trainable / bf16-frozen layout with f32 moments")
        say(f"[main] {model_type}: {len(before) - len(trainable)} frozen parameters bit-identical, "
            f"{len(trainable)} trainable moved (f32, f32 moments; frozen bf16)")
    step_s = statistics.median(times[1:])
    samples = mbs * acc
    tokens = samples * (tokens_per_sample or mc.sequence_length)
    say(f"[main] {model_type} median step {step_s:.4f} s over {len(times) - 1} steps, {samples / step_s:.2f} samples/s, "
        f"{tokens / step_s:.1f} tokens/s, peak memory {peak} bytes ({peak / 2**30:.2f} GiB), launches "
        + ", ".join(f"{n} {c}" for n, c in launches.items()))
    return {"module": sess.module, "micro_batches": acc * len(losses), "launches": launches}


def phase_main_path() -> dict:
    """pythia-1b: bench.py's recipe, without remat (pythia's remat policies
    are not ported yet) at acc 2; every attention call on the kernels."""
    run = drive_training("pythia-1b", mbs=4, acc=2, remat=False, counters=fa, loss_band=TEXT_LOSS_BAND)
    run["launches"] = tuple(run["launches"].values())
    expected = len(run["module"].layers) * run["micro_batches"]
    if run["launches"] != (expected, expected):
        raise AssertionError(f"flash launches {run['launches']}, expected {expected} each")
    return {"flash_fwd": run["launches"][0], "flash_bwd_fused": run["launches"][1]}


# ---------------------------------------------------------------- selective scan


def _scan_inputs(shape, dtype, seed: int):
    """u, delta, A, B, C, D, dy on the card; delta in (0.01, 0.51) and A in
    -(0.5, 1.5) as in the JAX suite's scan tests."""
    b, L, I = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn(b, L, I, generator=g, device="cuda").to(dtype)
    delta = (torch.rand(b, L, I, generator=g, device="cuda") * 0.5 + 0.01).to(dtype)
    A = -(torch.rand(I, 16, generator=g, device="cuda") + 0.5)
    B, C = (torch.randn(b, L, 16, generator=g, device="cuda").to(dtype) for _ in range(2))
    D = torch.randn(I, generator=g, device="cuda")
    dy = torch.randn(b, L, I, generator=g, device="cuda")
    return u, delta, A, B, C, D, dy


def check_scan_at(shape, dtype, seed: int = 0) -> dict:
    """Both scan kernels vs their plain versions on identical inputs, dD
    through the autograd Function, and a second backward run; returns the
    errors."""
    u, delta, A, B, C, D, dy = _scan_inputs(shape, dtype, seed)
    y, ckpt = ssf.selective_scan_fwd_cuda(u, delta, A, B, C)
    y_ref, ckpt_ref = ssf.selective_scan_fwd_reference(u, delta, A, B, C)
    grads = ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt_ref)
    grads_ref = ssf.selective_scan_bwd_reference(u, delta, A, B, C, dy, ckpt_ref)
    leaves = [t.clone().requires_grad_() for t in (u, delta, A, B, C, D)]
    g = dy.to(dtype)
    ssf.SelectiveScanFused.apply(*leaves).backward(g)
    dD_ref = (g.float() * u.float()).sum((0, 1))
    torch.cuda.synchronize()
    got = {"y": (y, y_ref), "ckpt": (ckpt, ckpt_ref), "dD": (leaves[5].grad, dD_ref)}
    got.update({n: pair for n, pair in zip(("du", "ddelta", "dA", "dB", "dC"), zip(grads, grads_ref))})
    res = {}
    for name, (a, b) in got.items():
        if not torch.isfinite(a).all():
            raise AssertionError(f"scan {name} has non-finite values at {shape} {dtype}")
        res[name] = _errs(a, b)
        tol = TOL_SCAN_Y if name == "y" else TOL_SCAN_GRAD
        say(f"[scan] {list(shape)} N16 {str(dtype).split('.')[-1]} {name}: max_abs {res[name][0]:.3e} "
            f"norm_rel {res[name][1]:.3e} (tol {tol:g})")
        if not res[name][1] <= tol:
            raise AssertionError(f"scan {name} norm-relative error {res[name][1]:.3e} > {tol} at {shape} {dtype}")
    again = ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt_ref)
    same = all(torch.equal(a, b) for a, b in zip(grads, again))
    say(f"[scan] {list(shape)} {str(dtype).split('.')[-1]} second backward run: du, ddelta, dA, dB, dC identical {same}")
    if not same:
        raise AssertionError(f"the scan backward differs between two runs at {shape} {dtype}")
    return res


def phase_scan_kernels() -> list[dict]:
    for dtype in (torch.float32, torch.bfloat16):  # bf16 last: the main path's dtype, reported below
        errs = check_scan_at(SCAN_SHAPE, dtype, seed=10)
        check_scan_at(SCAN_RAGGED, dtype, seed=11)

    u, delta, A, B, C, _, dy = _scan_inputs(SCAN_SHAPE, torch.bfloat16, 12)
    _, ckpt = ssf.selective_scan_fwd_reference(u, delta, A, B, C)
    t = {
        "fwd": cuda_ms(lambda: ssf.selective_scan_fwd_cuda(u, delta, A, B, C)),
        "fwd_plain": cuda_ms(lambda: ssf.selective_scan_fwd_reference(u, delta, A, B, C)),
        "bwd": cuda_ms(lambda: ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt)),
        "bwd_plain": cuda_ms(lambda: ssf.selective_scan_bwd_reference(u, delta, A, B, C, dy, ckpt)),
    }
    say(f"[scan] median ms at {list(SCAN_SHAPE)} N16 bf16: " + ", ".join(f"{n} {ms:.3f}" for n, ms in t.items()))
    return [
        {"name": "scan_fwd", "route": "cuda", "source": SCAN_SOURCE, "replaces": f"{JAX_SCAN}:47",
         "launches": None, "max_abs_err": errs["y"][0], "ms": t["fwd"], "plain_ms": t["fwd_plain"]},
        {"name": "scan_bwd", "route": "cuda", "source": SCAN_SOURCE, "replaces": f"{JAX_SCAN}:161",
         "launches": None, "max_abs_err": max(errs[n][0] for n in ("du", "ddelta", "dA", "dB", "dC")),
         "ms": t["bwd"], "plain_ms": t["bwd_plain"]},
    ]


def phase_scan_slice() -> None:
    """Two-layer narrow Mamba in f32: the kernels against the plain chunked
    scan under autograd, on the same weights and tokens (seq 600: three
    256-step chunks, the last ragged)."""
    from multimodal_llm_pretraining_tpu_torch.models.mamba import MambaLM

    # full f32 products on both sides (the pythia phase's plan turned TF32 on)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    results = {}
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 1024, (2, 600))).to("cuda")
    for kernels in (True, False):
        model = MambaLM(256, 2, 512, 16, 4, 16, 1024, use_custom_kernels=kernels).to("cuda")
        model.reset_parameters(torch.Generator(device="cuda").manual_seed(0))
        ssf.reset_launch_counts()
        loss = model(ids, labels=ids)
        loss.backward()
        launches = (ssf.FWD_LAUNCHES, ssf.BWD_LAUNCHES)
        if launches != ((2, 2) if kernels else (0, 0)):
            raise AssertionError(f"scan slice with kernels={kernels}: launches {launches}")
        results[kernels] = (loss.item(), {n: p.grad.float() for n, p in model.named_parameters()})
    (loss_k, g_k), (loss_p, g_p) = results[True], results[False]
    worst_name = max(g_p, key=lambda n: _errs(g_k[n], g_p[n])[1])
    worst = _errs(g_k[worst_name], g_p[worst_name])[1]
    say(f"[scan slice] 2-layer f32 loss kernels {loss_k:.6f} vs plain {loss_p:.6f}; "
        f"worst grad norm_rel {worst:.3e} ({worst_name})")
    if not abs(loss_k - loss_p) <= TOL_SCAN_SLICE_LOSS_REL * abs(loss_p):
        raise AssertionError(f"scan slice loss differs by {abs(loss_k - loss_p):.3e}")
    if not worst <= TOL_SCAN_SLICE_GRAD_NORM_REL:
        raise AssertionError(f"scan slice grads differ: norm_rel {worst:.3e} > {TOL_SCAN_SLICE_GRAD_NORM_REL}")


def phase_mamba_main_path() -> dict:
    """mamba-2.8b at full width and depth with block remat: every scan call
    on the kernels, the forward twice per block and micro-batch (the remat
    recompute runs it again) and the backward once."""
    run = drive_training("mamba", mbs=2, acc=2, remat=True, counters=ssf, loss_band=TEXT_LOSS_BAND)
    run["launches"] = tuple(run["launches"].values())
    calls = len(run["module"].layers) * run["micro_batches"]
    if run["launches"] != (2 * calls, calls):
        raise AssertionError(f"scan launches {run['launches']}, expected ({2 * calls}, {calls})")
    return {"scan_fwd": run["launches"][0], "scan_bwd": run["launches"][1]}


# ---------------------------------------------------------------- varlen flash attention (llava)


def _ragged_lens(b: int, s: int, seed: int) -> list[int]:
    """One full row, one shorter than a tile, one ending on a tile edge (64,
    a multiple of both kernels' key tiles), the rest random in [1, s]."""
    edge = (s - 1) // 64 * 64
    rest = np.random.default_rng(seed).integers(1, s + 1, max(b - 3, 0)).tolist()
    return [s, 37, edge, *rest][:b]


def phase_varlen_kernels() -> list[dict]:
    # full f32 products in the plain versions (the main paths' plans turned TF32 on)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    errs = check_kernels_at(VARLEN_SHAPE, True, seed=20, lens=_ragged_lens(VARLEN_SHAPE[0], VARLEN_SHAPE[2], 0))
    check_kernels_at(TOWER_SHAPE, False, seed=21, lens=_ragged_lens(TOWER_SHAPE[0], TOWER_SHAPE[2], 1))
    for causal in (True, False):
        check_kernels_at(VARLEN_RAGGED, causal, seed=22 + causal, lens=[77, 37, 64, 0])
    check_kernels_at(TOWER_SHAPE, False, seed=24)  # the tower's own call: plain mode, non-causal

    b, h, s, _ = VARLEN_SHAPE
    q, k, v, do = _inputs(VARLEN_SHAPE, 23)
    scale = VARLEN_SHAPE[-1] ** -0.5
    full = torch.full((b * h,), s, dtype=torch.int32, device="cuda")  # every row full: the benchmark batch's mask
    out, lse = fa.flash_fwd_reference(q, k, v, True, scale, full)
    t = {
        "fwd": cuda_ms(lambda: fa.flash_fwd_cuda(q, k, v, True, scale, full)),
        "fwd_plain_mode": cuda_ms(lambda: fa.flash_fwd_cuda(q, k, v, True, scale)),
        "fwd_plain": cuda_ms(lambda: fa.flash_fwd_reference(q, k, v, True, scale, full)),
        "bwd": cuda_ms(lambda: fa.flash_bwd_cuda(q, k, v, out, lse, do, True, scale, full)),
        "bwd_plain_mode": cuda_ms(lambda: fa.flash_bwd_cuda(q, k, v, out, lse, do, True, scale)),
        "bwd_plain": cuda_ms(lambda: fa.flash_bwd_reference(q, k, v, out, lse, do, True, scale, full)),
    }
    say(f"[varlen] median ms at {list(VARLEN_SHAPE)} bf16 causal, full lens: "
        + ", ".join(f"{n} {ms:.3f}" for n, ms in t.items()))
    del q, k, v, do, out, lse
    q, k, v, _ = _inputs(TOWER_SHAPE, 24)
    tower_scale = TOWER_SHAPE[-1] ** -0.5
    tower = {
        "fwd": cuda_ms(lambda: fa.flash_fwd_cuda(q, k, v, False, tower_scale)),
        "fwd_plain": cuda_ms(lambda: fa.flash_fwd_reference(q, k, v, False, tower_scale)),
    }
    say(f"[varlen] median ms at the tower's {list(TOWER_SHAPE)} bf16 non-causal, plain mode: "
        + ", ".join(f"{n} {ms:.3f}" for n, ms in tower.items()))
    return [
        {"name": "flash_fwd_varlen", "route": "cuda", "source": KERNEL_SOURCE, "replaces": f"{JAX_FLASH}:91",
         "launches": None, "max_abs_err": errs["out"][0], "ms": t["fwd"], "plain_ms": t["fwd_plain"]},
        {"name": "flash_bwd_fused_varlen", "route": "cuda", "source": KERNEL_SOURCE, "replaces": f"{JAX_FLASH}:208",
         "launches": None, "max_abs_err": max(errs[n][0] for n in ("dq", "dk", "dv")), "ms": t["bwd"],
         "plain_ms": t["bwd_plain"]},
    ]


LLAVA_COUNTERS = ("FWD_LAUNCHES", "BWD_LAUNCHES", "VARLEN_FWD_LAUNCHES", "VARLEN_BWD_LAUNCHES")


def phase_llava_slice() -> None:
    """Two-layer narrow LLaVA in bf16 at the kernels' head_dim 64 (tower of
    hidden 128 with 2 heads, decoder of hidden 256 with 4 q / 2 kv heads),
    336-pixel images (576 patches) and 64 text tokens, the second row
    right-padded after 40; tower and decoder frozen as llava-pretrain
    freezes them. Loss and every projector grad with the kernels against
    the plain f32 attention ("naive") on the same weights and batch."""
    from multimodal_llm_pretraining_tpu_torch.models.llava import LlavaModule

    tower = dict(hidden=128, num_layers=3, num_heads=2, intermediate=512)  # feature layer -2: 2 blocks
    lm = dict(hidden=256, num_layers=2, num_heads=4, num_kv_heads=2, ffn=512)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 1024, (2, 64))
    ids[:, 0] = 1024
    mask = np.ones_like(ids)
    mask[1, 40:] = 0
    batch = {"input_ids": ids, "pixel_values": rng.random((2, 336, 336, 3), dtype=np.float32),
             "labels": np.where(mask > 0, ids, -100), "attention_mask": mask}
    batch = {n: torch.from_numpy(x).to("cuda") for n, x in batch.items()}
    results = {}
    for impl in ("flash", "naive"):
        model = LlavaModule(attn_impl=impl, dtype=torch.bfloat16, tower_kwargs=tower, lm_kwargs=lm,
                            vocab_with_image=1025, image_token=1024).to("cuda")
        model.reset_parameters(torch.Generator(device="cuda").manual_seed(0))
        for n, p in model.named_parameters():
            p.requires_grad_(n.startswith("projector"))
        fa.reset_launch_counts()
        loss = model(batch["input_ids"], batch["pixel_values"], labels=batch["labels"],
                     attention_mask=batch["attention_mask"])
        loss.backward()
        launches = tuple(getattr(fa, n) for n in LLAVA_COUNTERS)
        if launches != ((2, 0, 2, 2) if impl == "flash" else (0, 0, 0, 0)):
            raise AssertionError(f"llava slice {impl}: launches {dict(zip(LLAVA_COUNTERS, launches))}")
        results[impl] = (loss.item(), {n: p.grad.float() for n, p in model.named_parameters() if p.requires_grad})
    (loss_k, g_k), (loss_n, g_n) = results["flash"], results["naive"]
    worst_name = max(g_n, key=lambda n: _errs(g_k[n], g_n[n])[1])
    worst = _errs(g_k[worst_name], g_n[worst_name])[1]
    say(f"[llava slice] 2-layer bf16 loss kernels {loss_k:.5f} vs plain {loss_n:.5f}; {len(g_n)} projector grads, "
        f"worst norm_rel {worst:.3e} ({worst_name}); launches fwd 2 bwd 0 varlen fwd 2 varlen bwd 2")
    if not abs(loss_k - loss_n) <= TOL_SLICE_LOSS:
        raise AssertionError(f"llava slice loss differs by {abs(loss_k - loss_n):.3e} > {TOL_SLICE_LOSS}")
    if not worst <= TOL_SLICE_GRAD_NORM_REL:
        raise AssertionError(f"llava slice grads differ: norm_rel {worst:.3e} > {TOL_SLICE_GRAD_NORM_REL}")


def phase_llava_main_path() -> dict:
    """llava-pretrain at full width and depth, micro-batch 16 x accumulation
    2 (the recipe's batch of 256 cut for one card), in the JAX package's
    layout for it. Per micro-batch: 16 varlen forwards and 16 varlen
    backwards (the decoder; its weights are frozen but the gradient flows
    through it to the projector), 23 plain-mode forwards (the tower) and no
    plain-mode backward (the frozen tower is not differentiated)."""
    run = drive_training("llava-pretrain", mbs=16, acc=2, remat=False, counters=fa, loss_band=LLAVA_LOSS_BAND,
                         layout="bf16", names=LLAVA_COUNTERS, tokens_per_sample=LLAVA_TOKENS_PER_SAMPLE)
    mod, mb = run["module"], run["micro_batches"]
    tower, decoder = len(mod.vision_tower.layers) * mb, len(mod.language_model.layers) * mb
    expected = dict(zip(LLAVA_COUNTERS, (tower, 0, decoder, decoder)))
    if run["launches"] != expected:
        raise AssertionError(f"llava launches {run['launches']}, expected {expected}")
    return {"flash_fwd": tower, "flash_bwd_fused": 0, "flash_fwd_varlen": decoder, "flash_bwd_fused_varlen": decoder}


def main() -> int:
    card = phase_env()
    phase_build()
    kernels = phase_kernels()
    phase_slice()
    launches = phase_main_path()
    kernels += phase_scan_kernels()
    phase_scan_slice()
    launches.update(phase_mamba_main_path())
    kernels += phase_varlen_kernels()
    phase_llava_slice()
    for name, n in phase_llava_main_path().items():
        launches[name] = launches.get(name, 0) + n
    for k in kernels:
        k["launches"] = launches[k["name"]]
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
