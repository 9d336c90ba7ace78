"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line (or a few) each; any failure exits non-zero:

1. environment: the card (``nvidia-smi`` name and power limit), torch, CUDA
   and nvcc versions. No visible GPU is a failure, never a CPU fallback.
2. build: the flash-attention, selective-scan and LM-head loss kernels from
   ``csrc/``, one nvcc per source, all started together (timed); each
   kernel's registers and spills from ``ptxas -v``, one ``[ptxas]`` line
   each.
2a. LM-head loss: both ``csrc/xent.cu`` kernels against their plain versions at
   pythia-1b's chunk ([1024, 50304]) and llava's ([1024, 128257] padded to
   128,264), bf16 dlogits, each seventh row ignored, NaN in the padding and
   the ignored rows, which the kernels never read; a second launch of each
   must repeat the first bit for bit. Then CUDA-event times at pythia's
   chunk beside their bounds, their plain versions and the yardsticks
   (``torch.logsumexp``; the pre-change autograd chain from the logits to
   bf16 dlogits); then the whole loss, forward and backward, at the
   benchmark's pythia-1b micro-batch ([32768, 2048] x 50304 bf16) on the
   kernels and on the pre-change path (``xent_autograd_yardstick``), the
   losses and gradients held to each other.
2b. RMSNorm: both ``csrc/rmsnorm.cu`` kernels against their plain versions
   at mamba-2.8b's benchmark micro-batch ([32768, 2560] f32 stream in, bf16
   out, the residual's gradient added in the backward), its final norm (no
   residual), llava-pretrain's decoder ([17392, 2048] bf16) and a ragged
   row ([3, 100]); a second launch of each must repeat the first bit for
   bit. Then CUDA-event times at mamba's shape beside their bounds, their
   plain versions and the yardsticks (``F.rms_norm`` and a cast for the
   forward; the pre-change autograd chain's backward and the residual's add
   for the backward). The mamba and llava main paths (8, 11) count the
   kernels' launches a micro-batch: 2 x 64 + 1 forwards and 64 + 1
   backwards for mamba under block remat (each block's norm, its replay,
   the final norm), 33 and 33 for llava's decoder.
2c. causal conv: both ``csrc/causal_conv.cu`` kernels against their plain
   versions at mamba-2.8b's benchmark micro-batch ([8, 4096, 5120] bf16, x
   the strided half of [8, 4096, 10240] as the block hands it over, bf16
   and f32 parameters) and at a ragged shape ([2, 300, 100], K 3); a second
   launch of each must repeat the first bit for bit. Then CUDA-event times
   at mamba's shape beside their bounds, their plain versions and the
   PyTorch chain they replace (the f32 cast, pad, depthwise conv, SiLU, the
   cast back and the copy to contiguous; its autograd backward). The mamba
   main path (8) counts their launches: 2 x 64 forwards and 64 backwards a
   micro-batch under block remat (each block's conv and its replay).
3. kernels: each flash-attention kernel against its plain PyTorch version on
   the same inputs, at the pythia-1b training shape ([4, 8, 2049, 256] bf16
   causal) and at a small ragged shape, with the tolerances stated below;
   the forward also at its tile edges (q_seq in FWD_EDGE_SEQS, kv_seq other
   than q_seq, every head dim, causal and not), every forward repeated bit
   for bit, and the fused backward at its own (``check_backward_edges``:
   q_seq in BWD_EDGE_SEQS, kv_seq other than q_seq both ways, varlen lengths
   BWD_EDGE_LENS, every head dim, causal and not; dk/dv bit for bit and dq
   within one ulp on a second launch, exact zeros past the lens); then
   CUDA-event times of kernel and plain version at the training shape, and
   the forward's and fused backward's TFLOP/s, share of the bound and ratio
   to PyTorch's call.
4. slice: a two-layer GPTNeoX, loss and grads with the kernels against the
   plain f32 attention on the same weights and tokens.
5. main path: the pythia-1b training step at full width and depth, through
   ``get_model_class`` -> ``TrainingPlan`` -> ``build_session`` ->
   ``init_state`` -> ``train_step_fn``. The kernel launch counters are
   zeroed just before and read just after, and must show every attention
   call of the run on the kernels.
6. scan kernels: both selective-scan kernels against their plain versions at
   the mamba-2.8b shape ([2, 4096, 5120], d_state 16) and at a ragged shape
   ([2, 300, 96]), for f32 and bf16 inputs: the forward before the D skip
   and with it (the skip and the cast in the kernel's epilogue), plus dD
   through the autograd Function; a second forward and a second backward
   must repeat bit for bit; then median CUDA-event times of kernel and plain
   version at the mamba shape (bf16; the forward with D, as the Function
   runs it), and each kernel's share of its bound beside its earlier
   design's time.
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
   forward there, and the varlen forward at lens on and around its tile
   edges. Then CUDA-event times of the varlen and plain-mode kernels and the
   plain versions at the decoder's shape (full lens), and of the plain-mode
   forward at the tower's shape, each forward beside PyTorch's call.
10. llava slice: a two-layer narrow LLaVA in bf16 (head_dim 64 in the tower
    and the decoder), frozen as llava-pretrain freezes it, on a right-padded
    batch: loss and every projector grad with the kernels against the plain
    f32 attention.
11. main path: the llava-pretrain training step at full width and depth (23
    CLIP blocks, 16 Llama-3.2-1B blocks, 1087 merged positions), the same
    entry points, in the JAX package's layout for it (bf16 compute, f32
    projector and moments, bf16 frozen leaves), micro-batch 16 x
    accumulation 2. Every decoder attention call must show on the varlen
    kernels (forward and backward), every tower call on the plain-mode
    forward, and no tower call on a backward; the frozen parameters stay
    bit for bit and the projector moves.
12. split kernels: the split backward (``check_split``: one prep launch,
    the dq kernel, the dk/dv kernel, as ``mlpt::flash_bwd_split`` runs
    it), beside the forward and the fused kernel, against their plain
    versions at pythia's [4, 8, 2049, 256] bf16 causal, ViT's [128, 16,
    197, 64] f32 and bf16 non-causal (the f32 forward and fused backward
    are the ViT main path's own), [2, 3, 77, 64] both causal settings, and
    in varlen mode at the llava decoder's [16, 32, 1087, 64] causal (ragged
    lens) and [4, 2, 77, 64] with an empty row; dq, dk and dv must repeat
    bit for bit on a second run, dq lie within TOL_NORM_REL of the fused
    kernel's and dk, dv equal the fused kernel's bit for bit (where both
    form k*scale from the same bf16 k), and in varlen mode dk/dv must be
    exactly 0 past each length and dq 0 on an empty row; the forward and
    the fused backward on f32 inputs at their tile edges, plain and varlen;
    the split pair at the fused backward's tile edges (``check_split_edges``),
    bf16 and f32. Then CUDA-event times at each main-path shape: the dq and
    the dk/dv kernel alone, the pair with its prep launch and casts, and
    their plain versions, set against the fused kernel (timed in phases 3
    and 9, at ViT's shape here), PyTorch's backward (the yardstick) and
    the bounds.
13. ViT slice: a two-layer narrow ViT in f32 (head_dim 64, 197 tokens), loss
    and every grad with the kernels under the fused and under the split
    backward, against the plain f32 attention on the same weights.
14. main path: the ViT-L/16 training step at full width and depth (24
    blocks, 197 tokens, 21,841 classes) in the f32 layout with dropout on,
    micro-batch 128 x accumulation 2.
15. head dims: the forward, fused backward and split pair against their
    plain versions at the head dims the kernels run zero-padded (32, 80,
    88; plain and varlen, causal and not), then 2 steps each of pythia-14m
    (head_dim 32) and of pythia-2.8b cut to 2 layers (head_dim 80, full
    width) with every attention call on the kernels.
16. grid: all of them at 65,536 batch-heads ([4096, 16, 16, 64], plain and
    varlen), one more than a launch grid's y dimension holds: two launches
    a call.
17. repairs: the shapes the JAX package computes that the kernels do not
    take as such, each against its plain version: head dim 320 through
    ``dot_product_attention(impl="flash")``, which sends it to the xla
    branch by shape (one xla-branch call, no flash launch); the fused
    backward at head dim 256 with scale 0.07 (its one-stage variant with a
    k*scale tile) and the split pair there (its dk/dv kernel on the
    wrapper's k*scale), plain and varlen; both scan kernels at d_state 8, 24 and
    64 (zero-padded groups of 16 states, one launch each) and at 65,536
    batch elements (two launches a call).
18. remat: pythia-1b at bench's recipe (micro-batch 4 x accumulation 2,
    ``bf16_sr``) in one session each without remat, under "dots" and under
    "flash" (``models/layers.py`` ``checkpoint_block`` on the flash custom
    ops), 1 warmup + 3 timed steps each. The first loss must be bit for bit
    the same in all three; every grad after one micro-batch under the split
    backward (which repeats bit for bit), taken before the steps from the
    same initial parameters, must equal no remat's bit for bit, or lie
    within TOL_SLICE_GRAD_NORM_REL with the largest difference printed; the
    flash launches must be the same in all three (one forward a block and
    micro-batch: the recompute takes the saved outputs). Each session's
    median step and peak memory are printed beside the card line.
19. remat-ViT: ViT-L/16 (f32, dropout on, micro-batch 128 x accumulation 2)
    without remat and under "flash", 2 steps each under the split
    backward: equal losses, and the dropout generator in the same state
    after the steps (the recompute replays the masks and draws nothing of
    its own).
20. remat-llava: llava-pretrain (micro-batch 16 x accumulation 2) the same
    way: equal losses, the frozen leaves bit for bit, and no backward
    launched for the frozen tower.
21. harness and method search: ``benchmarking/`` on pythia-1b under "dots":
    phase times at micro-batch 4 (1 warmup + 3 samples) and the step they
    give at accumulation 32; one ``bf16_master`` session (micro-batch 4 x
    accumulation 2, no remat) whose first loss must equal phase 18's
    ``bf16_sr`` one bit for bit and whose bf16 params must equal their f32
    masters rounded, its peak beside phase 18's; ``CountFlopsExperiment``
    and ``TrainingTimeAnalytic`` (assumed MFU 1.0) for pythia-1b, mamba,
    llava-pretrain and ViT-L/16, each count through the flash (plain and
    varlen) and scan kernels under ``FlopCounterMode``, with mamba's scan
    share; then, with the parent's reserved memory below 1 GiB, the method
    search (``experiments/``): the CLI's ``--methods all`` grid for
    pythia-1b on one card restricted to "dots" remat and the ``bf16_sr``
    and ``bf16_master`` layouts, two arms, in a workspace of the phase's
    own: each arm's max micro-batch (``find_max_mbs_pow2`` with one fresh
    worker a candidate), split and fused step and training days, every
    worker's op, outcome and time printed; the same sweep again, which
    must start no worker and take under 5 s; the results table; the
    phase's wall time. The counts also take vilt-pretrain (120 forwards and
    120 backwards: three trunk passes), roberta (24 + 24) and
    convnext-large-1k (no kernel).
22. ViLT slice: the narrow ViLT of ``tests/test_torch_vilt.py`` (2 trunk
    layers, 2 heads of 88 zero-padded to 128, f32, MLM + ITM + WPA, ragged
    ITM text masks) on the card: loss and every grad with the kernels under
    the fused and the split backward against the plain f32 attention.
23. ViLT main paths: the forward and fused backward against their plain
    versions and timed at vilt-pretrain's [4, 16, 769, 88] f32 shape; then
    vilt-pretrain at full width and depth (CLIP-g/14 trunk, 40 blocks,
    1,464,333,826 parameters) in the f32 layout, micro-batch 4 x
    accumulation 2, under the A/B schedule: 120 forwards and 120 backwards
    a micro-batch (three trunk passes); then 2 steps of
    vilt-original-pretrain (ViLT-B/32, micro-batch 32 x accumulation 2).
24. RoBERTa: the kernels at its [32, 16, 512, 64] bf16 shape; a 2-layer
    bf16 slice against the plain attention under both backwards; the main
    path (RoBERTa-large, dropout on, bf16 compute over f32 params,
    micro-batch 32 x accumulation 2, A/B schedule: 24 + 24 a micro-batch);
    then without remat and under "flash", 2 split steps each: equal losses
    and the dropout generator in the same state after the steps.
25. ConvNeXt main path: convnext-large-1k at full width and depth in the
    f32 layout, micro-batch 64 x accumulation 2, 1 warmup + 3 timed steps,
    no kernel launched. Then the run's wall time.

Every main path must send no attention call to the xla branch
(``attention.XLA_BRANCH_CALLS`` stays 0). Main paths 5, 11, 14, 23
(vilt-pretrain) and 24 (roberta) run in
one session each 1 warmup step under each
backward (``fa.PREFER_FUSED_BWD``), then 3 timed steps under each,
interleaved fused, split, split, fused, fused, split; the median of each is
printed, and the launch counters must show every attention backward of a
micro-batch on the backward it ran under. Main path 8 (mamba, no attention)
runs 1 warmup + 3 timed steps.

Kernel times are the mean of a call in a run of 10 launches back to back
between two CUDA events, the median of 3 runs (``cuda_ms``); the forward's
line also gives its time with one event pair per call (``cuda_ms_alone``),
where the card waits on the host's launch work.

The last three lines are the kernels JSON line, the card line and
``{"ok": true, "device": ...}``. A kernel's ``launches`` there is the sum
over the main paths that run it (phases 18-21 included: phase 21's
``bf16_master`` session and counts, not its workers, which are other
processes); ``bound_ms`` is the larger of the bytes the
function must move over the memory rate and its operations over their
unit's peak rate, computed from that entry's inputs; ``library_ms`` is the
time of the PyTorch call that computes the same function (``sdpa_ms``, the
yardstick, which the port never calls), or null where there is none. The
split kernels' ``library_ms`` is PyTorch's backward, which computes what the
pair computes together, and their ``pair_ms`` the pair's own time beside it.
The launches of ``xent_fwd`` and ``xent_bwd`` are those of the main paths
that end in an LM-head loss (pythia-1b, mamba, llava, ViLT, RoBERTa), each
counted from 0 just before its steps; those of ``rmsnorm_fwd`` and
``rmsnorm_bwd`` the mamba and llava main paths' (their remat sessions'
norms are not counted). The entries ``flash_fwd_vilt``, ``flash_bwd_fused_vilt``,
``flash_fwd_roberta`` and ``flash_bwd_fused_roberta`` are the same two
kernels at vilt-pretrain's and RoBERTa-large's shapes, their ``launches``
those of the main paths at that shape (counted in ``flash_fwd`` and
``flash_bwd_fused`` too).
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
from multimodal_llm_pretraining_tpu_torch.ops import attention as attn  # noqa: E402
from multimodal_llm_pretraining_tpu_torch.ops import flash_attention as fa  # noqa: E402
from multimodal_llm_pretraining_tpu_torch.ops import selective_scan_fused as ssf  # noqa: E402
from multimodal_llm_pretraining_tpu_torch.time_attention import ms_per_call as cuda_ms  # noqa: E402
from multimodal_llm_pretraining_tpu_torch.time_attention import card_line, visible_pairs  # noqa: E402
from multimodal_llm_pretraining_tpu_torch.utils import require_cuda  # noqa: E402

FWD_SOURCE = "multimodal_llm_pretraining_tpu_torch/csrc/flash_fwd.cu"
BWD_SOURCE = "multimodal_llm_pretraining_tpu_torch/csrc/flash_bwd.cu"
DQ_SOURCE = "multimodal_llm_pretraining_tpu_torch/csrc/flash_bwd_dq.cu"
JAX_FLASH = "multimodal_llm_pretraining_tpu/ops/flash_attention.py"
SCAN_SOURCE = "multimodal_llm_pretraining_tpu_torch/csrc/selective_scan.cu"
JAX_SCAN = "multimodal_llm_pretraining_tpu/ops/selective_scan_pallas.py"
SCAN_SHAPE = (2, 4096, 5120)  # mamba-2.8b: mbs 2, seq 4096, d_inner 5120 (d_state 16)
SCAN_RAGGED = (2, 300, 96)  # L not a multiple of 256, I not a multiple of the backward's 80-channel tile
SCAN_BWD_EARLIER_MS = 5.485  # the earlier backward (one state a thread, synchronous staging) at SCAN_SHAPE bf16
SCAN_FWD_EARLIER_MS = 1.299  # the earlier forward (the same, f32 y before the skip) at SCAN_SHAPE bf16, kernel alone
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
# ViT-L/16 at the main path's mbs 128: 16 heads, 196 patches + CLS, head_dim 64
VIT_SHAPE = (128, 16, 197, 64)
VIT_TOKENS = 197
VIT_DROPOUT = 0.1  # the JAX ViTBlock's hidden dropout; the session always hands the loss its generator
# ViT's first loss: the final LayerNorm gives the class token's row unit
# variance (square norm 1024), and the classifier's lecun-normal kernel has
# variance 1/1024 with a zero bias, so the 21,841 logits are about N(0, 1):
# E[logsumexp] = ln 21841 + 1/2 = 9.99 + 0.50 = 10.49, and the mean of the
# 256 labels' logits has a standard deviation of 1/16; 0.3 either side
VIT_LOSS_BAND = (10.19, 10.79)

# H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): bf16 tensor-core products, f32 outside the tensor cores,
# HBM. The exp rate: 16 special-function results per SM per clock (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0) x 132 SMs x 1.98 GHz. The flash kernels' products run in bf16 also on
# f32 inputs, so their operations are held to the bf16 rate.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
PEAK_EXPS = 16 * 132 * 1.98e9

# Kernel vs plain version. On bf16 inputs both round the same operands to
# bf16 (q*scale, p, ds) and accumulate in f32; they differ in summation
# order, in the online softmax's running rescale of p, and in dq's atomic
# (run-to-run varying) summation order. Outputs are bf16, so one rounding of
# 2^-9 is already in every element: bound the error relative to the output's
# norm. On f32 inputs the kernels round every product operand to bf16 (2^-9
# each), as a default-precision f32 dot does on the TPU, where the plain
# versions keep f32: a few such roundings, again under 1e-2 of the norm.
TOL_NORM_REL = 1e-2  # ||kernel - plain|| / ||plain|| for out, dq, dk, dv
TOL_LSE_ABS = 1e-3  # lse is f32 and sees no bf16 output rounding; f32 inputs add ``lse_limit``'s term
# Two-layer model, kernels vs f32 plain attention (bf16 compute both ways)
TOL_SLICE_LOSS = 2e-2
TOL_SLICE_GRAD_NORM_REL = 5e-2
# Scan kernels vs plain versions: both take the same inputs to f32 and
# compute in f32; they differ in summation order (shuffle sums, doubling
# scans, per-tile partial sums) and in the kernels' fast exp (ex2.approx, a
# few ulps), which the recurrence carries over thousands of steps.
TOL_SCAN_Y = 1e-4  # ||kernel - plain|| / ||plain|| for y before the skip, and with it in f32
TOL_SCAN_Y_BF16 = 4e-3  # y with the skip in bf16: both round to bf16 values the f32 error may put one ulp apart
TOL_SCAN_GRAD = 1e-3  # same for the checkpoint and du, ddelta, dA, dB, dC, dD (dA, dB sum thousands of terms)
# Two-layer Mamba in f32, kernels vs the plain scan under autograd: every
# other op is the same on both sides, so only the scan's error shows
TOL_SCAN_SLICE_LOSS_REL = 1e-5
TOL_SCAN_SLICE_GRAD_NORM_REL = 1e-3


def say(msg: str) -> None:
    print(msg, flush=True)


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


def cuda_ms_alone(fn, warmup: int = 3, iters: int = 10) -> float:
    """Median milliseconds of ``fn`` with one CUDA-event pair per call and a
    synchronise after each: the card waits on the host's launch work, as it
    does when nothing else is queued."""
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


def _inputs(shape, seed: int, dtype: torch.dtype = torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, h, s, d = shape
    q, k, v, do = (torch.randn(b * h, s, d, generator=g, device="cuda").to(dtype) for _ in range(4))
    return q, k, v, do


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(nbytes: int, flops: float = 0.0, flop_rate: float = PEAK_BF16_FLOPS, exps: float = 0.0) -> dict:
    """The least time the card could take for a function, in ms, and what
    bounds it: the bytes it must move (each input read once, each output
    written once) over the memory rate, or its operations (products at
    ``flop_rate``, exps at the special-function rate)."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(flops / flop_rate, exps / PEAK_EXPS)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def bound_terms(nbytes: int, flops: float = 0.0, flop_rate: float = PEAK_BF16_FLOPS, exps: float = 0.0) -> str:
    """``bound``'s three terms in ms, for the log."""
    return (f"bytes {nbytes} ({nbytes / PEAK_BYTES * 1e3:.4f} ms), products {flops:.4g} "
            f"({flops / flop_rate * 1e3:.4f} ms), exps {exps:.4g} ({exps / PEAK_EXPS * 1e3:.4f} ms)")


def attention_bounds(q, k, v, do, causal: bool, kv_lens=None) -> dict:
    """``bound`` of each attention function on these [BH, S, D] inputs, with
    2·D FLOP per visible pair per product and one exp per pair: the forward
    (q, k, v -> out, f32 lse; 2 products) and the backward (q, k, v, out,
    dO, lse -> dq, dk, dv; 5 products), which the fused kernel and the
    split pair both compute."""
    pairs = visible_pairs(q.shape[0], q.shape[1], k.shape[1], causal, kv_lens)
    f = 2 * q.shape[-1] * pairs
    stats = q.shape[0] * q.shape[1] * 4  # one f32 lse (or delta) per query row
    qkv = _nbytes(q, k, v, kv_lens)
    return {
        "fwd": bound(qkv + _nbytes(q) + stats, 2 * f, exps=pairs),
        "bwd": bound(qkv + _nbytes(q, do) + stats + _nbytes(q, k, v), 5 * f, exps=pairs),
    }


def split_bounds(q, k, ops, causal: bool, kv_lens=None) -> dict:
    """``bound`` of the split pair's kernels on what each one reads and
    writes: q, k, v and dO as ``split_operands`` hands them over (bf16; f32
    inputs come rounded, the casts outside the kernels), the lse and delta
    rows, the lens, and the outputs in the input dtype. dq alone (-> dq;
    s, dp and ds·k: 3 products) and dk, dv alone (-> dk, dv; s, dp, pᵀ·dO
    and dsᵀ·q: 4). ``q`` and ``k`` are the caller's [BH, S, D] tensors, so
    the counts leave out the padding of a head dim."""
    pairs = visible_pairs(q.shape[0], q.shape[1], k.shape[1], causal, kv_lens)
    f = 2 * q.shape[-1] * pairs
    stats = q.shape[0] * q.shape[1] * 4
    read = 2 * (q.numel() + k.numel()) * ops.q.element_size() + 2 * stats + _nbytes(kv_lens)  # q, dO, k, v
    return {
        "dq": bound(read + _nbytes(q), 3 * f, exps=pairs),
        "dkv": bound(read + 2 * _nbytes(k), 4 * f, exps=pairs),
    }


def sdpa_ms(q, k, v, do, causal: bool, flash_only: bool) -> dict:
    """The yardstick, and the one place where this script names PyTorch's
    fused attention (the port never calls it): median ms of
    ``scaled_dot_product_attention`` on the [BH, S, D] inputs viewed as [1,
    BH, S, D] at the default scale 1/sqrt(D), forward, and backward as
    forward + backward less the forward. ``flash_only`` holds it to the
    flash backend (bf16); else PyTorch picks, and the backend is named."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q4, k4, v4, do4 = (t.unsqueeze(0) for t in (q, k, v, do))
    if flash_only:
        backend = SDPBackend.FLASH_ATTENTION
    else:
        choice = int(torch._fused_sdp_choice(q4, k4, v4, None, 0.0, causal))
        backend = next(b for b in SDPBackend.__members__.values() if int(b) == choice)
    leaves = [t.detach().clone().requires_grad_() for t in (q4, k4, v4)]
    with sdpa_kernel([backend]):
        fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal))
        both = cuda_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*leaves, is_causal=causal), leaves, do4))
    return {"fwd": fwd, "bwd": both - fwd, "backend": backend.name}


def lse_limit(q, k, scale: float):
    """The most the forward kernel's lse may differ from the plain
    version's: TOL_LSE_ABS on bf16 inputs, where both round the same
    operands. On f32 inputs the kernel rounds q*scale and k to bf16 and the
    plain version does not. Each rounding moves an operand by at most 2^-9
    of itself, so a score moves by at most (2^-8 + 2^-18) * sum_d |q_d *
    scale| * |k_d|, and a row's lse, which moves no further than its
    largest score does, by at most that row's largest such sum (taken over
    every key, visible or not: an upper bound under any mask). Returns one
    limit per query row [BH, Sq], TOL_LSE_ABS included for the f32 exp and
    summation order."""
    if q.dtype != torch.float32:
        return torch.full(q.shape[:2], TOL_LSE_ABS, device=q.device)
    sums = torch.matmul(q.abs() * scale, k.abs().transpose(-1, -2))  # [BH, Sq, Sk]
    return TOL_LSE_ABS + (2**-8 + 2**-18) * sums.amax(-1)


def _split(q, k, v, out, lse, do, causal, scale, kv_lens, kernels: bool = True):
    """The split backward as ``mlpt::flash_bwd_split`` runs it: one prep
    launch (delta and the padded lse rows) and the casts, then dq, then
    dk/dv; the kernels, or with ``kernels=False`` their plain versions."""
    fn = fa.flash_bwd_split_cuda if kernels else fa.flash_bwd_split_reference
    return fn(q, k, v, out, lse, do, causal, scale, kv_lens)


def check_split(q, k, v, do, causal: bool, kv_lens=None, out=None, lse=None, scale: float | None = None,
                fused=None) -> dict:
    """The split pair against its plain versions on the plain forward's out
    and lse (or the given ones), at ``scale`` (default D^-0.5): dq, dk, dv
    finite in the input dtype and within TOL_NORM_REL of their norm; all
    three bit for bit on a second run (nothing is summed across blocks); dk
    and dv exactly 0 at and past each length, dq exactly 0 on a row of
    length 0. With ``fused`` (the fused kernel's (dq, dk, dv) on the same
    inputs), dk and dv equal the fused kernel's bit for bit wherever both
    form k*scale from the same bf16 k (bf16 inputs, or a power-of-two
    scale), and dq, dk, dv lie within TOL_NORM_REL of it. Returns the errors
    against the plain version, the largest dk/dv value past the lens, the
    largest dq on an empty row and the norm_rel against the fused dq."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if out is None:
        out, lse = fa.flash_fwd_reference(q, k, v, causal, scale, kv_lens)
    grads = _split(q, k, v, out, lse, do, causal, scale, kv_lens)
    again = _split(q, k, v, out, lse, do, causal, scale, kv_lens)
    plain = _split(q, k, v, out, lse, do, causal, scale, kv_lens, kernels=False)
    torch.cuda.synchronize()
    what = f"{list(q.shape)} kv {k.shape[1]} {str(q.dtype).split('.')[-1]} causal={causal} scale {scale:.4g} lens {kv_lens}"
    res = {}
    for name, g, p in zip(("dq", "dk", "dv"), grads, plain):
        if g.dtype != q.dtype or g.shape != p.shape or not torch.isfinite(g).all():
            raise AssertionError(f"[split] {name} not finite, or of the wrong type or shape, at {what}")
        res[name] = _errs(g, p)
        if not res[name][1] <= TOL_NORM_REL:
            raise AssertionError(f"[split] {name} norm-relative error {res[name][1]:.3e} > {TOL_NORM_REL} at {what}")
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError(f"[split] dq, dk, dv differ between two runs at {what}")
    past_max = dq_empty = 0.0
    if kv_lens is not None:
        past = torch.arange(k.shape[1], device="cuda")[None, :] >= kv_lens[:, None]  # [BH, Sk]: keys at or past the length
        if past.any():
            past_max = max(g[past].abs().max().item() for g in grads[1:])
        if (kv_lens == 0).any():
            dq_empty = grads[0][kv_lens == 0].abs().max().item()
        if past_max != 0.0 or dq_empty != 0.0:
            raise AssertionError(f"[split] dk/dv past the lens or dq on an empty row not exactly 0 at {what}")
    dq_vs_fused = same_k = None
    if fused is not None:
        same_k = q.dtype == torch.bfloat16 or math.frexp(scale)[0] == 0.5
        if same_k and not (torch.equal(grads[1], fused[1]) and torch.equal(grads[2], fused[2])):
            raise AssertionError(f"[split] dk/dv differ from the fused kernel's at {what}")
        if not all(_errs(a, f)[1] <= TOL_NORM_REL for a, f in zip(grads[1:], fused[1:])):
            raise AssertionError(f"[split] dk/dv differ from the fused kernel's by more than {TOL_NORM_REL} at {what}")
        dq_vs_fused = _errs(grads[0], fused[0])[1]
        if not dq_vs_fused <= TOL_NORM_REL:
            raise AssertionError(f"[split] dq differs from the fused kernel's by {dq_vs_fused:.3e} at {what}")
    return {"grads": grads, "errs": res, "past_max": past_max, "dq_empty": dq_empty, "dq_vs_fused": dq_vs_fused,
            "dkv_as_fused": same_k}


# The forward at its tile edges: q blocks of 64 or 128 rows, key tiles of 64
# or 128, and varlen lengths on and around them.
FWD_EDGE_SEQS = (1, 63, 64, 65, 127, 128, 129, 2049)
FWD_EDGE_KV = ((65, 200), (200, 65), (129, 1), (1, 129), (2049, 300))  # (q_seq, kv_seq)
FWD_EDGE_LENS = (0, 1, 64, 127, 128, 300)  # one per batch row of [6 x 2 heads, 300, D]


def check_forward(q, k, v, causal: bool, kv_lens=None) -> dict:
    """The forward kernel against its plain version: out within
    TOL_NORM_REL of its norm, lse within ``lse_limit``, a second launch bit
    for bit, out exactly 0 on rows of length 0. Returns the kernel's and the
    plain version's out and lse, out's norm_rel, the largest lse error /
    limit and the largest limit."""
    scale = q.shape[-1] ** -0.5
    out, lse = fa.flash_fwd_cuda(q, k, v, causal, scale, kv_lens)
    out2, lse2 = fa.flash_fwd_cuda(q, k, v, causal, scale, kv_lens)
    out_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal, scale, kv_lens)
    torch.cuda.synchronize()
    what = f"{list(q.shape)} kv {k.shape[1]} {str(q.dtype).split('.')[-1]} causal={causal} lens {kv_lens}"
    if out.dtype != q.dtype or lse.dtype != torch.float32 or not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
        raise AssertionError(f"[forward] out or lse not finite or of the wrong type at {what}")
    rel = _errs(out, out_ref)[1]
    limit = lse_limit(q, k, scale)
    margin = ((lse - lse_ref).abs() / limit).max().item()  # at most 1 where every row is within its limit
    if not (rel <= TOL_NORM_REL and margin <= 1.0):
        raise AssertionError(f"[forward] out norm_rel {rel:.3e} or lse error / limit {margin:.3f} beyond its limit at {what}")
    if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
        raise AssertionError(f"[forward] a second forward differs from the first at {what}")
    if kv_lens is not None and (kv_lens == 0).any() and out[kv_lens == 0].any():
        raise AssertionError(f"[forward] a row that sees no key is not 0 at {what}")
    return {"out": out, "lse": lse, "out_ref": out_ref, "lse_ref": lse_ref, "norm_rel": rel, "lse_margin": margin,
            "lse_limit_max": limit.max().item()}


def check_forward_edges(tag: str, dtype: torch.dtype, mode: str) -> None:
    """``check_forward`` at every head dim, causal and not, over the edge
    cases of ``mode``: "seq" (q_seq = kv_seq in FWD_EDGE_SEQS, 3 heads),
    "kv" (FWD_EDGE_KV) or "lens" (varlen, FWD_EDGE_LENS)."""
    g = torch.Generator(device="cuda").manual_seed(50)

    def rand(bh, s, d):
        return torch.randn(bh, s, d, generator=g, device="cuda").to(dtype)

    cases = {"seq": [(s, s) for s in FWD_EDGE_SEQS], "kv": list(FWD_EDGE_KV), "lens": [(300, 300)]}[mode]
    worst_rel = worst_margin = 0.0
    n = 0
    for d in fa.KERNEL_HEAD_DIMS:
        for causal in (True, False):
            for q_seq, kv_seq in cases:
                bh = 2 * len(FWD_EDGE_LENS) if mode == "lens" else 3
                lens = (torch.tensor(FWD_EDGE_LENS, dtype=torch.int32, device="cuda").repeat_interleave(2)
                        if mode == "lens" else None)
                fwd = check_forward(rand(bh, q_seq, d), rand(bh, kv_seq, d), rand(bh, kv_seq, d), causal, lens)
                worst_rel, worst_margin = max(worst_rel, fwd["norm_rel"]), max(worst_margin, fwd["lse_margin"])
                n += 1
    what = {"seq": f"q_seq = kv_seq in {list(FWD_EDGE_SEQS)}", "kv": f"(q_seq, kv_seq) in {list(FWD_EDGE_KV)}",
            "lens": f"[12, 300, D], lens {list(FWD_EDGE_LENS)} x 2 heads"}[mode]
    say(f"{tag} forward at the tile edges, {n} cases, {str(dtype).split('.')[-1]}, D {list(fa.KERNEL_HEAD_DIMS)}, "
        f"causal and not, {what}: worst out norm_rel {worst_rel:.3e}, worst lse error / limit {worst_margin:.3f}, "
        f"every second forward identical")


def check_backward(q, k, v, do, causal: bool, kv_lens=None, out=None, lse=None, scale: float | None = None) -> dict:
    """The fused backward kernel against its plain version on the plain
    forward's out and lse (or the given ones), at ``scale`` (default
    D^-0.5): dq, dk, dv finite in the
    input dtype and within TOL_NORM_REL of their norm; a second launch gives
    dk and dv bit for bit and dq within one bf16 ulp; dk and dv exactly 0 at
    and past each length. Returns the errors against the plain version, the
    largest change of dq between the two launches and the largest dk/dv
    value past the lens."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if out is None:
        out, lse = fa.flash_fwd_reference(q, k, v, causal, scale, kv_lens)
    grads = fa.flash_bwd_cuda(q, k, v, out, lse, do, causal, scale, kv_lens)
    again = fa.flash_bwd_cuda(q, k, v, out, lse, do, causal, scale, kv_lens)
    plain = fa.flash_bwd_reference(q, k, v, out, lse, do, causal, scale, kv_lens)
    torch.cuda.synchronize()
    what = f"{list(q.shape)} kv {k.shape[1]} {str(q.dtype).split('.')[-1]} causal={causal} lens {kv_lens}"
    res = {}
    for name, g, p in zip(("dq", "dk", "dv"), grads, plain):
        if g.dtype != q.dtype or g.shape != p.shape or not torch.isfinite(g).all():
            raise AssertionError(f"[backward] {name} not finite, or of the wrong type or shape, at {what}")
        res[name] = _errs(g, p)
        if not res[name][1] <= TOL_NORM_REL:
            raise AssertionError(f"[backward] {name} norm-relative error {res[name][1]:.3e} > {TOL_NORM_REL} at {what}")
    # dq sums by f32 atomics in an order that changes between runs: a second
    # run may differ by one bf16 ulp of the larger of the two values, plus
    # f32 summation noise (1e-6) where terms cancel to near zero; dk and dv
    # have no atomics and repeat exactly
    dq_diff = (again[0].float() - grads[0].float()).abs()
    dq_ulp = torch.maximum(again[0].float().abs(), grads[0].float().abs()) * 2.0**-7 + 1e-6
    if not (torch.equal(again[1], grads[1]) and torch.equal(again[2], grads[2])):
        raise AssertionError(f"[backward] dk/dv differ between two runs at {what}")
    if not bool((dq_diff <= dq_ulp).all()):
        raise AssertionError(f"[backward] dq differs by more than one bf16 ulp between two runs at {what}")
    past_max = 0.0
    if kv_lens is not None:
        past = torch.arange(k.shape[1], device="cuda")[None, :] >= kv_lens[:, None]  # [BH, Sk]: keys at or past the length
        if past.any():
            past_max = max(g[past].abs().max().item() for g in grads[1:])
        if past_max != 0.0:
            raise AssertionError(f"[backward] dk/dv past the lens not exactly 0 at {what}")
    return {"grads": grads, "errs": res, "dq_change": dq_diff.max().item(), "past_max": past_max}


# The fused backward at its tile edges: 64-row q and k blocks, and varlen
# lengths on and around them. A query alone (q_seq 1, or a causal row 0)
# sees one key, where ds = p (dp - delta) is rounding noise on both sides,
# so q_seq 1 runs non-causal only.
BWD_EDGE_SEQS = (17, 63, 64, 65, 127, 128, 129, 2049)
BWD_EDGE_KV = ((1, 129), (65, 200), (200, 65), (129, 130), (2049, 300), (300, 2049))  # (q_seq, kv_seq)
BWD_EDGE_LENS = (0, 1, 63, 64, 65, 127, 128, 300)  # one per batch row of [8 x 2 heads, 300, D]


def backward_edge_cases(dtype: torch.dtype, seed: int):
    """(q, k, v, dO, causal, kv_lens) at every head dim, causal and not, over
    q_seq = kv_seq in BWD_EDGE_SEQS (3 heads), (q_seq, kv_seq) in
    BWD_EDGE_KV and the varlen lengths BWD_EDGE_LENS."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(bh, s, d):
        return torch.randn(bh, s, d, generator=g, device="cuda").to(dtype)

    lens = torch.tensor(BWD_EDGE_LENS, dtype=torch.int32, device="cuda").repeat_interleave(2)
    cases = [(s, s, None) for s in BWD_EDGE_SEQS] + [(q, kv, None) for q, kv in BWD_EDGE_KV] + [(300, 300, lens)]
    for d in fa.KERNEL_HEAD_DIMS:
        for causal in (True, False):
            for q_seq, kv_seq, kv_lens in cases:
                if causal and q_seq == 1:
                    continue
                bh = 3 if kv_lens is None else len(kv_lens)
                yield rand(bh, q_seq, d), rand(bh, kv_seq, d), rand(bh, kv_seq, d), rand(bh, q_seq, d), causal, kv_lens


BWD_EDGES_SHOWN = (f"D {list(fa.KERNEL_HEAD_DIMS)}, causal and not, q_seq = kv_seq in {list(BWD_EDGE_SEQS)}, "
                   f"(q_seq, kv_seq) in {list(BWD_EDGE_KV)}, [16, 300, D] lens {list(BWD_EDGE_LENS)} x 2 heads")


def check_backward_edges(tag: str, dtype: torch.dtype) -> None:
    """``check_backward`` over ``backward_edge_cases``."""
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    dq_change = 0.0
    n = 0
    for q, k, v, do, causal, kv_lens in backward_edge_cases(dtype, 51):
        r = check_backward(q, k, v, do, causal, kv_lens)
        worst = {m: max(worst[m], r["errs"][m][1]) for m in worst}
        dq_change = max(dq_change, r["dq_change"])
        n += 1
    say(f"{tag} fused backward at the tile edges, {n} cases, {str(dtype).split('.')[-1]}, {BWD_EDGES_SHOWN}: worst "
        "norm_rel " + ", ".join(f"{m} {r:.3e}" for m, r in worst.items())
        + f"; dk/dv identical on every second run, dq max change {dq_change:.3e}, dk/dv past the lens exactly 0")


def check_split_edges(tag: str, dtype: torch.dtype) -> None:
    """``check_split`` over ``backward_edge_cases``, each also held against
    the fused kernel on the same inputs (dk and dv bit for bit where both
    form k*scale from the same bf16 k)."""
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    n = n_same = 0
    for q, k, v, do, causal, kv_lens in backward_edge_cases(dtype, 52):
        scale = q.shape[-1] ** -0.5
        out, lse = fa.flash_fwd_reference(q, k, v, causal, scale, kv_lens)
        fused = fa.flash_bwd_cuda(q, k, v, out, lse, do, causal, scale, kv_lens)
        r = check_split(q, k, v, do, causal, kv_lens, out, lse, fused=fused)
        worst = {m: max(worst[m], r["errs"][m][1]) for m in worst}
        n += 1
        n_same += bool(r["dkv_as_fused"])
    say(f"{tag} split pair at the fused backward's tile edges, {n} cases, {str(dtype).split('.')[-1]}, "
        f"{BWD_EDGES_SHOWN}: worst norm_rel " + ", ".join(f"{m} {r:.3e}" for m, r in worst.items())
        + f"; dq, dk, dv identical on every second run, dk/dv past the lens exactly 0, dk/dv identical to the "
          f"fused kernel's in {n_same} of {n} cases (the rest f32 at D=128, whose k*scale the fused kernel rounds "
          f"twice)")


def fwd_flops(q, k, causal: bool, kv_lens=None) -> float:
    """The forward's products: 2 x 2·D FLOP per visible (query, key) pair."""
    return 4 * q.shape[-1] * visible_pairs(q.shape[0], q.shape[1], k.shape[1], causal, kv_lens)


def bwd_flops(q, k, causal: bool, kv_lens=None) -> float:
    """The backward's products: 5 x 2·D FLOP per visible (query, key) pair."""
    return 10 * q.shape[-1] * visible_pairs(q.shape[0], q.shape[1], k.shape[1], causal, kv_lens)


def say_backward(shape, what: str, ms: float, flops: float, bnd: dict, lib: dict) -> None:
    """The fused backward's time beside what it achieves, its bound and PyTorch's call."""
    say(f"[yardstick] fused backward {list(shape)} {what}: {ms:.4f} ms a call, {flops / ms / 1e9:.1f} TFLOP/s, "
        f"{bnd['bound_ms'] / ms:.3f} of the bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); "
        f"PyTorch ({lib['backend']}) {lib['bwd']:.4f} ms, ours / PyTorch {ms / lib['bwd']:.3f}")


def say_forward(shape, what: str, ms: float, ms_alone: float, flops: float, bnd: dict, lib: dict) -> None:
    """The forward's time beside what it achieves, its bound and PyTorch's call."""
    say(f"[forward] {list(shape)} {what}: {ms:.4f} ms a call ({ms_alone:.4f} ms timed alone), "
        f"{flops / ms / 1e9:.1f} TFLOP/s, {bnd['bound_ms'] / ms:.3f} of the bound {bnd['bound_ms']:.4f} ms "
        f"({bnd['bound_by']}); PyTorch ({lib['backend']}) {lib['fwd']:.4f} ms, ours / PyTorch {ms / lib['fwd']:.3f}")


def check_kernels_at(shape, causal: bool, seed: int = 0, lens: list[int] | None = None,
                     dtype: torch.dtype = torch.bfloat16, split: bool = False, tag: str | None = None) -> dict:
    """The forward (``check_forward``) and the fused backward kernel
    (``check_backward``) against their plain versions on identical inputs.
    With ``lens`` (one per batch row, broadcast over heads as
    ``flash_attention`` does) all run in varlen mode. With ``split``, the
    split pair too: dq, dk, dv within TOL_NORM_REL of its plain versions and
    of the fused kernel, all three bit for bit on a second run (nothing is
    summed across blocks), dk and dv exactly 0 past the lens and dq exactly 0
    on a row of length 0. Returns the errors against the plain versions."""
    b, h, s, _ = shape
    q, k, v, do = _inputs(shape, seed, dtype)
    scale = shape[-1] ** -0.5
    kv_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda").repeat_interleave(h)
    tag = tag or ("[split]" if split else "[kernels]" if lens is None else "[varlen]")
    shown = lens if lens is None or len(lens) <= 16 else f"{len(lens)} in [{min(lens)}, {max(lens)}]"
    what = f"{list(shape)} {str(dtype).split('.')[-1]} causal={causal}{'' if lens is None else f' lens {shown}'}"
    fwd = check_forward(q, k, v, causal, kv_lens)
    out_ref, lse_ref = fwd["out_ref"], fwd["lse_ref"]
    bwd = check_backward(q, k, v, do, causal, kv_lens, out_ref, lse_ref)
    res = {"out": _errs(fwd["out"], out_ref), "lse": _errs(fwd["lse"], lse_ref), **bwd["errs"]}
    past_max, dq_empty, split_line = bwd["past_max"], 0.0, ""
    if split:
        sp = check_split(q, k, v, do, causal, kv_lens, out_ref, lse_ref, fused=bwd["grads"])
        res.update({"split_" + n: e for n, e in sp["errs"].items()})
        past_max, dq_empty = max(past_max, sp["past_max"]), sp["dq_empty"]
        split_line = (f"; split pair second run identical True, dk/dv "
                      + ("identical to the fused kernel's" if sp["dkv_as_fused"] else "not compared bit for bit (f32, odd scale)")
                      + f", dq vs fused norm_rel {sp['dq_vs_fused']:.3e}")
    say(f"{tag} {what}: " + ", ".join(f"{n} max_abs {a:.3e} norm_rel {r:.3e}" for n, (a, r) in res.items())
        + f"; lse error / limit max {fwd['lse_margin']:.3f} (limit max {fwd['lse_limit_max']:.3e})"
        + ("" if lens is None else f"; dk/dv past the lens max_abs {past_max:.1e}")
        + (f", dq on empty rows {dq_empty:.1e}" if split and lens is not None else ""))
    say(f"{tag} {what} second backward run: dq max_abs change {bwd['dq_change']:.3e}, dk/dv identical True"
        + split_line)
    return res


def phase_kernels() -> tuple[dict, list[dict]]:
    """Returns the times at pythia's shape and the kernels line's entries."""
    errs = check_kernels_at(SLICE_SHAPE, causal=True)
    check_kernels_at(RAGGED_SHAPE, causal=True, seed=1)
    check_kernels_at(RAGGED_SHAPE, causal=False, seed=2)
    check_forward_edges("[kernels]", torch.bfloat16, "seq")
    check_forward_edges("[kernels]", torch.bfloat16, "kv")
    check_backward_edges("[kernels]", torch.bfloat16)

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
    say(f"[kernels] ms a call at {list(SLICE_SHAPE)} bf16 causal: " + ", ".join(f"{n} {ms:.3f}" for n, ms in t.items()))
    lib = sdpa_ms(q, k, v, do, True, flash_only=True)
    bounds = attention_bounds(q, k, v, do, True)
    say_yardstick(SLICE_SHAPE, "bf16 causal", lib, bounds)
    say_forward(SLICE_SHAPE, "bf16 causal", t["fwd"], cuda_ms_alone(lambda: fa.flash_fwd_cuda(q, k, v, True, scale)),
                fwd_flops(q, k, True), bounds["fwd"], lib)
    say_backward(SLICE_SHAPE, "bf16 causal", t["bwd"], bwd_flops(q, k, True), bounds["bwd"], lib)
    max_grad_err = max(errs[n][0] for n in ("dq", "dk", "dv"))
    return {"ms": t, "library": lib}, [
        {"name": "flash_fwd", "route": "cuda", "source": FWD_SOURCE, "replaces": f"{JAX_FLASH}:91",
         "launches": None, "max_abs_err": errs["out"][0], "ms": t["fwd"], "plain_ms": t["fwd_plain"],
         **bounds["fwd"], "library_ms": lib["fwd"]},
        {"name": "flash_bwd_fused", "route": "cuda", "source": BWD_SOURCE, "replaces": f"{JAX_FLASH}:208",
         "launches": None, "max_abs_err": max_grad_err, "ms": t["bwd"], "plain_ms": t["bwd_plain"],
         **bounds["bwd"], "library_ms": lib["bwd"]},
    ]


def say_yardstick(shape, what: str, lib: dict, bounds: dict) -> None:
    say(f"[yardstick] {list(shape)} {what}: PyTorch attention ({lib['backend']}) fwd {lib['fwd']:.3f} ms, "
        f"bwd {lib['bwd']:.3f} ms; bounds " + ", ".join(
            f"{n} {b['bound_ms']:.4f} ms ({b['bound_by']})" for n, b in bounds.items()))


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
    if hasattr(module, "vilt"):
        return f"{len(module.vilt.layers)} trunk layers, tasks {'+'.join(module.target_tasks)}"
    if hasattr(module, "depths"):
        return f"stages of {list(module.depths)} blocks"
    return f"{len(module.vision_tower.layers)} tower + {len(module.language_model.layers)} decoder layers"


# PREFER_FUSED_BWD per step: one warmup under each backward, then 3 timed
# steps under each, in turns
AB_SCHEDULE = (True, False, True, False, False, True, True, False)
AB_WARMUP = 2


def drive_training(model_type: str, mbs: int, acc: int, remat: bool, counters, *, loss_band: tuple[float, float],
                   layout: str = "bf16_sr", names=("FWD_LAUNCHES", "BWD_LAUNCHES"),
                   tokens_per_sample: int | None = None, split_ab: bool = False, steps: int = 4,
                   policy: str = "flash", fused: bool = True, on_init=None, after=None) -> dict:
    """The training step through the user's entry points with the model's
    own optimizer and schedule: 1 warmup + ``steps`` - 1 timed steps under
    the fused backward (the split one with ``fused`` False), or with
    ``split_ab`` the fused/split schedule ``AB_SCHEDULE`` in one session.
    With ``remat``, under ``policy``. ``on_init(sess, state)`` runs after
    the state is made, before the counters and the peak memory are reset;
    ``after(sess, state)`` after the steps and their checks.
    ``layout`` is one of ``profile_step.make_plan``'s. ``counters`` is the
    kernel module whose launch counts ``names`` are zeroed just before the
    steps and read just after, and so are the LM-head loss's
    (``ops/xent.py``), returned as ``xent``, RMSNorm's
    (``ops/rmsnorm.py``), returned as ``rmsnorm``, and the causal conv's
    (``ops/causal_conv.py``), returned as ``conv``. The first loss must lie in
    ``loss_band``.
    For a model with a trainable mask, every frozen parameter must come out
    bit for bit and every trainable one must have moved; in the f32 layout
    every parameter and moment must be f32. Returns the module, the number
    of micro-batches under each backward, the launch counts, the losses,
    the median step of each backward, the peak memory and the dropout
    generator's state after the steps."""
    from multimodal_llm_pretraining_tpu_torch.models import get_model_class
    from multimodal_llm_pretraining_tpu_torch.ops import causal_conv, rmsnorm, xent
    from multimodal_llm_pretraining_tpu_torch.profile_step import make_plan
    from multimodal_llm_pretraining_tpu_torch.utils import block_on

    mc = get_model_class(model_type)
    sr = layout == "bf16_sr"
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sess = make_plan(mc, mbs, acc, remat, layout, policy).build_session(mc, device="cuda")
    state = sess.init_state()
    step = sess.train_step_fn()
    block_on("cuda")
    # the run's name in every line below: the model, and its remat
    if remat and model_type.startswith("pythia"):
        model_type = f"{model_type} remat {policy}"
    elif remat and model_type != "mamba":
        model_type = f"{model_type} remat"
    say(f"[main] {model_type} session built and initialised in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in state.params.values())} parameters, "
        f"{sum(state.params[n].numel() for n in sess.trainable)} trainable, {_depth(sess.module)})")
    masked = sess.bundle.trainable_mask is not None
    # on the host, so that the peak memory below is the steps' own
    before = {n: p.detach().cpu() for n, p in state.params.items()} if masked else {}

    if on_init is not None:
        on_init(sess, state)
    schedule, warmup = (AB_SCHEDULE, AB_WARMUP) if split_ab else ((fused,) * steps, 1)
    torch.cuda.reset_peak_memory_stats()
    counters.reset_launch_counts()
    xent.reset_launch_counts()
    rmsnorm.reset_launch_counts()
    causal_conv.reset_launch_counts()
    attn.XLA_BRANCH_CALLS = 0
    losses, times = [], []
    try:
        for i, fused in enumerate(schedule):
            fa.PREFER_FUSED_BWD = fused
            batch = sess.make_train_batch(seed=i)
            block_on("cuda")
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            loss = float(metrics["loss"])  # reads the loss back: waits for the step
            block_on("cuda")
            times.append(time.perf_counter() - t0)
            losses.append(loss)
            say(f"[main] {model_type} step {i}{' (warmup)' if i < warmup else ''}"
                f"{(' ' + ('fused' if fused else 'split') + ' backward') if split_ab or not fused else ''}: "
                f"loss {loss:.5f}, {times[-1]:.3f} s")
    finally:
        fa.PREFER_FUSED_BWD = True
    launches = {n: getattr(counters, n) for n in names}
    xent_launches = {"xent_fwd": xent.XENT_FWD_LAUNCHES, "xent_bwd": xent.XENT_BWD_LAUNCHES}
    norm_launches = {"rmsnorm_fwd": rmsnorm.RMSNORM_FWD_LAUNCHES, "rmsnorm_bwd": rmsnorm.RMSNORM_BWD_LAUNCHES}
    conv_launches = {"causal_conv_fwd": causal_conv.CONV_FWD_LAUNCHES, "causal_conv_bwd": causal_conv.CONV_BWD_LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    if attn.XLA_BRANCH_CALLS != 0:
        raise AssertionError(f"{model_type}: {attn.XLA_BRANCH_CALLS} attention calls took the xla branch")

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
    if layout == "f32" and not all(t.dtype == torch.float32 for t in (
            *state.params.values(), *state.opt_state.mu, *state.opt_state.nu)):
        raise AssertionError(f"{model_type}: not the f32 layout (f32 parameters and moments)")
    samples = mbs * acc
    tokens = samples * (tokens_per_sample or mc.sequence_length)
    medians = {}
    for fused in sorted(set(schedule), reverse=True):
        timed = [t for t, f in zip(times[warmup:], schedule[warmup:]) if f == fused]
        medians[fused] = step_s = statistics.median(timed)
        say(f"[main] {model_type}{(' ' + ('fused' if fused else 'split') + ' backward') if split_ab or not fused else ''} "
            f"median step {step_s:.4f} s over {len(timed)} steps, {samples / step_s:.2f} samples/s, "
            f"{tokens / step_s:.1f} tokens/s")
    if split_ab:
        say(f"[main] {model_type} fused vs split backward, median step: {medians[True]:.4f} vs {medians[False]:.4f} s "
            f"(split / fused {medians[False] / medians[True]:.4f})")
    say(f"[main] {model_type} peak memory {peak} bytes ({peak / 2**30:.2f} GiB), launches "
        + ", ".join(f"{n} {c}" for n, c in (launches | xent_launches | norm_launches | conv_launches).items())
        + ", xla-branch attention calls 0")
    if after is not None:
        after(sess, state)
    return {"module": sess.module, "launches": launches, "xent": xent_launches, "rmsnorm": norm_launches,
            "conv": conv_launches, "micro_batches": {fused: acc * schedule.count(fused) for fused in (True, False)},
            "losses": losses, "medians": medians, "peak": peak, "dropout_state": sess.dropout_generator.get_state()}


def flash_launches_expected(names, plain_layers: int, varlen_layers: int, micro_batches: dict,
                            plain_bwd: bool = True) -> dict:
    """Flash launch counts of a run whose micro-batches ran ``micro_batches``
    [fused] under the fused and [split] under the split backward: one
    forward per attention layer and micro-batch, and one fused backward, or
    one dq and one dk/dv, per differentiated layer (the plain-mode layers
    only where ``plain_bwd``)."""
    total, fused, split = micro_batches[True] + micro_batches[False], micro_batches[True], micro_batches[False]
    bwd_layers = plain_layers if plain_bwd else 0
    counts = {"FWD_LAUNCHES": plain_layers * total, "BWD_LAUNCHES": bwd_layers * fused,
              "DQ_LAUNCHES": bwd_layers * split, "DKV_LAUNCHES": bwd_layers * split,
              "VARLEN_FWD_LAUNCHES": varlen_layers * total, "VARLEN_BWD_LAUNCHES": varlen_layers * fused,
              "VARLEN_DQ_LAUNCHES": varlen_layers * split, "VARLEN_DKV_LAUNCHES": varlen_layers * split}
    return {n: counts[n] for n in names}


def flash_launch_entries(launches: dict) -> dict:
    """The run's counters under the kernels JSON line's names."""
    return {"flash_fwd": launches["FWD_LAUNCHES"], "flash_bwd_fused": launches["BWD_LAUNCHES"],
            "flash_bwd_dq": launches["DQ_LAUNCHES"], "flash_bwd_dkv": launches["DKV_LAUNCHES"],
            "flash_fwd_varlen": launches["VARLEN_FWD_LAUNCHES"],
            "flash_bwd_fused_varlen": launches["VARLEN_BWD_LAUNCHES"],
            "flash_bwd_dq_varlen": launches["VARLEN_DQ_LAUNCHES"],
            "flash_bwd_dkv_varlen": launches["VARLEN_DKV_LAUNCHES"]}


def xent_launch_entries(run: dict, model_type: str, chunks: int | None = None) -> dict:
    """The run's LM-head loss launches (``drive_training``'s ``xent``):
    ``chunks`` of each kernel a micro-batch where given (its tokens over the
    loss's chunks of 1024), else at least one of each."""
    got = run["xent"]
    if chunks is None:
        ok, want = got["xent_fwd"] > 0 and got["xent_bwd"] > 0, "at least one of each"
    else:
        n = chunks * sum(run["micro_batches"].values())
        ok, want = got == {"xent_fwd": n, "xent_bwd": n}, f"{n} of each"
    if not ok:
        raise AssertionError(f"{model_type}: LM-head loss launches {got}, expected {want}")
    return dict(got)


# pythia-1b's LM-head loss a micro-batch of 4 rows: 4 x 2048 shifted tokens, 8 chunks of 1024
PYTHIA_MBS4_XENT_CHUNKS = 8


FLASH_COUNTERS = ("FWD_LAUNCHES", "BWD_LAUNCHES", "DQ_LAUNCHES", "DKV_LAUNCHES", "VARLEN_FWD_LAUNCHES",
                  "VARLEN_BWD_LAUNCHES", "VARLEN_DQ_LAUNCHES", "VARLEN_DKV_LAUNCHES")


def phase_main_path() -> dict:
    """pythia-1b: bench.py's recipe, without remat (phase 18 runs its remat)
    at acc 2, under the fused and the split backward;
    every attention call on the plain-mode kernels."""
    run = drive_training("pythia-1b", mbs=4, acc=2, remat=False, counters=fa, loss_band=TEXT_LOSS_BAND,
                         names=FLASH_COUNTERS, split_ab=True)
    expected = flash_launches_expected(FLASH_COUNTERS, len(run["module"].layers), 0, run["micro_batches"])
    if run["launches"] != expected:
        raise AssertionError(f"pythia flash launches {run['launches']}, expected {expected}")
    return flash_launch_entries(run["launches"]) | xent_launch_entries(run, "pythia-1b", PYTHIA_MBS4_XENT_CHUNKS)


# ---------------------------------------------------------------- selective scan


def _scan_inputs(shape, dtype, seed: int, d_state: int = 16):
    """u, delta, A, B, C, D, dy on the card; delta in (0.01, 0.51) and A in
    -(0.5, 1.5) as in the JAX suite's scan tests."""
    b, L, I = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn(b, L, I, generator=g, device="cuda").to(dtype)
    delta = (torch.rand(b, L, I, generator=g, device="cuda") * 0.5 + 0.01).to(dtype)
    A = -(torch.rand(I, d_state, generator=g, device="cuda") + 0.5)
    B, C = (torch.randn(b, L, d_state, generator=g, device="cuda").to(dtype) for _ in range(2))
    D = torch.randn(I, generator=g, device="cuda")
    dy = torch.randn(b, L, I, generator=g, device="cuda")
    return u, delta, A, B, C, D, dy


def check_scan_at(shape, dtype, seed: int = 0, d_state: int = 16) -> dict:
    """Both scan kernels vs their plain versions on identical inputs: the
    forward before the D skip and with it (y in u's dtype), dD through the
    autograd Function, and a second forward (with the skip) and backward
    run bit for bit; returns the errors. Launches: the forward 4 calls (3
    here, 1 in the Function), the backward 3 (2 here, 1 in the Function)."""
    u, delta, A, B, C, D, dy = _scan_inputs(shape, dtype, seed, d_state)
    y, ckpt = ssf.selective_scan_fwd_cuda(u, delta, A, B, C)
    y_ref, ckpt_ref = ssf.selective_scan_fwd_reference(u, delta, A, B, C)
    ys, ckpt_s = ssf.selective_scan_fwd_cuda(u, delta, A, B, C, D)
    ys_ref, _ = ssf.selective_scan_fwd_reference(u, delta, A, B, C, D)
    again = ssf.selective_scan_fwd_cuda(u, delta, A, B, C, D)
    same = ys.dtype == dtype and torch.equal(ckpt_s, ckpt) and all(torch.equal(a, b) for a, b in zip(again, (ys, ckpt_s)))
    say(f"[scan] {list(shape)} N{d_state} {str(dtype).split('.')[-1]} second forward run: y (with the skip, "
        f"{str(ys.dtype).split('.')[-1]}) and checkpoint identical {same}")
    if not same:
        raise AssertionError(f"the scan forward differs between two runs (or from its pre-skip run) at {shape} {dtype}")
    grads = ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt_ref)
    grads_ref = ssf.selective_scan_bwd_reference(u, delta, A, B, C, dy, ckpt_ref)
    leaves = [t.clone().requires_grad_() for t in (u, delta, A, B, C, D)]
    g = dy.to(dtype)
    ssf.selective_scan_fused(*leaves).backward(g)
    dD_ref = (g.float() * u.float()).sum((0, 1))
    torch.cuda.synchronize()
    got = {"y": (y, y_ref), "y+skip": (ys, ys_ref), "ckpt": (ckpt, ckpt_ref), "dD": (leaves[5].grad, dD_ref)}
    got.update({n: pair for n, pair in zip(("du", "ddelta", "dA", "dB", "dC"), zip(grads, grads_ref))})
    res = {}
    for name, (a, b) in got.items():
        if not torch.isfinite(a).all():
            raise AssertionError(f"scan {name} has non-finite values at {shape} {dtype}")
        res[name] = _errs(a, b)
        tol = TOL_SCAN_GRAD if name not in ("y", "y+skip") else (
            TOL_SCAN_Y_BF16 if name == "y+skip" and dtype == torch.bfloat16 else TOL_SCAN_Y)
        say(f"[scan] {list(shape)} N{d_state} {str(dtype).split('.')[-1]} {name}: max_abs {res[name][0]:.3e} "
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

    u, delta, A, B, C, D, dy = _scan_inputs(SCAN_SHAPE, torch.bfloat16, 12)
    _, ckpt = ssf.selective_scan_fwd_reference(u, delta, A, B, C)
    t = {  # the forward with D, as selective_scan_fused runs it
        "fwd": cuda_ms(lambda: ssf.selective_scan_fwd_cuda(u, delta, A, B, C, D)),
        "fwd_plain": cuda_ms(lambda: ssf.selective_scan_fwd_reference(u, delta, A, B, C, D)),
        "bwd": cuda_ms(lambda: ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt)),
        "bwd_plain": cuda_ms(lambda: ssf.selective_scan_bwd_reference(u, delta, A, B, C, dy, ckpt)),
    }
    say(f"[scan] ms a call at {list(SCAN_SHAPE)} N16 bf16: " + ", ".join(f"{n} {ms:.3f}" for n, ms in t.items()))
    # what each function must do per (batch, step, channel, state): the
    # forward one exp (exp(delta*A)) and 6 f32 operations (delta*A, the
    # decay, delta*u*B and its add, C*h and its sum); the backward the same
    # exp and 16 (the recomputed state, the reverse-time dh recurrence, the
    # du, ddelta, dA, dB, dC terms). Bytes: the inputs and outputs as given
    # (the forward's y in u's dtype, with the skip).
    y, ckpt = ssf.selective_scan_fwd_cuda(u, delta, A, B, C, D)
    grads = ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt)
    elems = u.numel() * A.shape[-1]
    ins = _nbytes(u, delta, A, B, C)
    work = {
        "fwd": (ins + _nbytes(D, y, ckpt), 6 * elems, PEAK_F32_FLOPS, elems),
        "bwd": (ins + _nbytes(dy, ckpt, *grads), 16 * elems, PEAK_F32_FLOPS, elems),
    }
    bounds = {n: bound(*w) for n, w in work.items()}
    for n, b in bounds.items():
        say(f"[scan] {n} bound at {list(SCAN_SHAPE)}: {b['bound_ms']:.4f} ms ({b['bound_by']}); {bound_terms(*work[n])}")
    say(f"[scan] forward with the skip at {list(SCAN_SHAPE)} bf16: {t['fwd']:.4f} ms a call, "
        f"{bounds['fwd']['bound_ms'] / t['fwd']:.3f} of its bound; the earlier design's {SCAN_FWD_EARLIER_MS} ms (one "
        f"state a thread, synchronous staging, f32 y before the wrapper's skip; H100 SXM, 700 W) is "
        f"{SCAN_FWD_EARLIER_MS / t['fwd']:.2f}x this")
    say(f"[scan] backward at {list(SCAN_SHAPE)} bf16: {t['bwd']:.4f} ms a call, {bounds['bwd']['bound_ms'] / t['bwd']:.3f} "
        f"of its bound; the earlier design's {SCAN_BWD_EARLIER_MS} ms (one state a thread, synchronous staging; "
        f"H100 SXM, 700 W) is {SCAN_BWD_EARLIER_MS / t['bwd']:.2f}x this")
    return [
        {"name": "scan_fwd", "route": "cuda", "source": SCAN_SOURCE, "replaces": f"{JAX_SCAN}:47",
         "launches": None, "max_abs_err": errs["y+skip"][0], "ms": t["fwd"], "plain_ms": t["fwd_plain"],
         **bounds["fwd"], "library_ms": None},
        {"name": "scan_bwd", "route": "cuda", "source": SCAN_SOURCE, "replaces": f"{JAX_SCAN}:161",
         "launches": None, "max_abs_err": max(errs[n][0] for n in ("du", "ddelta", "dA", "dB", "dC")),
         "ms": t["bwd"], "plain_ms": t["bwd_plain"], **bounds["bwd"], "library_ms": None},
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
    """mamba-2.8b at full width and depth with block remat: every scan and
    conv call on the kernels, the forward twice per block and micro-batch
    (the remat recompute runs it again) and the backward once."""
    run = drive_training("mamba", mbs=2, acc=2, remat=True, counters=ssf, loss_band=TEXT_LOSS_BAND)
    run["launches"] = tuple(run["launches"].values())
    micro_batches = sum(run["micro_batches"].values())
    calls = len(run["module"].layers) * micro_batches
    if run["launches"] != (2 * calls, calls):
        raise AssertionError(f"scan launches {run['launches']}, expected ({2 * calls}, {calls})")
    # each block's norm forward twice (its replay), backward once, and the final norm's once each
    norms = {"rmsnorm_fwd": 2 * calls + micro_batches, "rmsnorm_bwd": calls + micro_batches}
    if run["rmsnorm"] != norms:
        raise AssertionError(f"mamba: rmsnorm launches {run['rmsnorm']}, expected {norms}")
    # each block's conv forward twice (its replay) and backward once
    convs = {"causal_conv_fwd": 2 * calls, "causal_conv_bwd": calls}
    if run["conv"] != convs:
        raise AssertionError(f"mamba: causal-conv launches {run['conv']}, expected {convs}")
    return ({"scan_fwd": run["launches"][0], "scan_bwd": run["launches"][1]} | xent_launch_entries(run, "mamba")
            | run["rmsnorm"] | run["conv"])


# ---------------------------------------------------------------- varlen flash attention (llava)


def _ragged_lens(b: int, s: int, seed: int) -> list[int]:
    """One full row, one shorter than a tile, one ending on a tile edge (64,
    a multiple of both kernels' key tiles), the rest random in [1, s]."""
    edge = (s - 1) // 64 * 64
    rest = np.random.default_rng(seed).integers(1, s + 1, max(b - 3, 0)).tolist()
    return [s, 37, edge, *rest][:b]


def phase_varlen_kernels() -> tuple[dict, list[dict]]:
    """Returns the times at the decoder's shape (full lens) and the kernels
    line's entries."""
    # full f32 products in the plain versions (the main paths' plans turned TF32 on)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    errs = check_kernels_at(VARLEN_SHAPE, True, seed=20, lens=_ragged_lens(VARLEN_SHAPE[0], VARLEN_SHAPE[2], 0))
    check_kernels_at(TOWER_SHAPE, False, seed=21, lens=_ragged_lens(TOWER_SHAPE[0], TOWER_SHAPE[2], 1))
    for causal in (True, False):
        check_kernels_at(VARLEN_RAGGED, causal, seed=22 + causal, lens=[77, 37, 64, 0])
    check_kernels_at(TOWER_SHAPE, False, seed=24)  # the tower's own call: plain mode, non-causal
    check_forward_edges("[varlen]", torch.bfloat16, "lens")

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
    say(f"[varlen] ms a call at {list(VARLEN_SHAPE)} bf16 causal, full lens: "
        + ", ".join(f"{n} {ms:.3f}" for n, ms in t.items()))
    # full lens: the same function as plain causal attention, which is what
    # PyTorch's flash backend (no per-row lengths) computes
    lib = sdpa_ms(q, k, v, do, True, flash_only=True)
    bounds = attention_bounds(q, k, v, do, True, full)
    say_yardstick(VARLEN_SHAPE, "bf16 causal, full lens", lib, bounds)
    say_forward(VARLEN_SHAPE, "bf16 causal, varlen mode, full lens", t["fwd"],
                cuda_ms_alone(lambda: fa.flash_fwd_cuda(q, k, v, True, scale, full)), fwd_flops(q, k, True, full),
                bounds["fwd"], lib)
    say_backward(VARLEN_SHAPE, "bf16 causal, varlen mode, full lens", t["bwd"], bwd_flops(q, k, True, full),
                 bounds["bwd"], lib)
    del q, k, v, do, out, lse
    q, k, v, do = _inputs(TOWER_SHAPE, 24)
    tower_scale = TOWER_SHAPE[-1] ** -0.5
    tower = {
        "fwd": cuda_ms(lambda: fa.flash_fwd_cuda(q, k, v, False, tower_scale)),
        "fwd_plain": cuda_ms(lambda: fa.flash_fwd_reference(q, k, v, False, tower_scale)),
    }
    say(f"[varlen] ms a call at the tower's {list(TOWER_SHAPE)} bf16 non-causal, plain mode: "
        + ", ".join(f"{n} {ms:.3f}" for n, ms in tower.items()))
    tower_lib = sdpa_ms(q, k, v, do, False, flash_only=True)
    tower_bound = attention_bounds(q, k, v, do, False)["fwd"]
    say_yardstick(TOWER_SHAPE, "bf16 non-causal", tower_lib, {"fwd": tower_bound})
    say_forward(TOWER_SHAPE, "bf16 non-causal", tower["fwd"],
                cuda_ms_alone(lambda: fa.flash_fwd_cuda(q, k, v, False, tower_scale)), fwd_flops(q, k, False),
                tower_bound, tower_lib)
    return {"ms": t, "library": lib}, [
        {"name": "flash_fwd_varlen", "route": "cuda", "source": FWD_SOURCE, "replaces": f"{JAX_FLASH}:91",
         "launches": None, "max_abs_err": errs["out"][0], "ms": t["fwd"], "plain_ms": t["fwd_plain"],
         **bounds["fwd"], "library_ms": lib["fwd"]},
        {"name": "flash_bwd_fused_varlen", "route": "cuda", "source": BWD_SOURCE, "replaces": f"{JAX_FLASH}:208",
         "launches": None, "max_abs_err": max(errs[n][0] for n in ("dq", "dk", "dv")), "ms": t["bwd"],
         "plain_ms": t["bwd_plain"], **bounds["bwd"], "library_ms": lib["bwd"]},
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
    plain-mode backward (the frozen tower is not differentiated). Under the
    split backward the decoder's backwards are one varlen dq and one varlen
    dk/dv kernel each."""
    run = drive_training("llava-pretrain", mbs=16, acc=2, remat=False, counters=fa, loss_band=LLAVA_LOSS_BAND,
                         layout="bf16", names=FLASH_COUNTERS, tokens_per_sample=LLAVA_TOKENS_PER_SAMPLE,
                         split_ab=True)
    mod = run["module"]
    expected = flash_launches_expected(FLASH_COUNTERS, len(mod.vision_tower.layers), len(mod.language_model.layers),
                                       run["micro_batches"], plain_bwd=False)
    if run["launches"] != expected:
        raise AssertionError(f"llava launches {run['launches']}, expected {expected}")
    # the decoder's two norms a layer and its final norm, forward and backward (the gradient reaches the projector)
    n = (2 * len(mod.language_model.layers) + 1) * sum(run["micro_batches"].values())
    if run["rmsnorm"] != {"rmsnorm_fwd": n, "rmsnorm_bwd": n}:
        raise AssertionError(f"llava: rmsnorm launches {run['rmsnorm']}, expected {n} of each")
    return flash_launch_entries(run["launches"]) | xent_launch_entries(run, "llava-pretrain") | run["rmsnorm"]


# ---------------------------------------------------------------- split backward (ViT)


def time_split(shape, causal: bool, dtype, seed: int, full_lens: bool = False, fused: dict | None = None) -> dict:
    """CUDA-event medians at a main path's shape: the dq and the dk/dv
    kernel alone (on one ``split_operands``), that shared work alone (the
    prep launch and casts), the split pair as
    ``mlpt::flash_bwd_split`` runs it (the prep launch and casts, dq,
    dk/dv), and their plain versions. ``fused`` holds what an
    earlier phase timed at this shape (``ms`` of the forward and the fused
    kernel and of their plain versions, ``library``: PyTorch's attention);
    without it those are timed here. The pair is set against the fused
    kernel and against the backward's bound, which both compute: the pair
    does 7 tile products to the fused kernel's 5, a cost of its design.
    ``full_lens``: the varlen mode with every length full, the same
    function as plain attention."""
    b, h, s, d = shape
    q, k, v, do = _inputs(shape, seed, dtype)
    scale = d**-0.5
    kv_lens = torch.full((b * h,), s, dtype=torch.int32, device="cuda") if full_lens else None
    out, lse = fa.flash_fwd_reference(q, k, v, causal, scale, kv_lens)
    ops = fa.split_operands(q, k, v, out, lse, do, scale, kv_lens)
    args = (q, k, v, do, lse, fa.bwd_delta(out, do), causal, scale, kv_lens)
    fns = {
        "dq": lambda: fa.flash_bwd_dq_cuda(ops, causal),
        "dkv": lambda: fa.flash_bwd_dkv_cuda(ops, causal),
        "shared": lambda: fa.split_operands(q, k, v, out, lse, do, scale, kv_lens),
        "split": lambda: _split(q, k, v, out, lse, do, causal, scale, kv_lens),
        "dq_plain": lambda: fa.flash_bwd_dq_reference(*args),
        "dkv_plain": lambda: fa.flash_bwd_dkv_reference(*args),
        "split_plain": lambda: _split(q, k, v, out, lse, do, causal, scale, kv_lens, kernels=False),
    }
    if fused is None:
        fns.update({
            "fwd": lambda: fa.flash_fwd_cuda(q, k, v, causal, scale, kv_lens),
            "fwd_plain": lambda: fa.flash_fwd_reference(q, k, v, causal, scale, kv_lens),
            "bwd": lambda: fa.flash_bwd_cuda(q, k, v, out, lse, do, causal, scale, kv_lens),
            "bwd_plain": lambda: fa.flash_bwd_reference(q, k, v, out, lse, do, causal, scale, kv_lens),
        })
    t = {n: cuda_ms(f) for n, f in fns.items()}
    what = f"{str(dtype).split('.')[-1]} {'causal' if causal else 'non-causal'}{', full lens' if full_lens else ''}"
    say(f"[split] ms a call at {list(shape)} {what}: " + ", ".join(f"{n} {ms:.3f}" for n, ms in t.items()))
    bounds = attention_bounds(q, k, v, do, causal, kv_lens)
    if fused is None:
        fused = {"ms": t, "library": sdpa_ms(q, k, v, do, causal, flash_only=dtype == torch.bfloat16)}
        say_yardstick(shape, what, fused["library"], bounds)
        say_forward(shape, what, t["fwd"], cuda_ms_alone(fns["fwd"]), fwd_flops(q, k, causal, kv_lens),
                    bounds["fwd"], fused["library"])
        say_backward(shape, what, t["bwd"], bwd_flops(q, k, causal, kv_lens), bounds["bwd"], fused["library"])
    bounds.update(split_bounds(q, k, ops, causal, kv_lens))
    bwd = bounds["bwd"]["bound_ms"]
    lib_bwd = fused["library"]["bwd"]
    say(f"[yardstick] {list(shape)} {what}: split pair {t['split']:.4f} ms (dq {t['dq']:.4f} + dk/dv {t['dkv']:.4f} "
        f"+ the shared work {t['shared']:.4f}: prep launch and casts), PyTorch's backward "
        f"({fused['library']['backend']}) {lib_bwd:.4f} ms, pair / PyTorch {t['split'] / lib_bwd:.3f}; on the "
        f"shared operands dq {bounds['dq']['bound_ms'] / t['dq']:.3f} of its bound {bounds['dq']['bound_ms']:.4f} ms "
        f"({bounds['dq']['bound_by']}), dk/dv {bounds['dkv']['bound_ms'] / t['dkv']:.3f} of its bound "
        f"{bounds['dkv']['bound_ms']:.4f} ms ({bounds['dkv']['bound_by']})")
    say(f"[yardstick] {list(shape)} {what}: split pair {t['split']:.3f} ms, fused {fused['ms']['bwd']:.3f} ms "
        f"(split / fused {t['split'] / fused['ms']['bwd']:.3f}); against the backward's bound {bwd:.4f} ms "
        f"({bounds['bwd']['bound_by']}): split pair {t['split'] / bwd:.1f}x, fused {fused['ms']['bwd'] / bwd:.1f}x. "
        f"The pair's 7 products to the fused kernel's 5: its kernels' bounds on the shared operands, dq {bounds['dq']['bound_ms']:.4f} + dk/dv "
        f"{bounds['dkv']['bound_ms']:.4f} = {bounds['dq']['bound_ms'] + bounds['dkv']['bound_ms']:.4f} ms")
    return {"ms": {**fused["ms"], **t}, "library": fused["library"], "bounds": bounds}


def phase_split_kernels(pythia: dict, decoder: dict) -> list[dict]:
    """The split pair beside the forward and fused kernels at every listed
    shape (``check_kernels_at(..., split=True)``), the forward and fused
    kernel on f32 inputs at ViT's shape among them; then the times at the
    main paths' shapes, where ``pythia`` and ``decoder`` are what phases 3
    and 9 timed at theirs."""
    # full f32 products in the plain versions (the main paths' plans turned TF32 on)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    errs = check_kernels_at(SLICE_SHAPE, True, seed=30, split=True)
    check_kernels_at(VIT_SHAPE, False, seed=31, dtype=torch.float32, split=True)
    check_forward_edges("[split]", torch.float32, "seq")
    check_forward_edges("[split]", torch.float32, "lens")
    check_backward_edges("[split]", torch.float32)
    check_split_edges("[split]", torch.bfloat16)
    check_split_edges("[split]", torch.float32)
    check_kernels_at(VIT_SHAPE, False, seed=32, split=True)
    for causal in (True, False):
        check_kernels_at(RAGGED_SHAPE, causal, seed=33 + causal, split=True)
        check_kernels_at(VARLEN_RAGGED, causal, seed=35 + causal, lens=[77, 37, 64, 0], split=True)
    errs_varlen = check_kernels_at(VARLEN_SHAPE, True, seed=37, lens=_ragged_lens(VARLEN_SHAPE[0], VARLEN_SHAPE[2], 2),
                                   split=True)

    pythia = time_split(SLICE_SHAPE, True, torch.bfloat16, 38, fused=pythia)
    time_split(VIT_SHAPE, False, torch.float32, 39)
    llava = time_split(VARLEN_SHAPE, True, torch.bfloat16, 40, full_lens=True, fused=decoder)

    # library_ms: PyTorch's backward, which computes what the pair computes
    # together (no PyTorch call computes dq or dk/dv alone); pair_ms beside it
    def entries(suffix: str, e: dict, timed: dict) -> list[dict]:
        return [
            {"name": f"flash_bwd_{part}{suffix}", "route": "cuda", "source": source,
             "replaces": f"{JAX_FLASH}:{line}", "launches": None, "max_abs_err": err, "ms": timed["ms"][part],
             "plain_ms": timed["ms"][f"{part}_plain"], **timed["bounds"][part],
             "library_ms": timed["library"]["bwd"], "pair_ms": timed["ms"]["split"]}
            for part, source, line, err in (("dq", DQ_SOURCE, 161, e["split_dq"][0]),
                                            ("dkv", BWD_SOURCE, 293, max(e["split_dk"][0], e["split_dv"][0])))
        ]

    return entries("", errs, pythia) + entries("_varlen", errs_varlen, llava)


def _slice_pair(tag: str, build, run, want: dict, tol_split: float = TOL_NORM_REL) -> None:
    """``build(impl)`` a narrow model on the card from one seed; ``run(model)``
    its loss. Loss and every grad with the kernels under the fused and
    under the split backward against the plain f32 attention ("naive") on
    the same weights, and the split grads against the fused ones within
    ``tol_split``; the launch counters must read ``want[fused]`` for the
    kernels and nothing for "naive"."""
    results = {}
    try:
        for impl, fused in (("flash", True), ("flash", False), ("naive", True)):
            fa.PREFER_FUSED_BWD = fused
            model = build(impl)
            fa.reset_launch_counts()
            loss = run(model)
            loss.backward()
            launches = {n: getattr(fa, n) for n in FLASH_COUNTERS if getattr(fa, n)}
            expected = {} if impl == "naive" else want[fused]
            if launches != expected:
                raise AssertionError(f"{tag} {impl} fused={fused}: launches {launches}, expected {expected}")
            results[impl, fused] = (loss.item(), {n: p.grad.float() for n, p in model.named_parameters()
                                                  if p.grad is not None})
    finally:
        fa.PREFER_FUSED_BWD = True
    loss_n, g_n = results["naive", True]
    for fused in (True, False):
        loss_k, g_k = results["flash", fused]
        worst_name = max(g_n, key=lambda n: _errs(g_k[n], g_n[n])[1])
        worst = _errs(g_k[worst_name], g_n[worst_name])[1]
        say(f"{tag} {'fused' if fused else 'split'} backward: loss kernels {loss_k:.6f} vs plain {loss_n:.6f}; "
            f"{len(g_n)} grads, worst norm_rel {worst:.3e} ({worst_name}); launches {want[fused]}")
        if not abs(loss_k - loss_n) <= TOL_SLICE_LOSS:
            raise AssertionError(f"{tag} loss differs by {abs(loss_k - loss_n):.3e} > {TOL_SLICE_LOSS}")
        if not worst <= TOL_SLICE_GRAD_NORM_REL:
            raise AssertionError(f"{tag} grads differ: norm_rel {worst:.3e} > {TOL_SLICE_GRAD_NORM_REL}")
    (_, g_f), (_, g_s) = results["flash", True], results["flash", False]
    worst = max(_errs(g_s[n], g_f[n])[1] for n in g_f)
    say(f"{tag} split vs fused backward: worst grad norm_rel {worst:.3e}")
    if not worst <= tol_split:
        raise AssertionError(f"{tag}: split and fused grads differ by {worst:.3e} > {tol_split}")


def phase_vit_slice() -> None:
    """Two-layer narrow ViT in f32 (hidden 128, 2 heads of 64, ffn 256) at
    224 px (197 tokens), 100 classes, 4 images, dropout off: loss and every
    grad with the kernels, under the fused and under the split backward,
    against the plain f32 attention ("naive") on the same weights and
    batch, TF32 off (``_slice_pair``). The kernels round q, k, v, p and ds
    to bf16 where the plain attention keeps f32, hence the bf16-level
    tolerances."""
    from multimodal_llm_pretraining_tpu_torch.models.layers import cross_entropy_loss
    from multimodal_llm_pretraining_tpu_torch.models.vit import ViTClassifier

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    pixels = torch.from_numpy(rng.random((4, 224, 224, 3), dtype=np.float32)).to("cuda")
    labels = torch.from_numpy(rng.integers(0, 100, 4)).to("cuda")

    def build(impl):
        model = ViTClassifier(100, 224, hidden=128, num_layers=2, num_heads=2, ffn=256, attn_impl=impl).to("cuda")
        model.reset_parameters(torch.Generator(device="cuda").manual_seed(0))
        return model

    want = {True: {"FWD_LAUNCHES": 2, "BWD_LAUNCHES": 2}, False: {"FWD_LAUNCHES": 2, "DQ_LAUNCHES": 2, "DKV_LAUNCHES": 2}}
    _slice_pair("[vit slice] 2-layer f32", build, lambda m: cross_entropy_loss(m(pixels), labels), want)


def phase_vit_main_path() -> dict:
    """ViT-L/16 at full width and depth in the f32 layout (the recipe's f32
    compute; TF32 products), dropout on, micro-batch 128 x accumulation 2
    (the recipe's batch of 4096 cut for one card). Per micro-batch: 24
    plain-mode f32 forwards, and 24 fused backwards or 24 dq + 24 dk/dv."""
    run = drive_training("vit", mbs=VIT_SHAPE[0], acc=2, remat=False, counters=fa, loss_band=VIT_LOSS_BAND,
                         layout="f32", names=FLASH_COUNTERS, tokens_per_sample=VIT_TOKENS, split_ab=True)
    mod = run["module"]
    if mod.position_embeddings.shape[1] != VIT_TOKENS or mod.classifier.weight.shape[0] != 21841:
        raise AssertionError(f"vit: not ViT-L/16 at 224 px with 21,841 classes: {mod.position_embeddings.shape}")
    if not all(block.mlp.dropout == VIT_DROPOUT for block in mod.layers):
        raise AssertionError(f"vit: not the recipe's dropout rate {VIT_DROPOUT} in every block")
    expected = flash_launches_expected(FLASH_COUNTERS, len(mod.layers), 0, run["micro_batches"])
    if run["launches"] != expected:
        raise AssertionError(f"vit flash launches {run['launches']}, expected {expected}")
    return flash_launch_entries(run["launches"])


# ---------------------------------------------------------------- head dims and batch*heads


PADDED_HEAD_DIMS = (32, 80, 88)  # pythia-14m/31m, pythia-2.8b, the default ViLT trunk: zero-padded to 64, 128, 128


def phase_head_dims() -> None:
    """The forward, fused backward and split pair against their plain
    versions at the head dims the kernels run zero-padded, plain and varlen
    mode, causal and not; then 2 steps each of pythia-14m (D=32, 6 layers)
    and of pythia-2.8b (D=80) cut to 2 layers at full width, whose launch
    counters must show every attention call on the kernels."""
    from multimodal_llm_pretraining_tpu_torch.models import pythia

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for i, d in enumerate(PADDED_HEAD_DIMS):
        for causal in (True, False):
            check_kernels_at((2, 4, 300, d), causal, seed=60 + i, split=True, tag="[head dims]")
            check_kernels_at((2, 4, 300, d), causal, seed=63 + i, lens=[300, 97], split=True, tag="[head dims]")
    for model_type, layers, mbs, acc in (("pythia-14m", None, 4, 2), ("pythia-2.8b", 2, 4, 1)):
        full = pythia.PYTHIA_SIZES[model_type]
        if layers is not None:
            pythia.PYTHIA_SIZES[model_type] = (layers, *full[1:])
        try:
            run = drive_training(model_type, mbs=mbs, acc=acc, remat=False, counters=fa, loss_band=TEXT_LOSS_BAND,
                                 names=FLASH_COUNTERS, steps=2)
        finally:
            pythia.PYTHIA_SIZES[model_type] = full
        expected = flash_launches_expected(FLASH_COUNTERS, len(run["module"].layers), 0, run["micro_batches"])
        if run["launches"] != expected:
            raise AssertionError(f"{model_type} flash launches {run['launches']}, expected {expected}")
        attn = run["module"].layers[0].attn
        say(f"[head dims] {model_type} ({len(run['module'].layers)} layers, head_dim {attn.head_dim}): every "
            f"attention call on the kernels, launches as expected")


GRID_SHAPE = (4096, 16, 16, 64)  # 65,536 batch-heads: one more than a launch grid's y dimension holds


def phase_many_heads() -> None:
    """The forward, fused backward and split pair against their plain
    versions at 65,536 batch-heads, plain and varlen mode: each wrapper call
    launches twice (two chunks)."""
    b, h, s, _ = GRID_SHAPE
    assert b * h == fa.MAX_GRID_Y + 1
    lens = np.random.default_rng(7).integers(0, s + 1, b).tolist()
    for causal, kv_lens in ((True, None), (False, lens)):
        fa.reset_launch_counts()
        check_kernels_at(GRID_SHAPE, causal, seed=70, lens=kv_lens, split=True, tag="[grid]")
        # check_forward, check_backward and the split check each launch twice
        calls = {"FWD_LAUNCHES": 2, "BWD_LAUNCHES": 2, "DQ_LAUNCHES": 2, "DKV_LAUNCHES": 2}
        if kv_lens is not None:
            calls = {"VARLEN_" + n: c for n, c in calls.items()}
        got = {n: getattr(fa, n) for n in FLASH_COUNTERS}
        want = {n: 2 * calls.get(n, 0) for n in FLASH_COUNTERS}  # two chunks a call
        if got != want:
            raise AssertionError(f"[grid] launches {got}, expected {want}")
        say(f"[grid] {b * h} batch-heads, {'varlen' if kv_lens else 'plain'} mode: two launches a call, {got}")


REPAIR_XLA_SHAPE = (2, 4, 300, 320)  # head dim 320: above the kernels' 256, inside the JAX kernel's 512
REPAIR_SCALE_SHAPE = (4, 8, 300, 256)  # the fused backward at head dim 256 with scale 0.07
REPAIR_SCALE = 0.07
REPAIR_D_STATES = (8, 24, 64)  # the scan at d_states other than 16: zero-padded groups of 16
REPAIR_SCAN_BATCH = (65536, 3, 8)  # one more batch element than a launch grid's y holds: two launches a call


def phase_repairs() -> None:
    """The shapes the JAX package computes and the kernels once refused,
    each against its plain version on the card: head dim 320 through
    ``dot_product_attention(impl="flash")``, which ``flash_supported``
    sends to the xla branch (out and the gradients through autograd against
    the f32 ``naive`` branch, to TOL_NORM_REL: the branch rounds its
    probabilities to bf16); the fused backward at head dim 256 with scale
    0.07, plain and varlen (its one-stage variant with a k*scale tile, as
    ``check_backward`` holds every backward); both scan kernels at d_state
    8, 24 and 64 (as ``check_scan_at`` holds them at 16, one launch per
    group of 16 states) and at 65,536 batch elements (one launch per chunk
    of at most 65,535)."""
    b, h, s, d = REPAIR_XLA_SHAPE
    q, k, v, do = (t.view(b, h, s, d) for t in _inputs(REPAIR_XLA_SHAPE, 80))
    fa.reset_launch_counts()
    attn.XLA_BRANCH_CALLS = 0
    results = {}
    for impl in ("flash", "naive"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = attn.dot_product_attention(*leaves, causal=True, impl=impl)
        out.backward(do.to(out.dtype))
        results[impl] = [out, *(t.grad for t in leaves)]
    torch.cuda.synchronize()
    flash = {n: getattr(fa, n) for n in FLASH_COUNTERS}
    if attn.XLA_BRANCH_CALLS != 1 or any(flash.values()):
        raise AssertionError(f"[repairs] head dim {d}: xla-branch calls {attn.XLA_BRANCH_CALLS}, flash launches {flash}")
    errs = {n: _errs(a, p) for n, a, p in zip(("out", "dq", "dk", "dv"), results["flash"], results["naive"])}
    say(f"[repairs] head dim {d} {list(REPAIR_XLA_SHAPE)} bf16 causal through the xla branch (1 call, no flash "
        f"launch): " + ", ".join(f"{n} norm_rel {r:.3e}" for n, (_, r) in errs.items()) + f" (tol {TOL_NORM_REL:g})")
    if not all(r <= TOL_NORM_REL for _, r in errs.values()):
        raise AssertionError(f"[repairs] the xla branch differs from the plain attention: {errs}")

    b, h, s, d = REPAIR_SCALE_SHAPE
    q, k, v, do = _inputs(REPAIR_SCALE_SHAPE, 81)
    for lens in (None, [300, 1, 64, 0]):
        kv_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda").repeat_interleave(h)
        fa.reset_launch_counts()
        res = check_backward(q, k, v, do, True, kv_lens, scale=REPAIR_SCALE)
        counted = fa.BWD_LAUNCHES if lens is None else fa.VARLEN_BWD_LAUNCHES
        if counted != 2:
            raise AssertionError(f"[repairs] fused backward at head dim {d}: {counted} launches counted, expected 2")
        say(f"[repairs] fused backward {list(REPAIR_SCALE_SHAPE)} bf16 causal scale {REPAIR_SCALE} lens {lens}: "
            + ", ".join(f"{n} norm_rel {r:.3e}" for n, (_, r) in res["errs"].items())
            + f" (tol {TOL_NORM_REL:g}); dk/dv identical on a second launch; {counted} launches counted")
        sp = check_split(q, k, v, do, True, kv_lens, scale=REPAIR_SCALE, fused=res["grads"])
        names = ("DQ_LAUNCHES", "DKV_LAUNCHES") if lens is None else ("VARLEN_DQ_LAUNCHES", "VARLEN_DKV_LAUNCHES")
        counted = [getattr(fa, n) for n in names]
        if counted != [2, 2]:
            raise AssertionError(f"[repairs] split pair at head dim {d}: {counted} launches counted, expected 2 each")
        say(f"[repairs] split pair {list(REPAIR_SCALE_SHAPE)} bf16 causal scale {REPAIR_SCALE} lens {lens}: "
            + ", ".join(f"{n} norm_rel {r:.3e}" for n, (_, r) in sp["errs"].items())
            + f" (tol {TOL_NORM_REL:g}); identical on a second run, dk/dv identical to the fused kernel's; "
              f"launches dq {counted[0]} dk/dv {counted[1]}")

    for n_state in REPAIR_D_STATES:
        ssf.reset_launch_counts()
        check_scan_at(SCAN_RAGGED, torch.bfloat16, seed=82, d_state=n_state)
        groups = -(-n_state // 16)
        got = (ssf.FWD_LAUNCHES, ssf.BWD_LAUNCHES)
        if got != (4 * groups, 3 * groups):  # check_scan_at's 4 forward and 3 backward calls
            raise AssertionError(f"[repairs] scan at d_state {n_state}: launches {got}, expected "
                                 f"({4 * groups}, {3 * groups})")
        say(f"[repairs] scan d_state {n_state}: {groups} group(s) of 16 states a call, launches fwd {got[0]} bwd {got[1]}")
    ssf.reset_launch_counts()
    check_scan_at(REPAIR_SCAN_BATCH, torch.bfloat16, seed=83)
    got = (ssf.FWD_LAUNCHES, ssf.BWD_LAUNCHES)
    if got != (4 * 2, 3 * 2):
        raise AssertionError(f"[repairs] scan at batch {REPAIR_SCAN_BATCH[0]}: launches {got}, expected (8, 6)")
    say(f"[repairs] scan {list(REPAIR_SCAN_BATCH)}: two launches a call (65,535 + 1 batch elements), "
        f"launches fwd {got[0]} bwd {got[1]}")


# ---------------------------------------------------------------- remat and the harness


def _held_to(what: str, got: dict, ref: dict, tol: float, cause: str) -> None:
    """Each tensor of ``got`` equal bit for bit to ``ref``'s; otherwise say
    which differs most, and why, and hold every one to ``tol`` of its norm."""
    differ = {n: _errs(got[n], ref[n]) for n in ref if not torch.equal(got[n], ref[n])}
    if not differ:
        say(f"[remat] {what}: all {len(ref)} bit for bit equal to no remat")
        return
    name = max(differ, key=lambda n: differ[n][1])
    say(f"[remat] {what}: {len(differ)} of {len(ref)} differ from no remat, largest {name}: max_abs "
        f"{differ[name][0]:.3e}, norm_rel {differ[name][1]:.3e} (tolerance {tol}); cause: {cause}")
    if differ[name][1] > tol:
        raise AssertionError(f"{what}: {name} norm_rel {differ[name][1]:.3e} > {tol}")


def phase_remat(card: str) -> tuple[dict, dict]:
    """pythia-1b at full width and depth, micro-batch 4 x accumulation 2,
    ``bf16_sr``, one session each without remat, under "dots" and under
    "flash" (1 warmup + 3 timed steps, fused backward). Before its steps,
    each session takes one micro-batch under the split backward (which
    repeats bit for bit) from the same initial parameters: every grad with
    remat must equal the one without, bit for bit, or lie within the slice
    tolerance with the difference printed. The first step's loss must be
    bit for bit equal across the three (remat does not touch the forward),
    and the flash launches equal: one forward and one backward per block
    and micro-batch under either policy, as without remat. Returns the
    launches, and the first loss and peak memory of the session without
    remat."""
    runs, grads = {}, {}
    for policy in (None, "dots", "flash"):
        def first_micro_batch(sess, state, policy=policy):
            fa.PREFER_FUSED_BWD = False
            try:
                sess.accumulate_fn()(state, sess.make_micro_batch(seed=0))
            finally:
                fa.PREFER_FUSED_BWD = True
            grads[policy] = {n: p.grad.detach().cpu() for n, p in state.params.items()}
            sess.zero_grads()

        runs[policy] = drive_training("pythia-1b", mbs=4, acc=2, remat=policy is not None, policy=policy or "flash",
                                      counters=fa, loss_band=TEXT_LOSS_BAND, names=FLASH_COUNTERS,
                                      on_init=first_micro_batch)
        # drop the module, so that the next session's peak memory is its own
        layers = len(runs[policy].pop("module").layers)
    expected = flash_launches_expected(FLASH_COUNTERS, layers, 0, runs[None]["micro_batches"])
    for policy, run in runs.items():
        if run["launches"] != expected:
            raise AssertionError(f"pythia remat {policy}: flash launches {run['launches']}, expected {expected}")
        if run["losses"][0] != runs[None]["losses"][0]:
            raise AssertionError(f"pythia remat {policy}: first loss {run['losses'][0]!r} differs from "
                                 f"{runs[None]['losses'][0]!r} without remat")
    for policy in ("dots", "flash"):
        _held_to(f"pythia-1b {policy} grads after one split-backward micro-batch", grads[policy], grads[None],
                 TOL_SLICE_GRAD_NORM_REL, "the recompute's products and elementwise kernels gave other bits")
    per_mb = {n: c // (runs[None]["micro_batches"][True]) for n, c in expected.items() if c}
    say(f"[remat] first loss {runs[None]['losses'][0]!r} in all three sessions; flash launches a micro-batch "
        f"{per_mb} in all three")
    for policy, run in runs.items():
        say(f"[remat] pythia-1b {policy or 'no remat'}: median step {run['medians'][True]:.4f} s, peak memory "
            f"{run['peak']} bytes ({run['peak'] / 2**30:.2f} GiB) on {card}")
    base = runs[None]["medians"][True]
    say(f"[remat] step / no-remat step: dots {runs['dots']['medians'][True] / base:.4f}, "
        f"flash {runs['flash']['medians'][True] / base:.4f}")
    launches: dict[str, int] = {}
    for policy, run in runs.items():
        counts = flash_launch_entries(run["launches"]) | xent_launch_entries(
            run, f"pythia-1b remat {policy}", PYTHIA_MBS4_XENT_CHUNKS)
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    return launches, {"loss": runs[None]["losses"][0], "peak": runs[None]["peak"]}


def _remat_pair(model_type: str, **kw) -> tuple[dict, dict]:
    """The same session without remat and with it, 2 steps each under the
    split backward (which repeats bit for bit), from the same seeds; the
    losses must agree bit for bit, or within the slice tolerance with the
    difference printed."""
    runs = {}
    for remat in (False, True):
        runs[remat] = drive_training(model_type, remat=remat, counters=fa, names=FLASH_COUNTERS, fused=False, steps=2,
                                     **kw)
        if not remat:
            del runs[remat]["module"]  # so that the next session's peak memory is its own
    if runs[True]["launches"] != runs[False]["launches"]:
        raise AssertionError(f"{model_type} remat: launches {runs[True]['launches']}, "
                             f"without remat {runs[False]['launches']}")
    for i, (got, ref) in enumerate(zip(runs[True]["losses"], runs[False]["losses"])):
        if got != ref:
            say(f"[remat] {model_type} step {i} loss {got!r}, without remat {ref!r}: differs by {abs(got - ref):.3e}")
            if abs(got - ref) > TOL_SLICE_LOSS:
                raise AssertionError(f"{model_type} remat: step {i} loss differs by {abs(got - ref):.3e}")
    say(f"[remat] {model_type}: losses {runs[True]['losses']} with remat, {runs[False]['losses']} without")
    return runs[False], runs[True]


def phase_remat_vit() -> dict:
    """ViT-L/16 in the f32 layout with dropout on, micro-batch 128 x
    accumulation 2, without remat and under "flash": equal losses, and the
    dropout generator in the same state after the steps (the recompute drew
    no masks of its own)."""
    plain, remat = _remat_pair("vit", mbs=VIT_SHAPE[0], acc=2, loss_band=VIT_LOSS_BAND, layout="f32",
                               tokens_per_sample=VIT_TOKENS)
    if not torch.equal(remat["dropout_state"], plain["dropout_state"]):
        raise AssertionError("vit remat: the dropout generator's state differs from the run without remat")
    expected = flash_launches_expected(FLASH_COUNTERS, len(remat["module"].layers), 0, remat["micro_batches"])
    if remat["launches"] != expected:
        raise AssertionError(f"vit remat flash launches {remat['launches']}, expected {expected}")
    say("[remat] vit: dropout generator state after the steps equal to the run without remat")
    return flash_launch_entries(remat["launches"])


def phase_remat_llava() -> dict:
    """llava-pretrain (its bf16 layout), micro-batch 16 x accumulation 2,
    without remat and under "flash": equal losses, the frozen leaves bit for
    bit (``drive_training``), and the frozen tower differentiated by no
    backward launch."""
    plain, remat = _remat_pair("llava-pretrain", mbs=16, acc=2, loss_band=LLAVA_LOSS_BAND, layout="bf16",
                               tokens_per_sample=LLAVA_TOKENS_PER_SAMPLE)
    mod = remat["module"]
    expected = flash_launches_expected(FLASH_COUNTERS, len(mod.vision_tower.layers), len(mod.language_model.layers),
                                       remat["micro_batches"], plain_bwd=False)
    if remat["launches"] != expected:
        raise AssertionError(f"llava remat launches {remat['launches']}, expected {expected}")
    launches = flash_launch_entries(remat["launches"])
    for run, name in ((plain, "llava-pretrain"), (remat, "llava-pretrain remat")):
        for k, n in xent_launch_entries(run, name).items():
            launches[k] = launches.get(k, 0) + n
    return launches


SEARCH_MODEL = "pythia-1b"
SEARCH_LAYOUTS = ("bf16_sr", "bf16_master")
# each count's launches: one forward and one backward an attention layer
# (llava's frozen tower none backward) or mamba block, no remat
COUNT_LAUNCHES = {
    "pythia-1b": {"FWD_LAUNCHES": 16, "BWD_LAUNCHES": 16},
    "mamba": {"scan fwd": 64, "scan bwd": 64},
    "llava-pretrain": {"FWD_LAUNCHES": 23, "VARLEN_FWD_LAUNCHES": 16, "VARLEN_BWD_LAUNCHES": 16},
    "vit": {"FWD_LAUNCHES": 24, "BWD_LAUNCHES": 24},
    "vilt-pretrain": {"FWD_LAUNCHES": 120, "BWD_LAUNCHES": 120},  # 3 trunk passes of 40 blocks
    "roberta": {"FWD_LAUNCHES": 24, "BWD_LAUNCHES": 24},
    "convnext-large-1k": {},  # no attention, no scan
}
CACHED_SWEEP_LIMIT_S = 5.0
PARENT_RESERVED_LIMIT = 2**30


def _harness_phase_times(card: str) -> None:
    """pythia-1b under "dots" (``bf16_sr``) in this process: phase times at
    micro-batch 4 (1 warmup + 3 samples) and the step they extrapolate to
    at accumulation 32."""
    from multimodal_llm_pretraining_tpu_torch.benchmarking.step_time import estimate_step_time, measure_phase_times
    from multimodal_llm_pretraining_tpu_torch.benchmarking.utils import BenchmarkHarness
    from multimodal_llm_pretraining_tpu_torch.models import get_model_class
    from multimodal_llm_pretraining_tpu_torch.profile_step import make_plan

    mc = get_model_class(SEARCH_MODEL)
    torch.cuda.empty_cache()
    harness = BenchmarkHarness(make_plan(mc, 4, 1, True, "bf16_sr", "dots"), mc)
    harness.setup()
    times = measure_phase_times(harness, 4, samples=3)
    estimate = estimate_step_time(harness, 4, 4 * 32, 3)
    say(f"[harness] pythia-1b dots mbs 4: accumulate {times.accumulate_s:.4f} s, optimizer {times.optimizer_s:.4f} s "
        f"(mean of {times.samples}); step at acc 32 from these {times.step_time(32):.4f} s, estimate_step_time "
        f"(its own 3 samples) {estimate:.4f} s; optimizer state {harness.persistent_state_bytes()} bytes; {card}")


def _bf16_master_session(card: str, bf16_sr_run: dict) -> dict:
    """pythia-1b in ``bf16_master`` at micro-batch 4 x accumulation 2, no
    remat: the first loss bit for bit phase 18's ``bf16_sr`` one (the same
    bf16 params and batch), every live param its f32 master rounded once
    after the steps; its peak beside the ``bf16_sr`` session's."""
    checked = {}

    def after(sess, state):
        master = state.opt_state.master
        if master is None or any(m.dtype != torch.float32 for m in master):
            raise AssertionError("bf16_master: no f32 master in the optimizer state")
        differ = [n for n, m in zip(sess.trainable, master) if not torch.equal(state.params[n], m.to(torch.bfloat16))]
        if differ:
            raise AssertionError(f"bf16_master: {len(differ)} params differ from their masters rounded, e.g. {differ[0]}")
        checked["params"] = len(master)

    run = drive_training(SEARCH_MODEL, mbs=4, acc=2, remat=False, counters=fa, loss_band=TEXT_LOSS_BAND,
                         layout="bf16_master", names=FLASH_COUNTERS, after=after)
    if run["losses"][0] != bf16_sr_run["loss"]:
        raise AssertionError(f"bf16_master first loss {run['losses'][0]!r}, bf16_sr's {bf16_sr_run['loss']!r}")
    say(f"[search] bf16_master session: first loss {run['losses'][0]!r} equal to bf16_sr's; all {checked['params']} "
        f"bf16 params equal to their f32 masters rounded; peak {run['peak']} bytes ({run['peak'] / 2**30:.2f} GiB) "
        f"vs bf16_sr's {bf16_sr_run['peak']} ({bf16_sr_run['peak'] / 2**30:.2f} GiB), median step "
        f"{run['medians'][True]:.4f} s; {card}")
    del run["module"]
    return flash_launch_entries(run["launches"]) | xent_launch_entries(run, "pythia-1b bf16_master",
                                                                       PYTHIA_MBS4_XENT_CHUNKS)


def _counts_and_analytic_days() -> dict:
    """``CountFlopsExperiment`` and ``TrainingTimeAnalytic`` (free lunch,
    ``assumed_mfu`` 1.0) for the models of ``COUNT_LAUNCHES`` on the card, each count one
    example's forward and backward under ``FlopCounterMode`` through the
    flash (plain and varlen) and scan kernels, whose launches are counted.
    mamba's scan share is its scan ops' formulas over its counted total."""
    from multimodal_llm_pretraining_tpu_torch.experiments.config import BaseConfig, TrainingConfig
    from multimodal_llm_pretraining_tpu_torch.experiments.count_flops import CountFlopsExperiment
    from multimodal_llm_pretraining_tpu_torch.experiments.training_time_analytic import TrainingTimeAnalytic
    from multimodal_llm_pretraining_tpu_torch.models import get_model_class
    from multimodal_llm_pretraining_tpu_torch.models import mamba as tmamba

    launches: dict[str, int] = {}
    for model, expected in COUNT_LAUNCHES.items():
        base = BaseConfig(num_hosts=1, chips_per_host=1, gpu_type="h100-sxm", model=model)
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        fa.reset_launch_counts()
        ssf.reset_launch_counts()
        count = CountFlopsExperiment(config=base)
        count.run()
        counts = {n: getattr(fa, n) for n in FLASH_COUNTERS}
        for name, n in {**flash_launch_entries(counts), "scan_fwd": ssf.FWD_LAUNCHES,
                        "scan_bwd": ssf.BWD_LAUNCHES}.items():
            launches[name] = launches.get(name, 0) + n
        analytic = TrainingTimeAnalytic(config=TrainingConfig(**vars(base), free_lunch=True), assumed_mfu=1.0)
        analytic.run()
        res, mc = count.results(), get_model_class(model)
        if not (math.isfinite(res["training_flops"]) and res["training_flops"] > 0):
            raise AssertionError(f"{model}: training FLOPs {res['training_flops']}")
        per_example = res["training_flops"] / res["training_examples"]
        shown = {k: v for k, v in {**counts, "scan fwd": ssf.FWD_LAUNCHES, "scan bwd": ssf.BWD_LAUNCHES}.items() if v}
        if shown != expected:
            raise AssertionError(f"{model} count: launches {shown}, expected {expected}")
        say(f"[count] {model}: {per_example:.6e} FLOPs an example ({res['training_flops']:.6e} in {mc.training_steps} "
            f"steps of {mc.batch_size}); analytic days at MFU 1.0 {analytic.results()['training_days']:.4f}; "
            f"launches {shown}; {time.perf_counter() - t0:.1f} s")
        if model == "mamba":
            seq, layers = mc.sequence_length, tmamba.N_LAYER
            scan = 3 * layers * (9 * seq * tmamba.D_INNER * tmamba.D_STATE + seq * tmamba.D_INNER)
            say(f"[count] mamba scan FLOPs an example {scan:.6e}, {scan / per_example:.4f} of its count")
        torch.cuda.empty_cache()
    return launches


def phase_harness(card: str, bf16_sr_run: dict) -> dict:
    """The method search on pythia-1b at full width and depth. First, in
    this process: the harness's phase times at micro-batch 4, one
    ``bf16_master`` session (``_bf16_master_session``), and the count and
    analytic experiments for four models (``_counts_and_analytic_days``).
    Then the parent frees its cached blocks and must hold under 1 GiB
    before any worker starts. The sweep is the CLI's ``--methods all`` grid
    restricted to "dots" remat and the ``bf16_sr`` and ``bf16_master``
    layouts (two arms), in a workspace of the phase's own: each arm's
    largest micro-batch (one fresh worker a candidate), split and fused step
    times (one worker each) and training days, every worker's op, outcome
    and time printed. The same sweep again must come from the cache: no
    worker, under ``CACHED_SWEEP_LIMIT_S``. Then the results table and the
    phase's wall time. Returns the in-process launches."""
    import shutil
    import tempfile

    from multimodal_llm_pretraining_tpu_torch.experiments import cache
    from multimodal_llm_pretraining_tpu_torch.experiments.base_classes import format_table

    t0 = time.perf_counter()
    _harness_phase_times(card)
    launches = _bf16_master_session(card, bf16_sr_run)
    workspace = tempfile.mkdtemp(prefix="mlpt_search_")
    cache.set_workspace(cache.Workspace(os.path.join(workspace, cache.WORKSPACE_SUBDIR)))
    try:
        for name, n in _counts_and_analytic_days().items():
            launches[name] = launches.get(name, 0) + n
        rows, target = _search(card)
    finally:
        cache.set_workspace(cache.MemoryWorkspace())
        shutil.rmtree(workspace, ignore_errors=True)
    for row in rows:
        if "failure" in row:
            raise AssertionError(f"{row['state_layout']}: {row['failure']}")
        if not (row["max_micro_batch_size"] >= 4 and row["step_time_fused"] is not None
                and math.isfinite(row["step_time"]) and row["training_days"] > 0):
            raise AssertionError(f"{row['state_layout']}: {row}")
        say(f"[search] {row['state_layout']}: max micro-batch {row['max_micro_batch_size']}, split step "
            f"{row['step_time_split']:.4f} s (mbs {row['micro_batch_size_split']}), fused step "
            f"{row['step_time_fused']:.4f} s (mbs {row['micro_batch_size']}, acc "
            f"{target // row['micro_batch_size']}), {row['training_days']:.3f} training days on one card; {card}")
    keep = ("state_layout", "max_micro_batch_size", "micro_batch_size", "micro_batch_size_split", "step_time",
            "step_time_split", "step_time_fused", "training_days")
    for line in format_table([{k: row[k] for k in keep} for row in rows]).splitlines():
        say(f"[search] {line}")
    say(f"[harness] phase {time.perf_counter() - t0:.1f} s")
    return launches


def _search(card: str) -> tuple[list[dict], int]:
    """The two-arm sweep, twice (see ``phase_harness``), in the workspace
    set; its result rows and the arms' target micro-batch."""
    import gc

    from multimodal_llm_pretraining_tpu_torch import benchmark as cli
    from multimodal_llm_pretraining_tpu_torch.benchmarking import max_batch_size
    from multimodal_llm_pretraining_tpu_torch.experiments import training_time_empirical as tte

    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    say(f"[search] parent's reserved memory before the first worker: {reserved} bytes ({reserved / 2**30:.3f} GiB)")
    if reserved >= PARENT_RESERVED_LIMIT:
        raise AssertionError(f"the parent holds {reserved} bytes reserved; the workers would lose them")
    sweep = cli.method_sweep(1, 1, "h100-sxm", SEARCH_MODEL, "all")
    sweep.search_space.update(activation_checkpointing=[True], checkpoint_policy=["dots"],
                              state_layout=list(SEARCH_LAYOUTS))

    def logged(spec: dict) -> dict:
        w0 = time.perf_counter()
        result = max_batch_size.run_probe_worker(spec)
        outcome = "out of memory" if result.get("oom") else "ran"
        times = {k: round(result[k], 4) for k in ("accumulate_s", "optimizer_s", "step_time_fused") if k in result}
        layout = {"sr": "bf16_sr", "device": "bf16_master"}[spec["plan"]["master_weights"]]
        say(f"[search] {layout} {spec['op']} mbs {spec['micro_batch_size']}"
            + (f" acc {spec['accumulation_steps']}" if "accumulation_steps" in spec else "")
            + f": {outcome} in a fresh worker, {time.perf_counter() - w0:.1f} s"
            + (f", {times}" if times else "")
            + (f", peak {result['peak_bytes'] / 2**30:.2f} GiB" if result.get("peak_bytes") else ""))
        return result

    tte.run_probe_worker = logged
    try:
        arms = sweep.experiments()
        if [a.config.state_layout for a in arms] != list(SEARCH_LAYOUTS):
            raise AssertionError(f"the restricted grid holds {[a.to_dict() for a in arms]}")
        s0 = time.perf_counter()
        sweep.sweep()
        say(f"[search] sweep of {len(arms)} arms: {time.perf_counter() - s0:.1f} s, "
            f"{max_batch_size.WORKER_STARTS} workers; {card}")
        starts = max_batch_size.WORKER_STARTS
        s0 = time.perf_counter()
        sweep.sweep()
        again = time.perf_counter() - s0
        done = sweep.count()
        say(f"[search] the same sweep again: {again:.2f} s, {max_batch_size.WORKER_STARTS - starts} workers, "
            f"{done[0]} / {done[1]} cached")
        if max_batch_size.WORKER_STARTS != starts or again >= CACHED_SWEEP_LIMIT_S or done != (2, 2):
            raise AssertionError("the second sweep did not come whole from the cache")
        return sweep.results(), arms[0].target_micro_batch_size
    finally:
        tte.run_probe_worker = max_batch_size.run_probe_worker


# ---------------------------------------------------------------- the last families: ViLT, RoBERTa, ConvNeXt

# the narrow ViLT of tests/test_torch_vilt.py: 2 trunk layers, 2 heads of 88 (the CLIP-g trunk's head dim)
VILT_SLICE = dict(hidden=176, num_layers=2, num_heads=2, intermediate=256, patch=14, image_size=28, vocab_size=512,
                  token_embed_dim=64)
VILT_SLICE_TEXT = 16
# vilt-pretrain at the main path's mbs 4: 16 heads of 88, 512 text + 256 patches + CLS = 769 positions, f32
VILT_SHAPE = (4, 16, 769, 88)
VILT_POSITIONS = 769
VILT_ORIGINAL_POSITIONS = 512 + 49 + 1
# vilt-pretrain's first loss, the sum of its three terms. MLM: mlm_ln1 gives
# each text row unit variance (square norm 1408) and the decoder's
# lecun-normal entries have variance 1/1408, so the 128,256 logits are about
# N(0, 1) and the loss about ln 128256 + 1/2 = 12.26. ITM: the pooler's
# tanh of an N(0, 1) pre-activation has E[tanh^2] about 0.39, so the two
# logits differ by about N(0, 0.79) and the loss is about ln 2 + 0.79 / 8 =
# 0.79, spread over the 8 random labels. WPA: 0.1 x (matched - mismatched
# OT distances) / B, each distance a cosine distance near 1: within 0.1 of
# 0. About 13.05; the band is 0.5 below and 0.7 above (ITM's spread)
VILT_LOSS_BAND = (12.55, 13.75)
VILT_ORIGINAL_LOSS_BAND = (11.12, 12.32)  # the same with ln 30522 + 1/2 = 10.83 for MLM: about 11.62
# RoBERTa-large at the main path's mbs 32: 16 heads of 64, 512 positions, bf16
ROBERTA_SHAPE = (32, 16, 512, 64)
# RoBERTa's first loss: mlm_ln gives unit rows (square norm 1024) and the
# tied decoder's rows are N(0, 0.02^2), so each logit is about N(0, 0.41):
# ln 50265 + 0.41 / 2 = 10.83 + 0.20 = 11.03; 0.5 either side
ROBERTA_LOSS_BAND = (10.53, 11.53)
ROBERTA_SLICE = dict(hidden=256, num_layers=2, num_heads=4, ffn=512, vocab_size=1024)  # head_dim 64
# ConvNeXt's first loss: the head LayerNorm gives unit rows (square norm
# 1536) and the classifier's lecun-normal kernel variance 1/1536, so the
# 1,000 logits are about N(0, 1): ln 1000 + 1/2 = 7.41; the mean of the 128
# labels' logits has a standard deviation of 1/11; 0.3 either side
CONVNEXT_LOSS_BAND = (7.11, 7.71)


def phase_vilt_slice() -> None:
    """The narrow ViLT of the CPU tests (2 trunk layers, 2 heads of 88
    zero-padded to 128, ffn 256, 512-token vocab, 16 text tokens, 28-px
    images at patch 14) in f32 with all three tasks on the card, TF32 off,
    the ITM text of two rows right-padded (WPA's ragged masks): loss and
    every grad with the kernels, under the fused and the split backward,
    against the plain f32 attention on the same weights. Three trunk passes
    of 2 blocks: 6 forwards and 6 backwards (or 6 dq + 6 dk/dv)."""
    from multimodal_llm_pretraining_tpu_torch.benchmarking.data import DummyMultimodalLanguageModelingForViltDataset
    from multimodal_llm_pretraining_tpu_torch.models.vilt import ViltForPretrain

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    host = DummyMultimodalLanguageModelingForViltDataset(512, VILT_SLICE_TEXT, 28, mask_token=511).sample_batch(4, 0)
    host["itm_attention_mask"][1, 9:] = 0
    host["itm_attention_mask"][2, 4:] = 0
    batch = {k: torch.from_numpy(v).to("cuda", torch.float32 if v.dtype == np.float32 else torch.long)
             for k, v in host.items()}

    def build(impl):
        model = ViltForPretrain(attn_impl=impl, **VILT_SLICE).to("cuda")
        model.reset_parameters(torch.Generator(device="cuda").manual_seed(0))
        return model

    want = {True: {"FWD_LAUNCHES": 6, "BWD_LAUNCHES": 6}, False: {"FWD_LAUNCHES": 6, "DQ_LAUNCHES": 6, "DKV_LAUNCHES": 6}}
    _slice_pair("[vilt slice] 2-layer f32, head_dim 88, mlm+itm+wpa", build, lambda m: m(batch)[0], want)


def kernel_entries_at(shape, causal: bool, dtype, seed: int, suffix: str) -> list[dict]:
    """The forward and the fused backward against their plain versions at a
    main path's shape (``check_kernels_at``), then CUDA-event times of both
    and of their plain versions, PyTorch's call (the flash backend for
    bf16; for f32 the backend PyTorch picks) and the bounds (from the
    caller's head dim: the padding is the kernels' cost, not the
    function's): the kernels JSON line's entries ``flash_fwd{suffix}`` and
    ``flash_bwd_fused{suffix}``."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    errs = check_kernels_at(shape, causal, seed=seed, dtype=dtype)
    q, k, v, do = _inputs(shape, seed + 1, dtype)
    scale = shape[-1] ** -0.5
    out, lse = fa.flash_fwd_reference(q, k, v, causal, scale)
    t = {
        "fwd": cuda_ms(lambda: fa.flash_fwd_cuda(q, k, v, causal, scale)),
        "fwd_plain": cuda_ms(lambda: fa.flash_fwd_reference(q, k, v, causal, scale)),
        "bwd": cuda_ms(lambda: fa.flash_bwd_cuda(q, k, v, out, lse, do, causal, scale)),
        "bwd_plain": cuda_ms(lambda: fa.flash_bwd_reference(q, k, v, out, lse, do, causal, scale)),
    }
    what = f"{str(dtype).split('.')[-1]} {'causal' if causal else 'non-causal'}"
    say(f"[kernels] ms a call at {list(shape)} {what}: " + ", ".join(f"{n} {ms:.3f}" for n, ms in t.items()))
    lib = sdpa_ms(q, k, v, do, causal, flash_only=dtype == torch.bfloat16)
    bounds = attention_bounds(q, k, v, do, causal)
    say_yardstick(shape, what, lib, bounds)
    say_forward(shape, what, t["fwd"], cuda_ms_alone(lambda: fa.flash_fwd_cuda(q, k, v, causal, scale)),
                fwd_flops(q, k, causal), bounds["fwd"], lib)
    say_backward(shape, what, t["bwd"], bwd_flops(q, k, causal), bounds["bwd"], lib)
    return [
        {"name": f"flash_fwd{suffix}", "route": "cuda", "source": FWD_SOURCE, "replaces": f"{JAX_FLASH}:91",
         "launches": None, "max_abs_err": errs["out"][0], "ms": t["fwd"], "plain_ms": t["fwd_plain"],
         **bounds["fwd"], "library_ms": lib["fwd"]},
        {"name": f"flash_bwd_fused{suffix}", "route": "cuda", "source": BWD_SOURCE, "replaces": f"{JAX_FLASH}:208",
         "launches": None, "max_abs_err": max(errs[n][0] for n in ("dq", "dk", "dv")), "ms": t["bwd"],
         "plain_ms": t["bwd_plain"], **bounds["bwd"], "library_ms": lib["bwd"]},
    ]


def phase_vilt_main_paths() -> tuple[dict, dict, list[dict]]:
    """The kernels at vilt-pretrain's shape ([4, 16, 769, 88] f32, plain
    mode, non-causal; ``kernel_entries_at``). Then vilt-pretrain at full
    width and depth (CLIP-g/14 trunk: 40 blocks, hidden 1408, 16 heads of
    88, ffn 6144; vocab 128,256) in the f32 layout (TF32 products), no
    remat, micro-batch 4 x accumulation 2 (the recipe's batch of 128 cut
    for one card), under the fused/split A/B schedule: three trunk passes
    a micro-batch, so 120 forwards and 120 fused backwards (or 120 dq + 120
    dk/dv). Then 2 steps of vilt-original-pretrain (ViLT-B/32: 12 blocks of
    12 heads of 64, 562 positions), micro-batch 32 x accumulation 2: 36 +
    36 a micro-batch. Returns the launches of all main-path runs, those at
    vilt-pretrain's shape, and the kernels line's entries at it."""
    entries = kernel_entries_at(VILT_SHAPE, False, torch.float32, 80, "_vilt")
    run = drive_training("vilt-pretrain", mbs=VILT_SHAPE[0], acc=2, remat=False, counters=fa,
                         loss_band=VILT_LOSS_BAND, layout="f32", names=FLASH_COUNTERS,
                         tokens_per_sample=VILT_POSITIONS, split_ab=True)
    mod = run["module"]
    if (mod.vilt.layers[0].attn.head_dim, mod.vilt.image_position_embeddings.shape[1], mod.mlm_decoder.shape) != (
            VILT_SHAPE[3], 257, (1408, 128256)):
        raise AssertionError("vilt-pretrain: not the CLIP-g/14 trunk at 224 px with the 128,256-token decoder")
    passes = 3 * len(mod.vilt.layers)
    expected = flash_launches_expected(FLASH_COUNTERS, passes, 0, run["micro_batches"])
    if run["launches"] != expected:
        raise AssertionError(f"vilt-pretrain flash launches {run['launches']}, expected {expected}")
    say(f"[vilt] vilt-pretrain: {passes} forwards and {passes} backwards a micro-batch (3 trunk passes of "
        f"{len(mod.vilt.layers)} blocks), every attention call on the kernels")
    at_shape = flash_launch_entries(run["launches"])
    launches = at_shape | xent_launch_entries(run, "vilt-pretrain")
    del run, mod
    original = drive_training("vilt-original-pretrain", mbs=32, acc=2, remat=False, counters=fa,
                              loss_band=VILT_ORIGINAL_LOSS_BAND, layout="f32", names=FLASH_COUNTERS,
                              tokens_per_sample=VILT_ORIGINAL_POSITIONS, steps=2)
    layers = len(original["module"].vilt.layers)
    expected = flash_launches_expected(FLASH_COUNTERS, 3 * layers, 0, original["micro_batches"])
    if original["launches"] != expected:
        raise AssertionError(f"vilt-original-pretrain flash launches {original['launches']}, expected {expected}")
    for name, n in (flash_launch_entries(original["launches"])
                    | xent_launch_entries(original, "vilt-original-pretrain")).items():
        launches[name] += n
    return launches, at_shape, entries


def phase_roberta(card: str) -> tuple[dict, dict, list[dict]]:
    """RoBERTa-large: the kernels at its shape ([32, 16, 512, 64] bf16,
    plain mode, non-causal; ``kernel_entries_at``); a narrow 2-layer slice
    in bf16 (hidden 256, 4 heads of 64, dropout off) with the kernels under
    both backwards against the plain f32 attention; then the main path at
    full width and depth (24 post-LN blocks, vocab 50,265, dropout on) in
    the recipe's layout ("fp16" as bf16 compute over f32 params and
    moments), micro-batch 32 x accumulation 2 (the recipe's batch of 8192
    cut for one card), under the A/B schedule: 24 forwards and 24 backwards
    a micro-batch; then the same without remat and under "flash", 2 split
    steps each: equal losses and the dropout generator in the same state
    after the steps (the recompute replays the masks). Returns the launches
    of all these runs, those at the shape (the same runs) and the kernels
    line's entries."""
    from multimodal_llm_pretraining_tpu_torch.models.roberta import RobertaMLM

    entries = kernel_entries_at(ROBERTA_SHAPE, False, torch.bfloat16, 90, "_roberta")
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 1024, (4, 128))).to("cuda")
    labels = torch.where(torch.from_numpy(rng.random((4, 128)) < 0.15).to("cuda"), ids, -100)

    def build(impl):
        model = RobertaMLM(**ROBERTA_SLICE, attn_impl=impl, dtype=torch.bfloat16).to("cuda")
        model.reset_parameters(torch.Generator(device="cuda").manual_seed(0))
        return model

    want = {True: {"FWD_LAUNCHES": 2, "BWD_LAUNCHES": 2}, False: {"FWD_LAUNCHES": 2, "DQ_LAUNCHES": 2, "DKV_LAUNCHES": 2}}
    # bf16 compute rounds every activation downstream of the two backwards' dq
    # (f32 atomics against one sum), so split and fused are held to the slice tolerance
    _slice_pair("[roberta slice] 2-layer bf16, head_dim 64", build, lambda m: m(ids, labels=labels), want,
                tol_split=TOL_SLICE_GRAD_NORM_REL)

    run = drive_training("roberta", mbs=ROBERTA_SHAPE[0], acc=2, remat=False, counters=fa,
                         loss_band=ROBERTA_LOSS_BAND, layout="bf16", names=FLASH_COUNTERS, split_ab=True)
    mod = run["module"]
    if (len(mod.layers), mod.word_embeddings.shape, mod.layers[0].attn.head_dim) != (24, (50265, 1024), 64):
        raise AssertionError("roberta: not RoBERTa-large")
    expected = flash_launches_expected(FLASH_COUNTERS, len(mod.layers), 0, run["micro_batches"])
    if run["launches"] != expected:
        raise AssertionError(f"roberta flash launches {run['launches']}, expected {expected}")
    launches = flash_launch_entries(run["launches"]) | xent_launch_entries(run, "roberta")
    del run, mod
    plain, remat = _remat_pair("roberta", mbs=ROBERTA_SHAPE[0], acc=2, loss_band=ROBERTA_LOSS_BAND, layout="bf16")
    if not torch.equal(remat["dropout_state"], plain["dropout_state"]):
        raise AssertionError("roberta remat: the dropout generator's state differs from the run without remat")
    expected = flash_launches_expected(FLASH_COUNTERS, len(remat["module"].layers), 0, remat["micro_batches"])
    if remat["launches"] != expected:
        raise AssertionError(f"roberta remat flash launches {remat['launches']}, expected {expected}")
    say(f"[remat] roberta: dropout generator state after the steps equal to the run without remat; peak "
        f"{remat['peak'] / 2**30:.2f} GiB under remat, {plain['peak'] / 2**30:.2f} GiB without; {card}")
    for run, name in ((plain, "roberta"), (remat, "roberta remat")):
        for k, n in (flash_launch_entries(run["launches"]) | xent_launch_entries(run, name)).items():
            launches[k] += n
    return launches, entries


def phase_convnext_main_path() -> None:
    """convnext-large-1k at full width and depth (stages of 3/3/27/3 blocks,
    192 to 1536 channels, 224 px, 1,000 classes) in the f32 layout (TF32
    products and convolutions), micro-batch 64 x accumulation 2 (the
    recipe's batch of 4096 cut for one card), 1 warmup + 3 timed steps. No
    attention and no scan: no kernel of the port runs, and none may."""
    run = drive_training("convnext-large-1k", mbs=64, acc=2, remat=False, counters=fa,
                         loss_band=CONVNEXT_LOSS_BAND, layout="f32", names=FLASH_COUNTERS, tokens_per_sample=1)
    if any(run["launches"].values()):
        raise AssertionError(f"convnext: flash launches {run['launches']}")
    mod = run["module"]
    if (mod.depths, mod.classifier.weight.shape) != ((3, 3, 27, 3), (1000, 1536)):
        raise AssertionError("convnext: not convnext-large-1k")


# ---------------------------------------------------------------- LM-head loss

XENT_SOURCE = "multimodal_llm_pretraining_tpu_torch/csrc/xent.cu"
XENT_CHUNK = (1024, 50304)  # pythia-1b's chunk of the LM-head loss: 1024 rows of its vocab
XENT_LLAVA_CHUNK = (1024, 128257, 128264)  # llava's: 1024 rows of 128,257, padded to 128,264
XENT_MICRO_BATCH = (16 * 2048, 2048)  # the benchmark's pythia-1b micro-batch: 16 rows of 2049 tokens, shifted
# kernel vs plain version, all f32 inside (as tests/test_torch_kernels.py):
# lse and each row's nll absolute, dlogits relative to their norm (bf16: one
# rounding of values that may lie an ulp apart)
TOL_XENT_LSE_ABS = 1e-4
TOL_XENT_D_NORM_REL = 4e-3
# the loss on the kernels vs the pre-change autograd path, at the micro-batch
TOL_XENT_LOSS_REL = 1e-5
TOL_XENT_GRAD_NORM_REL = 2e-3


def _xent_chunk(rows: int, vocab: int, width: int, seed: int):
    """f32 logits about N(0, 9) with each seventh row ignored; NaN past
    ``vocab`` and on the ignored rows, which the kernels never read."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn(rows, width, generator=g, device="cuda") * 3
    labels = torch.randint(0, vocab, (rows,), generator=g, device="cuda")
    labels[::7] = -100
    logits[:, vocab:] = float("nan")
    logits[labels == -100] = float("nan")
    return logits, labels


def check_xent_at(rows: int, vocab: int, width: int, seed: int) -> dict:
    """Both xent kernels against their plain versions (bf16 dlogits); a
    second forward and backward must repeat the first bit for bit, and
    ignored rows and padded columns must come out 0."""
    from multimodal_llm_pretraining_tpu_torch.ops import xent

    logits, labels = _xent_chunk(rows, vocab, width, seed)
    valid = labels != -100
    lse_ref, nll_ref = xent.xent_fwd_reference(logits, labels, vocab, -100)
    runs = []
    for _ in range(2):
        lse, nll = torch.empty(rows, device="cuda"), torch.empty(rows, device="cuda")
        xent.xent_fwd_cuda(logits, labels, vocab, -100, lse, nll)
        runs.append((lse, nll))
    scale = torch.tensor(1.0 / int(valid.sum()), device="cuda")
    d_ref = xent.xent_bwd_reference(logits, labels, lse_ref, scale, vocab, -100, torch.bfloat16)
    d = xent.xent_bwd_cuda(logits, labels, lse_ref, scale, vocab, -100, torch.bfloat16)
    d2 = xent.xent_bwd_cuda(logits, labels, lse_ref, scale, vocab, -100, torch.bfloat16)
    (lse, nll), (lse2, nll2) = runs
    errs = {"lse": _errs(lse[valid], lse_ref[valid]), "nll": _errs(nll[valid], nll_ref[valid]),
            "dlogits": _errs(d, d_ref)}
    repeat = torch.equal(lse, lse2) and torch.equal(nll, nll2) and torch.equal(d, d2)
    zeros = not (d[~valid].any() or d[:, vocab:].any() or lse[~valid].any() or nll[~valid].any())
    say(f"[xent] kernels vs plain at [{rows}, {vocab}] (width {width}): lse max_abs {errs['lse'][0]:.2e}, nll "
        f"max_abs {errs['nll'][0]:.2e}, dlogits bf16 norm_rel {errs['dlogits'][1]:.2e}; second run identical "
        f"{repeat}, ignored rows and padding 0 {zeros}")
    if not (max(errs["lse"][0], errs["nll"][0]) <= TOL_XENT_LSE_ABS and errs["dlogits"][1] <= TOL_XENT_D_NORM_REL
            and repeat and zeros):
        raise AssertionError(f"xent kernels at [{rows}, {vocab}]: {errs}, repeat {repeat}, zeros {zeros}")
    return errs


def _xent_autograd_dlogits(logits, labels, vocab: int, scale):
    """The chain the kernels replace, as the pre-change backward ran it on a
    chunk's recomputed logits: logsumexp and the gather, autograd's backward
    through them, and the cast to bf16 (the yardstick; the port never calls
    it)."""
    x = logits.detach().requires_grad_()
    valid = labels != -100
    gold = x[:, :vocab].gather(-1, torch.where(valid, labels, 0)[:, None])[:, 0]
    nll = ((torch.logsumexp(x[:, :vocab], dim=-1) - gold) * valid).sum()
    (g,) = torch.autograd.grad(nll * scale, x)
    return g.to(torch.bfloat16)


def phase_xent() -> list[dict]:
    """The LM-head loss's kernels: against their plain versions at pythia's
    and llava's chunks, then timed at pythia's beside their bounds, their
    plain versions and the yardsticks (``torch.logsumexp``; the pre-change
    autograd chain); then the whole loss, forward and backward, at the
    benchmark's pythia-1b micro-batch on the kernels and on the pre-change
    path (``xent_autograd_yardstick``), their losses and gradients held to
    each other. The kernels JSON line's entries ``xent_fwd``, ``xent_bwd``."""
    from multimodal_llm_pretraining_tpu_torch.ops import xent

    errs = check_xent_at(*XENT_CHUNK, XENT_CHUNK[1], seed=20)
    check_xent_at(*XENT_LLAVA_CHUNK, seed=21)
    rows, vocab = XENT_CHUNK
    logits, labels = _xent_chunk(rows, vocab, vocab, seed=22)
    logits = torch.nan_to_num(logits)  # the plain versions and yardsticks read every row
    labels = labels.clamp_min(0)  # every row counts, as in a packed pythia batch
    lse, _ = xent.xent_fwd_reference(logits, labels, vocab, -100)
    lse_k, nll_k = torch.empty(rows, device="cuda"), torch.empty(rows, device="cuda")
    scale = torch.tensor(1.0 / XENT_MICRO_BATCH[0], device="cuda")
    t = {
        "fwd": cuda_ms(lambda: xent.xent_fwd_cuda(logits, labels, vocab, -100, lse_k, nll_k)),
        "fwd_plain": cuda_ms(lambda: xent.xent_fwd_reference(logits, labels, vocab, -100)),
        "fwd_library": cuda_ms(lambda: torch.logsumexp(logits, dim=-1)),
        "bwd": cuda_ms(lambda: xent.xent_bwd_cuda(logits, labels, lse, scale, vocab, -100, torch.bfloat16)),
        "bwd_plain": cuda_ms(lambda: xent.xent_bwd_reference(logits, labels, lse, scale, vocab, -100, torch.bfloat16)),
        "bwd_library": cuda_ms(lambda: _xent_autograd_dlogits(logits, labels, vocab, scale)),
    }
    say(f"[xent] ms a call at {list(XENT_CHUNK)}: " + ", ".join(f"{n} {ms:.4f}" for n, ms in t.items()))
    # bytes: each logit and label read once; the forward writes lse and nll, the backward
    # reads lse and writes bf16 dlogits
    ins = _nbytes(logits, labels)
    bounds = {"fwd": bound(ins + 2 * _nbytes(lse), exps=logits.numel()),
              "bwd": bound(ins + _nbytes(lse) + logits.numel() * 2, exps=logits.numel())}
    for n in ("fwd", "bwd"):
        say(f"[xent] {n} at {list(XENT_CHUNK)}: {t[n]:.4f} ms a call, bound {bounds[n]['bound_ms']:.4f} ms "
            f"({bounds[n]['bound_by']}), {bounds[n]['bound_ms'] / t[n]:.3f} of it; plain {t[n + '_plain']:.4f} ms, "
            f"yardstick {t[n + '_library']:.4f} ms ({t[n + '_library'] / t[n]:.2f}x the kernel)")
    del logits

    n_tok, hidden = XENT_MICRO_BATCH
    g = torch.Generator(device="cuda").manual_seed(23)
    h = torch.randn(n_tok, hidden, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn(hidden, vocab, generator=g, device="cuda") * hidden**-0.5).to(torch.bfloat16)
    tokens = torch.randint(0, vocab, (n_tok,), generator=g, device="cuda")
    results, times = {}, {}
    for name, fn in (("kernels", xent.chunked_lm_cross_entropy), ("pre-change", xent.xent_autograd_yardstick)):
        hh, ww = h.clone().requires_grad_(), w.clone().requires_grad_()

        def fwd_bwd():
            hh.grad = ww.grad = None
            loss = fn(hh, ww, tokens)
            loss.backward()
            return loss

        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times[name] = cuda_ms(fwd_bwd, warmup=1, iters=3, reps=3)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        results[name] = (fwd_bwd().detach(), hh.grad, ww.grad)
        say(f"[xent] loss at the micro-batch [{n_tok}, {hidden}] x {vocab} bf16 on the {name} path: "
            f"{times[name]:.2f} ms forward and backward, {peak:.2f} GiB above its inputs")
    (loss, dh, dw), (loss_ref, dh_ref, dw_ref) = results["kernels"], results["pre-change"]
    gaps = {"loss": abs(loss.item() - loss_ref.item()) / abs(loss_ref.item()),
            "dh": _errs(dh, dh_ref)[1], "dw": _errs(dw, dw_ref)[1]}
    say(f"[xent] micro-batch: {times['pre-change'] / times['kernels']:.2f}x faster than the pre-change path; loss "
        f"{loss.item():.6f} against {loss_ref.item():.6f} (rel {gaps['loss']:.1e}), grads norm_rel hidden "
        f"{gaps['dh']:.1e}, head {gaps['dw']:.1e}")
    if gaps["loss"] > TOL_XENT_LOSS_REL or max(gaps["dh"], gaps["dw"]) > TOL_XENT_GRAD_NORM_REL:
        raise AssertionError(f"xent loss on the kernels vs the pre-change path: {gaps}")
    return [
        {"name": "xent_fwd", "route": "cuda", "source": XENT_SOURCE, "replaces": None, "launches": None,
         "max_abs_err": errs["lse"][0], "ms": t["fwd"], "plain_ms": t["fwd_plain"], **bounds["fwd"],
         "library_ms": t["fwd_library"]},
        {"name": "xent_bwd", "route": "cuda", "source": XENT_SOURCE, "replaces": None, "launches": None,
         "max_abs_err": errs["dlogits"][0], "ms": t["bwd"], "plain_ms": t["bwd_plain"], **bounds["bwd"],
         "library_ms": t["bwd_library"]},
    ]


# ---------------------------------------------------------------- RMSNorm

RMSNORM_SOURCE = "multimodal_llm_pretraining_tpu_torch/csrc/rmsnorm.cu"
RMSNORM_SHAPE = (8 * 4096, 2560)  # mamba-2.8b at the benchmark's micro-batch: 8 rows of 4096 tokens, d_model 2560
RMSNORM_LLAVA_SHAPE = (16 * LLAVA_TOKENS_PER_SAMPLE, 2048)  # llava-pretrain's decoder at mbs 16
RMSNORM_EPS = 1e-5
# kernel vs plain version (as tests/test_torch_kernels.py): both in f32, in
# another summation order and with the kernel's rsqrtf; rstd, f32 dx and the
# scale's gradient within 1e-5 of their norm, bf16 outputs within one bf16
# rounding
TOL_RMSNORM_F32 = 1e-5
TOL_RMSNORM_BF16 = 4e-3


def _rmsnorm_tol(dtype: torch.dtype) -> float:
    return TOL_RMSNORM_BF16 if dtype == torch.bfloat16 else TOL_RMSNORM_F32


def _rmsnorm_inputs(rows: int, cols: int, x_dtype, y_dtype, residual: bool, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(rows, cols, generator=g, device="cuda") * 3 + 0.5).to(x_dtype)
    w = torch.rand(cols, generator=g, device="cuda") + 0.5
    dy = torch.randn(rows, cols, generator=g, device="cuda").to(y_dtype)
    dres = torch.randn(rows, cols, generator=g, device="cuda").to(x_dtype) if residual else None
    return x, w, dy, dres


def check_rmsnorm_at(rows: int, cols: int, x_dtype, y_dtype, residual: bool, seed: int) -> dict:
    """Both norm kernels against their plain versions; a second launch of
    each must repeat the first bit for bit."""
    from multimodal_llm_pretraining_tpu_torch.ops import rmsnorm

    x, w, dy, dres = _rmsnorm_inputs(rows, cols, x_dtype, y_dtype, residual, seed)
    y_ref, rstd_ref = rmsnorm.rmsnorm_fwd_reference(x, w, RMSNORM_EPS, y_dtype)
    dx_ref, dw_ref = rmsnorm.rmsnorm_bwd_reference(dy, x, rstd_ref, w, dres)
    runs = [(*rmsnorm.rmsnorm_fwd_cuda(x, w, RMSNORM_EPS, y_dtype), *rmsnorm.rmsnorm_bwd_cuda(dy, x, rstd_ref, w, dres))
            for _ in range(2)]
    y, rstd, dx, dw = runs[0]
    errs = {"y": _errs(y, y_ref), "rstd": _errs(rstd, rstd_ref), "dx": _errs(dx, dx_ref), "dw": _errs(dw, dw_ref)}
    repeat = all(torch.equal(a, b) for a, b in zip(*runs))
    say(f"[rmsnorm] kernels vs plain at [{rows}, {cols}] {str(x_dtype)[6:]} -> {str(y_dtype)[6:]}"
        f"{' with the residual' if residual else ''}: " + ", ".join(f"{n} norm_rel {e[1]:.1e}" for n, e in errs.items())
        + f"; second run identical {repeat}")
    if not (errs["y"][1] <= _rmsnorm_tol(y_dtype) and errs["dx"][1] <= _rmsnorm_tol(x_dtype)
            and max(errs["rstd"][1], errs["dw"][1]) <= TOL_RMSNORM_F32 and repeat):
        raise AssertionError(f"rmsnorm kernels at [{rows}, {cols}]: {errs}, repeat {repeat}")
    return errs


def phase_rmsnorm() -> list[dict]:
    """The norm kernels: against their plain versions at mamba's benchmark
    micro-batch (a block's norm with the residual, the final norm without),
    llava's decoder and a ragged row; then timed at mamba's shape beside
    their bounds, their plain versions and the yardsticks (``F.rms_norm``
    and the cast to bf16; the pre-change autograd chain's backward and the
    residual's add). The kernels JSON line's entries ``rmsnorm_fwd``,
    ``rmsnorm_bwd``."""
    from multimodal_llm_pretraining_tpu_torch.ops import rmsnorm

    rows, cols = RMSNORM_SHAPE
    errs = check_rmsnorm_at(rows, cols, torch.float32, torch.bfloat16, True, seed=30)
    check_rmsnorm_at(rows, cols, torch.float32, torch.bfloat16, False, seed=31)
    check_rmsnorm_at(*RMSNORM_LLAVA_SHAPE, torch.bfloat16, torch.bfloat16, False, seed=32)
    check_rmsnorm_at(3, 100, torch.bfloat16, torch.float32, True, seed=33)

    x, w, dy, dres = _rmsnorm_inputs(rows, cols, torch.float32, torch.bfloat16, True, seed=34)
    y, rstd = rmsnorm.rmsnorm_fwd_cuda(x, w, RMSNORM_EPS, torch.bfloat16)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    y_chain = (xg * (torch.rsqrt(xg.square().mean(-1, keepdim=True) + RMSNORM_EPS) * wg)).to(torch.bfloat16)

    def chain_backward():
        dx, _ = torch.autograd.grad(y_chain, (xg, wg), dy, retain_graph=True)
        return dx + dres

    t = {
        "fwd": cuda_ms(lambda: rmsnorm.rmsnorm_fwd_cuda(x, w, RMSNORM_EPS, torch.bfloat16)),
        "fwd_plain": cuda_ms(lambda: rmsnorm.rmsnorm_fwd_reference(x, w, RMSNORM_EPS, torch.bfloat16)),
        "fwd_library": cuda_ms(lambda: torch.nn.functional.rms_norm(x, (cols,), w, RMSNORM_EPS).to(torch.bfloat16)),
        "bwd": cuda_ms(lambda: rmsnorm.rmsnorm_bwd_cuda(dy, x, rstd, w, dres)),
        "bwd_plain": cuda_ms(lambda: rmsnorm.rmsnorm_bwd_reference(dy, x, rstd, w, dres)),
        "bwd_library": cuda_ms(chain_backward),
    }
    say(f"[rmsnorm] ms a call at {list(RMSNORM_SHAPE)} f32 -> bf16: " + ", ".join(f"{n} {ms:.4f}" for n, ms in t.items()))
    # bytes: the forward reads the f32 stream and the scale and writes bf16 y and an f32 rstd a row; the
    # backward reads bf16 dy, the stream, rstd, the scale and the residual's f32 gradient, and writes the
    # stream's f32 gradient and the scale's
    small = _nbytes(w, rstd)
    bounds = {"fwd": bound(_nbytes(x, y) + small), "bwd": bound(_nbytes(dy, x, dres, x) + 2 * small)}
    for n in ("fwd", "bwd"):
        say(f"[rmsnorm] {n} at {list(RMSNORM_SHAPE)}: {t[n]:.4f} ms a call, bound {bounds[n]['bound_ms']:.4f} ms "
            f"({bounds[n]['bound_by']}), {bounds[n]['bound_ms'] / t[n]:.3f} of it; plain {t[n + '_plain']:.4f} ms, "
            f"yardstick {t[n + '_library']:.4f} ms ({t[n + '_library'] / t[n]:.2f}x the kernel)")
    return [
        {"name": "rmsnorm_fwd", "route": "cuda", "source": RMSNORM_SOURCE, "replaces": None, "launches": None,
         "max_abs_err": errs["y"][0], "ms": t["fwd"], "plain_ms": t["fwd_plain"], **bounds["fwd"],
         "library_ms": t["fwd_library"]},
        {"name": "rmsnorm_bwd", "route": "cuda", "source": RMSNORM_SOURCE, "replaces": None, "launches": None,
         "max_abs_err": errs["dx"][0], "ms": t["bwd"], "plain_ms": t["bwd_plain"], **bounds["bwd"],
         "library_ms": t["bwd_library"]},
    ]


# ---------------------------------------------------------------- causal conv

CONV_SOURCE = "multimodal_llm_pretraining_tpu_torch/csrc/causal_conv.cu"
CONV_SHAPE = (8, 4096, 5120, 4)  # mamba-2.8b at the benchmark's micro-batch: B, L, d_inner, d_conv
# kernel vs plain version (as tests/test_torch_kernels.py): both in f32, in another order and with the
# kernels' fast exp; out and dx within one rounding of x's dtype elementwise (2^-7 of the value in bf16)
# plus 1e-5 of the largest entry, dw and db in f32 within 1e-5 of their norm, in bf16 one bf16 rounding
TOL_CONV_ELEM_BF16 = 2.0**-7
TOL_CONV_F32_NORM_REL = 1e-5
TOL_CONV_BF16_NORM_REL = 4e-3


def _conv_inputs(B: int, L: int, I: int, K: int, p_dtype, seed: int):
    """bf16 x (the first half of [B, L, 2I]) and dout N(0, 1), the taps and
    bias uniform in [-0.5, 0.5) in ``p_dtype``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, L, 2 * I, generator=g, device="cuda").to(torch.bfloat16)[..., :I]
    w = (torch.rand(K, I, generator=g, device="cuda") - 0.5).to(p_dtype)
    b = (torch.rand(I, generator=g, device="cuda") - 0.5).to(p_dtype)
    dout = torch.randn(B, L, I, generator=g, device="cuda").to(torch.bfloat16)
    return x, w, b, dout


def _conv_chain(x, w, b):
    """The pre-kernel chain on the card: the f32 composition, then the copy to
    contiguous that ``x_proj``'s product made of its channel-first result."""
    from multimodal_llm_pretraining_tpu_torch.ops.selective_scan import causal_conv1d

    return torch.nn.functional.silu(causal_conv1d(x.float(), w.float(), b.float())).to(x.dtype).contiguous()


def check_conv_at(B: int, L: int, I: int, K: int, p_dtype, seed: int) -> dict:
    """Both conv kernels against their plain versions (PyTorch's native
    depthwise conv, cuDNN off); a second launch of each must repeat the
    first bit for bit."""
    from multimodal_llm_pretraining_tpu_torch.ops import causal_conv as cc

    x, w, b, dout = _conv_inputs(B, L, I, K, p_dtype, seed)
    with torch.backends.cudnn.flags(enabled=False):
        ref = (cc.causal_conv_fwd_reference(x, w, b), *cc.causal_conv_bwd_reference(x, w, b, dout))
    runs = [(cc.causal_conv_fwd_cuda(x, w, b), *cc.causal_conv_bwd_cuda(x, w, b, dout)) for _ in range(2)]
    names = ("out", "dx", "dw", "db")
    errs = {n: _errs(got, want) for n, got, want in zip(names, runs[0], ref)}
    elem = {n: ((got.float() - want.float()).abs() - TOL_CONV_ELEM_BF16 * want.float().abs()).max().item()
            / max(want.float().abs().max().item(), 1e-30) for n, got, want in zip(("out", "dx"), runs[0], ref)}
    repeat = all(torch.equal(a, c) for a, c in zip(*runs))
    say(f"[conv] kernels vs plain at [{B}, {L}, {I}] K {K} bf16, {str(p_dtype)[6:]} parameters: "
        + ", ".join(f"{n} max_abs {e[0]:.1e} norm_rel {e[1]:.1e}" for n, e in errs.items())
        + f"; out and dx past one bf16 rounding by at most {max(elem.values()):.1e} of the largest entry"
        + f"; second run identical {repeat}")
    p_tol = TOL_CONV_F32_NORM_REL if p_dtype == torch.float32 else TOL_CONV_BF16_NORM_REL
    if not (max(elem.values()) <= 1e-5 and max(errs["dw"][1], errs["db"][1]) <= p_tol and repeat):
        raise AssertionError(f"causal-conv kernels at [{B}, {L}, {I}]: {errs}, {elem}, repeat {repeat}")
    return errs


def phase_causal_conv() -> list[dict]:
    """The conv kernels: against their plain versions at mamba's benchmark
    micro-batch (the strided half, bf16 and f32 parameters) and at a ragged
    shape; then timed at mamba's shape beside their bounds, their plain
    versions and the pre-kernel chain (``_conv_chain``, and its autograd
    backward). The kernels JSON line's entries ``causal_conv_fwd``,
    ``causal_conv_bwd``."""
    from multimodal_llm_pretraining_tpu_torch.ops import causal_conv as cc

    B, L, I, K = CONV_SHAPE
    errs = check_conv_at(B, L, I, K, torch.bfloat16, seed=40)
    check_conv_at(B, L, I, K, torch.float32, seed=41)
    check_conv_at(2, 300, 100, 3, torch.bfloat16, seed=42)

    x, w, b, dout = _conv_inputs(B, L, I, K, torch.bfloat16, seed=43)
    xg, wg, bg = x.detach().requires_grad_(), w.clone().requires_grad_(), b.clone().requires_grad_()
    out_chain = _conv_chain(xg, wg, bg)
    t = {
        "fwd": cuda_ms(lambda: cc.causal_conv_fwd_cuda(x, w, b)),
        "fwd_plain": cuda_ms(lambda: cc.causal_conv_fwd_reference(x, w, b)),
        "fwd_library": cuda_ms(lambda: _conv_chain(x, w, b)),
        "bwd": cuda_ms(lambda: cc.causal_conv_bwd_cuda(x, w, b, dout)),
        "bwd_plain": cuda_ms(lambda: cc.causal_conv_bwd_reference(x, w, b, dout)),
        "bwd_library": cuda_ms(lambda: torch.autograd.grad(out_chain, (xg, wg, bg), dout, retain_graph=True)),
    }
    say(f"[conv] ms a call at {list(CONV_SHAPE)} bf16: " + ", ".join(f"{n} {ms:.4f}" for n, ms in t.items()))
    # bytes: the forward reads x, the taps and the bias and writes out; the backward reads x, dout, the taps
    # and the bias and writes dx and the f32 sums of dw and db
    small = _nbytes(w, b)
    bounds = {"fwd": bound(2 * _nbytes(dout) + small),
              "bwd": bound(3 * _nbytes(dout) + small + (K + 1) * I * 4)}
    for n in ("fwd", "bwd"):
        say(f"[conv] {n} at {list(CONV_SHAPE)}: {t[n]:.4f} ms a call, bound {bounds[n]['bound_ms']:.4f} ms "
            f"({bounds[n]['bound_by']}), {bounds[n]['bound_ms'] / t[n]:.3f} of it; plain {t[n + '_plain']:.4f} ms, "
            f"pre-kernel chain {t[n + '_library']:.4f} ms ({t[n + '_library'] / t[n]:.2f}x the kernel)")
    return [
        {"name": "causal_conv_fwd", "route": "cuda", "source": CONV_SOURCE, "replaces": None, "launches": None,
         "max_abs_err": errs["out"][0], "ms": t["fwd"], "plain_ms": t["fwd_plain"], **bounds["fwd"],
         "library_ms": t["fwd_library"]},
        {"name": "causal_conv_bwd", "route": "cuda", "source": CONV_SOURCE, "replaces": None, "launches": None,
         "max_abs_err": errs["dx"][0], "ms": t["bwd"], "plain_ms": t["bwd_plain"], **bounds["bwd"],
         "library_ms": t["bwd_library"]},
    ]


def families(card: str, add) -> list[dict]:
    """Phases 22-25; returns the kernels line's entries at ViLT's and
    RoBERTa's shapes, each with the launches of the main paths at that
    shape (which the ``flash_fwd`` and ``flash_bwd_fused`` totals include)."""
    phase_vilt_slice()
    vilt_launches, vilt_at_shape, entries = phase_vilt_main_paths()
    add(vilt_launches)
    roberta_launches, roberta_entries = phase_roberta(card)
    add(roberta_launches)
    phase_convnext_main_path()
    for entry in entries:
        entry["launches"] = vilt_at_shape[entry["name"].rsplit("_", 1)[0]]
    for entry in roberta_entries:
        entry["launches"] = roberta_launches[entry["name"].rsplit("_", 1)[0]]
    return entries + roberta_entries


def main() -> int:
    t_start = time.perf_counter()
    card = phase_env()
    phase_build()
    xent_kernels = phase_xent()
    norm_kernels = phase_rmsnorm()
    conv_kernels = phase_causal_conv()
    pythia_times, kernels = phase_kernels()
    phase_slice()
    launches: dict[str, int] = {}

    def add(counts: dict) -> None:
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    add(phase_main_path())
    kernels += phase_scan_kernels()
    phase_scan_slice()
    add(phase_mamba_main_path())
    decoder_times, varlen = phase_varlen_kernels()
    kernels += varlen
    phase_llava_slice()
    add(phase_llava_main_path())
    kernels += phase_split_kernels(pythia_times, decoder_times)
    phase_vit_slice()
    add(phase_vit_main_path())
    phase_head_dims()
    phase_many_heads()
    phase_repairs()
    remat_launches, bf16_sr_run = phase_remat(card)
    add(remat_launches)
    add(phase_remat_vit())
    add(phase_remat_llava())
    add(phase_harness(card, bf16_sr_run))
    shaped = families(card, add)
    kernels += xent_kernels + norm_kernels + conv_kernels
    for k in kernels:
        k["launches"] = launches[k["name"]]
    kernels += shaped
    say(f"[total] chip_smoke wall time {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
