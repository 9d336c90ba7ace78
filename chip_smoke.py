"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Each kernel's correctness is the card tests' (``python -m pytest --noconftest
tests/test_torch_kernels.py -m cuda``). This script times each kernel at the
one shape the kernel table reports, guarded by one comparison with its plain
version there, and runs the main paths at full size. Phases, in order; any
failure exits non-zero:

1. env: the card (``nvidia-smi`` name and power limit), torch, CUDA and nvcc.
2. build: every ``csrc/`` source, one nvcc each, in parallel; a ``[ptxas]`` line per kernel.
3. LM-head loss kernels at pythia-1b's chunk; the whole loss at the benchmark's micro-batch against the pre-change path.
4. RMSNorm kernels at mamba-2.8b's micro-batch ([32768, 2560] f32 in, bf16 out, the residual's gradient).
5. causal-conv kernels at mamba-2.8b's micro-batch ([8, 4096, 5120] bf16, x a strided half), then the
   gate kernels there (z a strided half).
6. flash kernels at pythia-1b's attention ([4, 8, 2049, 256] bf16 causal): forward, fused and split backward.
7. pythia slice: a 2-layer GPTNeoX, loss and grads with the kernels against the plain f32 attention.
8. pythia-1b main path: the training step at full size, every attention call on the kernels.
9. scan kernels at mamba-2.8b's [2, 4096, 5120] bf16, d_state 16.
10. scan slice: a 2-layer narrow Mamba in f32 against the plain chunked scan.
11. mamba-2.8b main path under block remat: every scan, norm, conv and gate call on the kernels, every
    scan backward in its skip mode.
12. flash kernels at the llava decoder's [16, 32, 1087, 64] (varlen mode) and the tower's [16, 16, 577, 64].
13. llava slice: a 2-layer narrow LLaVA on a right-padded batch.
14. llava-pretrain main path: frozen leaves bit for bit, the projector moving.
15. flash kernels at ViT's [128, 16, 197, 64] f32: forward, fused and split backward.
16. ViT slice under both backwards. 17. ViT-L/16 main path, dropout on.
18. head dims: 2 steps each of pythia-14m (D 32) and pythia-2.8b cut to 2 layers (D 80).
19. remat: pythia-1b without remat, under "dots" and "flash": equal first loss, grads bit for bit.
20. remat-ViT and 21. remat-llava: equal losses, dropout state and frozen leaves.
22. harness and method search: phase times, a ``bf16_master`` session, FLOP counts, the two-arm sweep.
23. ViLT slice; 24. the kernels at vilt-pretrain's shape, vilt-pretrain and vilt-original-pretrain.
25. RoBERTa: the kernels at its shape, a slice, the main path and its remat pair. 26. ConvNeXt main path.

Main paths 8, 14, 17, 24 and 25 run 1 warmup step under each backward, then 3
timed steps under each in turns; every main path sends no attention call to
the xla branch, and its launch counters must show each kernel call. Kernel
times are ``ms_per_call``: the mean of a call in 10 launches back to back,
the median of 3 runs. The last lines are ``[total]``, the kernels JSON line
(each entry's ``launches`` summed over the main paths that run it; its bound
from ``gpus.bound``; ``library_ms`` the PyTorch call computing the same
function, or null), the card line and ``{"ok": true, ...}``.
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

from multimodal_llm_pretraining_tpu_torch.gpus import bound  # noqa: E402
from multimodal_llm_pretraining_tpu_torch.ops import _build  # noqa: E402
from multimodal_llm_pretraining_tpu_torch.ops import attention as attn  # noqa: E402
from multimodal_llm_pretraining_tpu_torch.ops import flash_attention as fa  # noqa: E402
from multimodal_llm_pretraining_tpu_torch.ops import selective_scan_fused as ssf  # noqa: E402
from multimodal_llm_pretraining_tpu_torch.time_attention import card_line, ms_per_call, visible_pairs  # noqa: E402
from multimodal_llm_pretraining_tpu_torch.time_scan import nbytes, scan_bounds, scan_inputs  # noqa: E402
from multimodal_llm_pretraining_tpu_torch.utils import require_cuda  # noqa: E402

FWD_SOURCE = "multimodal_llm_pretraining_tpu_torch/csrc/flash_fwd.cu"
BWD_SOURCE = "multimodal_llm_pretraining_tpu_torch/csrc/flash_bwd.cu"
DQ_SOURCE = "multimodal_llm_pretraining_tpu_torch/csrc/flash_bwd_dq.cu"
JAX_FLASH = "multimodal_llm_pretraining_tpu/ops/flash_attention.py"
SCAN_SOURCE = "multimodal_llm_pretraining_tpu_torch/csrc/selective_scan.cu"
JAX_SCAN = "multimodal_llm_pretraining_tpu/ops/selective_scan_pallas.py"
XENT_SOURCE = "multimodal_llm_pretraining_tpu_torch/csrc/xent.cu"
RMSNORM_SOURCE = "multimodal_llm_pretraining_tpu_torch/csrc/rmsnorm.cu"
CONV_SOURCE = "multimodal_llm_pretraining_tpu_torch/csrc/causal_conv.cu"
GATE_SOURCE = "multimodal_llm_pretraining_tpu_torch/csrc/gate.cu"
SCAN_SHAPE = (2, 4096, 5120)  # mamba-2.8b: mbs 2, seq 4096, d_inner 5120 (d_state 16)
SLICE_SHAPE = (4, 8, 2049, 256)  # pythia-1b: mbs 4, 8 heads, seq 2049, head_dim 256
# llava-pretrain at the main path's mbs 16: the decoder's attention (32
# heads, 512 - 1 + 576 merged positions, head_dim 64) and the CLIP tower's
# (16 heads, 576 patches + CLS, head_dim 64)
VARLEN_SHAPE = (16, 32, 1087, 64)
TOWER_SHAPE = (16, 16, 577, 64)
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

# Kernel vs plain version at a table shape, each output's error relative to
# its norm. Flash attention: on bf16 inputs both sides round the same
# operands to bf16 and accumulate in f32, differing in summation order and
# in the online softmax's rescaling; on f32 inputs the kernels round every
# product operand to bf16 (2^-9 each) where the plain versions keep f32: a
# few such roundings, under 1e-2 of the norm. The scan: both sides in f32,
# differing in summation order and the kernels' fast exp; y with the skip in
# bf16 within one bf16 rounding. The other kernels: f32 within 1e-5, a bf16
# output within one bf16 rounding.
TOL_NORM_REL = 1e-2
TOL_SCAN_Y_BF16 = 4e-3
TOL_SCAN_GRAD = 1e-3
TOL_SCAN_DD = 1e-6  # dD's f32 summation order, of its largest value
TOL_F32 = 1e-5
TOL_BF16 = 4e-3
TOL_XENT_LSE_ABS = 1e-4  # the loss's lse and each row's nll, absolute (f32)
# Two-layer model, kernels vs f32 plain attention (bf16 compute both ways)
TOL_SLICE_LOSS = 2e-2
TOL_SLICE_GRAD_NORM_REL = 5e-2
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
        fwd = ms_per_call(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal))
        both = ms_per_call(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*leaves, is_causal=causal), leaves, do4))
    return {"fwd": fwd, "bwd": both - fwd, "backend": backend.name}


def _ragged_lens(b: int, s: int, seed: int) -> list[int]:
    """One full row, one shorter than a tile, one ending on a tile edge (64,
    a multiple of both kernels' key tiles), the rest random in [1, s]."""
    edge = (s - 1) // 64 * 64
    rest = np.random.default_rng(seed).integers(1, s + 1, max(b - 3, 0)).tolist()
    return [s, 37, edge, *rest][:b]


# ---------------------------------------------------------------- the kernel table


def held(tag: str, what: str, pairs: dict, tols: dict, abs_tols: dict | None = None) -> dict:
    """Each kernel output of ``pairs`` (name -> (kernel's, plain version's))
    finite and within ``tols[name]`` of its norm, or ``abs_tols[name]``
    absolute, of its plain version; prints and returns (max_abs, norm_rel)
    of each."""
    errs = {n: _errs(got, want) for n, (got, want) in pairs.items()}
    say(f"{tag} kernels vs plain at {what}: "
        + ", ".join(f"{n} max_abs {a:.3e} norm_rel {r:.3e}" for n, (a, r) in errs.items()))
    abs_tols = abs_tols or {}
    bad = [n for n, (got, _) in pairs.items() if not torch.isfinite(got).all()
           or not (errs[n][0] <= abs_tols[n] if n in abs_tols else errs[n][1] <= tols[n])]
    if bad:
        raise AssertionError(f"{tag} {bad} beyond their tolerances at {what}")
    return errs


def say_times(tag: str, what: str, t: dict, bounds: dict, library: dict, flops: dict | None = None) -> None:
    """A line for each kernel ``n`` of ``bounds`` timed in ``t``: its time,
    TFLOP/s where ``flops`` counts it, its share of its bound, its plain
    version's time (``t[n + "_plain"]``) and the library call's (``library[n]``:
    a name and its ms, or None where there is none)."""
    for n, (bnd, by) in bounds.items():
        if n not in t:
            continue
        ms = t[n]
        rate = f", {flops[n] / ms / 1e9:.1f} TFLOP/s" if flops else ""
        lib = library.get(n)
        lib = f"; {lib[0]} {lib[1]:.4f} ms ({lib[1] / ms:.2f}x the kernel)" if lib else "; no library call"
        say(f"{tag} {n} at {what}: {ms:.4f} ms a call{rate}, {bnd / ms:.3f} of its bound {bnd:.4f} ms ({by}); "
            f"plain {t[n + '_plain']:.4f} ms{lib}")


def kernel_entry(name: str, source: str, replaces: str | None, max_abs_err: float, ms: float, plain_ms: float,
                 bnd: tuple[float, str], library_ms: float | None, **extra) -> dict:
    """One entry of the kernels JSON line; ``launches`` comes from the main paths at the end."""
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": None,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": library_ms, **extra}


def attention_bounds(q, k, v, do, causal: bool, kv_lens=None) -> dict:
    """``bound`` of each attention function on these [BH, S, D] inputs, with
    2·D FLOP per visible pair per product and one exp per pair: the forward
    (q, k, v -> out, f32 lse; 2 products) and the backward (q, k, v, out,
    dO, lse -> dq, dk, dv; 5 products), which the fused kernel and the
    split pair both compute."""
    pairs = visible_pairs(q.shape[0], q.shape[1], k.shape[1], causal, kv_lens)
    f = 2 * q.shape[-1] * pairs
    stats = q.shape[0] * q.shape[1] * 4  # one f32 lse (or delta) per query row
    qkv = nbytes(q, k, v, kv_lens)
    return {
        "fwd": bound(qkv + nbytes(q) + stats, 2 * f, exps=pairs),
        "bwd": bound(qkv + nbytes(q, do) + stats + nbytes(q, k, v), 5 * f, exps=pairs),
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
    read = 2 * (q.numel() + k.numel()) * ops.q.element_size() + 2 * stats + nbytes(kv_lens)  # q, dO, k, v
    return {
        "dq": bound(read + nbytes(q), 3 * f, exps=pairs),
        "dkv": bound(read + 2 * nbytes(k), 4 * f, exps=pairs),
    }


def attention_at(shape, causal: bool, dtype: torch.dtype = torch.bfloat16, varlen: bool = False,
                 split: bool = False, backward: bool = True, seed: int = 0) -> dict:
    """The flash kernels at one shape of the table: the forward, the fused
    backward (with ``backward``) and the split pair (with ``split``: its prep
    launch and casts, dq, dk/dv, as ``mlpt::flash_bwd_split`` runs it)
    against their plain versions, the backwards on the plain forward's out
    and lse; then each timed beside its plain version, its bound and
    PyTorch's call (``sdpa_ms``: the flash backend on bf16, on f32 the one
    PyTorch picks; its backward is the split kernels' yardstick too).
    ``varlen``: compared in the varlen mode at ragged lengths
    (``_ragged_lens``) and timed with every length full, the function
    PyTorch's call computes. The bounds and FLOP counts take the caller's
    head dim: the padding is the kernels' cost, not the function's. Returns
    the errors, the times, the bounds and PyTorch's times."""
    b, h, s, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(b * h, s, d, generator=g, device="cuda").to(dtype) for _ in range(4))
    scale = d**-0.5
    what = f"{list(shape)} {str(dtype).split('.')[-1]} {'causal' if causal else 'non-causal'}"
    # full f32 products in the plain versions (the main paths' plans turn TF32 on)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    lens = torch.tensor(_ragged_lens(b, s, seed), dtype=torch.int32, device="cuda").repeat_interleave(h) \
        if varlen else None
    out, lse = fa.flash_fwd_reference(q, k, v, causal, scale, lens)
    pairs = {"out": (fa.flash_fwd_cuda(q, k, v, causal, scale, lens)[0], out)}
    args = (q, k, v, out, lse, do, causal, scale, lens)
    for prefix, kernel, plain, on in (("", fa.flash_bwd_cuda, fa.flash_bwd_reference, backward),
                                      ("split_", fa.flash_bwd_split_cuda, fa.flash_bwd_split_reference, split)):
        if on:
            pairs |= {prefix + n: pair for n, pair in zip(("dq", "dk", "dv"), zip(kernel(*args), plain(*args)))}
    errs = held("[attention]", what + (", varlen mode at ragged lens" if varlen else ""), pairs,
                dict.fromkeys(pairs, TOL_NORM_REL))

    if varlen:
        what += ", varlen mode, full lens"
        lens = torch.full((b * h,), s, dtype=torch.int32, device="cuda")
        out, lse = fa.flash_fwd_reference(q, k, v, causal, scale, lens)
        args = (q, k, v, out, lse, do, causal, scale, lens)
    fns = {"fwd": lambda: fa.flash_fwd_cuda(q, k, v, causal, scale, lens),
           "fwd_plain": lambda: fa.flash_fwd_reference(q, k, v, causal, scale, lens)}
    if backward:
        fns |= {"bwd": lambda: fa.flash_bwd_cuda(*args), "bwd_plain": lambda: fa.flash_bwd_reference(*args)}
    bounds = attention_bounds(q, k, v, do, causal, lens)
    if split:
        ops = fa.split_operands(q, k, v, out, lse, do, scale, lens)
        plain_args = (q, k, v, do, lse, fa.bwd_delta(out, do), causal, scale, lens)
        fns |= {"dq": lambda: fa.flash_bwd_dq_cuda(ops, causal),
                "dq_plain": lambda: fa.flash_bwd_dq_reference(*plain_args),
                "dkv": lambda: fa.flash_bwd_dkv_cuda(ops, causal),
                "dkv_plain": lambda: fa.flash_bwd_dkv_reference(*plain_args),
                "pair": lambda: fa.flash_bwd_split_cuda(*args),
                "pair_plain": lambda: fa.flash_bwd_split_reference(*args),
                "shared": lambda: fa.split_operands(q, k, v, out, lse, do, scale, lens)}
        bounds |= split_bounds(q, k, ops, causal, lens) | {"pair": bounds["bwd"]}
    t = {n: ms_per_call(fn) for n, fn in fns.items()}
    lib = sdpa_ms(q, k, v, do, causal, flash_only=dtype == torch.bfloat16)
    pytorch = f"PyTorch ({lib['backend']})"
    library = {"fwd": (pytorch, lib["fwd"])} | dict.fromkeys(("bwd", "dq", "dkv", "pair"), (pytorch, lib["bwd"]))
    fd = d * visible_pairs(b * h, s, s, causal, lens)
    say_times("[attention]", what, t, bounds, library, {"fwd": 4 * fd, "bwd": 10 * fd, "dq": 6 * fd, "dkv": 8 * fd,
                                                        "pair": 10 * fd})
    if split:
        say(f"[attention] split pair at {what}: the shared work (prep launch and casts) {t['shared']:.4f} ms; "
            f"pair / fused backward {t['pair'] / t['bwd']:.3f}")
    return {"errs": errs, "ms": t, "bounds": bounds, "library": lib}


def attention_entries(rows: dict, suffix: str = "") -> list[dict]:
    """The kernels JSON line's entries of ``attention_at``'s rows: the
    forward and the fused backward, and the split kernels where timed (their
    ``library_ms`` PyTorch's backward, which computes what the pair computes
    together, and ``pair_ms`` the pair's own time)."""
    e, t, bnd, lib = rows["errs"], rows["ms"], rows["bounds"], rows["library"]
    entries = [
        kernel_entry(f"flash_fwd{suffix}", FWD_SOURCE, f"{JAX_FLASH}:91", e["out"][0], t["fwd"], t["fwd_plain"],
                     bnd["fwd"], lib["fwd"]),
        kernel_entry(f"flash_bwd_fused{suffix}", BWD_SOURCE, f"{JAX_FLASH}:208", max(e[n][0] for n in ("dq", "dk", "dv")),
                     t["bwd"], t["bwd_plain"], bnd["bwd"], lib["bwd"]),
    ]
    if "pair" in t:
        entries += [
            kernel_entry(f"flash_bwd_dq{suffix}", DQ_SOURCE, f"{JAX_FLASH}:161", e["split_dq"][0], t["dq"],
                         t["dq_plain"], bnd["dq"], lib["bwd"], pair_ms=t["pair"]),
            kernel_entry(f"flash_bwd_dkv{suffix}", BWD_SOURCE, f"{JAX_FLASH}:293",
                         max(e["split_dk"][0], e["split_dv"][0]), t["dkv"], t["dkv_plain"], bnd["dkv"], lib["bwd"],
                         pair_ms=t["pair"]),
        ]
    return entries


# pythia-1b's chunk of the LM-head loss (1024 rows of its vocab), and the benchmark's pythia-1b micro-batch (16 rows
# of 2049 tokens, shifted) with its hidden width
XENT_CHUNK = (1024, 50304)
XENT_MICRO_BATCH = (16 * 2048, 2048)
# the loss on the kernels vs the pre-change autograd path, at the micro-batch
TOL_XENT_LOSS_REL = 1e-5
TOL_XENT_GRAD_NORM_REL = 2e-3


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
    """The LM-head loss's kernels at pythia's chunk (f32 logits, every row
    counting, as in a packed pythia batch; bf16 dlogits): against their
    plain versions, then timed beside their bounds (each logit and label
    read once; the forward writes lse and nll, the backward reads lse and
    writes bf16 dlogits; one exp a logit), their plain versions and the
    yardsticks (``torch.logsumexp``; the pre-change autograd chain). Then
    the whole loss, forward and backward, at the benchmark's pythia-1b
    micro-batch on the kernels and on the pre-change path
    (``xent_autograd_yardstick``), their losses and gradients held to each
    other. The kernels JSON line's entries ``xent_fwd``, ``xent_bwd``."""
    from multimodal_llm_pretraining_tpu_torch.ops import xent

    rows, vocab = XENT_CHUNK
    g = torch.Generator(device="cuda").manual_seed(22)
    logits = torch.randn(rows, vocab, generator=g, device="cuda") * 3
    labels = torch.randint(0, vocab, (rows,), generator=g, device="cuda")
    lse_k, nll_k = torch.empty(rows, device="cuda"), torch.empty(rows, device="cuda")
    xent.xent_fwd_cuda(logits, labels, vocab, -100, lse_k, nll_k)
    lse, nll = xent.xent_fwd_reference(logits, labels, vocab, -100)
    scale = torch.tensor(1.0 / XENT_MICRO_BATCH[0], device="cuda")
    bwd_args = (logits, labels, lse, scale, vocab, -100, torch.bfloat16)
    errs = held("[xent]", str(list(XENT_CHUNK)),
                {"lse": (lse_k, lse), "nll": (nll_k, nll),
                 "dlogits": (xent.xent_bwd_cuda(*bwd_args), xent.xent_bwd_reference(*bwd_args))},
                {"dlogits": TOL_BF16}, {"lse": TOL_XENT_LSE_ABS, "nll": TOL_XENT_LSE_ABS})
    t = {
        "fwd": ms_per_call(lambda: xent.xent_fwd_cuda(logits, labels, vocab, -100, lse_k, nll_k)),
        "fwd_plain": ms_per_call(lambda: xent.xent_fwd_reference(logits, labels, vocab, -100)),
        "fwd_library": ms_per_call(lambda: torch.logsumexp(logits, dim=-1)),
        "bwd": ms_per_call(lambda: xent.xent_bwd_cuda(*bwd_args)),
        "bwd_plain": ms_per_call(lambda: xent.xent_bwd_reference(*bwd_args)),
        "bwd_library": ms_per_call(lambda: _xent_autograd_dlogits(logits, labels, vocab, scale)),
    }
    ins = nbytes(logits, labels)
    bounds = {"fwd": bound(ins + 2 * nbytes(lse), exps=logits.numel()),
              "bwd": bound(ins + nbytes(lse) + logits.numel() * 2, exps=logits.numel())}
    say_times("[xent]", str(list(XENT_CHUNK)), t, bounds,
              {"fwd": ("torch.logsumexp", t["fwd_library"]), "bwd": ("the pre-change chain", t["bwd_library"])})
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
        times[name] = ms_per_call(fwd_bwd, warmup=1, iters=3, reps=3)
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
    return [kernel_entry("xent_fwd", XENT_SOURCE, None, errs["lse"][0], t["fwd"], t["fwd_plain"], bounds["fwd"],
                         t["fwd_library"]),
            kernel_entry("xent_bwd", XENT_SOURCE, None, errs["dlogits"][0], t["bwd"], t["bwd_plain"], bounds["bwd"],
                         t["bwd_library"])]


RMSNORM_SHAPE = (8 * 4096, 2560)  # mamba-2.8b at the benchmark's micro-batch: 8 rows of 4096 tokens, d_model 2560
RMSNORM_EPS = 1e-5


def phase_rmsnorm() -> list[dict]:
    """The norm kernels at mamba's benchmark micro-batch (the f32 stream in,
    bf16 out, the residual's gradient added in the backward): against their
    plain versions, then timed beside their bounds (the forward reads the
    stream and the scale and writes y and an f32 rstd a row; the backward
    reads dy, the stream, rstd, the scale and the residual's gradient and
    writes the stream's gradient and the scale's), their plain versions and
    the yardsticks (``F.rms_norm`` and the cast to bf16; the pre-change
    autograd chain's backward and the residual's add). The kernels JSON
    line's entries ``rmsnorm_fwd``, ``rmsnorm_bwd``."""
    from multimodal_llm_pretraining_tpu_torch.ops import rmsnorm

    rows, cols = RMSNORM_SHAPE
    g = torch.Generator(device="cuda").manual_seed(34)
    x = torch.randn(rows, cols, generator=g, device="cuda") * 3 + 0.5
    w = torch.rand(cols, generator=g, device="cuda") + 0.5
    dy = torch.randn(rows, cols, generator=g, device="cuda").to(torch.bfloat16)
    dres = torch.randn(rows, cols, generator=g, device="cuda")
    y, rstd = rmsnorm.rmsnorm_fwd_cuda(x, w, RMSNORM_EPS, torch.bfloat16)
    y_ref, rstd_ref = rmsnorm.rmsnorm_fwd_reference(x, w, RMSNORM_EPS, torch.bfloat16)
    dx, dw = rmsnorm.rmsnorm_bwd_cuda(dy, x, rstd_ref, w, dres)
    dx_ref, dw_ref = rmsnorm.rmsnorm_bwd_reference(dy, x, rstd_ref, w, dres)
    what = f"{list(RMSNORM_SHAPE)} f32 -> bf16"
    errs = held("[rmsnorm]", what, {"y": (y, y_ref), "rstd": (rstd, rstd_ref), "dx": (dx, dx_ref), "dw": (dw, dw_ref)},
                {"y": TOL_BF16, "rstd": TOL_F32, "dx": TOL_F32, "dw": TOL_F32})
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    y_chain = (xg * (torch.rsqrt(xg.square().mean(-1, keepdim=True) + RMSNORM_EPS) * wg)).to(torch.bfloat16)

    def chain_backward():
        dx, _ = torch.autograd.grad(y_chain, (xg, wg), dy, retain_graph=True)
        return dx + dres

    t = {
        "fwd": ms_per_call(lambda: rmsnorm.rmsnorm_fwd_cuda(x, w, RMSNORM_EPS, torch.bfloat16)),
        "fwd_plain": ms_per_call(lambda: rmsnorm.rmsnorm_fwd_reference(x, w, RMSNORM_EPS, torch.bfloat16)),
        "fwd_library": ms_per_call(lambda: torch.nn.functional.rms_norm(x, (cols,), w, RMSNORM_EPS).to(torch.bfloat16)),
        "bwd": ms_per_call(lambda: rmsnorm.rmsnorm_bwd_cuda(dy, x, rstd, w, dres)),
        "bwd_plain": ms_per_call(lambda: rmsnorm.rmsnorm_bwd_reference(dy, x, rstd, w, dres)),
        "bwd_library": ms_per_call(chain_backward),
    }
    small = nbytes(w, rstd)
    bounds = {"fwd": bound(nbytes(x, y) + small), "bwd": bound(nbytes(dy, x, dres, x) + 2 * small)}
    say_times("[rmsnorm]", what, t, bounds, {"fwd": ("F.rms_norm and a cast", t["fwd_library"]),
                                             "bwd": ("the pre-change chain", t["bwd_library"])})
    return [kernel_entry("rmsnorm_fwd", RMSNORM_SOURCE, None, errs["y"][0], t["fwd"], t["fwd_plain"], bounds["fwd"],
                         t["fwd_library"]),
            kernel_entry("rmsnorm_bwd", RMSNORM_SOURCE, None, errs["dx"][0], t["bwd"], t["bwd_plain"], bounds["bwd"],
                         t["bwd_library"])]


CONV_SHAPE = (8, 4096, 5120, 4)  # mamba-2.8b at the benchmark's micro-batch: B, L, d_inner, d_conv


def _conv_chain(x, w, b):
    """The pre-kernel chain on the card: the f32 composition, then the copy to
    contiguous that ``x_proj``'s product made of its channel-first result."""
    from multimodal_llm_pretraining_tpu_torch.ops.selective_scan import causal_conv1d

    return torch.nn.functional.silu(causal_conv1d(x.float(), w.float(), b.float())).to(x.dtype).contiguous()


def phase_causal_conv() -> list[dict]:
    """The conv kernels at mamba's benchmark micro-batch (x the strided half
    of [8, 4096, 10240] bf16, as in_proj's output is split; bf16 taps and
    bias): against their plain versions (PyTorch's depthwise conv in f32,
    cuDNN off), then timed beside their bounds (the forward reads x, the
    taps and the bias and writes out; the backward reads x, dout, the taps
    and the bias and writes dx and the f32 sums of dw and db), their plain
    versions and the pre-kernel chain (``_conv_chain``, and its autograd
    backward). The kernels JSON line's entries ``causal_conv_fwd``,
    ``causal_conv_bwd``."""
    from multimodal_llm_pretraining_tpu_torch.ops import causal_conv as cc

    B, L, I, K = CONV_SHAPE
    g = torch.Generator(device="cuda").manual_seed(43)
    x = torch.randn(B, L, 2 * I, generator=g, device="cuda").to(torch.bfloat16)[..., :I]
    w = (torch.rand(K, I, generator=g, device="cuda") - 0.5).to(torch.bfloat16)
    b = (torch.rand(I, generator=g, device="cuda") - 0.5).to(torch.bfloat16)
    dout = torch.randn(B, L, I, generator=g, device="cuda").to(torch.bfloat16)
    with torch.backends.cudnn.flags(enabled=False):
        ref = (cc.causal_conv_fwd_reference(x, w, b), *cc.causal_conv_bwd_reference(x, w, b, dout))
    got = (cc.causal_conv_fwd_cuda(x, w, b), *cc.causal_conv_bwd_cuda(x, w, b, dout))
    what = f"{list(CONV_SHAPE)} bf16"
    errs = held("[conv]", what, dict(zip(("out", "dx", "dw", "db"), zip(got, ref))), dict.fromkeys(
        ("out", "dx", "dw", "db"), TOL_BF16))
    xg, wg, bg = x.detach().requires_grad_(), w.clone().requires_grad_(), b.clone().requires_grad_()
    out_chain = _conv_chain(xg, wg, bg)
    t = {
        "fwd": ms_per_call(lambda: cc.causal_conv_fwd_cuda(x, w, b)),
        "fwd_plain": ms_per_call(lambda: cc.causal_conv_fwd_reference(x, w, b)),
        "fwd_library": ms_per_call(lambda: _conv_chain(x, w, b)),
        "bwd": ms_per_call(lambda: cc.causal_conv_bwd_cuda(x, w, b, dout)),
        "bwd_plain": ms_per_call(lambda: cc.causal_conv_bwd_reference(x, w, b, dout)),
        "bwd_library": ms_per_call(lambda: torch.autograd.grad(out_chain, (xg, wg, bg), dout, retain_graph=True)),
    }
    small = nbytes(w, b)
    bounds = {"fwd": bound(2 * nbytes(dout) + small), "bwd": bound(3 * nbytes(dout) + small + (K + 1) * I * 4)}
    say_times("[conv]", what, t, bounds, {"fwd": ("the pre-kernel chain", t["fwd_library"]),
                                          "bwd": ("the pre-kernel chain", t["bwd_library"])})
    return [kernel_entry("causal_conv_fwd", CONV_SOURCE, None, errs["out"][0], t["fwd"], t["fwd_plain"],
                         bounds["fwd"], t["fwd_library"]),
            kernel_entry("causal_conv_bwd", CONV_SOURCE, None, errs["dx"][0], t["bwd"], t["bwd_plain"],
                         bounds["bwd"], t["bwd_library"])]


GATE_SHAPE = (8, 4096, 5120)  # mamba-2.8b at the benchmark's micro-batch: B, L, d_inner


def phase_gate() -> list[dict]:
    """The gate kernels at mamba's benchmark micro-batch (y contiguous, z the
    strided half of [8, 4096, 10240] bf16, as in_proj's output is split):
    against their plain versions (the pre-kernel f32 composition and its
    autograd gradient), then timed beside their bounds (the forward reads y
    and z and writes out; the backward reads dout, y and z and writes dy and
    dz; one exp an element) and their plain versions. The kernels JSON
    line's entries ``gate_silu_fwd``, ``gate_silu_bwd``."""
    from multimodal_llm_pretraining_tpu_torch.ops import gate

    B, L, I = GATE_SHAPE
    g = torch.Generator(device="cuda").manual_seed(44)
    y = (torch.randn(B, L, I, generator=g, device="cuda") * 2).to(torch.bfloat16)
    z = (torch.randn(B, L, 2 * I, generator=g, device="cuda") * 2).to(torch.bfloat16)[..., I:]
    dout = torch.randn(B, L, I, generator=g, device="cuda").to(torch.bfloat16)
    ref = (gate.gate_silu_fwd_reference(y, z), *gate.gate_silu_bwd_reference(y, z, dout))
    got = (gate.gate_silu_fwd_cuda(y, z), *gate.gate_silu_bwd_cuda(y, z, dout))
    what = f"{list(GATE_SHAPE)} bf16"
    errs = held("[gate]", what, dict(zip(("out", "dy", "dz"), zip(got, ref))), dict.fromkeys(("out", "dy", "dz"),
                                                                                             TOL_BF16))
    del ref, got
    t = {
        "fwd": ms_per_call(lambda: gate.gate_silu_fwd_cuda(y, z)),
        "fwd_plain": ms_per_call(lambda: gate.gate_silu_fwd_reference(y, z)),
        "bwd": ms_per_call(lambda: gate.gate_silu_bwd_cuda(y, z, dout)),
        "bwd_plain": ms_per_call(lambda: gate.gate_silu_bwd_reference(y, z, dout)),
    }
    bounds = {"fwd": bound(3 * nbytes(y), exps=y.numel()), "bwd": bound(5 * nbytes(y), exps=y.numel())}
    say_times("[gate]", what, t, bounds, {})
    return [kernel_entry("gate_silu_fwd", GATE_SOURCE, None, errs["out"][0], t["fwd"], t["fwd_plain"], bounds["fwd"],
                         None),
            kernel_entry("gate_silu_bwd", GATE_SOURCE, None, errs["dz"][0], t["bwd"], t["bwd_plain"], bounds["bwd"],
                         None)]


def phase_scan_kernels() -> list[dict]:
    """Both scan kernels at mamba's shape in bf16 with D, as the autograd
    rule runs them: the forward with the skip and the cast in its epilogue,
    the backward in its skip mode (bf16 dy in; du and ddelta out in bf16
    with the skip's D * dy; dD). The forward and the backward's f32 mode
    against their plain versions; the skip mode's du, ddelta, dA, dB and dC
    bit for bit the f32 mode followed by the PyTorch epilogue it replaced
    (``skip_bwd``), dD within ``TOL_SCAN_DD`` of its largest value. Then
    each timed beside its bound (``time_scan.scan_bounds``), the forward
    beside its plain version and the skip mode beside the f32 mode and its
    epilogue."""
    u, delta, A, B, C, D, dy = scan_inputs(*SCAN_SHAPE, 16, torch.bfloat16, seed=12)
    dy = dy.to(torch.bfloat16)
    y, ckpt = ssf.selective_scan_fwd_cuda(u, delta, A, B, C, D)
    y_ref, ckpt_ref = ssf.selective_scan_fwd_reference(u, delta, A, B, C, D)
    grads = ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt_ref)
    grads_ref = ssf.selective_scan_bwd_reference(u, delta, A, B, C, dy, ckpt_ref)
    names = ("du", "ddelta", "dA", "dB", "dC")
    what = f"{list(SCAN_SHAPE)} N16 bf16"
    errs = held("[scan]", what, {"y+skip": (y, y_ref), "ckpt": (ckpt, ckpt_ref), **dict(zip(names, zip(grads, grads_ref)))},
                {"y+skip": TOL_SCAN_Y_BF16} | dict.fromkeys(("ckpt", *names), TOL_SCAN_GRAD))
    del grads, grads_ref

    def unfused():
        return ssf.skip_bwd(*ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt), u, delta, D, dy)

    fused = ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt, D)
    old = unfused()
    differ = [n for n, a, b in zip(names, fused, old) if not (a.dtype == b.dtype and torch.equal(a, b))]
    dD_gap = ((fused[5] - old[5]).abs().max() / old[5].abs().max()).item()
    say(f"[scan] skip mode vs the f32 mode and its epilogue at {what}: {', '.join(names)} "
        f"{'bit for bit' if not differ else 'differ in ' + ', '.join(differ)}; dD {dD_gap:.3e} of its largest value")
    if differ or not dD_gap <= TOL_SCAN_DD:
        raise AssertionError(f"[scan] skip mode: {differ} not bit for bit, dD gap {dD_gap:.3e}")
    del old
    t = {
        "fwd": ms_per_call(lambda: ssf.selective_scan_fwd_cuda(u, delta, A, B, C, D)),
        "fwd_plain": ms_per_call(lambda: ssf.selective_scan_fwd_reference(u, delta, A, B, C, D)),
        "bwd": ms_per_call(lambda: ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt, D)),
        "bwd_plain": ms_per_call(unfused),
    }
    bounds = scan_bounds(u, delta, A, B, C, D, dy, y, ckpt, fused)
    say_times("[scan]", what, t, bounds, {})
    return [kernel_entry("scan_fwd", SCAN_SOURCE, f"{JAX_SCAN}:47", errs["y+skip"][0], t["fwd"], t["fwd_plain"],
                         bounds["fwd"], None),
            kernel_entry("scan_bwd", SCAN_SOURCE, f"{JAX_SCAN}:161", max(errs[n][0] for n in names), t["bwd"],
                         t["bwd_plain"], bounds["bwd"], None)]


# ---------------------------------------------------------------- main paths


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
    (``ops/rmsnorm.py``), returned as ``rmsnorm``, the causal conv's
    (``ops/causal_conv.py``), returned as ``conv``, and the gate's
    (``ops/gate.py``), returned as ``gate``. The first loss must lie in
    ``loss_band``.
    For a model with a trainable mask, every frozen parameter must come out
    bit for bit and every trainable one must have moved; in the f32 layout
    every parameter and moment must be f32. Returns the module, the number
    of micro-batches under each backward, the launch counts, the losses,
    the median step of each backward, the peak memory and the dropout
    generator's state after the steps."""
    from multimodal_llm_pretraining_tpu_torch.models import get_model_class
    from multimodal_llm_pretraining_tpu_torch.ops import causal_conv, gate, rmsnorm, xent
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
    gate.reset_launch_counts()
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
    gate_launches = {"gate_silu_fwd": gate.GATE_FWD_LAUNCHES, "gate_silu_bwd": gate.GATE_BWD_LAUNCHES}
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
        + ", ".join(f"{n} {c}" for n, c in
                    (launches | xent_launches | norm_launches | conv_launches | gate_launches).items())
        + ", xla-branch attention calls 0")
    if after is not None:
        after(sess, state)
    return {"module": sess.module, "launches": launches, "xent": xent_launches, "rmsnorm": norm_launches,
            "conv": conv_launches, "gate": gate_launches,
            "micro_batches": {fused: acc * schedule.count(fused) for fused in (True, False)},
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
    """pythia-1b: bench.py's recipe, without remat (phase 19 runs its remat)
    at acc 2, under the fused and the split backward;
    every attention call on the plain-mode kernels."""
    run = drive_training("pythia-1b", mbs=4, acc=2, remat=False, counters=fa, loss_band=TEXT_LOSS_BAND,
                         names=FLASH_COUNTERS, split_ab=True)
    expected = flash_launches_expected(FLASH_COUNTERS, len(run["module"].layers), 0, run["micro_batches"])
    if run["launches"] != expected:
        raise AssertionError(f"pythia flash launches {run['launches']}, expected {expected}")
    return flash_launch_entries(run["launches"]) | xent_launch_entries(run, "pythia-1b", PYTHIA_MBS4_XENT_CHUNKS)


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
    """mamba-2.8b at full width and depth with block remat: every scan, norm,
    conv and gate call on the kernels, the forward twice per block and micro-batch
    (the remat recompute runs it again) and the backward once."""
    run = drive_training("mamba", mbs=2, acc=2, remat=True, counters=ssf, loss_band=TEXT_LOSS_BAND,
                         names=("FWD_LAUNCHES", "BWD_LAUNCHES", "BWD_SKIP_LAUNCHES"))
    run["launches"] = tuple(run["launches"].values())
    micro_batches = sum(run["micro_batches"].values())
    calls = len(run["module"].layers) * micro_batches
    # every backward launch folds the D skip
    if run["launches"] != (2 * calls, calls, calls):
        raise AssertionError(f"scan launches {run['launches']}, expected ({2 * calls}, {calls}, {calls})")
    # each block's norm forward twice (its replay), backward once, and the final norm's once each
    norms = {"rmsnorm_fwd": 2 * calls + micro_batches, "rmsnorm_bwd": calls + micro_batches}
    if run["rmsnorm"] != norms:
        raise AssertionError(f"mamba: rmsnorm launches {run['rmsnorm']}, expected {norms}")
    # each block's conv forward twice (its replay) and backward once
    convs = {"causal_conv_fwd": 2 * calls, "causal_conv_bwd": calls}
    if run["conv"] != convs:
        raise AssertionError(f"mamba: causal-conv launches {run['conv']}, expected {convs}")
    # each block's gate forward twice (its replay) and backward once
    gates = {"gate_silu_fwd": 2 * calls, "gate_silu_bwd": calls}
    if run["gate"] != gates:
        raise AssertionError(f"mamba: gate launches {run['gate']}, expected {gates}")
    return ({"scan_fwd": run["launches"][0], "scan_bwd": run["launches"][1]} | xent_launch_entries(run, "mamba")
            | run["rmsnorm"] | run["conv"] | run["gate"])


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


def phase_head_dims() -> None:
    """2 steps each of pythia-14m (D=32, 6 layers) and of pythia-2.8b (D=80)
    cut to 2 layers at full width, which the kernels run zero-padded: the
    launch counters must show every attention call on the kernels."""
    from multimodal_llm_pretraining_tpu_torch.models import pythia

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
    remat: the first loss bit for bit phase 19's ``bf16_sr`` one (the same
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


def phase_vilt_main_paths() -> tuple[dict, dict, list[dict]]:
    """The kernels at vilt-pretrain's shape ([4, 16, 769, 88] f32, plain
    mode, non-causal; ``attention_at``). Then vilt-pretrain at full
    width and depth (CLIP-g/14 trunk: 40 blocks, hidden 1408, 16 heads of
    88, ffn 6144; vocab 128,256) in the f32 layout (TF32 products), no
    remat, micro-batch 4 x accumulation 2 (the recipe's batch of 128 cut
    for one card), under the fused/split A/B schedule: three trunk passes
    a micro-batch, so 120 forwards and 120 fused backwards (or 120 dq + 120
    dk/dv). Then 2 steps of vilt-original-pretrain (ViLT-B/32: 12 blocks of
    12 heads of 64, 562 positions), micro-batch 32 x accumulation 2: 36 +
    36 a micro-batch. Returns the launches of all main-path runs, those at
    vilt-pretrain's shape, and the kernels line's entries at it."""
    entries = attention_entries(attention_at(VILT_SHAPE, False, torch.float32, seed=80), "_vilt")
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
    plain mode, non-causal; ``attention_at``); a narrow 2-layer slice
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

    entries = attention_entries(attention_at(ROBERTA_SHAPE, False, seed=90), "_roberta")
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


def families(card: str, add) -> list[dict]:
    """Phases 23-26; returns the kernels line's entries at ViLT's and
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
    kernels = phase_xent() + phase_rmsnorm() + phase_causal_conv() + phase_gate()
    kernels += attention_entries(attention_at(SLICE_SHAPE, True, split=True, seed=3))
    phase_slice()
    launches: dict[str, int] = {}

    def add(counts: dict) -> None:
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    add(phase_main_path())
    kernels += phase_scan_kernels()
    phase_scan_slice()
    add(phase_mamba_main_path())
    kernels += attention_entries(attention_at(VARLEN_SHAPE, True, varlen=True, split=True, seed=20), "_varlen")
    attention_at(TOWER_SHAPE, False, backward=False, seed=24)  # the tower's own call: the plain-mode forward
    phase_llava_slice()
    add(phase_llava_main_path())
    attention_at(VIT_SHAPE, False, torch.float32, split=True, seed=31)
    phase_vit_slice()
    add(phase_vit_main_path())
    phase_head_dims()
    remat_launches, bf16_sr_run = phase_remat(card)
    add(remat_launches)
    add(phase_remat_vit())
    add(phase_remat_llava())
    add(phase_harness(card, bf16_sr_run))
    shaped = families(card, add)
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
