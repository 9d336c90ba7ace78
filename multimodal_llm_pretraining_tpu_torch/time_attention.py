"""Time the flash-attention forward, fused backward and split backward on the card at chosen shapes.

    python -m multimodal_llm_pretraining_tpu_torch.time_attention 4,8,2049,256:causal 16,32,1087,64:causal:varlen 128,16,197,64:f32

A shape is B,H,S,D, optionally followed by ``:causal``, ``:varlen`` (every
length full, in the varlen mode) and ``:f32`` (f32 inputs; bf16 otherwise).
For each shape: the milliseconds a call of ``flash_fwd_cuda`` takes in a run
of 10 launches back to back (the median of 3 runs), its TFLOP/s (2 x 2·D
FLOP per visible query-key pair), and the device time of each kernel a call
launches, from ``torch.profiler`` over 10 calls: the forward kernel and, on
f32 inputs, the wrapper's casts to bf16. Then the same for a call of the
fused backward ``flash_bwd_cuda`` (5 x 2·D FLOP per visible pair; its
device time also holds delta, the padded lse and delta rows, dq's zeroing
and cast, and on f32 inputs the casts to bf16). Then the split backward
as the ``mlpt::flash_bwd_split`` op runs it (``PREFER_FUSED_BWD`` off): its
shared work alone (``split_operands``: the prep launch and, on f32 inputs,
the casts), the dq kernel alone and the dk/dv kernel alone on one such set
of operands (3 and 4 x 2·D FLOP per visible pair), and the pair as a whole
(``flash_bwd_split_cuda``: the backward's 5 x 2·D FLOP, though the pair
does 7), each beside the fused backward's time. PyTorch's own backward,
the pair's yardstick, is timed by ``chip_smoke.py`` (its ``[yardstick]``
lines), since the package names no library attention. Where this process
compiles the kernels, the build first prints every kernel's template
arguments, registers and spills from ``ptxas -v`` (a flash kernel's dynamic
shared memory is the ``launch_bytes`` of its tile struct in the source).
The card's ``nvidia-smi`` name and power limit head the output.
"""

import argparse
import statistics
import subprocess

import numpy as np
import torch

from .ops import _build
from .ops import flash_attention as fa
from .utils import require_cuda


def ms_per_call(fn, warmup: int = 3, iters: int = 10, reps: int = 3) -> float:
    """Milliseconds a call of ``fn`` takes on the card: one CUDA-event pair
    around a run of ``iters`` calls back to back, over ``iters``; the median
    of ``reps`` runs. The calls queue behind one another as a training step
    queues its kernels, so the host's launch work counts only where it takes
    longer than the card's."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def kernel_us(fn, calls: int = 10) -> dict[str, float]:
    """Device microseconds per call of each kernel ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / calls for e in prof.key_averages() if e.device_time_total > 0}


def visible_pairs(bh: int, q_seq: int, kv_seq: int, causal: bool, kv_lens=None) -> int:
    """(query, key) pairs the attention must compute: every query row sees
    the keys below its batch-head's length, and with ``causal`` only those
    at or before it."""
    lens = np.full(bh, kv_seq) if kv_lens is None else np.clip(kv_lens.cpu().numpy(), 0, kv_seq)
    if not causal:
        return int(lens.sum()) * q_seq
    return int(np.minimum(np.arange(1, q_seq + 1)[None, :], lens[:, None]).sum())


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("shapes", nargs="*", help="B,H,S,D[:causal][:varlen][:f32]")
    args = ap.parse_args()
    require_cuda()
    print(f"[card] {card_line()}", flush=True)
    _build.load(verbose=True)
    for spec in args.shapes:
        dims, *flags = spec.split(":")
        b, h, s, d = (int(x) for x in dims.split(","))
        causal = "causal" in flags
        dtype = torch.float32 if "f32" in flags else torch.bfloat16
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn(b * h, s, d, generator=g, device="cuda").to(dtype) for _ in range(4))
        lens = torch.full((b * h,), s, dtype=torch.int32, device="cuda") if "varlen" in flags else None

        def fwd():
            return fa.flash_fwd_cuda(q, k, v, causal, d**-0.5, lens)

        out, lse = fwd()

        def bwd():
            return fa.flash_bwd_cuda(q, k, v, out, lse, do, causal, d**-0.5, lens)

        def operands():
            return fa.split_operands(q, k, v, out, lse, do, d**-0.5, lens)

        ops = operands()

        def split():
            return fa.flash_bwd_split_cuda(q, k, v, out, lse, do, causal, d**-0.5, lens)

        pairs = visible_pairs(b * h, s, s, causal, lens)
        fused_ms = None
        for name, fn, flops in (
            ("forward", fwd, 4 * d * pairs),
            ("backward", bwd, 10 * d * pairs),
            ("split operands", operands, 0),
            ("split dq", lambda: fa.flash_bwd_dq_cuda(ops, causal), 6 * d * pairs),
            ("split dk/dv", lambda: fa.flash_bwd_dkv_cuda(ops, causal), 8 * d * pairs),
            ("split pair", split, 10 * d * pairs),
        ):
            ms = ms_per_call(fn)
            fused_ms = ms if name == "backward" else fused_ms
            kernels = ", ".join(f"{k_name[:60]} {us:.1f} us" for k_name, us in kernel_us(fn).items())
            rate = f", {flops / ms / 1e9:.1f} TFLOP/s" if flops else ""
            beside = f" ({ms / fused_ms:.3f} of the fused backward's)" if name.startswith("split") else ""
            print(f"[{name}] {spec}: {ms:.4f} ms a call{rate}{beside}; device time a call: {kernels}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
