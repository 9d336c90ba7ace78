"""Time the selective-scan forward and backward kernels on the card at chosen shapes.

    python -m multimodal_llm_pretraining_tpu_torch.time_scan 2,4096,5120 2,300,96:f32

A shape is B,L,I or B,L,I,N (d_state, 16 if left out), optionally followed
by ``:f32`` (f32 u, delta, B, C; bf16 otherwise). For each shape: the
milliseconds a call of ``selective_scan_fwd_cuda`` and of
``selective_scan_bwd_cuda`` takes, both with D and the backward with dy in
u's dtype, as ``selective_scan_fused`` runs them (the skip's terms and the
casts in the kernels' epilogues at d_state 16), in a run of 10 launches back
to back (the median of 3 runs), each one's bound (``scan_bounds``) and its
share of it, and the device time of each kernel a call launches
(``torch.profiler``): the backward's time holds the wrapper's sums of the
dA, dB, dC and dD partials. The
kernels' correctness is the card tests' (``tests/test_torch_kernels.py -m
cuda -k scan``). ``--ptxas`` has the build print one ``ptxas -v`` line per
kernel first (registers, static shared memory where there is any, spills).
The card's ``nvidia-smi`` name and power limit head the output.
"""

import argparse

import torch

from .gpus import bound, peak_tflops
from .ops import _build
from .ops import selective_scan_fused as ssf
from .time_attention import card_line, kernel_us, ms_per_call
from .utils import require_cuda


def scan_inputs(b: int, L: int, I: int, N: int, dtype, seed: int = 0):
    """u, delta, A, B, C, D, dy on the card; delta in (0.01, 0.51) and A in
    -(0.5, 1.5) as in the JAX suite's scan tests."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn(b, L, I, generator=g, device="cuda").to(dtype)
    delta = (torch.rand(b, L, I, generator=g, device="cuda") * 0.5 + 0.01).to(dtype)
    A = -(torch.rand(I, N, generator=g, device="cuda") + 0.5)
    B, C = (torch.randn(b, L, N, generator=g, device="cuda").to(dtype) for _ in range(2))
    D = torch.randn(I, generator=g, device="cuda")
    dy = torch.randn(b, L, I, generator=g, device="cuda")
    return u, delta, A, B, C, D, dy


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def scan_bounds(u, delta, A, B, C, D, dy, y, ckpt, grads) -> dict[str, tuple[float, str]]:
    """``gpus.bound`` of each kernel's call on these tensors (``y`` and
    ``ckpt`` the forward's with D, ``grads`` the backward's): the inputs read
    once and the outputs written once, one exp a state-step, and 6 f32
    operations a state-step forward (delta*A, the decay, delta*u*B and its
    add, C*h and its sum), 16 backward (the recomputed state, the
    reverse-time dh recurrence, the du, ddelta, dA, dB and dC terms)."""
    steps = u.numel() * A.shape[-1]
    ins = nbytes(u, delta, A, B, C)
    f32 = peak_tflops("h100-sxm", "fp32") * 1e12
    return {"fwd": bound(ins + nbytes(D, y, ckpt), 6 * steps, f32, steps),
            "bwd": bound(ins + nbytes(dy, ckpt, *grads), 16 * steps, f32, steps)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("shapes", nargs="+", help="B,L,I[,N][:f32]")
    ap.add_argument("--ptxas", action="store_true", help="print the build's ptxas -v report")
    args = ap.parse_args()
    require_cuda()
    print(f"[card] {card_line()}", flush=True)
    _build.load(verbose=args.ptxas)
    for spec in args.shapes:
        dims, *flags = spec.split(":")
        b, L, I, *n = (int(x) for x in dims.split(","))
        dtype = torch.float32 if "f32" in flags else torch.bfloat16
        u, delta, A, B, C, D, dy = scan_inputs(b, L, I, n[0] if n else 16, dtype)
        dy = dy.to(dtype)
        y, ckpt = ssf.selective_scan_fwd_cuda(u, delta, A, B, C, D)
        grads = ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt, D)
        bounds = scan_bounds(u, delta, A, B, C, D, dy, y, ckpt, grads)
        for key, name, fn in (("fwd", "forward", lambda: ssf.selective_scan_fwd_cuda(u, delta, A, B, C, D)),
                              ("bwd", "backward", lambda: ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt, D))):
            ms = ms_per_call(fn)
            kernels = ", ".join(f"{k[:50]} {us:.1f} us" for k, us in kernel_us(fn).items())
            bnd, what = bounds[key]
            print(f"[{name}] {spec}: {ms:.4f} ms a call, bound {bnd:.4f} ms ({what}), share {bnd / ms:.3f}; "
                  f"device time a call: {kernels}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
