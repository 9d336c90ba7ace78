"""Time the selective-scan forward and backward kernels on the card at chosen shapes.

    python -m multimodal_llm_pretraining_tpu_torch.time_scan 2,4096,5120 2,300,96:f32 --check

A shape is B,L,I or B,L,I,N (d_state, 16 if left out), optionally followed
by ``:f32`` (f32 u, delta, B, C; bf16 otherwise). For each shape: the
milliseconds a call of ``selective_scan_fwd_cuda`` and of
``selective_scan_bwd_cuda`` takes in a run of 10 launches back to back (the
median of 3 runs), the backward's bound (its bytes over 3.35 TB/s: the
inputs read once, the outputs written once) and its share of it, and the
device time of each kernel a call launches (``torch.profiler``): the
backward's time holds the wrapper's sums of the dA, dB and dC partials.
With ``--check`` each shape's kernels are first held to their plain versions
(y to 1e-4 of its norm, the checkpoint and gradients to 1e-3) and a second
backward run must repeat the first bit for bit; any failure exits 1.
``--ptxas`` prints the build's ``ptxas -v`` report (registers, shared
memory, spills) first. The card's ``nvidia-smi`` name and power limit head
the output.
"""

import argparse

import torch

from .ops import _build
from .ops import selective_scan_fused as ssf
from .time_attention import card_line, kernel_us, ms_per_call
from .utils import require_cuda

PEAK_BYTES = 3.35e12  # H100 SXM HBM3 (NVIDIA's data sheet)
TOL_Y, TOL_GRAD = 1e-4, 1e-3


def scan_inputs(b: int, L: int, I: int, N: int, dtype, seed: int = 0):
    """u, delta, A, B, C, dy on the card; delta in (0.01, 0.51) and A in
    -(0.5, 1.5) as in the JAX suite's scan tests."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn(b, L, I, generator=g, device="cuda").to(dtype)
    delta = (torch.rand(b, L, I, generator=g, device="cuda") * 0.5 + 0.01).to(dtype)
    A = -(torch.rand(I, N, generator=g, device="cuda") + 0.5)
    B, C = (torch.randn(b, L, N, generator=g, device="cuda").to(dtype) for _ in range(2))
    dy = torch.randn(b, L, I, generator=g, device="cuda")
    return u, delta, A, B, C, dy


def norm_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)).item()


def check(spec: str, u, delta, A, B, C, dy) -> bool:
    """The kernels against their plain versions, and a second backward."""
    y, ckpt = ssf.selective_scan_fwd_cuda(u, delta, A, B, C)
    y_ref, ckpt_ref = ssf.selective_scan_fwd_reference(u, delta, A, B, C)
    grads = ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt_ref)
    refs = ssf.selective_scan_bwd_reference(u, delta, A, B, C, dy, ckpt_ref)
    errs = {"y": (norm_rel(y, y_ref), TOL_Y), "ckpt": (norm_rel(ckpt, ckpt_ref), TOL_GRAD)}
    errs.update({n: (norm_rel(g, r), TOL_GRAD) for n, g, r in zip(("du", "ddelta", "dA", "dB", "dC"), grads, refs)})
    again = ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt_ref)
    same = all(torch.equal(a, b) for a, b in zip(grads, again))
    finite = all(torch.isfinite(t).all().item() for t in (y, ckpt, *grads))
    ok = same and finite and all(e <= tol for e, tol in errs.values())
    print(f"[check] {spec}: " + ", ".join(f"{n} {e:.2e}" for n, (e, _) in errs.items())
          + f"; second backward identical {same}; {'ok' if ok else 'FAILED'}", flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("shapes", nargs="+", help="B,L,I[,N][:f32]")
    ap.add_argument("--check", action="store_true", help="hold the kernels to their plain versions first")
    ap.add_argument("--ptxas", action="store_true", help="print the build's ptxas -v report")
    args = ap.parse_args()
    require_cuda()
    print(f"[card] {card_line()}", flush=True)
    _build.load(verbose=args.ptxas)
    ok = True
    for spec in args.shapes:
        dims, *flags = spec.split(":")
        b, L, I, *n = (int(x) for x in dims.split(","))
        dtype = torch.float32 if "f32" in flags else torch.bfloat16
        u, delta, A, B, C, dy = scan_inputs(b, L, I, n[0] if n else 16, dtype)
        if args.check:
            ok &= check(spec, u, delta, A, B, C, dy)
        _, ckpt = ssf.selective_scan_fwd_cuda(u, delta, A, B, C)
        grads = ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt)
        nbytes = sum(t.numel() * t.element_size() for t in (u, delta, A, B, C, dy, ckpt, *grads))
        bound_ms = nbytes / PEAK_BYTES * 1e3
        for name, fn in (("forward", lambda: ssf.selective_scan_fwd_cuda(u, delta, A, B, C)),
                         ("backward", lambda: ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt))):
            ms = ms_per_call(fn)
            kernels = ", ".join(f"{k[:50]} {us:.1f} us" for k, us in kernel_us(fn).items())
            extra = (f", bound {bound_ms:.4f} ms ({nbytes} bytes), share {bound_ms / ms:.3f}"
                     if name == "backward" else "")
            print(f"[{name}] {spec}: {ms:.4f} ms a call{extra}; device time a call: {kernels}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
