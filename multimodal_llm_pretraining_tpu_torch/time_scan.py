"""Time the selective-scan forward and backward kernels on the card at chosen shapes.

    python -m multimodal_llm_pretraining_tpu_torch.time_scan 2,4096,5120 2,300,96:f32 --check

A shape is B,L,I or B,L,I,N (d_state, 16 if left out), optionally followed
by ``:f32`` (f32 u, delta, B, C; bf16 otherwise). For each shape: the
milliseconds a call of ``selective_scan_fwd_cuda`` with D (the skip and the
cast in its epilogue, as ``SelectiveScanFused`` runs it) and of
``selective_scan_bwd_cuda`` takes in a run of 10 launches back to back (the
median of 3 runs), each one's bound and its share of it, and the device
time of each kernel a call launches (``torch.profiler``): the backward's
time holds the wrapper's sums of the dA, dB and dC partials. A bound is the
larger of the bytes (the inputs read once, the outputs written once) over
3.35 TB/s, the exps (one a state-step) over the special-function units'
rate and the f32 operations (6 a state-step forward, 16 backward) over 67
TFLOP/s, as ``chip_smoke.py`` counts them. With ``--check`` each shape's
kernels are first held to their plain versions (y before the skip to 1e-4
of its norm, y with the skip to 1e-4 in f32 and to one bf16 rounding, 4e-3,
in bf16, the checkpoint and gradients to 1e-3), and a second forward and a
second backward must repeat the first bit for bit; any failure exits 1.
``--ptxas`` has the build print one ``ptxas -v`` line per kernel first
(registers, static shared memory where there is any, spills). The card's ``nvidia-smi`` name and power limit head
the output.
"""

import argparse

import torch

from .ops import _build
from .ops import selective_scan_fused as ssf
from .time_attention import card_line, kernel_us, ms_per_call
from .utils import require_cuda

# H100 SXM (NVIDIA's data sheet, at 700 W): HBM, f32 outside the tensor cores, and 16 exps a clock on each
# of 132 SMs at 1.98 GHz (CUDA C++ Programming Guide, arithmetic instruction throughput, compute capability 9.0)
PEAK_BYTES = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_EXPS = 16 * 132 * 1.98e9
TOL_Y, TOL_GRAD = 1e-4, 1e-3
TOL_Y_BF16 = 4e-3  # y with the skip in bf16: one bf16 rounding of values that differ by the f32 error


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


def bound_ms(nbytes: int, flops: float, exps: float) -> tuple[float, str]:
    """The least time the card could take, in ms, and what sets it."""
    terms = {"bytes": nbytes / PEAK_BYTES, "f32 operations": flops / PEAK_F32_FLOPS, "exps": exps / PEAK_EXPS}
    what = max(terms, key=terms.get)
    return terms[what] * 1e3, what


def norm_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)).item()


def check(spec: str, u, delta, A, B, C, D, dy) -> bool:
    """The kernels against their plain versions, and a second forward and backward."""
    y, ckpt = ssf.selective_scan_fwd_cuda(u, delta, A, B, C)
    y_ref, ckpt_ref = ssf.selective_scan_fwd_reference(u, delta, A, B, C)
    ys, ckpt_s = ssf.selective_scan_fwd_cuda(u, delta, A, B, C, D)
    ys_ref, _ = ssf.selective_scan_fwd_reference(u, delta, A, B, C, D)
    grads = ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt_ref)
    refs = ssf.selective_scan_bwd_reference(u, delta, A, B, C, dy, ckpt_ref)
    tol_skip = TOL_Y_BF16 if u.dtype == torch.bfloat16 else TOL_Y
    errs = {"y": (norm_rel(y, y_ref), TOL_Y), "y+skip": (norm_rel(ys, ys_ref), tol_skip),
            "ckpt": (norm_rel(ckpt, ckpt_ref), TOL_GRAD)}
    errs.update({n: (norm_rel(g, r), TOL_GRAD) for n, g, r in zip(("du", "ddelta", "dA", "dB", "dC"), grads, refs)})
    again = ssf.selective_scan_fwd_cuda(u, delta, A, B, C, D)
    same_fwd = torch.equal(again[0], ys) and torch.equal(again[1], ckpt_s) and torch.equal(ckpt_s, ckpt)
    again = ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt_ref)
    same_bwd = all(torch.equal(a, b) for a, b in zip(grads, again))
    finite = all(torch.isfinite(t).all().item() for t in (y, ys, ckpt, *grads))
    ok = same_fwd and same_bwd and finite and ys.dtype == u.dtype and all(e <= tol for e, tol in errs.values())
    print(f"[check] {spec}: " + ", ".join(f"{n} {e:.2e}" for n, (e, _) in errs.items())
          + f"; second forward identical {same_fwd}, second backward identical {same_bwd}; "
          + f"{'ok' if ok else 'FAILED'}", flush=True)
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
        u, delta, A, B, C, D, dy = scan_inputs(b, L, I, n[0] if n else 16, dtype)
        if args.check:
            ok &= check(spec, u, delta, A, B, C, D, dy)
        y, ckpt = ssf.selective_scan_fwd_cuda(u, delta, A, B, C, D)
        grads = ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt)
        elems = u.numel() * A.shape[-1]  # state-steps
        ins = nbytes(u, delta, A, B, C)
        bounds = {"forward": bound_ms(ins + nbytes(D, y, ckpt), 6 * elems, elems),
                  "backward": bound_ms(ins + nbytes(dy, ckpt, *grads), 16 * elems, elems)}
        for name, fn in (("forward", lambda: ssf.selective_scan_fwd_cuda(u, delta, A, B, C, D)),
                         ("backward", lambda: ssf.selective_scan_bwd_cuda(u, delta, A, B, C, dy, ckpt))):
            ms = ms_per_call(fn)
            kernels = ", ".join(f"{k[:50]} {us:.1f} us" for k, us in kernel_us(fn).items())
            bnd, what = bounds[name]
            print(f"[{name}] {spec}: {ms:.4f} ms a call, bound {bnd:.4f} ms ({what}), share {bnd / ms:.3f}; "
                  f"device time a call: {kernels}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
