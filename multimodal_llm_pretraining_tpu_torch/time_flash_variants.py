"""Time variants of the split backward's dq kernel on the card, in turns within one process.

    python -m multimodal_llm_pretraining_tpu_torch.time_flash_variants 4,8,2049,256:causal 16,32,1087,64:causal:varlen 128,16,197,64:f32

Each variant is ``csrc/flash_bwd_dq.cu`` with some of its constants
replaced (``VARIANTS``), built by nvcc into its own library with the flags
of the package's build and ``-Xptxas -v`` (each dq kernel's registers and
spills are printed per variant), and put in place of the package's dq
entry point for its turns (the prep launch stays the package's). A shape
is B,H,S,D[:causal][:varlen][:f32], as in ``time_attention.py``. For each
shape every variant is first held to the plain version (dq to 1e-2 of its
norm) and must repeat bit for bit; then ``flash_bwd_dq_cuda`` on one
``split_operands`` is timed per variant (``ms_per_call``) in three rounds:
in order, reversed, in order. Each variant's mean of the three is printed
with the three. Any failed check exits 1. The card's ``nvidia-smi`` name
and power limit head the output.
"""

import argparse
import statistics
import sys
import tempfile
from pathlib import Path

import torch

from .ops import _build
from .ops import flash_attention as fa
from .time_attention import card_line, ms_per_call
from .time_scan_variants import build_variants
from .utils import require_cuda

SOURCE = "flash_bwd_dq.cu"
TOL = 1e-2

# name -> edits of csrc/flash_bwd_dq.cu: (text found there exactly once, its replacement)
VARIANTS = {
    "as built": (),
    "D=256: one consumer warpgroup (BQ 64), two stages": (("D256_CONSUMERS = 2;", "D256_CONSUMERS = 1;"),),
}


def _describe(entry: str) -> str:
    return f"D {entry.split('dq_kernelILi')[1].split('E')[0]} {'bf16' if 'bfloat16' in entry else 'f32'}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("shapes", nargs="+", help="B,H,S,D[:causal][:varlen][:f32]")
    args = ap.parse_args()
    require_cuda()
    print(f"[card] {card_line()}", flush=True)
    ok = True
    package_lib = _build.load()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = build_variants(package_lib, Path(tmp), SOURCE, VARIANTS, ("mlpt_flash_bwd_dq",), "dq_kernel", _describe)
        try:
            for spec in args.shapes:
                dims, *flags = spec.split(":")
                b, h, s, d = (int(x) for x in dims.split(","))
                causal, scale = "causal" in flags, d**-0.5
                dtype = torch.float32 if "f32" in flags else torch.bfloat16
                g = torch.Generator(device="cuda").manual_seed(0)
                q, k, v, do = (torch.randn(b * h, s, d, generator=g, device="cuda").to(dtype) for _ in range(4))
                lens = torch.full((b * h,), s, dtype=torch.int32, device="cuda") if "varlen" in flags else None
                out, lse = fa.flash_fwd_reference(q, k, v, causal, scale, lens)
                ref = fa.flash_bwd_dq_reference(q, k, v, do, lse, fa.bwd_delta(out, do), causal, scale, lens)
                ops = fa.split_operands(q, k, v, out, lse, do, scale, lens)
                times = {name: [] for name in libs}
                order = list(libs)
                for rnd in (order, order[::-1], order):
                    for name in rnd:
                        _build._lib = libs[name]
                        fn = lambda: fa.flash_bwd_dq_cuda(ops, causal)  # noqa: E731
                        if not times[name]:
                            first, again = fn()[..., :d], fn()[..., :d]
                            err = ((first.float() - ref.float()).norm() / ref.float().norm()).item()
                            good = torch.equal(first, again) and err <= TOL
                            ok &= good
                            print(f"[check] {spec} {name}: dq norm_rel {err:.2e}, second run identical "
                                  f"{torch.equal(first, again)}; {'ok' if good else 'FAILED'}", flush=True)
                        times[name].append(ms_per_call(fn))
                for name, t in times.items():
                    print(f"[variant] {spec} {name}: {statistics.mean(t):.4f} ms a call "
                          f"({', '.join(f'{x:.4f}' for x in t)})", flush=True)
        finally:
            _build._lib = package_lib
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
