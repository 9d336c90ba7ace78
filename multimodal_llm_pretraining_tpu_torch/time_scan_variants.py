"""Time variants of the selective-scan forward kernel on the card, in turns within one process.

    python -m multimodal_llm_pretraining_tpu_torch.time_scan_variants 2,4096,5120 2,4096,5120:f32

Each variant is ``csrc/selective_scan.cu`` with some of its constants
replaced (``VARIANTS``), built by nvcc into its own library with the flags
of the package's build and ``-Xptxas -v`` (the forward's registers and
spills are printed per variant), and put in place of the package's library
for its turns. A shape is B,L,I, optionally followed by ``:f32`` (bf16
otherwise), as in ``time_scan.py``. For each shape every variant is first
held to the plain version (y with the D skip to 4e-3 of its norm in bf16
and 1e-4 in f32, the checkpoint to 1e-3) and must repeat bit for bit; then
``selective_scan_fwd_cuda`` with D, as the autograd Function runs it, is
timed per variant (``ms_per_call``) in three rounds: in order, reversed, in
order. Each variant's mean of the three is printed with the three. Any
failed check exits 1. The card's ``nvidia-smi`` name and power limit head
the output.
"""

import argparse
import ctypes
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from .ops import _build
from .ops import selective_scan_fused as ssf
from .time_attention import card_line, ms_per_call
from .time_scan import scan_inputs
from .utils import require_cuda

TOL_Y, TOL_GRAD = 1e-4, 1e-3
TOL_Y_BF16 = 4e-3  # y with the skip in bf16: one bf16 rounding of values that differ by the f32 error

# name -> (text in csrc/selective_scan.cu, its replacement), each text found exactly once
VARIANTS = {
    "as built": (),
    "no widener": (("WIDEN = sizeof(T) == 2;", "WIDEN = false;"),),
    "32-step groups, 8 stages": (("FW_G = 64;", "FW_G = 32;"), ("FW_STAGES = 3;", "FW_STAGES = 8;")),
    "16-step groups, 8 stages": (("FW_G = 64;", "FW_G = 16;"), ("FW_STAGES = 3;", "FW_STAGES = 8;")),
    "16-step groups, 8 stages, no widener": (("FW_G = 64;", "FW_G = 16;"), ("FW_STAGES = 3;", "FW_STAGES = 8;"),
                                             ("WIDEN = sizeof(T) == 2;", "WIDEN = false;")),
    "2 states a thread": (("FW_SPT = 4;", "FW_SPT = 2;"),),
    "8 states a thread": (("FW_SPT = 4;", "FW_SPT = 8;"),),
    "40-channel tiles, two blocks an SM": (("FW_CH = 80;", "FW_CH = 40;"),
                                           ("__launch_bounds__(FW_THREADS, 1)", "__launch_bounds__(FW_THREADS, 2)")),
    "2 stages": (("FW_STAGES = 3;", "FW_STAGES = 2;"),),
    "3 y buffers": (("FW_OUT_BUFS = 2;", "FW_OUT_BUFS = 3;"),),
}


def variant_source(source: str, edits) -> str:
    """``csrc/<source>`` with each (old, new) of ``edits`` replaced."""
    src = (_build.CSRC_DIR / source).read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"{old!r} is not in {source} exactly once")
        src = src.replace(old, new)
    return src


class VariantLib:
    """The package library's entry points, those named taken from a variant's library."""

    def __init__(self, path: Path, main: ctypes.CDLL, names):
        self._main = main
        lib = ctypes.CDLL(str(path))
        for name in names:
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = getattr(main, name).argtypes, getattr(main, name).restype
            setattr(self, name, fn)

    def __getattr__(self, name):
        return getattr(self._main, name)


def build_variants(main: ctypes.CDLL, out_dir: Path, source: str, variants: dict, names, kernel: str,
                   describe) -> dict[str, VariantLib]:
    """Compile every variant of ``csrc/<source>`` alone into its own library,
    all nvcc processes started together; print ``describe(entry)`` with its
    registers and spills for each compiled entry function whose mangled
    name holds ``kernel``; take the entry points ``names`` from each
    variant."""
    nvcc = _build.find_nvcc()
    procs = {}
    for k, (name, edits) in enumerate(variants.items()):
        src = out_dir / f"v{k}.cu"
        src.write_text(variant_source(source, edits))
        cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", str(_build.CSRC_DIR),
               "-o", str(out_dir / f"v{k}.so"), str(src)]
        procs[name] = (k, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (k, proc) in procs.items():
        err = proc.communicate()[1]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{err[-4000:]}")
        regs = [f"{describe(entry)}: {found}" for entry, found in _build.entry_registers(err, kernel)]
        print(f"[ptxas] {name}: " + " | ".join(regs), flush=True)
        libs[name] = VariantLib(out_dir / f"v{k}.so", main, names)
    return libs


def norm_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)).item()


def _describe(entry: str) -> str:
    return f"{'bf16' if 'bfloat16' in entry else 'f32'}{' skip' if 'Lb1' in entry else ''}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("shapes", nargs="+", help="B,L,I[:f32]")
    args = ap.parse_args()
    require_cuda()
    print(f"[card] {card_line()}", flush=True)
    ok = True
    package_lib = _build.load()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = build_variants(package_lib, Path(tmp), "selective_scan.cu", VARIANTS, ("mlpt_scan_fwd", "mlpt_scan_bwd"),
                              "scan_fwd", _describe)
        try:
            for spec in args.shapes:
                dims, *flags = spec.split(":")
                b, L, I = (int(x) for x in dims.split(","))
                dtype = torch.float32 if "f32" in flags else torch.bfloat16
                u, delta, A, B, C, D, _ = scan_inputs(b, L, I, 16, dtype)
                y_ref, ckpt_ref = ssf.selective_scan_fwd_reference(u, delta, A, B, C, D)
                tol_y = TOL_Y_BF16 if dtype == torch.bfloat16 else TOL_Y
                times = {name: [] for name in libs}
                order = list(libs)
                for rnd in (order, order[::-1], order):
                    for name in rnd:
                        _build._lib = libs[name]
                        fn = lambda: ssf.selective_scan_fwd_cuda(u, delta, A, B, C, D)  # noqa: E731
                        if not times[name]:
                            first, again = fn(), fn()
                            errs = (norm_rel(first[0], y_ref), norm_rel(first[1], ckpt_ref))
                            same = all(torch.equal(x, z) for x, z in zip(first, again))
                            good = same and errs[0] <= tol_y and errs[1] <= TOL_GRAD
                            ok &= good
                            print(f"[check] {spec} {name}: y {errs[0]:.2e}, ckpt {errs[1]:.2e}, second run "
                                  f"identical {same}; {'ok' if good else 'FAILED'}", flush=True)
                        times[name].append(ms_per_call(fn))
                for name, t in times.items():
                    print(f"[variant] {spec} {name}: {statistics.mean(t):.4f} ms a call "
                          f"({', '.join(f'{x:.4f}' for x in t)})", flush=True)
        finally:
            _build._lib = package_lib
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
