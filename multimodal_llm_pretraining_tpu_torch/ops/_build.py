"""Build and bind the package's CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a``, one
process per source, all started together, and linked into one shared library
with a plain C interface, loaded with ``ctypes``. The build happens at first
use, into ``_build/`` inside the package (ignored by git), and is keyed by a
hash of the sources and flags: a changed source rebuilds, an unchanged one
loads the library already there. Nothing here runs at import time, so the
CPU-only tests can import every module.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from ..utils import get_logger

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "flash_bwd_dq.cu", "selective_scan.cu", "xent.cu", "rmsnorm.cu",
           "causal_conv.cu", "gate.cu", "ssd.cu")
HEADERS = ("hopper.cuh",)  # included by the sources: part of the build's hash
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
last_build_seconds: float | None = None  # wall time of the last compile in this process (None: loaded as built)


def find_nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put the CUDA toolkit's bin/ on PATH)")


def entry_registers(report: str, kernel: str = "") -> list[tuple[str, str]]:
    """(mangled name, registers and spills) of each entry function of an
    ``nvcc -Xptxas -v`` report whose name holds ``kernel``."""
    lines = report.splitlines()
    return [(line.split("'")[1], f"{lines[i + 3].split(': ')[-1]}, {lines[i + 2].strip()}")
            for i, line in enumerate(lines) if "Compiling entry" in line and kernel in line]


def demangled(names: list[str]) -> list[str]:
    """``names`` demangled by ``cu++filt`` beside ``nvcc`` (or ``c++filt``),
    without namespace or parameter list; as given where no demangler is."""
    filt = os.path.join(os.path.dirname(find_nvcc()), "cu++filt")
    filt = filt if os.path.exists(filt) else shutil.which("c++filt")
    if not filt or not names:
        return names
    out = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True).stdout.splitlines()
    if len(out) != len(names):
        return names
    # cu++filt writes a template's integer and bool arguments as (int)256 and (bool)1
    return [re.sub(r"\(anonymous namespace\)::|<unnamed>::|\((?:int|bool)\)", "", n).split("(")[0].removeprefix("void ")
            for n in out]


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libmlpt_kernels_{_source_hash()}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels if the library for the current sources is missing;
    return its path. The build writes into a temporary directory and renames
    the library into place, so a concurrent or interrupted build never leaves
    a partial library behind."""
    global last_build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"{Path(s).stem}.o") for s in SOURCES]
        t0 = time.perf_counter()
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", obj, str(CSRC_DIR / src)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for src, obj in zip(SOURCES, objs)
        ]
        errs = [p.communicate()[1] for p in procs]  # waits for each compile
        if verbose:
            for src, err in zip(SOURCES, errs):
                found = entry_registers(err)
                for name, (_, regs) in zip(demangled([n for n, _ in found]), found):
                    print(f"[ptxas] {src}: {name}: {regs}", flush=True)
        failed = [f"{src} ({p.returncode}):\n{err[-8000:]}" for src, p, err in zip(SOURCES, procs, errs) if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, "-shared", "-o", lib, *objs], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr[-8000:]}")
        os.replace(lib, out)
    last_build_seconds = time.perf_counter() - t0
    get_logger().info(f"built {out.name} with nvcc in {last_build_seconds:.1f} s")
    return out


def load(verbose: bool = False) -> ctypes.CDLL:
    """The kernel library with its C signatures declared (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build(verbose=verbose)))
            ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
            lib.mlpt_flash_fwd.argtypes = [ptr] * 6 + [i32] * 6 + [f32, ptr]
            lib.mlpt_flash_fwd.restype = i32
            lib.mlpt_flash_bwd.argtypes = [ptr] * 13 + [i32] * 6 + [f32, ptr]
            lib.mlpt_flash_bwd.restype = i32
            lib.mlpt_flash_bwd_prep.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
            lib.mlpt_flash_bwd_prep.restype = i32
            lib.mlpt_flash_bwd_dq.argtypes = [ptr] * 8 + [i32] * 6 + [f32, f32, ptr]
            lib.mlpt_flash_bwd_dq.restype = i32
            lib.mlpt_flash_bwd_dkv.argtypes = [ptr] * 9 + [i32] * 6 + [f32, i32, ptr]
            lib.mlpt_flash_bwd_dkv.restype = i32
            lib.mlpt_scan_fwd.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
            lib.mlpt_scan_fwd.restype = i32
            lib.mlpt_scan_bwd.argtypes = [ptr] * 14 + [i32] * 5 + [ptr]
            lib.mlpt_scan_bwd.restype = i32
            lib.mlpt_xent_fwd.argtypes = [ptr] * 4 + [i32, i32, i64, i64, ptr]
            lib.mlpt_xent_fwd.restype = i32
            lib.mlpt_xent_bwd.argtypes = [ptr] * 5 + [i32, i32, i64, i64, i32, ptr]
            lib.mlpt_xent_bwd.restype = i32
            lib.mlpt_rmsnorm_fwd.argtypes = [ptr] * 4 + [i32, i32, f32, i32, i32, ptr]
            lib.mlpt_rmsnorm_fwd.restype = i32
            lib.mlpt_rmsnorm_bwd_grid.argtypes = [i32] * 4
            lib.mlpt_rmsnorm_bwd_grid.restype = i32
            lib.mlpt_rmsnorm_bwd.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
            lib.mlpt_rmsnorm_bwd.restype = i32
            lib.mlpt_causal_conv_fwd.argtypes = [ptr, i64, i64, ptr, ptr, ptr] + [i32] * 7 + [ptr]
            lib.mlpt_causal_conv_fwd.restype = i32
            lib.mlpt_causal_conv_bwd.argtypes = [ptr, i64, i64] + [ptr] * 5 + [i32] * 7 + [ptr]
            lib.mlpt_causal_conv_bwd.restype = i32
            lib.mlpt_causal_conv_bwd_partials.argtypes = [i32, i32]
            lib.mlpt_causal_conv_bwd_partials.restype = i32
            lib.mlpt_gate_silu_fwd.argtypes = [ptr, i64, ptr, i64, ptr, i64] + [i32] * 3 + [ptr]
            lib.mlpt_gate_silu_fwd.restype = i32
            lib.mlpt_gate_silu_bwd.argtypes = [ptr, ptr, i64, ptr, i64, ptr, ptr, i64] + [i32] * 3 + [ptr]
            lib.mlpt_gate_silu_bwd.restype = i32
            lib.mlpt_ssd_fwd.argtypes = [ptr, i64, i64] + [ptr] * 7 + [i32] * 6 + [ptr]
            lib.mlpt_ssd_fwd.restype = i32
            lib.mlpt_ssd_bwd.argtypes = [ptr, i64, i64] + [ptr] * 14 + [i32] * 5 + [ptr]
            lib.mlpt_ssd_bwd.restype = i32
            lib.mlpt_ssd_scale.argtypes = [ptr, i64, i64, ptr, ptr] + [i32] * 4 + [ptr]
            lib.mlpt_ssd_scale.restype = i32
            lib.mlpt_ssd_state_fwd.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
            lib.mlpt_ssd_state_fwd.restype = i32
            lib.mlpt_ssd_state_bwd_parts.argtypes = [i32]
            lib.mlpt_ssd_state_bwd_parts.restype = i32
            lib.mlpt_ssd_state_bwd.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
            lib.mlpt_ssd_state_bwd.restype = i32
            lib.mlpt_error_string.argtypes = [i32]
            lib.mlpt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} ({lib.mlpt_error_string(err).decode()})")
