"""Build and bind the package's CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, into ``_build/`` inside the package (ignored by git),
and is keyed by a hash of the sources and flags: a changed source rebuilds,
an unchanged one loads the library already there. Nothing here runs at
import time, so the CPU-only tests can import every module.
"""

import ctypes
import hashlib
import os
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
SOURCES = ("flash_attention.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
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


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libmlpt_kernels_{_source_hash()}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels if the library for the current sources is missing;
    return its path. The compile writes to a temporary file and renames it
    into place, so a concurrent or interrupted build never leaves a partial
    library behind."""
    global last_build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-o", tmp, *[str(CSRC_DIR / s) for s in SOURCES]]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-8000:]}")
        if verbose:
            print(proc.stderr[-8000:], flush=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    last_build_seconds = time.perf_counter() - t0
    get_logger().info(f"built {out.name} with nvcc in {last_build_seconds:.1f} s")
    return out


def load(verbose: bool = False) -> ctypes.CDLL:
    """The kernel library with its C signatures declared (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build(verbose=verbose)))
            ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.mlpt_flash_fwd.argtypes = [ptr] * 5 + [i32] * 6 + [f32, ptr]
            lib.mlpt_flash_fwd.restype = i32
            lib.mlpt_flash_bwd.argtypes = [ptr] * 9 + [i32] * 6 + [f32, ptr]
            lib.mlpt_flash_bwd.restype = i32
            lib.mlpt_error_string.argtypes = [i32]
            lib.mlpt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} ({lib.mlpt_error_string(err).decode()})")
