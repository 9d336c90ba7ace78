"""The port and ``chip_smoke.py`` run where JAX is not installed: importing
them pulls in no JAX, flax, optax or JAX-package module, and the package
holds no library attention."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "multimodal_llm_pretraining_tpu_torch"

_PROBE = """
import importlib, pkgutil, sys
import multimodal_llm_pretraining_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "multimodal_llm_pretraining_tpu"))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_port_and_chip_smoke_import_no_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    count = int(proc.stdout.split()[0])
    assert count >= 15  # every module of the slice was imported


@pytest.mark.parametrize(
    "pattern",
    [r"^\s*(import|from)\s+(jax|jaxlib|flax|optax)\b", r"^\s*(import|from)\s+multimodal_llm_pretraining_tpu\b",
     r"scaled_dot_product_attention", r"torch\.compile", r"cudnn_attention|_efficient_attention|_flash_attention_forward"],
)
def test_package_source_has_none_of(pattern):
    sources = [*PACKAGE.rglob("*.py"), *PACKAGE.rglob("*.cu"), ROOT / "chip_smoke.py"]
    hits = [str(p.relative_to(ROOT)) for p in sources if re.search(pattern, p.read_text(), re.MULTILINE)]
    assert not hits, hits
