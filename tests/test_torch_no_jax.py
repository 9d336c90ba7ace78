"""The port and ``chip_smoke.py`` run where JAX is not installed: importing
them pulls in no JAX, flax, optax or JAX-package module, and the package
holds no library attention. ``chip_smoke.py`` names PyTorch's fused
attention in one function only, ``sdpa_ms``, the yardstick it times beside
the kernels, which the port never calls."""

import ast
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


SDPA = r"scaled_dot_product_attention"
YARDSTICK = "sdpa_ms"


def _chip_smoke(outside_yardstick: bool) -> str:
    """``chip_smoke.py``'s source, with the yardstick function cut out."""
    text = (ROOT / "chip_smoke.py").read_text()
    if not outside_yardstick:
        return text
    (fn,) = [n for n in ast.parse(text).body if isinstance(n, ast.FunctionDef) and n.name == YARDSTICK]
    return text.replace(ast.get_source_segment(text, fn), "")


@pytest.mark.parametrize(
    "pattern",
    [r"^\s*(import|from)\s+(jax|jaxlib|flax|optax)\b", r"^\s*(import|from)\s+multimodal_llm_pretraining_tpu\b",
     SDPA, r"torch\.compile", r"cudnn_attention|_efficient_attention|_flash_attention_forward"],
)
def test_package_source_has_none_of(pattern):
    """The package's sources and ``chip_smoke.py`` (outside its yardstick
    for PyTorch's fused attention) name none of these."""
    sources = {str(p.relative_to(ROOT)): p.read_text() for p in [*PACKAGE.rglob("*.py"), *PACKAGE.rglob("*.cu")]}
    sources["chip_smoke.py"] = _chip_smoke(outside_yardstick=pattern == SDPA)
    hits = [name for name, text in sources.items() if re.search(pattern, text, re.MULTILINE)]
    assert not hits, hits


def test_chip_smoke_names_library_attention_only_in_its_yardstick():
    """The yardstick exists and calls PyTorch's fused attention; cutting it
    out leaves no mention, and nothing in the package calls it."""
    assert re.search(SDPA, _chip_smoke(outside_yardstick=False))
    assert not re.search(SDPA, _chip_smoke(outside_yardstick=True))
    assert not re.search(rf"\b{YARDSTICK}\b", "".join(p.read_text() for p in PACKAGE.rglob("*.py")))
