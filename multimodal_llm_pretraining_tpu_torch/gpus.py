"""GPU registry: the cards the port runs on and their data-sheet rates.

Counterpart of ``multimodal_llm_pretraining_tpu/tpus.py:15-126``, which
holds the TPU generations; this one holds the NVIDIA H100 SXM 80GB, the
card the port's kernels are written for (``sm_90a``). Peaks are NVIDIA's
data sheet for the H100 SXM: dense rates without sparsity, at the card's
full 700 W power limit (a card set below it runs slower under load). MFU
divides by them (``bench.py``).
"""

from dataclasses import dataclass
from typing import Literal

import torch

GpuT = Literal["h100-sxm"]

GPU_TYPES: tuple[GpuT, ...] = ("h100-sxm",)


@dataclass(frozen=True)
class GpuSpec:
    name: GpuT
    device_name: str  # what ``torch.cuda.get_device_name`` reports for it
    peak_bf16_tflops: float  # tensor cores, dense
    peak_tf32_tflops: float  # tensor cores, dense
    peak_fp32_tflops: float  # outside the tensor cores
    hbm_gb: float  # 10**9 bytes
    hbm_bandwidth_gbps: float  # GB/s
    nvlink_bandwidth_gbps: float  # GB/s to the other cards of the host, both ways together

    @property
    def hbm_bytes(self) -> int:
        return int(self.hbm_gb * 10**9)


_SPECS: dict[GpuT, GpuSpec] = {
    s.name: s
    for s in [
        # NVIDIA H100 Tensor Core GPU data sheet, H100 SXM column
        GpuSpec("h100-sxm", device_name="NVIDIA H100 80GB HBM3", peak_bf16_tflops=989.0, peak_tf32_tflops=494.7,
                peak_fp32_tflops=67.0, hbm_gb=80.0, hbm_bandwidth_gbps=3350.0, nvlink_bandwidth_gbps=900.0),
    ]
}


def gpu_spec(gpu: GpuT) -> GpuSpec:
    return _SPECS[gpu]


def peak_tflops(gpu: GpuT, dtype: Literal["bf16", "tf32", "fp32"]) -> float:
    """Dense peak TFLOP/s of ``gpu`` for products in ``dtype``: bf16 and
    TF32 on the tensor cores, fp32 outside them."""
    spec = gpu_spec(gpu)
    match dtype:
        case "bf16":
            return spec.peak_bf16_tflops
        case "tf32":
            return spec.peak_tf32_tflops
        case "fp32":
            return spec.peak_fp32_tflops
    raise ValueError(f"unknown dtype {dtype}")


def supports_bf16(gpu: GpuT) -> bool:
    """Whether ``gpu`` computes bf16 on its tensor cores (Ampere and newer,
    the reference's ``ampere_or_newer_gpu``): every card in the registry."""
    gpu_spec(gpu)
    return True


def analytic_peak_tflops(gpu: GpuT, mixed_precision: Literal[None, "bf16", "fp16"], free_lunch: bool) -> float:
    """The peak the analytic experiment divides by (the reference's
    ``training_time_analytic.py`` choice): bf16 for models in bf16 or fp16,
    TF32 for f32 models under the free lunch (which turns TF32 on), f32
    outside the tensor cores otherwise."""
    if mixed_precision in ("bf16", "fp16"):
        return peak_tflops(gpu, "bf16")
    return peak_tflops(gpu, "tf32" if free_lunch else "fp32")


def detect_local_gpu() -> GpuT | None:
    """The registry's name for card 0, or None when no card is visible or
    the card is not in the registry (its rates are then unknown: no guess)."""
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(0)
    return next((s.name for s in _SPECS.values() if s.device_name == name), None)


def device_hbm_bytes() -> int:
    """The device memory of the current card as CUDA reports it
    (``torch.cuda.mem_get_info``'s total); raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible (torch.cuda.is_available() is False)")
    return torch.cuda.mem_get_info()[1]
