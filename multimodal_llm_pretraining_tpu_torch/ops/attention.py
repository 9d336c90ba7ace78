"""Attention dispatcher (counterpart of ``ops/attention.py:21-82``).

- ``flash`` -- the hand-written flash-attention kernels
  (``ops/flash_attention.py``) for CUDA tensors; their plain PyTorch
  versions for CPU tensors. The custom-kernel branch.
- ``naive`` -- plain f32 dot-product attention, the eager parity branch.

Padding masks are not supported yet (the varlen kernel is ROADMAP Queue 2
item 2).
"""

from typing import Literal

import torch

from .flash_attention import flash_attention

AttnImpl = Literal["flash", "naive"]


def default_attn_impl(use_custom_kernels: bool) -> AttnImpl:
    return "flash" if use_custom_kernels else "naive"


def dot_product_attention(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, H, Sk, D]
    v: torch.Tensor,  # [B, H, Sk, D]
    *,
    causal: bool = False,
    mask: torch.Tensor | None = None,
    impl: AttnImpl = "flash",
    sm_scale: float | None = None,
) -> torch.Tensor:
    if mask is not None:
        raise NotImplementedError("padding masks need the varlen flash kernel: ROADMAP Queue 2 item 2")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if impl == "flash":
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    if impl == "naive":
        # eager-parity branch: f32 throughout, returns f32 like the JAX branch
        q, k, v = q.float(), k.float(), v.float()
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * sm_scale
        if causal:
            sq, sk = q.shape[2], k.shape[2]
            keep = torch.arange(sq, device=q.device)[:, None] >= torch.arange(sk, device=q.device)[None, :]
            scores = scores.masked_fill(~keep, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", probs, v)
    raise ValueError(f"unknown attention impl: {impl}")
