"""Attention dispatcher (counterpart of ``ops/attention.py:21-82``).

- ``flash`` -- the hand-written flash-attention kernels
  (``ops/flash_attention.py``) for CUDA tensors; their plain PyTorch
  versions for CPU tensors. The custom-kernel branch. A padding mask takes
  the kernels' varlen mode. What ``flash_supported`` refuses (a head dim
  above the kernels' 256, an irregular mask) takes the ``xla`` branch, as
  the JAX dispatcher sends it there (``:54-59``); the choice is made by
  shape alone and counted in ``XLA_BRANCH_CALLS``.
- ``xla`` -- the JAX package's ``xla`` branch (``:73-82``): scores from
  the input-dtype operands with f32 accumulation, times the scale; an f32
  softmax rounded to the output dtype; its product with v. Plain PyTorch.
- ``naive`` -- plain f32 dot-product attention, the eager parity branch. A
  padding mask becomes an f32 additive ``-inf`` key bias, as in JAX.
"""

from typing import Literal

import torch

from .flash_attention import flash_attention, flash_supported

AttnImpl = Literal["flash", "xla", "naive"]

# Calls of ``impl="flash"`` that ``flash_supported`` sent to the xla branch
XLA_BRANCH_CALLS = 0


def default_attn_impl(use_custom_kernels: bool) -> AttnImpl:
    return "flash" if use_custom_kernels else "naive"


def _mask_bias(q_seq: int, kv_seq: int, causal: bool, mask, device) -> torch.Tensor | None:
    """Additive f32 bias from the causal and padding masks ([Sq, Sk] or [B,
    1, Sq, Sk]), or None for full attention (``_mask_bias``, ``:29-40``)."""
    bias = None
    if causal:
        keep = torch.arange(q_seq, device=device)[:, None] >= torch.arange(kv_seq, device=device)[None, :]
        bias = torch.where(keep, 0.0, float("-inf"))
    if mask is not None:
        m = torch.where(mask[:, None, None, :] > 0, 0.0, float("-inf"))
        bias = m if bias is None else bias + m
    return bias


def dot_product_attention(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, H, Sk, D]
    v: torch.Tensor,  # [B, H, Sk, D]
    *,
    causal: bool = False,
    mask: torch.Tensor | None = None,  # [B, Sk] keep-mask (1 = attend)
    impl: AttnImpl = "flash",
    sm_scale: float | None = None,
) -> torch.Tensor:
    global XLA_BRANCH_CALLS
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if impl == "flash":
        if flash_supported(q, k, v, mask):
            return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale, kv_len_mask=mask)
        XLA_BRANCH_CALLS += 1
        impl = "xla"
    if impl == "naive":
        # eager-parity branch: f32 throughout, returns f32 like the JAX branch
        q, k, v = q.float(), k.float(), v.float()
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * sm_scale
        bias = _mask_bias(q.shape[2], k.shape[2], causal, mask, q.device)
        if bias is not None:
            scores = scores + bias
        probs = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", probs, v)
    if impl == "xla":
        # the operands' values in f32 (exact for bf16) give the f32-accumulated scores
        out_dtype = q.dtype
        scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
        bias = _mask_bias(q.shape[2], k.shape[2], causal, mask, q.device)
        if bias is not None:
            scores = scores + bias
        probs = torch.softmax(scores, dim=-1).to(out_dtype)
        return torch.einsum("bhqk,bhkd->bhqd", probs, v)
    raise ValueError(f"unknown attention impl: {impl}")
