"""Selective-state-space scan (Mamba S6) and the depthwise causal conv
(counterpart of ``ops/selective_scan.py:25-132``).

- ``causal_conv1d``: left pad, then a grouped ``F.conv1d`` (XLA in the JAX
  package too, not a Pallas kernel). It is the conv of the JAX arithmetic
  (``MambaBlock`` with ``residual_in_fp32=False``) and, in f32, the plain
  version behind ``ops/causal_conv.py``, whose kernel pair computes the
  published arithmetic's conv with its bias and SiLU on the card.
- ``selective_scan``: the dispatcher. With ``use_custom_kernels=True`` the
  scan runs through ``selective_scan_fused`` (the ``mlpt::scan_fwd`` op):
  the hand-written CUDA kernels for CUDA tensors, at every sequence length,
  and their plain versions for CPU tensors. ``use_custom_kernels=False`` is the plain chunked scan
  (``selective_scan_reference``) under autograd, anywhere: the JAX package's
  slow-path parity branch.

The scan's forward records the span ``scan.forward`` (a block's replay under
remat too); the kernels' backward, the D skip's terms included (in the
backward kernel's epilogue at d_state 16), records ``scan.backward``
(``selective_scan_fused``), ``tracing.py``.

The JAX dispatcher sends only TPU runs with L > ``chunk_size`` to its Pallas
kernels and everything else to its XLA chunked scan (``:68``). The port has
no XLA path to fall back to on the card: a plain PyTorch scan there
materialises the discretized [B, L, I, N] tensors chunk by chunk and keeps
them all for its backward, which is what the kernels exist to avoid. So on
CUDA the kernels take every length, and a short sequence is simply one
partial chunk.
"""

import torch
import torch.nn.functional as F

from ..tracing import span
from .selective_scan_fused import chunked_scan, selective_scan_fused, skip


def causal_conv1d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal 1D conv. x: [B, L, C]; weight: [K, C] (the JAX
    layout); bias: [C]. Returns [B, L, C]."""
    k, c = weight.shape
    x_pad = F.pad(x.transpose(1, 2), (k - 1, 0))
    return F.conv1d(x_pad, weight.t().unsqueeze(1), bias, groups=c).transpose(1, 2)


def selective_scan_reference(u, delta, A, B, C, D, *, chunk_size: int = 256) -> torch.Tensor:
    """The plain chunked scan, counterpart of ``selective_scan_xla``:
    discretize in f32, run the recurrence chunk by chunk (a doubling scan
    inside each chunk), add D * u, cast to u's dtype."""
    y, _ = chunked_scan(u, delta, A, B, C, chunk_size)
    return skip(y, D, u)


def selective_scan(
    u: torch.Tensor,  # [B, L, I] input (after the conv and its SiLU)
    delta: torch.Tensor,  # [B, L, I] positive step sizes
    A: torch.Tensor,  # [I, N] (negative real)
    B: torch.Tensor,  # [B, L, N]
    C: torch.Tensor,  # [B, L, N]
    D: torch.Tensor,  # [I] skip
    *,
    chunk_size: int = 256,
    use_custom_kernels: bool = True,
) -> torch.Tensor:
    """y[b,l,i] = sum_n C[b,l,n] * h[b,l,i,n] + D[i] * u[b,l,i], where
    h_t = exp(delta_t A) h_{t-1} + delta_t B_t u_t; in u's dtype.
    ``chunk_size`` is the plain scan's chunk; the kernels checkpoint every
    256 steps whatever it is."""
    with span("scan.forward"):
        if use_custom_kernels:
            return selective_scan_fused(u, delta, A, B, C, D)
        return selective_scan_reference(u, delta, A, B, C, D, chunk_size=chunk_size)
