"""Memory-efficient LM cross-entropy (counterpart of ``ops/xent.py:16-77``).

The vocab projection and softmax cross-entropy run in token chunks under
``torch.utils.checkpoint``: the forward keeps only each chunk's loss, the
backward recomputes the chunk's logits. At pythia's vocab 50304 the full
[B, S, V] f32 logits and their gradient never exist at once.

Logits are f32 from operands in the compute dtype, as the JAX package asks
with ``preferred_element_type=f32``. A bf16 ``torch.matmul`` returns bf16, so
``matmul_f32`` does the product itself: on CUDA ``torch.mm(..., out_dtype=
torch.float32)`` (bf16 operands, f32 accumulation and output); on the CPU,
where that overload does not exist, the operands are widened to f32 first,
which gives the same products exactly (a bf16 x bf16 product is exact in f32)
and differs only in summation order. Its backward rounds the incoming f32
gradient to the operands' dtype before the two products, as a
default-precision dot does on the TPU.
"""

import torch
from torch.utils.checkpoint import checkpoint


def _mm(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """a @ b with f32 accumulation, returned in ``out_dtype``."""
    if a.is_cuda:
        return torch.mm(a, b) if out_dtype == a.dtype else torch.mm(a, b, out_dtype=out_dtype)
    return torch.mm(a.float(), b.float()).to(out_dtype)


class _MatmulF32(torch.autograd.Function):
    """[N, H] @ [H, V] -> f32 [N, V] from operands of one (low) dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm(x, w, torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return _mm(g, w.t(), x.dtype), _mm(x.t(), g, w.dtype)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.dtype != w.dtype:
        raise ValueError(f"matmul_f32 takes operands of one dtype, got {x.dtype} and {w.dtype}")
    return _MatmulF32.apply(x, w)


def _chunk_nll_sum(kernel: torch.Tensor, h_c: torch.Tensor, l_c: torch.Tensor, ignore_index: int) -> torch.Tensor:
    logits = matmul_f32(h_c, kernel)
    valid = l_c != ignore_index
    safe = torch.where(valid, l_c, 0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, safe[:, None])[:, 0]
    return ((logz - gold) * valid).sum()


def chunked_lm_cross_entropy(
    hidden: torch.Tensor,  # [N, H]
    kernel: torch.Tensor,  # [H, V]
    labels: torch.Tensor,  # [N] int, ignore_index masked
    *,
    chunk_size: int = 1024,
    ignore_index: int = -100,
) -> torch.Tensor:
    """Mean cross entropy over valid tokens, computed chunk by chunk. The last
    chunk is simply shorter: the JAX version pads it with ignored labels,
    which adds nothing to the sum."""
    loss_sum = hidden.new_zeros((), dtype=torch.float32)
    for start in range(0, hidden.shape[0], chunk_size):
        h_c, l_c = hidden[start : start + chunk_size], labels[start : start + chunk_size]
        loss_sum = loss_sum + checkpoint(_chunk_nll_sum, kernel, h_c, l_c, ignore_index, use_reentrant=False)
    count = (labels != ignore_index).sum().clamp_min(1)
    return loss_sum / count


def lm_head_loss(
    hidden: torch.Tensor,  # [B, S, H]
    kernel: torch.Tensor,  # [H, V]
    labels: torch.Tensor,  # [B, S]
    *,
    shift: bool = True,
    chunk_size: int = 1024,
    ignore_index: int = -100,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Causal-LM loss: optionally shift (predict token t+1 from t), then
    chunked xent over all tokens. ``bias`` folds an output-head bias in by
    augmenting the hidden states with a ones column."""
    if shift:
        hidden = hidden[:, :-1]
        labels = labels[:, 1:]
    b, s, h = hidden.shape
    flat_h = hidden.reshape(b * s, h)
    flat_l = labels.reshape(b * s)
    if bias is not None:
        flat_h = torch.cat([flat_h, flat_h.new_ones(b * s, 1)], dim=-1)
        kernel = torch.cat([kernel, bias[None, :].to(kernel.dtype)], dim=0)
    return chunked_lm_cross_entropy(flat_h, kernel, flat_l, chunk_size=chunk_size, ignore_index=ignore_index)
