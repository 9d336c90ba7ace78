"""Memory-efficient LM cross-entropy (counterpart of ``ops/xent.py:16-77``).

The vocab projection and softmax cross-entropy run in token chunks inside one
``torch.autograd.Function``, ``_ChunkedXent``: the forward keeps each row's
logsumexp (f32, 4 bytes a token) and the backward recomputes each chunk's
logits. At pythia's vocab 50304 the full [B, S, V] f32 logits and their
gradient never exist at once.

Per chunk of ``chunk_size`` rows, the forward runs the head's product
(``torch.mm``, f32 logits from operands in the compute dtype) and then
``xent_fwd``: each row's lse and its ``(lse - gold) * valid``, the loss being
their sum over all rows, once, over the count of valid rows. The backward recomputes the product, runs
``xent_bwd``: ``dlogits = (exp(logits - lse) - onehot(label)) * (g / count) *
valid``, computed in f32 and rounded once to the compute dtype, and then the
two products: dx straight into its rows of one [N, H] gradient, dW summed
over the chunks in W's dtype, last chunk first (the order autograd sums
them in under ``xent_autograd_yardstick``, which the card tests hold this
loss to); a frozen head (llava's tied embedding) skips its [H, V] product.
Neither the loss nor its count leaves the device.

``xent_fwd`` and ``xent_bwd`` are hand-written CUDA kernels on CUDA tensors
(``csrc/xent.cu``, built on first use by ``ops/_build.py``) and their plain
PyTorch versions, ``xent_fwd_reference`` and ``xent_bwd_reference``, on CPU
tensors. Which runs is decided by where the tensors lie: a CUDA tensor
launches the kernel or raises, with no fallback. The kernels replace no TPU
kernel: the JAX package's loss has none, XLA fusing the logsumexp, the
gather and their gradient. Under eager autograd the same arithmetic made
some ten passes over each chunk's f32 logits. Their bound is bytes: at
pythia's chunk of 1024 rows of 50,304, the forward reads 206 MB (0.062 ms at
3.35 TB/s), the backward reads 206 MB and writes 103 MB of bf16 (0.092 ms);
``csrc/xent.cu`` says how its one pass a kernel meets that. Columns at or
past the logical vocab are never read and get a zero gradient; ignored rows
are not read at all. ``XENT_FWD_LAUNCHES`` and ``XENT_BWD_LAUNCHES`` count
the kernels' launches.

Logits are f32 from operands in the compute dtype, as the JAX package asks
with ``preferred_element_type=f32``. A bf16 ``torch.matmul`` returns bf16, so
``_mm`` does the product itself: on CUDA ``torch.mm(..., out_dtype=
torch.float32)`` (bf16 operands, f32 accumulation and output); on the CPU,
where that overload does not exist, the operands are widened to f32 first,
which gives the same products exactly (a bf16 x bf16 product is exact in f32)
and differs only in summation order. The gradient's products take dlogits in
the operands' dtype, as a default-precision dot does on the TPU.

The loss's forward records the span ``xent.forward`` and its backward, the
chunk recomputes included, ``xent.backward`` (``tracing.py``).
"""

import torch

from ..tracing import backward_span, span
from . import _build

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

# Kernel launches in this process, counted by the wrappers right where they
# launch; plain-version calls do not count.
XENT_FWD_LAUNCHES = 0
XENT_BWD_LAUNCHES = 0


def reset_launch_counts() -> None:
    global XENT_FWD_LAUNCHES, XENT_BWD_LAUNCHES
    XENT_FWD_LAUNCHES = XENT_BWD_LAUNCHES = 0


def _mm(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype, out: torch.Tensor | None = None) -> torch.Tensor:
    """a @ b with f32 accumulation, returned in ``out_dtype`` (written into
    ``out`` when given)."""
    if a.is_cuda:
        return torch.mm(a, b, out=out) if out_dtype == a.dtype else torch.mm(a, b, out_dtype=out_dtype)
    prod = torch.mm(a.float(), b.float()).to(out_dtype)
    return prod if out is None else out.copy_(prod)


class _MatmulF32(torch.autograd.Function):
    """[N, H] @ [H, V] -> f32 [N, V] from operands of one (low) dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm(x, w, torch.float32)

    @staticmethod
    def backward(ctx, g):
        # a frozen head (llava's tied embedding) skips its [H, V] product
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = _mm(g, w.t(), x.dtype) if ctx.needs_input_grad[0] else None
        dw = _mm(x.t(), g, w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.dtype != w.dtype:
        raise ValueError(f"matmul_f32 takes operands of one dtype, got {x.dtype} and {w.dtype}")
    return _MatmulF32.apply(x, w)


# ---------------------------------------------------------------- plain versions


def xent_fwd_reference(logits: torch.Tensor, labels: torch.Tensor, vocab: int,
                       ignore_index: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (lse, ``(lse - gold) * valid``),
    each [rows] f32 and 0 on ignored rows, over the f32 ``logits`` [rows,
    >= vocab], columns at or past ``vocab`` left out and nothing of an
    ignored row counted, as the kernel never reads it."""
    logits = logits[:, :vocab]
    valid = labels != ignore_index
    lse = torch.where(valid, torch.logsumexp(logits, dim=-1), 0.0)
    gold = logits.gather(-1, torch.where(valid, labels, 0)[:, None])[:, 0]
    return lse, torch.where(valid, lse - gold, 0.0)


def xent_bwd_reference(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor, scale: torch.Tensor,
                       vocab: int, ignore_index: int, dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the backward kernel: dlogits [rows, logits' width] in
    ``dtype``, ``(exp(logits - lse) - onehot(label)) * scale * valid`` in f32
    below ``vocab``, 0 at and past it and on ignored rows."""
    valid = labels != ignore_index
    d = torch.exp(logits[:, :vocab] - lse[:, None])
    d[torch.arange(d.shape[0]), torch.where(valid, labels, 0)] -= 1.0
    d = torch.where(valid[:, None], d * scale.reshape(()), 0.0)
    out = torch.zeros(logits.shape, dtype=dtype, device=logits.device)
    out[:, :vocab] = d.to(dtype)
    return out


# ---------------------------------------------------------------- kernels


def _kernel_inputs(logits: torch.Tensor, labels: torch.Tensor, vocab: int, *f32: torch.Tensor) -> None:
    """Raise on what the kernels do not take."""
    if logits.device.type != "cuda":
        raise ValueError(f"xent kernels take CUDA tensors, got {logits.device}")
    if logits.dtype != torch.float32 or logits.ndim != 2 or not logits.is_contiguous():
        raise ValueError(f"xent kernels take contiguous f32 logits [rows, width], got {logits.dtype} {tuple(logits.shape)}")
    rows, width = logits.shape
    if not 0 < vocab <= width or width % 4 or logits.data_ptr() % 16:
        raise ValueError(f"xent kernels take a vocab up to the logits' width, a width a multiple of 4 and 16-byte "
                         f"aligned logits, got vocab {vocab}, width {width}")
    if rows == 0:
        raise ValueError("xent kernels take at least one row")
    if labels.dtype != torch.int64 or labels.shape != (rows,) or not labels.is_contiguous():
        raise ValueError(f"xent kernels take contiguous int64 labels [{rows}], got {labels.dtype} {tuple(labels.shape)}")
    for t in (labels, *f32):
        if t.device != logits.device:
            raise ValueError("xent kernel inputs must lie on one device")
    for t in f32:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"xent kernels take contiguous f32 lse, nll and scale, got {t.dtype}")


def xent_fwd_cuda(logits: torch.Tensor, labels: torch.Tensor, vocab: int, ignore_index: int,
                  lse: torch.Tensor, nll: torch.Tensor) -> None:
    """Launch the forward kernel: writes each row's lse into ``lse`` [rows]
    and its ``(lse - gold) * valid`` into ``nll`` [rows], both 0 on ignored
    rows."""
    global XENT_FWD_LAUNCHES
    _kernel_inputs(logits, labels, vocab, lse, nll)
    rows, width = logits.shape
    if lse.shape != (rows,) or nll.shape != (rows,):
        raise ValueError("xent forward kernel takes lse [rows] and nll [rows]")
    lib = _build.load()
    with torch.cuda.device(logits.device):
        err = lib.mlpt_xent_fwd(logits.data_ptr(), labels.data_ptr(), lse.data_ptr(), nll.data_ptr(), rows, vocab,
                                width, ignore_index, torch.cuda.current_stream(logits.device).cuda_stream)
    _build.check(lib, err, "xent forward kernel")
    XENT_FWD_LAUNCHES += 1


def xent_bwd_cuda(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor, scale: torch.Tensor, vocab: int,
                  ignore_index: int, dtype: torch.dtype) -> torch.Tensor:
    """Launch the backward kernel: dlogits [rows, width] in ``dtype`` (bf16
    or f32); ``scale`` is an f32 scalar on the device."""
    global XENT_BWD_LAUNCHES
    _kernel_inputs(logits, labels, vocab, lse, scale)
    rows, width = logits.shape
    if lse.shape != (rows,) or scale.numel() != 1 or dtype not in _DTYPE_CODE:
        raise ValueError(f"xent backward kernel takes lse [rows], a scalar scale and bf16 or f32, got {dtype}")
    lib = _build.load()
    dlogits = torch.empty(rows, width, dtype=dtype, device=logits.device)
    with torch.cuda.device(logits.device):
        err = lib.mlpt_xent_bwd(logits.data_ptr(), labels.data_ptr(), lse.data_ptr(), scale.data_ptr(),
                                dlogits.data_ptr(), rows, vocab, width, ignore_index, _DTYPE_CODE[dtype],
                                torch.cuda.current_stream(logits.device).cuda_stream)
    _build.check(lib, err, "xent backward kernel")
    XENT_BWD_LAUNCHES += 1
    return dlogits


# ---------------------------------------------------------------- the loss


class _ChunkedXent(torch.autograd.Function):
    """Mean cross entropy of ``hidden @ kernel`` [N, V'] over its first
    ``vocab`` columns against ``labels``, chunk by chunk (see above)."""

    @staticmethod
    def forward(ctx, hidden, kernel, labels, vocab: int, chunk_size: int, ignore_index: int):
        n = hidden.shape[0]
        lse = torch.empty(n, dtype=torch.float32, device=hidden.device)
        nll = torch.empty(n, dtype=torch.float32, device=hidden.device)
        for start in range(0, n, chunk_size):
            rows = slice(start, start + chunk_size)
            logits = _mm(hidden[rows], kernel, torch.float32)
            if logits.is_cuda:
                xent_fwd_cuda(logits, labels[rows], vocab, ignore_index, lse[rows], nll[rows])
            else:
                lse[rows], nll[rows] = xent_fwd_reference(logits, labels[rows], vocab, ignore_index)
        count = (labels != ignore_index).sum().clamp_min(1)
        ctx.save_for_backward(hidden, kernel, labels, lse, count)
        ctx.vocab, ctx.chunk_size, ctx.ignore_index = vocab, chunk_size, ignore_index
        return nll.sum() / count

    @staticmethod
    def backward(ctx, g):
        hidden, kernel, labels, lse, count = ctx.saved_tensors
        vocab, ignore_index, dtype = ctx.vocab, ctx.ignore_index, hidden.dtype
        scale = g.float() / count  # the loss's gradient over each valid row's nll
        dhidden = torch.empty(hidden.shape, dtype=dtype, device=hidden.device) if ctx.needs_input_grad[0] else None
        dkernel = None
        for start in reversed(range(0, hidden.shape[0], ctx.chunk_size)):
            rows = slice(start, start + ctx.chunk_size)
            logits = _mm(hidden[rows], kernel, torch.float32)
            if logits.is_cuda:
                dlogits = xent_bwd_cuda(logits, labels[rows], lse[rows], scale, vocab, ignore_index, dtype)
            else:
                dlogits = xent_bwd_reference(logits, labels[rows], lse[rows], scale, vocab, ignore_index, dtype)
            del logits
            if dhidden is not None:
                _mm(dlogits, kernel.t(), dtype, out=dhidden[rows])
            if ctx.needs_input_grad[1]:
                part = _mm(hidden[rows].t(), dlogits, kernel.dtype)
                dkernel = part if dkernel is None else dkernel.add_(part)
        return dhidden, dkernel, None, None, None, None


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
    which adds nothing to the sum.

    A vocab that is not a multiple of 8 (llava's 128257) gets zero columns
    up to one, which the kernels never read: f32 logits rows of an odd
    length are not 16-byte aligned, and cuBLAS then falls back to a GEMM
    several times slower."""
    if hidden.dtype != kernel.dtype:
        raise ValueError(f"the LM head takes hidden and kernel of one dtype, got {hidden.dtype} and {kernel.dtype}")
    vocab = kernel.shape[1]
    if vocab % 8:
        kernel = torch.nn.functional.pad(kernel, (0, -vocab % 8))
    with span("xent.forward"):
        loss = _ChunkedXent.apply(hidden, kernel, labels.long().contiguous(), vocab, chunk_size, ignore_index)
    backward_span("xent.backward", loss, hidden)
    return loss


def xent_autograd_yardstick(hidden: torch.Tensor, kernel: torch.Tensor, labels: torch.Tensor, *,
                            chunk_size: int = 1024, ignore_index: int = -100) -> torch.Tensor:
    """The same loss from PyTorch's own ops under autograd, each chunk under
    ``torch.utils.checkpoint``: how the port computed it before the kernels.
    ``chip_smoke.py`` times it and the card tests hold the kernels' loss and
    gradients to it; the port never calls it."""
    from torch.utils.checkpoint import checkpoint

    vocab = kernel.shape[1]
    if vocab % 8:
        kernel = torch.nn.functional.pad(kernel, (0, -vocab % 8))

    def chunk_nll_sum(kernel, h_c, l_c):
        logits = matmul_f32(h_c, kernel)[:, :vocab]
        valid = l_c != ignore_index
        gold = logits.gather(-1, torch.where(valid, l_c, 0)[:, None])[:, 0]
        return ((torch.logsumexp(logits, dim=-1) - gold) * valid).sum()

    loss_sum = hidden.new_zeros((), dtype=torch.float32)
    for start in range(0, hidden.shape[0], chunk_size):
        h_c, l_c = hidden[start : start + chunk_size], labels[start : start + chunk_size]
        loss_sum = loss_sum + checkpoint(chunk_nll_sum, kernel, h_c, l_c, use_reentrant=False)
    return loss_sum / (labels != ignore_index).sum().clamp_min(1)


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
