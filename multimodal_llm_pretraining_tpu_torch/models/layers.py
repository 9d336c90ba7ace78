"""Shared building blocks (counterpart of ``models/layers.py:30-190``, and
of flax's ``nn.RMSNorm``).

Parameters keep their own dtype (f32, or bf16 under the ``bf16_sr`` layout)
and are cast to the compute dtype where they are used, the way flax's
``dtype=`` works: a Dense with f32 params and bf16 compute multiplies bf16
operands, and its gradient flows back to the f32 params through the cast.

``checkpoint_block`` is the remat of the JAX ``make_stack``
(``:151-190``), with its two policies over the ops the dispatcher sees;
``remat`` runs every remat site's ``checkpoint`` and marks its recompute.
"""

import functools
import math
import threading
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts, noop_context_fn

from ..ops import rmsnorm
from ..ops.attention import AttnImpl, dot_product_attention
from ..ops.flash_attention import flash_fwd
from ..tracing import backward_span, profiling, replay_span, span

# ------------------------------------------------------------------ rotary


def rotary_angles(positions: torch.Tensor, rotary_dim: int, base: float = 10000.0, scaling: Callable | None = None):
    """(cos, sin), each f32 [S, rotary_dim // 2]. ``scaling`` maps the f32
    inverse frequencies (``llama3_rope_scaling``)."""
    inv_freq = 1.0 / (base ** (torch.arange(0, rotary_dim, 2, dtype=torch.float32, device=positions.device) / rotary_dim))
    if scaling is not None:
        inv_freq = scaling(inv_freq)
    freqs = positions.float()[:, None] * inv_freq[None, :]
    return torch.cos(freqs), torch.sin(freqs)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the first ``2 * cos.shape[-1]`` head dims of x [B, H, S, D]
    (GPTNeoX rotate-half). The arithmetic runs in x's dtype: the f32 angle
    tables are cast to it first, as the JAX version does."""
    rot = cos.shape[-1] * 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., : rot // 2], x_rot[..., rot // 2 :]
    cos = cos[None, None].to(x.dtype)
    sin = sin[None, None].to(x.dtype)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out, x_pass], dim=-1) if x_pass.shape[-1] else out


def llama3_rope_scaling(inv_freq: torch.Tensor) -> torch.Tensor:
    """Llama-3.x rope frequency scaling at Llama-3.2's constants (factor 32,
    low and high frequency factors 1 and 4, original context 8192), in f32
    as the JAX version computes it."""
    factor, low_freq_factor, high_freq_factor, original_max_position = 32.0, 1.0, 4.0, 8192
    wavelen = 2 * math.pi / inv_freq
    low_wl = original_max_position / low_freq_factor
    high_wl = original_max_position / high_freq_factor
    smooth = ((original_max_position / wavelen - low_freq_factor) / (high_freq_factor - low_freq_factor)).clamp(0.0, 1.0)
    scaled = inv_freq / factor
    mid = (1 - smooth) * scaled + smooth * inv_freq
    return torch.where(wavelen > low_wl, scaled, torch.where(wavelen < high_wl, inv_freq, mid))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``, whose default is the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: each element kept with probability ``1 - rate``
    and scaled by ``1 / (1 - rate)``, else 0. The keep-mask comes from
    ``generator`` (``F.dropout`` takes none), which must live on x's device;
    with no generator, or rate 0, x passes through (``deterministic``)."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -100) -> torch.Tensor:
    """Mean cross entropy in f32 over the labels that are not
    ``ignore_index`` (the JAX ``layers.cross_entropy_loss``)."""
    logits = logits.float().reshape(-1, logits.shape[-1])
    labels = labels.reshape(-1).long()
    valid = labels != ignore_index
    nll = torch.logsumexp(logits, -1) - logits.gather(-1, torch.where(valid, labels, 0)[:, None])[:, 0]
    return (nll * valid).sum() / valid.sum().clamp_min(1)


# ------------------------------------------------------------------ modules


class Dense(nn.Linear):
    """``nn.Linear`` whose weight and bias are cast to ``dtype`` at use
    (flax ``nn.Dense(dtype=...)``). The weight is [out, in]; JAX kernels are
    [in, out] (``models/from_jax.py`` transposes).

    ``feeds_residual`` marks a projection whose output only enters a
    residual sum (attention's output projection, the MLP's down
    projection): no backward reads it, so JAX's remat drops it from the
    residuals, and the "dots" policy of ``checkpoint_block`` does not keep
    it either."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, dtype: torch.dtype = torch.float32,
                 feeds_residual: bool = False):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        self.feeds_residual = feeds_residual

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        if not self.feeds_residual:
            return F.linear(x.to(dt), self.weight.to(dt), bias)
        _RESIDUAL_DOT.active = True
        try:
            return F.linear(x.to(dt), self.weight.to(dt), bias)
        finally:
            _RESIDUAL_DOT.active = False


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(epsilon=1e-5, dtype=...)``: statistics and the
    normalisation in f32 whatever the input dtype, result in ``dtype``."""

    def __init__(self, features: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(), self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm(epsilon=1e-5, dtype=...)``: the mean square in f32
    whatever the input dtype (``force_float32_reductions``), then
    ``x * (rsqrt(ms + eps) * scale)`` in f32, result in ``dtype``.

    On the card it runs on ``ops/rmsnorm.py``'s two hand-written kernels,
    which raise for rows they do not take; on the CPU, on the plain math
    below. With ``residual`` the call
    returns (y, x): the caller adds its block's output to that x, and on the
    card the add's gradient then reaches the norm's backward kernel, which
    sums it with the norm's own in its one pass over the stream."""

    def __init__(self, features: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.eps = eps
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, residual: bool = False):
        if x.is_cuda:
            return rmsnorm.rmsnorm(x, self.weight, self.eps, self.compute_dtype, residual)
        xf = x.float()
        mul = torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps) * self.weight.float()
        y = (xf * mul).to(self.compute_dtype)
        return (y, x) if residual else y


class SelfAttention(nn.Module):
    """Fused-QKV multi-head (optionally grouped-query) self-attention,
    optionally causal and rotary. The qkv output is laid out [q (h*d) | k
    (kvh*d) | v], head-major, like the JAX module's. GQA repeats each kv head
    ``h // kvh`` times in place (``repeat_interleave``, as ``jnp.repeat``
    does), so q head i reads kv head ``i // (h // kvh)``. The forward runs in
    the span ``attn.forward`` and its backward in ``attn.backward``
    (``tracing.py``)."""

    def __init__(
        self,
        hidden: int,
        num_heads: int,
        head_dim: int,
        *,
        num_kv_heads: int | None = None,
        causal: bool = False,
        rotary_dim: int = 0,
        rotary_base: float = 10000.0,
        rope_scaling: Callable | None = None,
        attn_impl: AttnImpl = "flash",
        use_bias: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        self.num_kv_heads = num_kv_heads or num_heads
        self.causal, self.rotary_dim, self.rotary_base = causal, rotary_dim, rotary_base
        self.rope_scaling = rope_scaling
        self.attn_impl = attn_impl
        self.qkv = Dense(hidden, (num_heads + 2 * self.num_kv_heads) * head_dim, bias=use_bias, dtype=dtype)
        self.out = Dense(num_heads * head_dim, hidden, bias=use_bias, dtype=dtype, feeds_residual=True)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """``mask``: [B, S] keep-mask over the keys (1 = attend)."""
        b, s, _ = x.shape
        h, kvh, d = self.num_heads, self.num_kv_heads, self.head_dim
        with span("attn.forward"):
            q, k, v = self.qkv(x).split([h * d, kvh * d, kvh * d], dim=-1)
            q = q.reshape(b, s, h, d).transpose(1, 2)
            k, v = (t.reshape(b, s, kvh, d).transpose(1, 2) for t in (k, v))
            if self.rotary_dim:
                cos, sin = rotary_angles(torch.arange(s, device=x.device), self.rotary_dim, self.rotary_base,
                                         self.rope_scaling)
                q = apply_rotary(q, cos, sin)
                k = apply_rotary(k, cos, sin)
            if kvh != h:
                k = k.repeat_interleave(h // kvh, dim=1)
                v = v.repeat_interleave(h // kvh, dim=1)
            out = dot_product_attention(q, k, v, causal=self.causal, mask=mask, impl=self.attn_impl)
            out = self.out(out.transpose(1, 2).reshape(b, s, h * d))
        backward_span("attn.backward", out, x)
        return out


class Mlp(nn.Module):
    """up -> activation -> down, then ``dropout`` (drawn from the generator
    handed to ``forward``). The default is flax's ``nn.gelu``, the tanh
    approximation, not the exact GELU. The forward runs in the span
    ``mlp.forward`` and its backward in ``mlp.backward``."""

    def __init__(
        self,
        hidden: int,
        intermediate: int,
        activation: Callable = gelu_tanh,
        use_bias: bool = True,
        dropout: float = 0.0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.activation = activation
        self.dropout = dropout
        self.up = Dense(hidden, intermediate, bias=use_bias, dtype=dtype)
        self.down = Dense(intermediate, hidden, bias=use_bias, dtype=dtype, feeds_residual=True)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        with span("mlp.forward"):
            out = dropout(self.down(self.activation(self.up(x))), self.dropout, generator)
        backward_span("mlp.backward", out, x)
        return out


class GatedMlp(nn.Module):
    """SwiGLU (Llama-style): a fused bias-free gate+up projection laid out
    [gate | up], then silu(gate) * up and the bias-free down projection, in
    the spans ``mlp.forward`` and ``mlp.backward``."""

    def __init__(self, hidden: int, intermediate: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gate_up = Dense(hidden, 2 * intermediate, bias=False, dtype=dtype)
        self.down = Dense(intermediate, hidden, bias=False, dtype=dtype, feeds_residual=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("mlp.forward"):
            gate, up = self.gate_up(x).chunk(2, dim=-1)
            out = self.down(F.silu(gate) * up)
        backward_span("mlp.backward", out, x)
        return out


# ------------------------------------------------------------------ remat

REMAT_POLICIES = ("flash", "dots")
# the matrix products without batch dims: what ``F.linear`` reaches (addmm
# with a bias, mm without), never the batched bmm/baddbmm
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


class _ResidualDot(threading.local):
    """Set while a ``Dense(feeds_residual=True)`` computes its product."""

    active = False


_RESIDUAL_DOT = _ResidualDot()


def check_remat_policy(policy: str) -> str:
    if policy not in REMAT_POLICIES:
        raise ValueError(f"checkpoint_policy must be one of {REMAT_POLICIES}, got {policy!r}")
    return policy


def remat_policy_fn(save_dots: bool, ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The op-level policy: keep ``mlpt::flash_fwd``'s outputs (out and
    lse: JAX's ``save_only_these_names("flash_out", "flash_lse")``), and
    with ``save_dots`` every product without batch dims that a backward
    reads (``dots_with_no_batch_dims_saveable`` after JAX's dead-code
    elimination); recompute the rest."""
    if op is torch.ops.mlpt.flash_fwd.default:
        return CheckpointPolicy.MUST_SAVE
    if save_dots and op in _DOTS and not _RESIDUAL_DOT.active:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _needs_grad(block: nn.Module, args) -> bool:
    return torch.is_grad_enabled() and (
        any(isinstance(a, torch.Tensor) and a.requires_grad for a in args)
        or any(p.requires_grad for p in block.parameters())
    )


def _replaying(block: nn.Module, generator: torch.Generator) -> Callable:
    """``block`` for ``checkpoint``: the first call runs it as it is; the
    recompute runs it from the generator state it had before the first
    call, so that it draws the same dropout masks, and then puts back the
    state the generator had when the recompute began, so that the next
    micro-batch draws on as it would without remat. ``checkpoint`` restores
    only the default generators."""
    state = generator.get_state()
    calls = 0

    def run(*args, **kwargs):
        nonlocal calls
        calls += 1
        if calls == 1:
            return block(*args, **kwargs)
        resumed = generator.get_state()
        generator.set_state(state)
        try:
            return block(*args, **kwargs)
        finally:
            generator.set_state(resumed)

    return run


class _Replay:
    """The recompute context ``checkpoint`` enters around each recompute of
    its callable, inside the span ``remat.replay``. The span opens before
    ``inner`` (a selective policy's dispatch mode), which would otherwise
    see the span's own op in the recompute and not in the forward, and
    refuse it."""

    def __init__(self, inner):
        self.inner = inner
        self.span = None

    def __enter__(self):
        self.span = replay_span()
        self.span.__enter__()
        return self.inner.__enter__()

    def __exit__(self, *exc):
        try:
            return self.inner.__exit__(*exc)
        finally:
            self.span.__exit__(None, None, None)


def remat(block: Callable, *args, generator: torch.Generator | None = None, context_fn: Callable = noop_context_fn):
    """``block(*args)`` under non-reentrant ``checkpoint`` with ``context_fn``
    (default: keep nothing, whole-block remat); ``generator`` is handed to
    the block as its ``generator`` keyword, and the recompute replays its
    draws (``_replaying``). While a profiler records, each recompute of the
    block runs in the span ``remat.replay`` (``tracing.py``); otherwise
    ``checkpoint`` gets ``block`` and ``context_fn`` as they are. Every
    remat site of the port goes through here."""
    kwargs = {} if generator is None else {"generator": generator}
    fn = block if generator is None else _replaying(block, generator)
    if profiling():
        inner_fn = context_fn

        def context_fn():
            forward, recompute = inner_fn()
            return forward, _Replay(recompute)

    return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn, **kwargs)


def checkpoint_block(block: nn.Module, *args, policy: str | None, generator: torch.Generator | None = None):
    """``block(*args)`` under the remat ``policy`` of the JAX ``make_stack``
    (``models/layers.py:151-190``); ``None`` runs the block as it is.

    - "flash" keeps only ``mlpt::flash_fwd``'s outputs and recomputes
      everything else in the backward; a block without flash attention
      keeps nothing (whole-block remat), as in JAX.
    - "dots" also keeps the outputs of the products without batch dims
      (``Dense``) that a backward reads, so the backward recomputes only
      elementwise work and the products whose outputs it does not keep.

    The forward kernel runs once per block and micro-batch either way: the
    recompute takes its saved outputs. ``generator`` (dropout) is handed to
    the block as its ``generator`` keyword, and the recompute replays its
    draws (``_replaying``). A block whose inputs and parameters need no
    gradient runs as it is: nothing to save, no backward to start."""
    kwargs = {} if generator is None else {"generator": generator}
    if policy is not None:
        check_remat_policy(policy)
    if policy is None or not _needs_grad(block, args):
        return block(*args, **kwargs)
    context_fn = functools.partial(create_selective_checkpoint_contexts,
                                   functools.partial(remat_policy_fn, policy == "dots"))
    return remat(block, *args, generator=generator, context_fn=context_fn)
