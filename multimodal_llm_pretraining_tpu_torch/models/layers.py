"""Shared building blocks (counterpart of ``models/layers.py:30-54, 76-134``).

Parameters keep their own dtype (f32, or bf16 under the ``bf16_sr`` layout)
and are cast to the compute dtype where they are used, the way flax's
``dtype=`` works: a Dense with f32 params and bf16 compute multiplies bf16
operands, and its gradient flows back to the f32 params through the cast.

Not ported yet (ROADMAP Queue 1 item 2): grouped-query attention,
``llama3_rope_scaling``, ``GatedMlp`` and the ``make_stack`` remat policies.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import AttnImpl, dot_product_attention

# ------------------------------------------------------------------ rotary


def rotary_angles(positions: torch.Tensor, rotary_dim: int, base: float = 10000.0):
    """(cos, sin), each f32 [S, rotary_dim // 2]."""
    inv_freq = 1.0 / (base ** (torch.arange(0, rotary_dim, 2, dtype=torch.float32, device=positions.device) / rotary_dim))
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


# ------------------------------------------------------------------ modules


class Dense(nn.Linear):
    """``nn.Linear`` whose weight and bias are cast to ``dtype`` at use
    (flax ``nn.Dense(dtype=...)``). The weight is [out, in]; JAX kernels are
    [in, out] (``models/from_jax.py`` transposes)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(epsilon=1e-5, dtype=...)``: statistics and the
    normalisation in f32 whatever the input dtype, result in ``dtype``."""

    def __init__(self, features: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(), self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


class SelfAttention(nn.Module):
    """Fused-QKV multi-head self-attention, optionally causal and rotary. The
    qkv output is laid out [q (h*d) | k | v], head-major, like the JAX
    module's."""

    def __init__(
        self,
        hidden: int,
        num_heads: int,
        head_dim: int,
        *,
        causal: bool = False,
        rotary_dim: int = 0,
        rotary_base: float = 10000.0,
        attn_impl: AttnImpl = "flash",
        use_bias: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        self.causal, self.rotary_dim, self.rotary_base = causal, rotary_dim, rotary_base
        self.attn_impl = attn_impl
        self.qkv = Dense(hidden, 3 * num_heads * head_dim, bias=use_bias, dtype=dtype)
        self.out = Dense(num_heads * head_dim, hidden, bias=use_bias, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        h, d = self.num_heads, self.head_dim
        q, k, v = (t.reshape(b, s, h, d).transpose(1, 2) for t in self.qkv(x).split(h * d, dim=-1))
        if self.rotary_dim:
            cos, sin = rotary_angles(torch.arange(s, device=x.device), self.rotary_dim, self.rotary_base)
            q = apply_rotary(q, cos, sin)
            k = apply_rotary(k, cos, sin)
        out = dot_product_attention(q, k, v, causal=self.causal, impl=self.attn_impl)
        return self.out(out.transpose(1, 2).reshape(b, s, h * d))


class Mlp(nn.Module):
    """up -> GELU -> down. flax's ``nn.gelu`` defaults to the tanh
    approximation, so this uses ``approximate="tanh"``, not the exact GELU."""

    def __init__(self, hidden: int, intermediate: int, use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.up = Dense(hidden, intermediate, bias=use_bias, dtype=dtype)
        self.down = Dense(intermediate, hidden, bias=use_bias, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.gelu(self.up(x), approximate="tanh"))
