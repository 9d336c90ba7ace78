"""Llama-3-family decoder: the LLaVA language model (counterpart of
``models/llama.py:18-95``).

Defaults are Llama-3.2-1B's, as in the JAX module: 16 layers, hidden 2048,
32 q / 8 kv heads (GQA), SwiGLU ffn 8192, RMSNorm eps 1e-5, rope theta
500000 with llama-3 frequency scaling (factor 32), no biases. The decoder
takes input embeddings (LLaVA merges text and image embeddings outside) and
an optional [B, S] key keep-mask, shared by every layer.
"""

import torch
from torch import nn

from .layers import GatedMlp, RMSNorm, SelfAttention, llama3_rope_scaling

HIDDEN = 2048
LAYERS = 16
HEADS = 32
KV_HEADS = 8
FFN = 8192
VOCAB = 128256
ROPE_THETA = 500000.0
RMS_EPS = 1e-5


class LlamaBlock(nn.Module):
    def __init__(
        self,
        hidden: int = HIDDEN,
        num_heads: int = HEADS,
        num_kv_heads: int = KV_HEADS,
        ffn: int = FFN,
        attn_impl: str = "flash",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        head_dim = hidden // num_heads
        self.ln_attn = RMSNorm(hidden, eps=RMS_EPS, dtype=dtype)
        self.attn = SelfAttention(
            hidden, num_heads, head_dim, num_kv_heads=num_kv_heads, causal=True, rotary_dim=head_dim,
            rotary_base=ROPE_THETA, rope_scaling=llama3_rope_scaling, attn_impl=attn_impl, use_bias=False, dtype=dtype,  # type: ignore[arg-type]
        )
        self.ln_mlp = RMSNorm(hidden, eps=RMS_EPS, dtype=dtype)
        self.mlp = GatedMlp(hidden, ffn, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        x = x + self.attn(self.ln_attn(x), mask=mask)
        return x + self.mlp(self.ln_mlp(x))


class LlamaDecoder(nn.Module):
    """``num_layers`` blocks and the final RMSNorm over input embeddings."""

    def __init__(
        self,
        hidden: int = HIDDEN,
        num_layers: int = LAYERS,
        num_heads: int = HEADS,
        num_kv_heads: int = KV_HEADS,
        ffn: int = FFN,
        attn_impl: str = "flash",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.layers = nn.ModuleList(
            LlamaBlock(hidden, num_heads, num_kv_heads, ffn, attn_impl, dtype) for _ in range(num_layers)
        )
        self.final_norm = RMSNorm(hidden, eps=RMS_EPS, dtype=dtype)

    def forward(self, inputs_embeds: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        x = inputs_embeds
        for block in self.layers:
            x = block(x, mask)
        return self.final_norm(x)
