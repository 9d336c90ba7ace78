"""CLIP vision encoder: the LLaVA tower (counterpart of ``models/clip.py:17-96``).

Conv patch embedding as a bias-free Dense over NHWC patches, class token and
learned positions, pre-LN, then pre-LN transformer blocks with a quick-GELU
MLP (openai/clip-vit-large-patch14-336 at the defaults: hidden 1024, 24
layers, 16 heads, intermediate 4096, patch 14, image 336).
"""

import torch
from torch import nn

from .layers import Dense, LayerNorm, Mlp, SelfAttention, checkpoint_block


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPBlock(nn.Module):
    def __init__(self, hidden: int, num_heads: int, intermediate: int, attn_impl: str = "flash",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln_attn = LayerNorm(hidden, dtype=dtype)
        self.attn = SelfAttention(hidden, num_heads, hidden // num_heads, causal=False, attn_impl=attn_impl, dtype=dtype)  # type: ignore[arg-type]
        self.ln_mlp = LayerNorm(hidden, dtype=dtype)
        self.mlp = Mlp(hidden, intermediate, activation=quick_gelu, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_attn(x))
        return x + self.mlp(self.ln_mlp(x))


class CLIPVisionEncoder(nn.Module):
    """Patch embed + cls + pos, pre-LN, then the blocks; returns [B, 1 +
    patches, hidden].

    It holds the blocks of LLaVA's vision feature layer -2: the JAX module
    with ``feature_layer=-2`` builds ``num_layers - 1`` blocks (the last
    one's output is unused), and so does this one, so the two hold the same
    parameters. ``remat_policy`` ("flash", the JAX stack's default) runs
    every block under ``checkpoint_block``."""

    def __init__(
        self,
        hidden: int = 1024,
        num_layers: int = 24,
        num_heads: int = 16,
        intermediate: int = 4096,
        patch: int = 14,
        image_size: int = 336,
        attn_impl: str = "flash",
        dtype: torch.dtype = torch.float32,
        remat_policy: str | None = None,
    ):
        super().__init__()
        self.patch, self.compute_dtype, self.remat_policy = patch, dtype, remat_policy
        grid = image_size // patch
        self.patch_embed = Dense(patch * patch * 3, hidden, bias=False, dtype=dtype)
        self.class_embedding = nn.Parameter(torch.empty(1, 1, hidden))
        self.position_embeddings = nn.Parameter(torch.empty(1, grid * grid + 1, hidden))
        self.pre_ln = LayerNorm(hidden, dtype=dtype)
        self.layers = nn.ModuleList(
            CLIPBlock(hidden, num_heads, intermediate, attn_impl=attn_impl, dtype=dtype) for _ in range(num_layers - 1)
        )

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """``pixel_values``: NHWC [B, H, W, 3]."""
        b, h, w, c = pixel_values.shape
        p, dt = self.patch, self.compute_dtype
        gh, gw = h // p, w // p
        # NHWC patches in the JAX order: (row, col) over the grid, then (y, x, channel) inside a patch
        patches = pixel_values.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * c)
        x = self.patch_embed(patches.to(dt))
        cls = self.class_embedding.to(dt).expand(b, 1, -1)
        x = self.pre_ln(torch.cat([cls, x], dim=1) + self.position_embeddings.to(dt))
        for block in self.layers:
            x = checkpoint_block(block, x, policy=self.remat_policy)
        return x
