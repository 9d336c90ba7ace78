"""ViT-L/16 image-classification pretraining (counterpart of ``models/vit.py:1-167``).

ViT-large at 224 px with patch 16: 196 patches and a class token, 24 pre-LN
blocks (hidden 1024, 16 heads of 64, ffn 4096, LayerNorm eps 1e-12), the
final LayerNorm and a classifier over 21,841 ImageNet-21k classes on the
class token; hidden dropout 0.1 on the embeddings, after attention and after
the MLP. NHWC pixels are patchified by reshape and transpose and embedded by
one Dense, as in the JAX package. The widths are constructor arguments (the
JAX model reads them as module constants); the recipe is the JAX package's
(a CPU test pins it equal): batch 4096, 311,948 steps, f32 compute, Adam (L2
weight decay) lr 1e-3, linear schedule with 10k warmup, clipping at 1.0.

Dropout draws from the generator handed to ``forward``; without one the
model is deterministic (the JAX ``deterministic=True``).
"""

from typing import Any, Literal

import torch
from torch import nn

from ..ops.attention import default_attn_impl
from . import ModelBundle, SchedulerType, ViTT, VisionModelClass
from .layers import Dense, LayerNorm, Mlp, SelfAttention, checkpoint_block, cross_entropy_loss, dropout
from .pythia import _lecun_normal_

HIDDEN = 1024
LAYERS = 24
HEADS = 16
FFN = 4096
PATCH = 16
LN_EPS = 1e-12
DROPOUT = 0.1


class ViTBlock(nn.Module):
    """Pre-LN encoder block: x + dropout(attn(ln(x))), then x + mlp(ln(x))
    with the MLP's own dropout."""

    def __init__(self, hidden: int, num_heads: int, ffn: int, attn_impl: str = "flash", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln_attn = LayerNorm(hidden, eps=LN_EPS, dtype=dtype)
        self.attn = SelfAttention(hidden, num_heads, hidden // num_heads, causal=False, attn_impl=attn_impl, dtype=dtype)  # type: ignore[arg-type]
        self.ln_mlp = LayerNorm(hidden, eps=LN_EPS, dtype=dtype)
        self.mlp = Mlp(hidden, ffn, dropout=DROPOUT, dtype=dtype)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        x = x + dropout(self.attn(self.ln_attn(x)), DROPOUT, generator)
        return x + self.mlp(self.ln_mlp(x), generator)


class ViTClassifier(nn.Module):
    """Patch embedding, class token and positions, ``num_layers`` blocks, the
    final LayerNorm and the classifier, under the JAX module's parameter
    names (``patch_embed``, ``cls_token``, ``position_embeddings``,
    ``layers.i``, ``final_ln``, ``classifier``). ``remat_policy`` ("flash",
    the JAX stack's default) runs every block under ``checkpoint_block``,
    whose recompute replays the block's dropout draws."""

    def __init__(
        self,
        num_classes: int = 21841,
        image_size: int = 224,
        hidden: int = HIDDEN,
        num_layers: int = LAYERS,
        num_heads: int = HEADS,
        ffn: int = FFN,
        attn_impl: str = "flash",
        dtype: torch.dtype = torch.float32,
        remat_policy: str | None = None,
    ):
        super().__init__()
        self.compute_dtype, self.remat_policy = dtype, remat_policy
        grid = image_size // PATCH
        self.patch_embed = Dense(PATCH * PATCH * 3, hidden, dtype=dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, hidden))
        self.position_embeddings = nn.Parameter(torch.empty(1, grid * grid + 1, hidden))
        self.layers = nn.ModuleList(ViTBlock(hidden, num_heads, ffn, attn_impl, dtype) for _ in range(num_layers))
        self.final_ln = LayerNorm(hidden, eps=LN_EPS, dtype=dtype)
        self.classifier = Dense(hidden, num_classes, dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX initializers in distribution (not in bits): lecun-normal
        Dense kernels, zero biases and class token, LayerNorm scale 1, and
        normal(0, 0.02) positions. Each tensor is drawn in f32 on the
        parameters' device from ``generator`` (which must live there), then
        cast to the parameter's dtype."""
        norms = {f"{n}.weight" for n, m in self.named_modules() if isinstance(m, LayerNorm)}
        for name, p in self.named_parameters():
            w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            if name in norms:
                w.fill_(1.0)
            elif name == "position_embeddings":
                w.normal_(0.0, 0.02, generator=generator)
            elif name.endswith(".weight"):  # Dense, [out, in]
                _lecun_normal_(w, p.shape[1], generator)
            else:  # biases and the class token
                w.zero_()
            p.copy_(w)

    def forward(self, pixel_values: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits [B, num_classes] from NHWC ``pixel_values`` [B, H, W, 3];
        dropout draws from ``generator`` when one is given."""
        b, h, w, c = pixel_values.shape
        p, dt = PATCH, self.compute_dtype
        gh, gw = h // p, w // p
        # NHWC patches in the JAX order: (row, col) over the grid, then (y, x, channel) inside a patch
        patches = pixel_values.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * c)
        x = self.patch_embed(patches.to(dt))
        x = torch.cat([self.cls_token.to(dt).expand(b, 1, -1), x], dim=1) + self.position_embeddings.to(dt)
        x = dropout(x, DROPOUT, generator)
        for block in self.layers:
            x = checkpoint_block(block, x, policy=self.remat_policy, generator=generator)
        return self.classifier(self.final_ln(x)[:, 0])


class ViTModelClass(VisionModelClass[ViTT]):
    def build_model(
        self,
        use_custom_kernels: bool = True,
        activation_checkpointing: bool = False,
        compute_dtype: torch.dtype | None = None,
        device: torch.device | str = "cuda",
    ) -> ModelBundle:
        """``activation_checkpointing`` remats every block under the "flash"
        policy (JAX ``vit.py:74-77``)."""
        if compute_dtype is None:
            compute_dtype = torch.bfloat16 if self.mixed_precision else torch.float32
        with torch.device("meta"):
            module = ViTClassifier(
                self.num_classes, self.image_size, HIDDEN, LAYERS, HEADS, FFN,
                attn_impl=default_attn_impl(use_custom_kernels), dtype=compute_dtype,
                remat_policy="flash" if activation_checkpointing else None,
            )
        module = module.to_empty(device=device)

        def init_fn(mod: ViTClassifier, generator: torch.Generator) -> None:
            mod.reset_parameters(generator)

        def loss_fn(mod: ViTClassifier, batch: dict[str, torch.Tensor], generator=None):
            logits = mod(batch["pixel_values"], generator)
            loss = cross_entropy_loss(logits, batch["labels"])
            return loss, {"loss": loss}

        return ModelBundle(module=module, loss_fn=loss_fn, init_fn=init_fn)

    @property
    def batch_size(self) -> int:
        return 4096

    @property
    def training_steps(self) -> int:
        return 311948

    @property
    def mixed_precision(self) -> Literal[None, "bf16", "fp16"]:
        return None

    @property
    def optimizer(self) -> Literal["adam", "adamw"]:
        return "adam"

    @property
    def optimizer_kwargs(self) -> dict[str, Any]:
        return {"lr": 1e-3, "betas": (0.9, 0.999), "weight_decay": 0.03}

    @property
    def scheduler_type(self) -> SchedulerType:
        return SchedulerType.LINEAR

    @property
    def scheduler_kwargs(self) -> dict[str, Any]:
        return {"num_warmup_steps": 10000}

    @property
    def max_grad_norm(self) -> float:
        return 1.0

    @property
    def fsdp_layers_to_wrap(self) -> list[str]:
        return ["ViTBlock"]

    @property
    def image_size(self) -> int:
        return 224

    @property
    def num_classes(self) -> int:
        return 21841
