"""ConvNeXt image-classification pretraining (counterpart of ``models/convnext.py:1-142``).

Large (depths 3/3/27/3, dims 192/384/768/1536) and xlarge (256/512/1024/2048)
at 224 px, over 1k or 21,841 classes. NHWC activations, as in the JAX
package: a 4x4 stride-4 stem convolution and LayerNorm; four stages of
blocks (depthwise 7x7, LayerNorm, pointwise 4x expansion, tanh-GELU,
pointwise back, layer scale initialised to 1e-6, residual) with a
LayerNorm and a 2x2 stride-2 convolution before each stage after the
first; a global mean pool, the head LayerNorm and the classifier. LayerNorm
eps 1e-6 everywhere.

The convolutions are ``F.conv2d`` on the NCHW view of the NHWC tensor (a
``channels_last`` layout): the JAX package computes them with ``nn.Conv``,
outside any Pallas kernel, so there is no TPU kernel to port. flax's SAME
padding is kept: zero at 224 px for the stem and the downsamplers, 3 for
the depthwise 7x7. Remat recomputes each whole block (there is no flash
output to keep). Recipe (the JAX package's, a CPU test pins it): batch
4096, 93,600 (1k) / 311,940 (22k) steps, f32, AdamW lr 4e-3 with weight
decay 0.05, cosine schedule, no clipping.
"""

import math
from typing import Any, Literal

import torch
import torch.nn.functional as F
from torch import nn

from . import ConvNextT, ModelBundle, SchedulerType, VisionModelClass
from .layers import Dense, LayerNorm, checkpoint_block, cross_entropy_loss, gelu_tanh
from .pythia import _lecun_normal_

CONFIGS = {
    "convnext-large-1k": dict(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536), num_classes=1000),
    "convnext-large-22k": dict(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536), num_classes=21841),
    "convnext-xlarge-22k": dict(depths=(3, 3, 27, 3), dims=(256, 512, 1024, 2048), num_classes=21841),
}

LN_EPS = 1e-6
LAYER_SCALE_INIT = 1e-6


class ConvNHWC(nn.Module):
    """flax ``nn.Conv`` on NHWC input with a bias: the weight in PyTorch's
    [out, in / groups, kh, kw] (the JAX kernel [kh, kw, in / groups, out]
    permuted by ``models/from_jax.py``), cast to ``dtype`` at use; SAME
    padding unless ``padding`` is given."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1, padding: int | None = None,
                 groups: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_ch))
        self.kernel, self.stride, self.padding, self.groups, self.compute_dtype = kernel, stride, padding, groups, dtype

    def _same(self, size: int) -> tuple[int, int]:
        total = max((math.ceil(size / self.stride) - 1) * self.stride + self.kernel - size, 0)
        return total // 2, total - total // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt).permute(0, 3, 1, 2)  # NCHW view, channels_last in memory
        pad = self.padding
        if pad is None:
            (top, bottom), (left, right) = self._same(x.shape[2]), self._same(x.shape[3])
            if top or bottom or left or right:
                x = F.pad(x, (left, right, top, bottom))
            pad = 0
        y = F.conv2d(x, self.weight.to(dt), self.bias.to(dt), self.stride, pad, 1, self.groups)
        return y.permute(0, 2, 3, 1)


class ConvNextBlock(nn.Module):
    """depthwise 7x7 -> LayerNorm -> pointwise 4x -> tanh-GELU -> pointwise
    back -> layer scale, added to the input."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dwconv = ConvNHWC(dim, dim, 7, padding=3, groups=dim, dtype=dtype)
        self.ln = LayerNorm(dim, eps=LN_EPS, dtype=dtype)
        self.pw_up = Dense(dim, 4 * dim, dtype=dtype)
        self.pw_down = Dense(4 * dim, dim, dtype=dtype)
        self.layer_scale = nn.Parameter(torch.empty(dim))
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.pw_down(gelu_tanh(self.pw_up(self.ln(self.dwconv(x)))))
        return x + self.layer_scale.to(self.compute_dtype) * h


class ConvNextClassifier(nn.Module):
    """Under the JAX module's parameter names: ``stem_conv``, ``stem_ln``,
    ``down_ln_i`` and ``down_conv_i`` (i > 0), ``stage_i.j`` (block j of
    stage i), ``head_ln``, ``classifier``. ``remat_policy`` ("flash") runs
    every block under ``checkpoint_block``: with no flash attention in a
    block it keeps nothing, a whole-block recompute as in JAX."""

    def __init__(self, depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536), num_classes: int = 21841,
                 dtype: torch.dtype = torch.float32, remat_policy: str | None = None):
        super().__init__()
        self.compute_dtype, self.remat_policy, self.depths = dtype, remat_policy, tuple(depths)
        self.stem_conv = ConvNHWC(3, dims[0], 4, stride=4, dtype=dtype)
        self.stem_ln = LayerNorm(dims[0], eps=LN_EPS, dtype=dtype)
        for i, (depth, dim) in enumerate(zip(depths, dims)):
            if i > 0:
                setattr(self, f"down_ln_{i}", LayerNorm(dims[i - 1], eps=LN_EPS, dtype=dtype))
                setattr(self, f"down_conv_{i}", ConvNHWC(dims[i - 1], dim, 2, stride=2, dtype=dtype))
            setattr(self, f"stage_{i}", nn.ModuleList(ConvNextBlock(dim, dtype) for _ in range(depth)))
        self.head_ln = LayerNorm(dims[-1], eps=LN_EPS, dtype=dtype)
        self.classifier = Dense(dims[-1], num_classes, dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX initializers in distribution (not in bits): lecun-normal
        convolution and Dense kernels (fan-in: the kernel's input elements a
        channel, in / groups x kh x kw), zero biases, LayerNorm scale 1,
        layer scale 1e-6. Each tensor is drawn in f32 on the parameters'
        device from ``generator`` (which must live there), then cast to the
        parameter's dtype."""
        norms = {f"{n}.weight" for n, m in self.named_modules() if isinstance(m, LayerNorm)}
        for name, p in self.named_parameters():
            w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            if name in norms:
                w.fill_(1.0)
            elif name.endswith("layer_scale"):
                w.fill_(LAYER_SCALE_INIT)
            elif name.endswith("bias"):
                w.zero_()
            else:  # Dense [out, in] or conv [out, in / groups, kh, kw]
                _lecun_normal_(w, math.prod(p.shape[1:]), generator)
            p.copy_(w)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """Logits [B, num_classes] from NHWC ``pixel_values`` [B, H, W, 3]."""
        x = self.stem_ln(self.stem_conv(pixel_values.to(self.compute_dtype)))
        for i in range(len(self.depths)):
            if i > 0:
                x = getattr(self, f"down_conv_{i}")(getattr(self, f"down_ln_{i}")(x))
            for block in getattr(self, f"stage_{i}"):
                x = checkpoint_block(block, x, policy=self.remat_policy)
        return self.classifier(self.head_ln(x.mean(dim=(1, 2))))


class ConvNextModelClass(VisionModelClass[ConvNextT]):
    def build_model(
        self,
        use_custom_kernels: bool = True,
        activation_checkpointing: bool = False,
        compute_dtype: torch.dtype | None = None,
        device: torch.device | str = "cuda",
    ) -> ModelBundle:
        """``use_custom_kernels`` changes nothing: no kernel of the port is
        on this path. ``activation_checkpointing`` recomputes each block."""
        cfg = CONFIGS[self.model_type]
        if compute_dtype is None:
            compute_dtype = torch.bfloat16 if self.mixed_precision else torch.float32
        with torch.device("meta"):
            module = ConvNextClassifier(cfg["depths"], cfg["dims"], cfg["num_classes"], dtype=compute_dtype,
                                        remat_policy="flash" if activation_checkpointing else None)
        module = module.to_empty(device=device)

        def init_fn(mod: ConvNextClassifier, generator: torch.Generator) -> None:
            mod.reset_parameters(generator)

        def loss_fn(mod: ConvNextClassifier, batch: dict[str, torch.Tensor], generator=None):
            loss = cross_entropy_loss(mod(batch["pixel_values"]), batch["labels"])
            return loss, {"loss": loss}

        return ModelBundle(module=module, loss_fn=loss_fn, init_fn=init_fn)

    @property
    def supports_activation_checkpointing(self) -> bool:
        return True

    @property
    def batch_size(self) -> int:
        return 4096

    @property
    def training_steps(self) -> int:
        return 93600 if self.model_type == "convnext-large-1k" else 311940

    @property
    def mixed_precision(self) -> Literal[None, "bf16", "fp16"]:
        return None

    @property
    def optimizer(self) -> Literal["adam", "adamw"]:
        return "adamw"

    @property
    def optimizer_kwargs(self) -> dict[str, Any]:
        return {"lr": 4e-3, "betas": (0.9, 0.999), "weight_decay": 0.05}

    @property
    def scheduler_type(self) -> SchedulerType:
        return SchedulerType.COSINE

    @property
    def scheduler_kwargs(self) -> dict[str, Any]:
        if self.model_type == "convnext-large-1k":
            return {"num_warmup_steps": 312 * 20}
        return {"num_warmup_steps": 3466 * 5}

    @property
    def max_grad_norm(self) -> float:
        return 0.0

    @property
    def fsdp_layers_to_wrap(self) -> list[str]:
        return ["ConvNextBlock"]

    @property
    def image_size(self) -> int:
        return 224

    @property
    def num_classes(self) -> int:
        return CONFIGS[self.model_type]["num_classes"]
