"""LLaVA pretraining and finetuning (counterpart of ``models/llava.py:31-300``).

CLIP-ViT-L/14-336 vision tower -> 2-layer GELU MLP projector ->
Llama-3.2-1B, with an added ``<image>`` token (index 128256, embedding table
128257 rows, tied to the LM head). The ``<image>`` token of each row expands
into the tower's 576 patch features (vision feature layer -2, CLS dropped),
so text of 512 tokens becomes 1087 decoder positions. The merged keep-mask
goes to every decoder layer, so the decoder's attention takes the flash
kernels' varlen mode whenever the batch carries an ``attention_mask``.

- llava-pretrain: tower and LM (with its embedding) frozen, the projector
  trains; batch 256, 2180 steps, bf16, adamw 1e-3, cosine with 3% warmup,
  no clipping.
- llava-finetune: tower frozen; batch 128, 5197 steps, f32, adamw 2e-5.

Weights are random (``reset_parameters``, the JAX initializers in
distribution); loading pretrained checkpoints is not ported. Size overrides
are module arguments (``tower_kwargs``, ``lm_kwargs``, ``vocab_with_image``,
``image_token``), as in JAX, and the model classes hand theirs over.
"""

from typing import Any, Literal

import torch
from torch import nn

from ..ops.attention import default_attn_impl
from ..ops.xent import lm_head_loss, matmul_f32
from . import LlavaT, ModelBundle, MultimodalModelClass, SchedulerType
from .clip import CLIPVisionEncoder
from .layers import Dense, LayerNorm, RMSNorm, gelu_tanh
from .llama import HIDDEN as LM_HIDDEN
from .llama import LlamaDecoder
from .pythia import _lecun_normal_

IMAGE_TOKEN = 128256
VOCAB_WITH_IMAGE = 128257
NUM_PATCHES = (336 // 14) ** 2  # 576
TOWER_HIDDEN = 1024
TOWER_KWARGS = dict(hidden=TOWER_HIDDEN, num_layers=24, num_heads=16, intermediate=4096, patch=14, image_size=336)


def merge_image_features(embeds, image_feats, input_ids, labels, image_token: int, attention_mask=None):
    """Expand each row's single ``<image>`` token into its patch features, as
    a static-shape gather: with the image token at position p, output
    position j reads text token j (j < p), patch j - p (p <= j < p + P), or
    text token j - (P - 1) after.

    embeds [B, S, H], image_feats [B, P, H] -> merged [B, S - 1 + P, H],
    labels with -100 at the patch positions, and the keep-mask with 1 there
    (None for labels or mask that were None)."""
    b, s, h = embeds.shape
    p_count = image_feats.shape[1]
    out_len = s - 1 + p_count
    pos = (input_ids == image_token).long().argmax(dim=1)[:, None]  # first <image> of each row, [B, 1]
    j = torch.arange(out_len, device=embeds.device)[None, :]
    is_img = (j >= pos) & (j < pos + p_count)
    text_idx = torch.where(j < pos, j, j - (p_count - 1)).clamp(0, s - 1)
    img_idx = (j - pos).clamp(0, p_count - 1)
    text_part = torch.gather(embeds, 1, text_idx[..., None].expand(b, out_len, h))
    img_part = torch.gather(image_feats, 1, img_idx[..., None].expand(b, out_len, h))
    merged = torch.where(is_img[..., None], img_part, text_part)
    merged_labels = None if labels is None else torch.where(is_img, -100, torch.gather(labels, 1, text_idx))
    merged_mask = None if attention_mask is None else torch.where(is_img, 1, torch.gather(attention_mask, 1, text_idx))
    return merged, merged_labels, merged_mask


class LlavaModule(nn.Module):
    """Tower, projector (``projector_in`` -> tanh GELU -> ``projector_out``),
    the embedding ``language_model_embed_tokens`` [vocab_with_image, H] and
    the decoder, under the JAX module's parameter names."""

    def __init__(
        self,
        attn_impl: str = "flash",
        dtype: torch.dtype = torch.float32,
        tower_kwargs: dict | None = None,
        lm_kwargs: dict | None = None,
        vocab_with_image: int = VOCAB_WITH_IMAGE,
        image_token: int = IMAGE_TOKEN,
        remat_policy: str | None = None,
    ):
        super().__init__()
        self.compute_dtype, self.image_token = dtype, image_token
        tower = {**TOWER_KWARGS, **(tower_kwargs or {})}
        lm_kwargs = dict(lm_kwargs or {})
        lm_hidden = lm_kwargs.get("hidden", LM_HIDDEN)
        self.vision_tower = CLIPVisionEncoder(**tower, attn_impl=attn_impl, dtype=dtype, remat_policy=remat_policy)
        self.projector_in = Dense(tower["hidden"], lm_hidden, dtype=dtype)
        self.projector_out = Dense(lm_hidden, lm_hidden, dtype=dtype)
        self.language_model_embed_tokens = nn.Parameter(torch.empty(vocab_with_image, lm_hidden))
        self.language_model = LlamaDecoder(**lm_kwargs, attn_impl=attn_impl, dtype=dtype, remat_policy=remat_policy)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX initializers in distribution (not in bits): lecun-normal
        Dense kernels, zero biases, norm scales 1, and normal(0, 0.02) for
        the embedding, the class token and the positions. Each tensor is
        drawn in f32 on the parameters' device from ``generator`` (which must
        live there), then cast to the parameter's dtype."""
        norms = {f"{n}.weight" for n, m in self.named_modules() if isinstance(m, (LayerNorm, RMSNorm))}
        for name, p in self.named_parameters():
            w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            if name in norms:
                w.fill_(1.0)
            elif name.endswith(".bias"):
                w.zero_()
            elif name.endswith(".weight"):  # Dense, [out, in]
                _lecun_normal_(w, p.shape[1], generator)
            else:  # language_model_embed_tokens, class_embedding, position_embeddings
                w.normal_(0.0, 0.02, generator=generator)
            p.copy_(w)

    def forward(self, input_ids, pixel_values, labels=None, attention_mask=None) -> torch.Tensor:
        """Logits when ``labels`` is None, else the shifted LM loss (chunked,
        with -100 at the image positions)."""
        dt = self.compute_dtype
        feats = self.vision_tower(pixel_values)[:, 1:]  # drop CLS
        feats = self.projector_out(gelu_tanh(self.projector_in(feats)))
        text_embeds = self.language_model_embed_tokens[input_ids].to(dt)
        merged, merged_labels, merged_mask = merge_image_features(
            text_embeds, feats, input_ids, labels, self.image_token, attention_mask
        )
        hidden = self.language_model(merged, mask=merged_mask)
        kernel = self.language_model_embed_tokens.to(dt).t()  # tied head [H, vocab_with_image]
        if labels is None:
            return matmul_f32(hidden.reshape(-1, hidden.shape[-1]), kernel).reshape(*hidden.shape[:-1], -1)
        return lm_head_loss(hidden, kernel, merged_labels, shift=True)


class _LlavaBase(MultimodalModelClass[LlavaT]):
    image_token_index = IMAGE_TOKEN
    freeze_prefixes: tuple[str, ...] = ()
    # size overrides handed to LlavaModule (None = the published dims)
    tower_kwargs: dict | None = None
    lm_kwargs: dict | None = None

    def build_model(
        self,
        use_custom_kernels: bool = True,
        activation_checkpointing: bool = False,
        compute_dtype: torch.dtype | None = None,
        device: torch.device | str = "cuda",
    ) -> ModelBundle:
        """``activation_checkpointing`` remats every tower and decoder block
        under the "flash" policy, the JAX default for both stacks; the frozen
        tower, whose blocks need no gradient, runs no backward either way."""
        if compute_dtype is None:
            compute_dtype = torch.bfloat16 if self.mixed_precision else torch.float32
        with torch.device("meta"):
            module = LlavaModule(
                attn_impl=default_attn_impl(use_custom_kernels), dtype=compute_dtype,
                tower_kwargs=self.tower_kwargs, lm_kwargs=self.lm_kwargs,
                remat_policy="flash" if activation_checkpointing else None,
            )
        module = module.to_empty(device=device)

        def init_fn(mod: LlavaModule, generator: torch.Generator) -> None:
            mod.reset_parameters(generator)

        def loss_fn(mod: LlavaModule, batch: dict[str, torch.Tensor], generator=None):
            loss = mod(batch["input_ids"], batch["pixel_values"], labels=batch["labels"],
                       attention_mask=batch.get("attention_mask"))
            return loss, {"loss": loss}

        # the requires_grad=False analog: a parameter trains unless its name
        # starts with a frozen prefix (the JAX mask tests the same prefixes
        # on its param paths)
        mask = {n: not n.startswith(self.freeze_prefixes) for n, _ in module.named_parameters()}
        return ModelBundle(module=module, loss_fn=loss_fn, init_fn=init_fn, trainable_mask=mask)

    @property
    def scheduler_type(self) -> SchedulerType:
        return SchedulerType.COSINE

    @property
    def scheduler_kwargs(self) -> dict[str, Any]:
        return {"num_warmup_steps": int(self.training_steps * 0.03)}

    @property
    def max_grad_norm(self) -> float:
        return 0.0

    @property
    def optimizer(self) -> Literal["adam", "adamw"]:
        return "adamw"

    @property
    def fsdp_layers_to_wrap(self) -> list[str]:
        return ["LlamaBlock"]

    @property
    def image_size(self) -> int:
        return int((self.tower_kwargs or {}).get("image_size", TOWER_KWARGS["image_size"]))

    @property
    def vocab_size(self) -> int:
        return 128256

    @property
    def sequence_length(self) -> int:
        # the declared max context; the dummy data uses 512
        return 131072


class LlavaPretrainModelClass(_LlavaBase):
    # projector-only training: tower, LM and its embedding frozen
    freeze_prefixes = ("vision_tower", "language_model")

    @property
    def batch_size(self) -> int:
        return 256

    @property
    def training_steps(self) -> int:
        return 2180

    @property
    def mixed_precision(self) -> Literal[None, "bf16", "fp16"]:
        return "bf16"

    @property
    def optimizer_kwargs(self) -> dict[str, Any]:
        return {"lr": 1e-3, "weight_decay": 0.0}


class LlavaFinetuneModelClass(_LlavaBase):
    # tower frozen; LM, its embedding and the projector train
    freeze_prefixes = ("vision_tower",)

    @property
    def batch_size(self) -> int:
        return 128

    @property
    def training_steps(self) -> int:
        return 5197

    @property
    def mixed_precision(self) -> Literal[None, "bf16", "fp16"]:
        return None

    @property
    def optimizer_kwargs(self) -> dict[str, Any]:
        return {"lr": 2e-5, "weight_decay": 0.0}
