"""ViLT single-tower multimodal pretraining, CLIP-g/14 trunk (counterpart of
``models/vilt.py:1-358``).

One fused text + image encoder with three pretraining heads, each on its
own pass through the trunk (three passes a step, as the JAX model runs
them):

- MLM over the text span: LayerNorm, Dense, tanh-GELU, LayerNorm, then the
  decoder ``mlm_decoder`` [H, V] with its bias through the chunked head;
- ITM: a binary match on the pooled first text token (``itm_head``);
- WPA: word-patch alignment by optimal transport, a 50-iteration IPOT in an
  f32 no-grad island (``ipot``); the gradient flows through the cosine cost
  matrix only (``wpa_loss``).

The trunk (``ViltEncoder``): Llama-3.2-1B-wide word embeddings (2048)
projected to the trunk width, token-type and learned text positions and a
LayerNorm; 224-px images as 256 patches of 14 (a Dense with a bias) after a
zero-initialised class token, learned positions and token type 1; the
sequence [text; image] through 40 CLIP blocks (hidden 1408, 16 heads of 88,
ffn 6144, tanh-GELU, LayerNorm eps 1e-12), the final LayerNorm, and the
pooler (tanh of a Dense) on position 0, the first text token. No mask goes
to the attention, so the flash kernels run in plain mode, the head dim 88
zero-padded to 128.

``vilt-finetune`` trains the MLM pass alone and has no ``itm_head``.
Recipe (the JAX package's, a CPU test pins it): batch 128, 10,000 steps
(5,197 finetune), f32, AdamW 1e-4 with weight decay 0.01, linear schedule
with 10% warmup, no clipping. Weights are random (``reset_parameters``, the
JAX initializers in distribution). The pretrained ViLT-B/32 encoder graft
(``MLPT_VILT_DIR``) needs ROADMAP Queue 1 item 8's weight loader.
"""

import os
from typing import Any, Literal

import torch
from torch import nn

from ..ops.attention import default_attn_impl
from ..ops.xent import lm_head_loss
from ..tracing import span
from . import ModelBundle, MultimodalModelClass, SchedulerType, ViltT
from .clip import CLIPBlock
from .layers import Dense, LayerNorm, checkpoint_block, cross_entropy_loss, gelu_tanh
from .pythia import _lecun_normal_

BIG = 1e4
LN_EPS = 1e-12  # ViLT/BERT layer_norm_eps: trunk blocks, text LN, final LN, both MLM-head LNs
TRUNK_KWARGS = dict(hidden=1408, num_layers=40, num_heads=16, intermediate=6144, patch=14, image_size=224,
                    vocab_size=128256, token_embed_dim=2048)
MAX_POSITION = 2048
IPOT_ITERATIONS = 50
IPOT_BETA = 0.5

# ------------------------------------------------------------------ IPOT


def cost_matrix_cosine(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Pairwise cosine distance [B, M, N] of x [B, M, D] and y [B, N, D]."""
    xn = x / x.norm(dim=-1, keepdim=True).clamp_min(eps)
    yn = y / y.norm(dim=-1, keepdim=True).clamp_min(eps)
    return 1.0 - torch.einsum("bmd,bnd->bmn", xn, yn)


@torch.no_grad()
def ipot(C, x_len, x_pad, y_len, y_pad, joint_pad, beta: float, iteration: int, k: int) -> torch.Tensor:
    """Inexact proximal-point optimal transport on the cost C [B, M, N]
    (JAX ``vilt.py:47-79``, step for step): ``iteration`` outer steps of
    ``k`` Sinkhorn-like inner steps, ``delta`` starting at zeros in each
    outer step and ``sigma`` carried through its column form, the padded
    rows and columns held out by the ``BIG`` terms. Returns the plan T [B,
    N, M], zero on the joint pad. Runs under no_grad: the plan is a
    constant of the loss."""
    b, m, n = C.shape
    sigma = torch.where(x_pad, 0.0, 1.0 / x_len[:, None])  # [B, M]
    jp_t = joint_pad.transpose(1, 2)  # [B, N, M]
    T = (~jp_t).to(C.dtype)
    A = torch.where(jp_t, 0.0, torch.exp(-C.transpose(1, 2) / beta))
    x_lenb = x_len[:, None, None]
    y_lenb = y_len[:, None, None]
    x_mask = x_pad.to(C.dtype)[:, None, :] * BIG  # [B, 1, M]
    y_mask = y_pad.to(C.dtype)[:, None, :] * BIG  # [B, 1, N]
    for _ in range(iteration):
        Q = A * T  # [B, N, M]
        sigma_col = sigma.reshape(b, m, 1)
        delta = C.new_zeros(b, 1, n)
        for _ in range(k):
            delta = 1.0 / (y_lenb * torch.einsum("bnm,bmi->bni", Q, sigma_col).reshape(b, 1, n) + y_mask)
            sigma_row = 1.0 / (x_lenb * torch.einsum("bin,bnm->bim", delta, Q) + x_mask)  # [B, 1, M]
            sigma_col = sigma_row.reshape(b, m, 1)
        T = delta.reshape(b, n, 1) * Q * sigma_col.reshape(b, 1, m)
        sigma = sigma_col.reshape(b, m)
    return torch.where(jp_t, 0.0, T)


def wpa_loss(txt_emb, img_emb, txt_mask_keep, img_mask_keep, itm_labels) -> torch.Tensor:
    """0.1 x (the summed OT distance of the matched pairs less that of the
    mismatched ones) / B, in f32 (JAX ``vilt.py:82-105``). IPOT runs on the
    detached cost; the gradient flows through the cosine cost only."""
    txt_emb, img_emb = txt_emb.float(), img_emb.float()
    txt_pad, img_pad = ~txt_mask_keep, ~img_mask_keep
    cost = cost_matrix_cosine(txt_emb, img_emb)
    joint_pad = txt_pad[:, :, None] | img_pad[:, None, :]
    cost = torch.where(joint_pad, 0.0, cost)
    txt_len = txt_mask_keep.sum(dim=1).to(cost.dtype)
    img_len = img_mask_keep.sum(dim=1).to(cost.dtype)
    with span("ipot"):  # a span of its own in profile_step's breakdown
        T = ipot(cost.detach(), txt_len, txt_pad, img_len, img_pad, joint_pad, IPOT_BETA, IPOT_ITERATIONS, 1)
    distance = torch.einsum("bmn,bnm->b", cost, T)
    pos = itm_labels == 1
    dist_pos = torch.where(pos, distance, 0.0).sum()
    dist_neg = torch.where(~pos, distance, 0.0).sum()
    return 0.1 * (dist_pos - dist_neg) / distance.shape[0]


# ------------------------------------------------------------------ modules


class ViltEncoder(nn.Module):
    """The fused trunk under the JAX module's parameter names
    (``word_embeddings``, ``text_projection``, ``token_type_embeddings``,
    ``text_position_embeddings``, ``text_ln``, ``patch_embed``,
    ``cls_token``, ``image_position_embeddings``, ``layers.i``,
    ``final_ln``, ``pooler``). ``remat_policy`` ("flash") runs every block
    under ``checkpoint_block``."""

    def __init__(self, hidden: int, num_layers: int, num_heads: int, intermediate: int, patch: int, image_size: int,
                 vocab_size: int, token_embed_dim: int, attn_impl: str = "flash", dtype: torch.dtype = torch.float32,
                 remat_policy: str | None = None):
        super().__init__()
        self.patch, self.compute_dtype, self.remat_policy = patch, dtype, remat_policy
        grid = image_size // patch
        self.word_embeddings = nn.Parameter(torch.empty(vocab_size, token_embed_dim))
        self.text_projection = Dense(token_embed_dim, hidden, dtype=dtype)
        self.token_type_embeddings = nn.Parameter(torch.empty(2, hidden))
        self.text_position_embeddings = nn.Parameter(torch.empty(MAX_POSITION, hidden))
        self.text_ln = LayerNorm(hidden, eps=LN_EPS, dtype=dtype)
        self.patch_embed = Dense(patch * patch * 3, hidden, dtype=dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, hidden))
        self.image_position_embeddings = nn.Parameter(torch.empty(1, grid * grid + 1, hidden))
        self.layers = nn.ModuleList(
            CLIPBlock(hidden, num_heads, intermediate, attn_impl=attn_impl, dtype=dtype, activation=gelu_tanh,
                      ln_eps=LN_EPS)
            for _ in range(num_layers)
        )
        self.final_ln = LayerNorm(hidden, eps=LN_EPS, dtype=dtype)
        self.pooler = Dense(hidden, hidden, dtype=dtype)

    def forward(self, input_ids, token_type_ids, pixel_values, pool: bool = False):
        """(sequence [B, S_text + 1 + patches, H], pooled [B, H] or None
        without ``pool``). Word ids out of range are clamped (``mode="clip"``)."""
        dt = self.compute_dtype
        s_t = input_ids.shape[1]
        ids = input_ids.clamp(0, self.word_embeddings.shape[0] - 1)
        t = self.text_projection(self.word_embeddings[ids].to(dt))
        t = t + self.token_type_embeddings[token_type_ids].to(dt) + self.text_position_embeddings[:s_t].to(dt)
        t = self.text_ln(t)

        b, h, w, c = pixel_values.shape
        p = self.patch
        gh, gw = h // p, w // p
        # NHWC patches in the JAX order: (row, col) over the grid, then (y, x, channel) inside a patch
        patches = pixel_values.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * c)
        v = self.patch_embed(patches.to(dt))
        v = torch.cat([self.cls_token.to(dt).expand(b, 1, -1), v], dim=1)
        v = v + self.image_position_embeddings.to(dt) + self.token_type_embeddings[1].to(dt)

        x = torch.cat([t, v], dim=1)
        for block in self.layers:
            x = checkpoint_block(block, x, policy=self.remat_policy)
        x = self.final_ln(x)
        return x, (torch.tanh(self.pooler(x[:, 0])) if pool else None)


class ViltForPretrain(nn.Module):
    """The trunk ``vilt`` and the heads of ``target_tasks``: the MLM head
    (``mlm_ln0``, ``mlm_dense``, ``mlm_ln1``, ``mlm_decoder`` [H, V] in the
    JAX layout, ``mlm_decoder_bias``) with "mlm", ``itm_head`` with "itm";
    WPA has no parameters of its own. The JAX module builds exactly these."""

    def __init__(self, target_tasks: tuple = ("mlm", "itm", "wpa"), attn_impl: str = "flash",
                 dtype: torch.dtype = torch.float32, remat_policy: str | None = None, **trunk_kwargs):
        super().__init__()
        kw = {**TRUNK_KWARGS, **trunk_kwargs}
        hidden, vocab = kw["hidden"], kw["vocab_size"]
        self.target_tasks, self.compute_dtype = tuple(target_tasks), dtype
        self.vilt = ViltEncoder(**kw, attn_impl=attn_impl, dtype=dtype, remat_policy=remat_policy)
        if "mlm" in self.target_tasks:
            self.mlm_ln0 = LayerNorm(hidden, eps=LN_EPS, dtype=dtype)
            self.mlm_dense = Dense(hidden, hidden, dtype=dtype)
            self.mlm_ln1 = LayerNorm(hidden, eps=LN_EPS, dtype=dtype)
            self.mlm_decoder = nn.Parameter(torch.empty(hidden, vocab))
            self.mlm_decoder_bias = nn.Parameter(torch.empty(vocab))
        if "itm" in self.target_tasks:
            self.itm_head = Dense(hidden, 2, dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX initializers in distribution (not in bits): lecun-normal
        Dense kernels and decoder (fan-in H), zero biases and class token,
        LayerNorm scale 1, normal(0, 0.02) word, token-type and position
        embeddings. Each tensor is drawn in f32 on the parameters' device
        from ``generator`` (which must live there), then cast to the
        parameter's dtype."""
        norms = {f"{n}.weight" for n, m in self.named_modules() if isinstance(m, LayerNorm)}
        for name, p in self.named_parameters():
            w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            if name in norms:
                w.fill_(1.0)
            elif name.endswith(("bias", "cls_token")):
                w.zero_()
            elif name.endswith(".weight"):  # Dense, [out, in]
                _lecun_normal_(w, p.shape[1], generator)
            elif name == "mlm_decoder":  # [H, V]
                _lecun_normal_(w, p.shape[0], generator)
            else:  # the word, token-type and position embeddings
                w.normal_(0.0, 0.02, generator=generator)
            p.copy_(w)

    def forward(self, batch: dict[str, torch.Tensor]):
        """(total loss, {"mlm_loss", "itm_loss", "wpa_loss", "loss"}) over
        the tasks, each on its own trunk pass (JAX ``vilt.py:187-244``)."""
        dt = self.compute_dtype
        s_t = batch["input_ids"].shape[1]
        metrics: dict[str, torch.Tensor] = {}
        total = 0.0
        if "mlm" in self.target_tasks:
            seq, _ = self.vilt(batch["mlm_input_ids"], batch["mlm_token_type_ids"], batch["mlm_pixel_values"])
            h = self.mlm_ln1(gelu_tanh(self.mlm_dense(self.mlm_ln0(seq[:, :s_t]))))
            mlm = lm_head_loss(h, self.mlm_decoder.to(dt), batch["mlm_labels"], shift=False, bias=self.mlm_decoder_bias)
            metrics["mlm_loss"] = mlm
            total = total + mlm
        if "itm" in self.target_tasks:
            _, pooled = self.vilt(batch["itm_input_ids"], batch["itm_token_type_ids"], batch["itm_pixel_values"],
                                  pool=True)
            itm = cross_entropy_loss(self.itm_head(pooled), batch["itm_labels"])
            metrics["itm_loss"] = itm
            total = total + itm
        if "wpa" in self.target_tasks:
            # a third full pass on the ITM inputs, as the JAX model runs it
            seq, _ = self.vilt(batch["itm_input_ids"], batch["itm_token_type_ids"], batch["itm_pixel_values"])
            txt_emb, img_emb = seq[:, :s_t], seq[:, s_t:]
            txt_keep = batch["itm_attention_mask"].bool()
            # drop position 0 and the last valid token
            lengths = txt_keep.sum(dim=1)
            idx = torch.arange(s_t, device=txt_keep.device)[None, :]
            txt_keep = txt_keep & (idx != (lengths[:, None] - 1)) & (idx != 0)
            img_keep = torch.ones(img_emb.shape[:2], dtype=torch.bool, device=img_emb.device)
            img_keep[:, 0] = False  # the class token
            wpa = wpa_loss(txt_emb, img_emb, txt_keep, img_keep, batch["itm_labels"])
            metrics["wpa_loss"] = wpa
            total = total + wpa
        metrics["loss"] = total
        return total, metrics


# ------------------------------------------------------------------ classes


class _ViltBase(MultimodalModelClass[ViltT]):
    target_tasks: tuple = ("mlm", "itm", "wpa")
    module_kwargs: dict = {}

    def build_model(
        self,
        use_custom_kernels: bool = True,
        activation_checkpointing: bool = False,
        compute_dtype: torch.dtype | None = None,
        device: torch.device | str = "cuda",
    ) -> ModelBundle:
        """``activation_checkpointing`` runs every trunk block under the
        "flash" policy, as the JAX ``make_stack`` would, though the method
        grid never asks for it (``supports_activation_checkpointing``)."""
        if compute_dtype is None:
            compute_dtype = torch.bfloat16 if self.mixed_precision else torch.float32
        with torch.device("meta"):
            module = ViltForPretrain(
                self.target_tasks, attn_impl=default_attn_impl(use_custom_kernels), dtype=compute_dtype,
                remat_policy="flash" if activation_checkpointing else None, **self.module_kwargs,
            )
        module = module.to_empty(device=device)
        hidden = self.module_kwargs.get("hidden", TRUNK_KWARGS["hidden"])

        def init_fn(mod: ViltForPretrain, generator: torch.Generator) -> None:
            # the JAX init grafts dandelin/vilt-b32-mlm's encoder here
            if os.environ.get("MLPT_VILT_DIR") and hidden == 768:
                raise NotImplementedError("MLPT_VILT_DIR: loading the pretrained ViLT-B/32 encoder needs the weight "
                                          "loader of ROADMAP Queue 1 item 8")
            mod.reset_parameters(generator)

        def loss_fn(mod: ViltForPretrain, batch: dict[str, torch.Tensor], generator=None):
            return mod(batch)

        return ModelBundle(module=module, loss_fn=loss_fn, init_fn=init_fn)

    @property
    def supports_activation_checkpointing(self) -> bool:
        # the JAX flag (vilt.py:300-303)
        return False

    @property
    def mixed_precision(self) -> Literal[None, "bf16", "fp16"]:
        return None

    @property
    def optimizer(self) -> Literal["adam", "adamw"]:
        return "adamw"

    @property
    def optimizer_kwargs(self) -> dict[str, Any]:
        return {"lr": 1e-4, "weight_decay": 0.01}

    @property
    def scheduler_type(self) -> SchedulerType:
        return SchedulerType.LINEAR

    @property
    def scheduler_kwargs(self) -> dict[str, Any]:
        return {"num_warmup_steps": int(self.training_steps * 0.10)}

    @property
    def max_grad_norm(self) -> float:
        return 0.0

    @property
    def batch_size(self) -> int:
        return 128

    @property
    def fsdp_layers_to_wrap(self) -> list[str]:
        return ["CLIPBlock"]

    @property
    def image_size(self) -> int:
        return 224

    @property
    def vocab_size(self) -> int:
        return 128256

    @property
    def sequence_length(self) -> int:
        return 2048


class ViltPretrainModelClass(_ViltBase):
    @property
    def training_steps(self) -> int:
        return 10000


class ViltFinetuneModelClass(_ViltBase):
    target_tasks = ("mlm",)  # finetuning trains MLM only

    @property
    def training_steps(self) -> int:
        return 5197
