"""IBM granite-4.0-h-micro causal LM, a model of the port alone: the JAX
package has no hybrid of state-space and attention layers.

ibm-granite/granite-4.0-h-micro's ``config.json`` (``model_type``
"granitemoehybrid", dense: ``num_local_experts`` 0): 40 layers of hidden
2048, vocab 100,352, the LM head tied to the embedding, ``rms_norm_eps``
1e-5. ``layer_types`` puts attention at layers 5, 15, 25 and 35 and a
Mamba-2 mixer everywhere else. As HF ``modeling_granitemoehybrid.py``
computes it, with the stream in the compute dtype:

    x0 = 12 Embed(ids)                                        (embedding_multiplier)
    x = x + 0.22 Mixer(RMSNorm_in(x))                         (residual_multiplier)
    x = x + 0.22 MLP(RMSNorm_post(x)),   MLP(g) = W_down(SiLU(W_gate g) * W_up g)
    logits = RMSNorm(x) E^T / 8                               (logits_scaling)

- The Mamba-2 mixer is ``models/mamba2.py``'s ``Mamba2Mixer``: 64 heads of
  64 (d_inner 4096), d_state 128, one group, d_conv 4 with a bias, chunks
  of 256, on the card the conv, SSD, gate and norm kernel pairs.
- The attention mixer is ``layers.SelfAttention`` with 32 query heads of 64
  and 8 KV heads (GQA), causal, no positional encoding
  (``position_embedding_type`` "nope"), no bias, softmax scale
  ``attention_multiplier`` 1/64; the KV heads are repeated onto the D=64
  flash kernels.
- The MLP is ``layers.GatedMlp`` (SwiGLU of ``shared_intermediate_size``
  8192).

The logits' division by 8 is applied to the final norm's output before the
chunked loss: exact, since 8 is a power of two. On the card the norms run
on ``ops/rmsnorm.py``'s kernel pair, and each sublayer's residual add joins
its norm's backward kernel, as Jamba's layers do. With ``remat`` each whole
layer, mixer and MLP, runs under ``layers.remat`` and keeps its input alone.

IBM publishes no pretraining recipe for this model: ``GraniteModelClass``
states an assumed one, Jamba's (AdamW, betas 0.9 / 0.95, decay 0.1, clip
1.0, peak 3e-4, cosine to 3e-5), with 32 rows of 16,384 tokens an update.
"""

from typing import Any, Literal

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import default_attn_impl
from ..ops.xent import lm_head_loss, matmul_f32
from . import GraniteT, LanguageModelClass, ModelBundle, SchedulerType
from .layers import GatedMlp, RMSNorm, SelfAttention, remat
from .mamba2 import Mamba2Mixer

D_MODEL = 2048
LAYER_TYPES = tuple("attention" if i in (5, 15, 25, 35) else "mamba" for i in range(40))
NUM_HEADS = 32
NUM_KV_HEADS = 8
HEAD_DIM = D_MODEL // NUM_HEADS  # 64
MAMBA_HEADS = 64
MAMBA_HEAD_DIM = 64  # d_inner 4096 = mamba_expand 2 x 2048
D_STATE = 128
N_GROUPS = 1
D_CONV = 4
CHUNK = 256
INTERMEDIATE = 8192
VOCAB = 100352
RMS_EPS = 1e-5
EMBEDDING_MULTIPLIER = 12.0
RESIDUAL_MULTIPLIER = 0.22
ATTENTION_MULTIPLIER = 1 / 64
LOGITS_SCALING = 8.0
INIT_STD = 0.02  # the draw the benchmark's configuration assumes


class GraniteLayer(nn.Module):
    """``input_layernorm`` -> the mixer (``self_attn`` or ``mamba``) -> the
    scaled residual add, then ``post_attention_layernorm`` -> ``shared_mlp``
    -> the scaled residual add."""

    def __init__(self, kind: str, d_model: int, num_heads: int, num_kv_heads: int, head_dim: int, mamba_heads: int,
                 mamba_head_dim: int, d_state: int, n_groups: int, d_conv: int, chunk: int, intermediate: int,
                 eps: float, use_custom_kernels: bool, dtype: torch.dtype):
        super().__init__()
        self.kind = kind
        self.input_layernorm = RMSNorm(d_model, eps=eps, dtype=dtype)
        if kind == "attention":
            self.self_attn = SelfAttention(
                d_model, num_heads, head_dim, num_kv_heads=num_kv_heads, causal=True, rotary_dim=0,
                attn_impl=default_attn_impl(use_custom_kernels), use_bias=False, dtype=dtype,
                sm_scale=ATTENTION_MULTIPLIER,
            )
        elif kind == "mamba":
            self.mamba = Mamba2Mixer(d_model, mamba_heads, mamba_head_dim, d_state, n_groups, d_conv, chunk, eps, dtype)
        else:
            raise ValueError(f"unknown Granite layer kind {kind!r}")
        self.post_attention_layernorm = RMSNorm(d_model, eps=eps, dtype=dtype)
        self.shared_mlp = GatedMlp(d_model, intermediate, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # each norm hands x back as its add's operand, so that the add's gradient reaches the norm's backward
        h, x = self.input_layernorm(x, residual=True)
        x = torch.add(x, self.self_attn(h) if self.kind == "attention" else self.mamba(h), alpha=RESIDUAL_MULTIPLIER)
        h, x = self.post_attention_layernorm(x, residual=True)
        return torch.add(x, self.shared_mlp(h), alpha=RESIDUAL_MULTIPLIER)


class GraniteLM(nn.Module):
    """Embedding [vocab, d_model], the layers in ``layer_types`` order, the
    final RMSNorm and the tied LM head (``embedding.T``)."""

    def __init__(
        self,
        d_model: int = D_MODEL,
        layer_types: tuple[str, ...] = LAYER_TYPES,
        num_heads: int = NUM_HEADS,
        num_kv_heads: int = NUM_KV_HEADS,
        head_dim: int = HEAD_DIM,
        mamba_heads: int = MAMBA_HEADS,
        mamba_head_dim: int = MAMBA_HEAD_DIM,
        d_state: int = D_STATE,
        n_groups: int = N_GROUPS,
        d_conv: int = D_CONV,
        chunk: int = CHUNK,
        intermediate: int = INTERMEDIATE,
        vocab_size: int = VOCAB,
        eps: float = RMS_EPS,
        use_custom_kernels: bool = True,
        remat: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.compute_dtype = dtype
        self.remat = remat
        self.embedding = nn.Parameter(torch.empty(vocab_size, d_model))
        self.layers = nn.ModuleList(
            GraniteLayer(kind, d_model, num_heads, num_kv_heads, head_dim, mamba_heads, mamba_head_dim, d_state,
                         n_groups, d_conv, chunk, intermediate, eps, use_custom_kernels, dtype)
            for kind in layer_types
        )
        self.final_layernorm = RMSNorm(d_model, eps=eps, dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """HF ``GraniteMoeHybridPreTrainedModel._init_weights`` in distribution,
        at a standard deviation of 0.02: normal for the embedding, every
        projection and the conv, zero conv bias, norm scales 1, ``dt_bias``
        1, ``A_log`` log(1..heads), ``D`` 1. Each tensor is drawn in f32 on
        the parameters' device from ``generator`` (which must live there),
        then cast to the parameter's dtype."""
        for name, p in self.named_parameters():
            w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            leaf = name.rsplit(".", 1)[-1]
            if name.endswith("norm.weight") or leaf in ("D", "dt_bias"):
                w.fill_(1.0)
            elif leaf == "A_log":
                w.copy_(torch.log(torch.arange(1, p.shape[0] + 1, dtype=torch.float32, device=p.device)))
            elif leaf == "conv_bias":
                w.zero_()
            else:  # the embedding, the projections and conv_weight
                w.normal_(0.0, INIT_STD, generator=generator)
            p.copy_(w)

    def forward(self, input_ids: torch.Tensor, labels: torch.Tensor | None = None) -> torch.Tensor:
        """Logits when ``labels`` is None, else the (shifted) LM loss via the
        chunked vocab projection."""
        x = F.embedding(input_ids, self.embedding).to(self.compute_dtype) * EMBEDDING_MULTIPLIER
        for layer in self.layers:
            x = remat(layer, x) if self.remat else layer(x)
        x = self.final_layernorm(x) * (1 / LOGITS_SCALING)
        kernel = self.embedding.to(self.compute_dtype).t()  # tied LM head [d_model, vocab]
        if labels is None:
            return matmul_f32(x.reshape(-1, x.shape[-1]), kernel).reshape(*x.shape[:-1], -1)
        return lm_head_loss(x, kernel, labels, shift=True)


class GraniteModelClass(LanguageModelClass[GraniteT]):
    def build_model(
        self,
        use_custom_kernels: bool = True,
        activation_checkpointing: bool = False,
        compute_dtype: torch.dtype | None = None,
        device: torch.device | str = "cuda",
    ) -> ModelBundle:
        """``activation_checkpointing`` remats each whole layer. The sizes are
        this module's constants, read at call time."""
        if compute_dtype is None:
            compute_dtype = torch.bfloat16 if self.mixed_precision else torch.float32
        with torch.device("meta"):
            module = GraniteLM(
                D_MODEL, LAYER_TYPES, NUM_HEADS, NUM_KV_HEADS, HEAD_DIM, MAMBA_HEADS, MAMBA_HEAD_DIM, D_STATE,
                N_GROUPS, D_CONV, CHUNK, INTERMEDIATE, VOCAB, RMS_EPS,
                use_custom_kernels=use_custom_kernels, remat=activation_checkpointing, dtype=compute_dtype,
            )
        module = module.to_empty(device=device)

        def init_fn(mod: GraniteLM, generator: torch.Generator) -> None:
            mod.reset_parameters(generator)

        def loss_fn(mod: GraniteLM, batch: dict[str, torch.Tensor], generator=None):
            loss = mod(batch["input_ids"], labels=batch["labels"])
            return loss, {"loss": loss}

        return ModelBundle(module=module, loss_fn=loss_fn, init_fn=init_fn)

    @property
    def batch_size(self) -> int:
        return 32  # rows of 16,384 tokens: 524,288 tokens an update, Jamba's

    @property
    def training_steps(self) -> int:
        return 100_000

    @property
    def mixed_precision(self) -> Literal[None, "bf16", "fp16"]:
        return "bf16"

    @property
    def optimizer(self) -> Literal["adam", "adamw"]:
        return "adamw"

    @property
    def optimizer_kwargs(self) -> dict[str, Any]:
        return {"lr": 3e-4, "weight_decay": 0.1, "betas": (0.9, 0.95)}

    @property
    def scheduler_type(self) -> SchedulerType:
        return SchedulerType.COSINE_WITH_MIN_LR

    @property
    def scheduler_kwargs(self) -> dict[str, Any]:
        return {"num_warmup_steps": int(0.01 * self.training_steps), "min_lr": 3e-5}

    @property
    def max_grad_norm(self) -> float:
        return 1.0

    @property
    def fsdp_layers_to_wrap(self) -> list[str]:
        return ["GraniteLayer"]

    @property
    def vocab_size(self) -> int:
        return VOCAB

    @property
    def sequence_length(self) -> int:
        return 16384
