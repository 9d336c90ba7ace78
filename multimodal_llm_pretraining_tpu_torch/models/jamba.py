"""AI21-Jamba2-3B causal LM, a model of the port alone: the JAX package has
no hybrid of state-space and attention layers.

ai21labs/AI21-Jamba2-3B's ``config.json`` (``model_type`` "jamba", dense:
``num_experts`` 1): 28 layers of hidden 2560, vocab 65,536, the LM head tied
to the embedding, ``rms_norm_eps`` 1e-6. Layer i is attention where ``i %
attn_layer_period == attn_layer_offset`` (14 and 7: layers 7 and 21), every
other layer Mamba, as HF ``JambaConfig.layers_block_type`` orders them.
Every layer is two pre-norm sublayers over the stream x, which stays in the
compute dtype:

    x = x + Mixer(RMSNorm_in(x))
    x = x + MLP(RMSNorm_ff(x)),   MLP(g) = W_down(SiLU(W_gate g) * W_up g)

then a final RMSNorm and the logits x E^T of the tied embedding E.

- The Mamba mixer is ``models/mamba.py``'s ``MambaMixer`` (Mamba-1: d_state
  16, d_conv 4, expand 2, dt_rank 160, a conv bias, no projection bias) with
  Jamba's inner RMSNorms over dt, B and C, and the conv with its SiLU and the
  gate computed in f32 and rounded once, as mamba_ssm's kernels compute them
  (``use_mamba_kernels``): on the card the scan, conv and gate kernel pairs.
- The attention mixer is ``layers.SelfAttention`` with 20 query heads of 128
  and one KV head (MQA), causal, with no positional encoding and no bias; the
  KV head is repeated for every query head onto the flash kernels.
- The MLP is ``layers.GatedMlp`` (SwiGLU of 8192).

On the card the norms run on ``ops/rmsnorm.py``'s kernel pair, and each
sublayer's residual add joins its norm's backward kernel, as mamba's block
does. With ``remat`` each whole layer, mixer and MLP, runs under
``layers.remat`` and keeps its input alone.

AI21 publishes no pretraining recipe for this model: ``JambaModelClass``
states an assumed one (AdamW, betas 0.9 / 0.95, decay 0.1, clip 1.0, peak
3e-4, cosine to 3e-5), with 32 rows of 16,384 tokens an update.
"""

from typing import Any, Literal

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import default_attn_impl
from ..ops.xent import lm_head_loss, matmul_f32
from . import JambaT, LanguageModelClass, ModelBundle, SchedulerType
from .layers import GatedMlp, RMSNorm, SelfAttention, remat
from .mamba import MambaMixer

D_MODEL = 2560
N_LAYER = 28
D_INNER = 5120  # mamba_expand 2
D_STATE = 16
D_CONV = 4
DT_RANK = 160
NUM_HEADS = 20
NUM_KV_HEADS = 1
HEAD_DIM = D_MODEL // NUM_HEADS  # 128
INTERMEDIATE = 8192
VOCAB = 65536
ATTN_LAYER_PERIOD = 14
ATTN_LAYER_OFFSET = 7
RMS_EPS = 1e-6
INIT_STD = 0.02  # initializer_range


def layer_kinds(num_layers: int, period: int, offset: int) -> list[str]:
    """Each layer's mixer, "attention" or "mamba" (HF ``layers_block_type``)."""
    return ["attention" if i % period == offset else "mamba" for i in range(num_layers)]


class JambaLayer(nn.Module):
    """``input_layernorm`` -> the mixer (``self_attn`` or ``mamba``) -> the
    residual add, then ``pre_ff_layernorm`` -> ``feed_forward`` -> the
    residual add."""

    def __init__(self, kind: str, d_model: int, d_inner: int, d_state: int, d_conv: int, dt_rank: int,
                 num_heads: int, num_kv_heads: int, head_dim: int, intermediate: int, eps: float,
                 use_custom_kernels: bool, dtype: torch.dtype):
        super().__init__()
        self.kind = kind
        self.input_layernorm = RMSNorm(d_model, eps=eps, dtype=dtype)
        if kind == "attention":
            self.self_attn = SelfAttention(
                d_model, num_heads, head_dim, num_kv_heads=num_kv_heads, causal=True, rotary_dim=0,
                attn_impl=default_attn_impl(use_custom_kernels), use_bias=False, dtype=dtype,
            )
        elif kind == "mamba":
            self.mamba = MambaMixer(d_model, d_inner, d_state, d_conv, dt_rank, use_custom_kernels, dtype,
                                    f32_conv_gate=True, inner_norm_eps=eps)
        else:
            raise ValueError(f"unknown Jamba layer kind {kind!r}")
        self.pre_ff_layernorm = RMSNorm(d_model, eps=eps, dtype=dtype)
        self.feed_forward = GatedMlp(d_model, intermediate, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # each norm hands x back as its add's operand, so that the add's gradient reaches the norm's backward
        h, x = self.input_layernorm(x, residual=True)
        x = x + (self.self_attn(h) if self.kind == "attention" else self.mamba(h))
        h, x = self.pre_ff_layernorm(x, residual=True)
        return x + self.feed_forward(h)


class JambaLM(nn.Module):
    """Embedding [vocab, d_model], the layers in ``layer_kinds`` order, the
    final RMSNorm and the tied LM head (``embedding.T``)."""

    def __init__(
        self,
        d_model: int = D_MODEL,
        num_layers: int = N_LAYER,
        d_inner: int = D_INNER,
        d_state: int = D_STATE,
        d_conv: int = D_CONV,
        dt_rank: int = DT_RANK,
        num_heads: int = NUM_HEADS,
        num_kv_heads: int = NUM_KV_HEADS,
        head_dim: int = HEAD_DIM,
        intermediate: int = INTERMEDIATE,
        vocab_size: int = VOCAB,
        attn_layer_period: int = ATTN_LAYER_PERIOD,
        attn_layer_offset: int = ATTN_LAYER_OFFSET,
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
            JambaLayer(kind, d_model, d_inner, d_state, d_conv, dt_rank, num_heads, num_kv_heads, head_dim,
                       intermediate, eps, use_custom_kernels, dtype)
            for kind in layer_kinds(num_layers, attn_layer_period, attn_layer_offset)
        )
        self.final_layernorm = RMSNorm(d_model, eps=eps, dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """HF ``JambaPreTrainedModel._init_weights`` in distribution: normal(0,
        0.02) for the embedding, every projection and the conv, zero biases,
        norm scales 1, ``A_log`` row log(1..d_state), ``D`` 1. Each tensor is
        drawn in f32 on the parameters' device from ``generator`` (which must
        live there), then cast to the parameter's dtype."""
        for name, p in self.named_parameters():
            w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            leaf = name.rsplit(".", 1)[-1]
            if name.endswith("norm.weight") or leaf == "D":
                w.fill_(1.0)
            elif leaf == "A_log":
                w.copy_(torch.log(torch.arange(1, p.shape[1] + 1, dtype=torch.float32, device=p.device)).expand_as(w))
            elif leaf in ("bias", "conv_bias"):
                w.zero_()
            else:  # the embedding, the projections and conv_weight
                w.normal_(0.0, INIT_STD, generator=generator)
            p.copy_(w)

    def forward(self, input_ids: torch.Tensor, labels: torch.Tensor | None = None) -> torch.Tensor:
        """Logits when ``labels`` is None, else the (shifted) LM loss via the
        chunked vocab projection."""
        x = F.embedding(input_ids, self.embedding).to(self.compute_dtype)
        for layer in self.layers:
            x = remat(layer, x) if self.remat else layer(x)
        x = self.final_layernorm(x)
        kernel = self.embedding.to(self.compute_dtype).t()  # tied LM head [d_model, vocab]
        if labels is None:
            return matmul_f32(x.reshape(-1, x.shape[-1]), kernel).reshape(*x.shape[:-1], -1)
        return lm_head_loss(x, kernel, labels, shift=True)


class JambaModelClass(LanguageModelClass[JambaT]):
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
            module = JambaLM(
                D_MODEL, N_LAYER, D_INNER, D_STATE, D_CONV, DT_RANK, NUM_HEADS, NUM_KV_HEADS, HEAD_DIM,
                INTERMEDIATE, VOCAB, ATTN_LAYER_PERIOD, ATTN_LAYER_OFFSET, RMS_EPS,
                use_custom_kernels=use_custom_kernels, remat=activation_checkpointing, dtype=compute_dtype,
            )
        module = module.to_empty(device=device)

        def init_fn(mod: JambaLM, generator: torch.Generator) -> None:
            mod.reset_parameters(generator)

        def loss_fn(mod: JambaLM, batch: dict[str, torch.Tensor], generator=None):
            loss = mod(batch["input_ids"], labels=batch["labels"])
            return loss, {"loss": loss}

        return ModelBundle(module=module, loss_fn=loss_fn, init_fn=init_fn)

    @property
    def batch_size(self) -> int:
        return 32  # rows of 16,384 tokens: 524,288 tokens an update, mamba's

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
        return ["JambaLayer"]

    @property
    def vocab_size(self) -> int:
        return VOCAB

    @property
    def sequence_length(self) -> int:
        return 16384
