"""RoBERTa-large masked-LM pretraining (counterpart of ``models/roberta.py:1-165``).

A 24-layer post-LN encoder (hidden 1024, 16 heads of 64, ffn 4096, vocab
50,265, 512 learned positions, LayerNorm eps 1e-5), hidden dropout 0.1
after the embedding LayerNorm, on the attention output and inside the MLP;
the MLM head is Dense, tanh-GELU and LayerNorm, then a decoder tied to the
word embeddings (``word_embeddings.T``) with its own ``mlm_bias``, through
the chunked head, so the [B, S, 50265] logits never exist at once. No mask
goes to the attention: the flash kernels run non-causal in plain mode.

The widths are constructor arguments (the JAX model reads them as module
constants, and ``build_model`` reads this module's the same way). Recipe
(the JAX package's, a CPU test pins it): batch 8192, 500k steps, "fp16"
(run as bf16 compute over f32 params and moments), Adam (L2 weight decay
0.01) lr 4e-4, betas (0.9, 0.98), linear schedule with 30k warmup, no
clipping. Dropout draws from the generator handed to ``forward``; without
one the model is deterministic.
"""

from typing import Any, Literal

import torch
from torch import nn

from ..ops.attention import default_attn_impl
from ..ops.xent import lm_head_loss
from . import LanguageModelClass, ModelBundle, RobertaT, SchedulerType
from .layers import Dense, LayerNorm, Mlp, SelfAttention, checkpoint_block, dropout, gelu_tanh
from .pythia import _lecun_normal_

HIDDEN = 1024
LAYERS = 24
HEADS = 16
FFN = 4096
VOCAB = 50265
MAX_POS = 512
LN_EPS = 1e-5
DROPOUT = 0.1


class RobertaBlock(nn.Module):
    """Post-LN encoder block (sublayer, add, norm): x = LN(x +
    dropout(attn(x))), then x = LN(x + mlp(x)) with the MLP's own dropout."""

    def __init__(self, hidden: int, num_heads: int, ffn: int, attn_impl: str = "flash",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attn = SelfAttention(hidden, num_heads, hidden // num_heads, causal=False, attn_impl=attn_impl, dtype=dtype)  # type: ignore[arg-type]
        self.ln_attn = LayerNorm(hidden, eps=LN_EPS, dtype=dtype)
        self.mlp = Mlp(hidden, ffn, dropout=DROPOUT, dtype=dtype)
        self.ln_mlp = LayerNorm(hidden, eps=LN_EPS, dtype=dtype)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.ln_attn(x + dropout(self.attn(x), DROPOUT, generator))
        return self.ln_mlp(x + self.mlp(x, generator))


class RobertaMLM(nn.Module):
    """Embeddings, ``num_layers`` blocks and the tied MLM head, under the
    JAX module's parameter names (``word_embeddings``,
    ``position_embeddings``, ``emb_ln``, ``layers.i``, ``mlm_dense``,
    ``mlm_ln``, ``mlm_bias``). ``remat_policy`` ("flash", the JAX stack's
    default) runs every block under ``checkpoint_block``, whose recompute
    replays the block's dropout draws."""

    def __init__(self, hidden: int = HIDDEN, num_layers: int = LAYERS, num_heads: int = HEADS, ffn: int = FFN,
                 vocab_size: int = VOCAB, attn_impl: str = "flash", dtype: torch.dtype = torch.float32,
                 remat_policy: str | None = None):
        super().__init__()
        self.compute_dtype, self.remat_policy = dtype, remat_policy
        self.word_embeddings = nn.Parameter(torch.empty(vocab_size, hidden))
        self.position_embeddings = nn.Parameter(torch.empty(MAX_POS, hidden))
        self.emb_ln = LayerNorm(hidden, eps=LN_EPS, dtype=dtype)
        self.layers = nn.ModuleList(RobertaBlock(hidden, num_heads, ffn, attn_impl, dtype) for _ in range(num_layers))
        self.mlm_dense = Dense(hidden, hidden, dtype=dtype)
        self.mlm_ln = LayerNorm(hidden, eps=LN_EPS, dtype=dtype)
        self.mlm_bias = nn.Parameter(torch.empty(vocab_size))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX initializers in distribution (not in bits): normal(0,
        0.02) embeddings, lecun-normal Dense kernels, zero biases, LayerNorm
        scale 1. Each tensor is drawn in f32 on the parameters' device from
        ``generator`` (which must live there), then cast to the parameter's
        dtype."""
        norms = {f"{n}.weight" for n, m in self.named_modules() if isinstance(m, LayerNorm)}
        for name, p in self.named_parameters():
            w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            if name in norms:
                w.fill_(1.0)
            elif name.endswith("bias"):
                w.zero_()
            elif name.endswith(".weight"):  # Dense, [out, in]
                _lecun_normal_(w, p.shape[1], generator)
            else:  # word and position embeddings
                w.normal_(0.0, 0.02, generator=generator)
            p.copy_(w)

    def forward(self, input_ids: torch.Tensor, labels: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """The MLM loss over the labels that are not -100; dropout draws
        from ``generator`` when one is given."""
        dt = self.compute_dtype
        s = input_ids.shape[1]
        x = self.word_embeddings[input_ids].to(dt) + self.position_embeddings[:s].to(dt)
        x = dropout(self.emb_ln(x), DROPOUT, generator)
        for block in self.layers:
            x = checkpoint_block(block, x, policy=self.remat_policy, generator=generator)
        x = self.mlm_ln(gelu_tanh(self.mlm_dense(x)))
        kernel = self.word_embeddings.to(dt).t()  # the tied decoder [H, V]
        return lm_head_loss(x, kernel, labels, shift=False, bias=self.mlm_bias)


class RobertaModelClass(LanguageModelClass[RobertaT]):
    def build_model(
        self,
        use_custom_kernels: bool = True,
        activation_checkpointing: bool = False,
        compute_dtype: torch.dtype | None = None,
        device: torch.device | str = "cuda",
    ) -> ModelBundle:
        """``activation_checkpointing`` remats every block under the "flash"
        policy (JAX ``make_stack``'s default)."""
        if compute_dtype is None:
            compute_dtype = torch.bfloat16 if self.mixed_precision else torch.float32
        with torch.device("meta"):
            module = RobertaMLM(HIDDEN, LAYERS, HEADS, FFN, VOCAB, attn_impl=default_attn_impl(use_custom_kernels),
                                dtype=compute_dtype, remat_policy="flash" if activation_checkpointing else None)
        module = module.to_empty(device=device)

        def init_fn(mod: RobertaMLM, generator: torch.Generator) -> None:
            mod.reset_parameters(generator)

        def loss_fn(mod: RobertaMLM, batch: dict[str, torch.Tensor], generator=None):
            loss = mod(batch["input_ids"], labels=batch["labels"], generator=generator)
            return loss, {"loss": loss}

        return ModelBundle(module=module, loss_fn=loss_fn, init_fn=init_fn)

    @property
    def batch_size(self) -> int:
        return 8192

    @property
    def training_steps(self) -> int:
        return 500000

    @property
    def mixed_precision(self) -> Literal[None, "bf16", "fp16"]:
        return "fp16"

    @property
    def optimizer(self) -> Literal["adam", "adamw"]:
        return "adam"

    @property
    def optimizer_kwargs(self) -> dict[str, Any]:
        return {"lr": 4e-4, "betas": (0.9, 0.98), "weight_decay": 0.01}

    @property
    def scheduler_type(self) -> SchedulerType:
        return SchedulerType.LINEAR

    @property
    def scheduler_kwargs(self) -> dict[str, Any]:
        return {"num_warmup_steps": 30_000}

    @property
    def max_grad_norm(self) -> float:
        return 0.0

    @property
    def fsdp_layers_to_wrap(self) -> list[str]:
        return ["RobertaBlock"]

    @property
    def vocab_size(self) -> int:
        return VOCAB

    @property
    def sequence_length(self) -> int:
        return 512
