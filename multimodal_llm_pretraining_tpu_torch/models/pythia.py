"""Pythia suite: GPTNeoX causal LMs, 14M-12B (counterpart of
``models/pythia.py:21-204``).

Parallel-residual blocks, rotary on 25% of head dims, untied output head,
vocab padded to 50304, seq 2049. Sizes and the training recipe are the JAX
package's (a CPU test pins them equal).
"""

import math
from typing import Any, Literal

import torch
from torch import nn

from ..ops.attention import default_attn_impl
from ..ops.xent import lm_head_loss, matmul_f32
from . import LanguageModelClass, ModelBundle, PythiaT, SchedulerType
from .layers import LayerNorm, Mlp, SelfAttention, check_remat_policy, checkpoint_block

# (layers, hidden, heads) per published EleutherAI configs
PYTHIA_SIZES: dict[str, tuple[int, int, int]] = {
    "pythia-14m": (6, 128, 4),
    "pythia-31m": (6, 256, 8),
    "pythia-70m": (6, 512, 8),
    "pythia-160m": (12, 768, 12),
    "pythia-410m": (24, 1024, 16),
    "pythia-1b": (16, 2048, 8),
    "pythia-1.4b": (24, 2048, 16),
    "pythia-2.8b": (32, 2560, 32),
    "pythia-6.9b": (32, 4096, 32),
    "pythia-12b": (36, 5120, 40),
}

VOCAB_SIZE = 50304
ROTARY_PCT = 0.25

# flax's lecun_normal draws from a normal truncated to (-2, 2) standard
# deviations; this is that truncated normal's own standard deviation
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


class GPTNeoXBlock(nn.Module):
    def __init__(self, hidden: int, num_heads: int, attn_impl: str = "flash", dtype: torch.dtype = torch.float32):
        super().__init__()
        head_dim = hidden // num_heads
        self.ln_attn = LayerNorm(hidden, dtype=dtype)
        self.attn = SelfAttention(
            hidden, num_heads, head_dim, causal=True, rotary_dim=int(head_dim * ROTARY_PCT),
            attn_impl=attn_impl, use_bias=True, dtype=dtype,  # type: ignore[arg-type]
        )
        self.ln_mlp = LayerNorm(hidden, dtype=dtype)
        self.mlp = Mlp(hidden, 4 * hidden, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # parallel residual: x + attn(ln1(x)) + mlp(ln2(x))
        return x + self.attn(self.ln_attn(x)) + self.mlp(self.ln_mlp(x))


class GPTNeoXLM(nn.Module):
    """Embedding, ``num_layers`` blocks, final LayerNorm and the untied
    output head ``embed_out`` [H, V] (the JAX layout, used as the LM-head
    kernel as it is). With a ``remat_policy`` ("flash" or "dots") every
    block runs under ``checkpoint_block``; the final LayerNorm and the
    chunked head stay outside it, as the JAX model keeps them outside its
    stack."""

    def __init__(
        self,
        num_layers: int,
        hidden: int,
        num_heads: int,
        vocab_size: int = VOCAB_SIZE,
        attn_impl: str = "flash",
        dtype: torch.dtype = torch.float32,
        remat_policy: str | None = None,
    ):
        super().__init__()
        self.compute_dtype = dtype
        self.remat_policy = remat_policy
        self.embed_in = nn.Embedding(vocab_size, hidden)
        self.layers = nn.ModuleList(GPTNeoXBlock(hidden, num_heads, attn_impl, dtype) for _ in range(num_layers))
        self.final_ln = LayerNorm(hidden, dtype=dtype)
        self.embed_out = nn.Parameter(torch.empty(hidden, vocab_size))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX initializers in distribution (not in bits): lecun-normal
        Dense kernels and ``embed_out``, zero biases, LayerNorm scale 1 and
        bias 0, and flax ``Embed``'s normal(0, 1/sqrt(hidden)) for
        ``embed_in``. Each tensor is drawn in f32 on the parameters' device
        from ``generator`` (which must live there), then cast to the
        parameter's dtype."""
        for name, p in self.named_parameters():
            w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            if name == "embed_in.weight":
                w.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator)
            elif name == "embed_out":
                _lecun_normal_(w, p.shape[0], generator)
            elif name.endswith("ln_attn.weight") or name.endswith("ln_mlp.weight") or name == "final_ln.weight":
                w.fill_(1.0)
            elif name.endswith(".weight"):  # Dense, [out, in]
                _lecun_normal_(w, p.shape[1], generator)
            else:
                w.zero_()
            p.copy_(w)

    def forward(self, input_ids: torch.Tensor, labels: torch.Tensor | None = None) -> torch.Tensor:
        """Logits when ``labels`` is None, else the (shifted) LM loss via the
        chunked vocab projection (full logits never materialise)."""
        x = self.embed_in(input_ids).to(self.compute_dtype)
        for block in self.layers:
            x = checkpoint_block(block, x, policy=self.remat_policy)
        x = self.final_ln(x)
        kernel = self.embed_out.to(self.compute_dtype)
        if labels is None:
            return matmul_f32(x.reshape(-1, x.shape[-1]), kernel).reshape(*x.shape[:-1], -1)
        return lm_head_loss(x, kernel, labels, shift=True)


class PythiaModelClass(LanguageModelClass[PythiaT]):
    def build_model(
        self,
        use_custom_kernels: bool = True,
        activation_checkpointing: bool = False,
        compute_dtype: torch.dtype | None = None,
        device: torch.device | str = "cuda",
        checkpoint_policy: str = "flash",
    ) -> ModelBundle:
        """``activation_checkpointing`` remats every block under
        ``checkpoint_policy`` ("flash" or "dots", JAX ``pythia.py:119-133``)."""
        policy = check_remat_policy(checkpoint_policy) if activation_checkpointing else None
        num_layers, hidden, heads = PYTHIA_SIZES[self.model_type]
        if compute_dtype is None:
            compute_dtype = torch.bfloat16 if self.mixed_precision else torch.float32
        with torch.device("meta"):
            module = GPTNeoXLM(num_layers, hidden, heads, attn_impl=default_attn_impl(use_custom_kernels), dtype=compute_dtype,
                               remat_policy=policy)
        module = module.to_empty(device=device)

        def init_fn(mod: GPTNeoXLM, generator: torch.Generator) -> None:
            mod.reset_parameters(generator)

        def loss_fn(mod: GPTNeoXLM, batch: dict[str, torch.Tensor], generator=None):
            loss = mod(batch["input_ids"], labels=batch["labels"])
            return loss, {"loss": loss}

        return ModelBundle(module=module, loss_fn=loss_fn, init_fn=init_fn)

    @property
    def batch_size(self) -> int:
        return 1024

    @property
    def training_steps(self) -> int:
        return 143000

    @property
    def mixed_precision(self) -> Literal[None, "bf16", "fp16"]:
        # Pythia trained fp16 except 1b (bf16); both run as bf16 here
        if self.model_type == "pythia-1b":
            return "bf16"
        return "fp16"

    @property
    def optimizer(self) -> Literal["adam", "adamw"]:
        return "adam"

    @property
    def optimizer_kwargs(self) -> dict[str, Any]:
        lr = {
            "pythia-14m": 1.0e-3,
            "pythia-31m": 1.0e-3,
            "pythia-70m": 1.0e-3,
            "pythia-160m": 6.0e-4,
            "pythia-410m": 3.0e-4,
            "pythia-1b": 3.0e-4,
            "pythia-1.4b": 2.0e-4,
            "pythia-2.8b": 1.6e-4,
            "pythia-6.9b": 1.2e-4,
            "pythia-12b": 1.2e-4,
        }[self.model_type]
        return {"lr": lr, "betas": (0.9, 0.95), "eps": 1e-8, "weight_decay": 0.01}

    @property
    def scheduler_type(self) -> SchedulerType:
        return SchedulerType.COSINE_WITH_MIN_LR

    @property
    def scheduler_kwargs(self) -> dict[str, Any]:
        return {"num_warmup_steps": int(0.01 * self.training_steps), "min_lr_rate": 0.1}

    @property
    def max_grad_norm(self) -> float:
        return 1.0

    @property
    def fsdp_layers_to_wrap(self) -> list[str]:
        return ["GPTNeoXBlock"]

    @property
    def vocab_size(self) -> int:
        return VOCAB_SIZE

    @property
    def sequence_length(self) -> int:
        return 2049
