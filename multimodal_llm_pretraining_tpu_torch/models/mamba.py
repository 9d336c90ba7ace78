"""Mamba-2.8b causal LM (counterpart of ``models/mamba.py:17-182``).

The state-spaces/mamba-2.8b architecture: d_model 2560, 64 layers, expand 2
(d_inner 5120), d_state 16, d_conv 4, dt_rank 160, vocab 50280, seq 4096,
with the LM head tied to the embedding. The sizes are constructor arguments
(the JAX model reads them as module constants); the training recipe is the
JAX package's (a CPU test pins it equal).

The selective scan runs through ``ops/selective_scan.py``: the hand-written
CUDA kernels on the card, their plain versions on the CPU, and the plain
chunked scan under autograd with ``use_custom_kernels=False``.

``residual_in_fp32`` (the default, ``RESIDUAL_IN_FP32``) computes as
state-spaces/mamba runs the published configuration:

- the residual stream is f32: the embedding's rows are widened to f32, each
  block normalises the f32 stream into the compute dtype and adds its output
  back in f32, and the final norm reads the f32 stream; under remat a block
  keeps that one f32 tensor. On the card the norms run on
  ``ops/rmsnorm.py``'s kernel pair, the published ``fused_add_norm``: the
  block's residual add is one PyTorch add, and its gradient joins the norm's
  in the backward kernel;
- the conv and its SiLU, and the gate ``y * SiLU(z)``, are computed in f32
  and rounded once to the compute dtype, as mamba_ssm's causal-conv and
  selective-scan kernels compute them. The conv with its bias and SiLU is
  ``ops/causal_conv.py``'s op: on the card its kernel pair, which reads the
  strided half of ``in_proj``'s output uncopied and writes u contiguous; on
  the CPU its plain version, the f32 ``causal_conv1d`` composition. The gate
  is ``ops/gate.py``'s op: on the card its kernel pair, which reads z, the
  other strided half, uncopied; on the CPU the f32 composition. Rounding each step to bf16, as the
  JAX package does, moves mamba-2.8b's first loss (8 x 4096 tokens, on an
  H100) by about +2.3e-4 of itself against a reference that keeps them in
  f32, more than the residual stream's precision moves it.

``residual_in_fp32=False`` computes as the JAX package does, every step in
the compute dtype, the stream included (the conv a padded grouped
``F.conv1d``): the port's arithmetic before the option. So the switch selects two things, the stream's precision and that
of the conv and the gate, where mamba_ssm's setting of the same name selects
the stream's alone (its kernels keep the conv and the gate in f32 either
way). False exists for the tests that hold the port to the JAX package;
they set it through ``RESIDUAL_IN_FP32``.

``MambaMixer`` is the block without its norm and residual, the mixer that
``models/jamba.py`` runs between its own norms: there the conv and the gate
are always computed in f32 (``f32_conv_gate``) over a stream in the compute
dtype, and the mixer has Jamba's inner norms over dt, B and C.
"""

import math
from typing import Any, Literal

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.causal_conv import causal_conv_silu
from ..ops.gate import gate_silu
from ..ops.selective_scan import causal_conv1d, selective_scan
from ..ops.xent import lm_head_loss, matmul_f32
from ..tracing import backward_span, span
from . import LanguageModelClass, MambaT, ModelBundle, SchedulerType
from .layers import Dense, RMSNorm, remat
from .pythia import _lecun_normal_

D_MODEL = 2560
N_LAYER = 64
D_STATE = 16
D_CONV = 4
EXPAND = 2
D_INNER = EXPAND * D_MODEL  # 5120
DT_RANK = math.ceil(D_MODEL / 16)  # 160
VOCAB = 50280
LN_EPS = 1e-5
RESIDUAL_IN_FP32 = True  # state-spaces/mamba-2.8b's config.json


class MambaMixer(nn.Module):
    """The Mamba (S6) mixer: in_proj (u | z) -> causal conv + SiLU on u ->
    x_proj (dt | B | C) -> dt_proj + softplus -> selective scan -> * SiLU(z)
    -> out_proj, in the compute dtype. ``conv_weight`` keeps the JAX layout
    [d_conv, d_inner].

    - ``f32_conv_gate``: the conv with its SiLU and the gate are computed in
      f32 and rounded once, as mamba_ssm's kernels compute them: the conv on
      ``ops/causal_conv.py``'s op, which reads the strided half of
      ``in_proj``'s output uncopied, and the gate on ``ops/gate.py``'s, which
      reads z, the other half, where it lies (their kernel pairs on the card).
      Without it both run in the compute dtype, as the JAX package runs them.
    - ``inner_norm_eps``: Jamba's RMSNorms over dt, B and C between x_proj and
      dt_proj / the scan (``dt_layernorm``, ``b_layernorm``, ``c_layernorm``),
      each computing as ``layers.RMSNorm``; None leaves them out, as Mamba
      has none. B and C reach the scan as the norms' new tensors.

    The mixer runs in the span ``mamba.forward`` and its backward in
    ``mamba.backward`` (``tracing.py``)."""

    def __init__(
        self,
        d_model: int = D_MODEL,
        d_inner: int = D_INNER,
        d_state: int = D_STATE,
        d_conv: int = D_CONV,
        dt_rank: int = DT_RANK,
        use_custom_kernels: bool = True,
        dtype: torch.dtype = torch.float32,
        f32_conv_gate: bool = True,
        inner_norm_eps: float | None = None,
    ):
        super().__init__()
        self._build(d_model, d_inner, d_state, d_conv, dt_rank, use_custom_kernels, dtype, f32_conv_gate,
                    inner_norm_eps)

    def _build(self, d_model, d_inner, d_state, d_conv, dt_rank, use_custom_kernels, dtype, f32_conv_gate,
               inner_norm_eps) -> None:
        """Register the mixer's modules and parameters, in leaf order."""
        self.d_inner, self.d_state, self.dt_rank = d_inner, d_state, dt_rank
        self.f32_conv_gate = f32_conv_gate
        self.use_custom_kernels = use_custom_kernels
        self.compute_dtype = dtype
        self.in_proj = Dense(d_model, 2 * d_inner, bias=False, dtype=dtype)
        self.conv_weight = nn.Parameter(torch.empty(d_conv, d_inner))
        self.conv_bias = nn.Parameter(torch.empty(d_inner))
        self.x_proj = Dense(d_inner, dt_rank + 2 * d_state, bias=False, dtype=dtype)
        self.dt_proj = Dense(dt_rank, d_inner, dtype=dtype)
        self.A_log = nn.Parameter(torch.empty(d_inner, d_state))
        self.D = nn.Parameter(torch.empty(d_inner))
        self.out_proj = Dense(d_inner, d_model, bias=False, dtype=dtype)
        self.inner_norms = inner_norm_eps is not None
        if self.inner_norms:
            self.dt_layernorm = RMSNorm(dt_rank, eps=inner_norm_eps, dtype=dtype)
            self.b_layernorm = RMSNorm(d_state, eps=inner_norm_eps, dtype=dtype)
            self.c_layernorm = RMSNorm(d_state, eps=inner_norm_eps, dtype=dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        """The mixer's output [B, L, d_model] from the normalised h."""
        cdt = self.compute_dtype
        with span("mamba.forward"):
            u, z = self.in_proj(h).chunk(2, dim=-1)
            if self.f32_conv_gate:
                u = causal_conv_silu(u, self.conv_weight, self.conv_bias)
            else:
                u = F.silu(causal_conv1d(u, self.conv_weight.to(cdt), self.conv_bias.to(cdt)))
            dt, B, C = self.x_proj(u).split([self.dt_rank, self.d_state, self.d_state], dim=-1)
            if self.inner_norms:
                dt, B, C = self.dt_layernorm(dt), self.b_layernorm(B), self.c_layernorm(C)
            delta = F.softplus(self.dt_proj(dt))
            A = -torch.exp(self.A_log)
            y = selective_scan(u, delta, A, B, C, self.D, use_custom_kernels=self.use_custom_kernels)
            out = self.out_proj(gate_silu(y, z) if self.f32_conv_gate else y * F.silu(z))
        backward_span("mamba.backward", out, h)
        return out


class MambaBlock(MambaMixer):
    """RMSNorm -> the mixer, plus the residual. With ``residual_in_fp32``
    the block takes and returns the residual stream in f32, its own work in
    the compute dtype but for the conv with its SiLU and the gate, each
    computed in f32 and rounded once (see above); without, all of it is in
    the compute dtype. The norm is registered ahead of the mixer's leaves,
    the order the optimizer's global norm sums them in."""

    def __init__(
        self,
        d_model: int = D_MODEL,
        d_inner: int = D_INNER,
        d_state: int = D_STATE,
        d_conv: int = D_CONV,
        dt_rank: int = DT_RANK,
        eps: float = LN_EPS,
        use_custom_kernels: bool = True,
        dtype: torch.dtype = torch.float32,
        residual_in_fp32: bool = True,
    ):
        nn.Module.__init__(self)
        self.norm = RMSNorm(d_model, eps=eps, dtype=dtype)
        self._build(d_model, d_inner, d_state, d_conv, dt_rank, use_custom_kernels, dtype, residual_in_fp32, None)
        self.residual_in_fp32 = residual_in_fp32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.residual_in_fp32:
            # x comes back as the add's operand, so that its gradient reaches the norm's backward
            h, x = self.norm(x.float(), residual=True)
        else:
            h = self.norm(x)
        return x + super().forward(h)


class MambaLM(nn.Module):
    """Embedding [vocab, d_model], ``num_layers`` blocks, the final RMSNorm
    and the tied LM head (``embedding.T``). With ``remat`` each block runs
    under ``torch.utils.checkpoint`` (``layers.remat``): the JAX stack's default "flash" policy
    saves only flash-attention residuals, and a Mamba block has none, so
    there it is whole-block remat too, keeping the block's input stream
    alone. ``residual_in_fp32`` carries the stream in f32 and computes the
    conv and the gate in f32; False computes all of it as the JAX package
    does (see above)."""

    def __init__(
        self,
        d_model: int = D_MODEL,
        num_layers: int = N_LAYER,
        d_inner: int = D_INNER,
        d_state: int = D_STATE,
        d_conv: int = D_CONV,
        dt_rank: int = DT_RANK,
        vocab_size: int = VOCAB,
        eps: float = LN_EPS,
        use_custom_kernels: bool = True,
        remat: bool = False,
        dtype: torch.dtype = torch.float32,
        residual_in_fp32: bool = True,
    ):
        super().__init__()
        self.compute_dtype = dtype
        self.remat = remat
        self.stream_dtype = torch.float32 if residual_in_fp32 else dtype
        self.embedding = nn.Parameter(torch.empty(vocab_size, d_model))
        self.layers = nn.ModuleList(
            MambaBlock(d_model, d_inner, d_state, d_conv, dt_rank, eps, use_custom_kernels, dtype, residual_in_fp32)
            for _ in range(num_layers)
        )
        self.final_norm = RMSNorm(d_model, eps=eps, dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX initializers in distribution (not in bits): lecun-normal
        Dense kernels (fan-in = in features) and ``conv_weight`` (fan-in =
        d_conv: flax reads the [d_conv, d_inner] kernel's axis -2), zero
        biases, RMSNorm scale 1, ``A_log = log(1..d_state)`` on every row,
        ``D = 1`` and a normal(0, 0.02) embedding. Each tensor is drawn in f32
        on the parameters' device from ``generator`` (which must live there),
        then cast to the parameter's dtype."""
        for name, p in self.named_parameters():
            w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            leaf = name.rsplit(".", 1)[-1]
            if name == "embedding":
                w.normal_(0.0, 0.02, generator=generator)
            elif name.endswith("norm.weight") or leaf == "D":
                w.fill_(1.0)
            elif leaf == "A_log":
                w.copy_(torch.log(torch.arange(1, p.shape[1] + 1, dtype=torch.float32, device=p.device)).expand_as(w))
            elif leaf == "conv_weight":
                _lecun_normal_(w, p.shape[0], generator)
            elif leaf == "weight":  # Dense, [out, in]
                _lecun_normal_(w, p.shape[1], generator)
            else:  # conv_bias and dt_proj.bias: zeros, as in the JAX package
                w.zero_()
            p.copy_(w)

    def forward(self, input_ids: torch.Tensor, labels: torch.Tensor | None = None) -> torch.Tensor:
        """Logits when ``labels`` is None, else the (shifted) LM loss via the
        chunked vocab projection."""
        x = F.embedding(input_ids, self.embedding).to(self.stream_dtype)
        for block in self.layers:
            x = remat(block, x) if self.remat else block(x)
        x = self.final_norm(x)
        kernel = self.embedding.to(self.compute_dtype).t()  # tied LM head [d_model, vocab]
        if labels is None:
            return matmul_f32(x.reshape(-1, x.shape[-1]), kernel).reshape(*x.shape[:-1], -1)
        return lm_head_loss(x, kernel, labels, shift=True)


class MambaModelClass(LanguageModelClass[MambaT]):
    def build_model(
        self,
        use_custom_kernels: bool = True,
        activation_checkpointing: bool = False,
        compute_dtype: torch.dtype | None = None,
        device: torch.device | str = "cuda",
    ) -> ModelBundle:
        """``activation_checkpointing`` remats each whole block. The sizes
        and ``RESIDUAL_IN_FP32`` are this module's constants, read at call
        time as the JAX model reads its own."""
        if compute_dtype is None:
            compute_dtype = torch.bfloat16 if self.mixed_precision else torch.float32
        with torch.device("meta"):
            module = MambaLM(
                D_MODEL, N_LAYER, D_INNER, D_STATE, D_CONV, DT_RANK, VOCAB, LN_EPS,
                use_custom_kernels=use_custom_kernels, remat=activation_checkpointing, dtype=compute_dtype,
                residual_in_fp32=RESIDUAL_IN_FP32,
            )
        module = module.to_empty(device=device)

        def init_fn(mod: MambaLM, generator: torch.Generator) -> None:
            mod.reset_parameters(generator)

        def loss_fn(mod: MambaLM, batch: dict[str, torch.Tensor], generator=None):
            loss = mod(batch["input_ids"], labels=batch["labels"])
            return loss, {"loss": loss}

        return ModelBundle(module=module, loss_fn=loss_fn, init_fn=init_fn)

    @property
    def batch_size(self) -> int:
        return 128

    @property
    def training_steps(self) -> int:
        return 572_204

    @property
    def mixed_precision(self) -> Literal[None, "bf16", "fp16"]:
        return "bf16"

    @property
    def optimizer(self) -> Literal["adam", "adamw"]:
        return "adamw"

    @property
    def optimizer_kwargs(self) -> dict[str, Any]:
        return {"lr": 1.6e-4 * 5, "weight_decay": 0.1, "betas": (0.9, 0.95)}

    @property
    def scheduler_type(self) -> SchedulerType:
        return SchedulerType.COSINE_WITH_MIN_LR

    @property
    def scheduler_kwargs(self) -> dict[str, Any]:
        return {"num_warmup_steps": int(0.1 * self.training_steps), "min_lr": 1e-5}

    @property
    def max_grad_norm(self) -> float:
        return 1.0

    @property
    def fsdp_layers_to_wrap(self) -> list[str]:
        return ["MambaBlock"]

    @property
    def vocab_size(self) -> int:
        # the dummy-data vocab of the reference; the embedding table is VOCAB = 50280
        return 50265

    @property
    def sequence_length(self) -> int:
        return 4096
