"""FLOPs accounting (counterpart of ``benchmarking/flops.py:18-145``).

Two counts of one example's forward and backward:

- ``analytic_flops_per_example``: the JAX package's closed forms, copied
  (dense transformer for pythia, roberta and vit; LLaVA; ViLT; ConvNeXt);
  Mamba has none (``None``), as in JAX.
- ``count_flops_per_example``: ``torch.utils.flop_counter.FlopCounterMode``
  over one micro-batch of 1 through the session's accumulate step (the
  reference's protocol, ``src/benchmarking/flops.py:9-37``). It counts what
  runs: the products (``mm``, ``addmm``, ``bmm``, convolutions, the
  backward's through ``_conv_backward_flops``), the three flash attention
  ops, the two selective-scan ops, the two causal-conv ops and the two SSD
  ops, each through the formula registered below; elementwise work counts
  nothing.

The flash formulas count the model's FLOPs for the visible (query, key)
pairs of the call, causal masking and varlen lengths included: 4·D a pair
forward (two products) and 8·D backward (the four products of the
gradient, twice the forward, as the closed form counts a backward). The
scores the backward kernels compute again are overhead, not model work,
as remat's recompute is.

The scan formulas take mamba_ssm's reference estimate for the selective
scan (``flops_selective_scan_ref``): 9·B·L·I·N forward, plus B·L·I for the
D skip when the op applies it, and twice that backward, as the closed forms
count a backward. The plain version does, a state and a step, 6 operations
and an exp forward (delta·A, its exp, (delta·u)·B, the recurrence's
multiply and add, C·h and its sum over the states): 7 against the
estimate's 9. Backward it recomputes the states (4 and the exp) and does
15 more (C·dy, the reverse recurrence's 2, the 2 of the common term, and a
product and a sum each for dA, the sums behind ddelta and du, dB and dC):
20 against the 18 counted, the recompute being overhead as the flash
backward's is. The backward op's count includes the skip's backward (du +=
D·dy and dD's product), which runs beside it in the autograd rule. The JAX
package counts mamba with XLA's cost analysis of every HLO op (elementwise
ones included), so the two packages' mamba totals differ by the
elementwise work.

The causal-conv formulas count the depthwise conv's products as PyTorch
counts a convolution: 2·K·B·L·I forward, and twice that backward (the input's
gradient and the taps'), what ``F.conv1d`` and its backward counted before
the kernels; the bias, the SiLU and its derivative count nothing.

The SSD formulas (Mamba-2's chunked scan, ``ops/ssd.py``) count the
products of the published decomposition, on chunks of Q steps: C B^T once a
chunk and group (2 Q^2 N), a head's chunk state and its entering state's
outputs (2 Q N P each a chunk), and the intra-chunk product over the causal
pairs, diagonal included (2 P Q (Q + 1) / 2 a chunk); a ragged last chunk
counts whole, as it runs. The backward counts twice the forward, as the
closed forms count a backward; the state passing between chunks and the
decay's exps count nothing.
"""

import math

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

from ..models import BaseModelClass
from ..ops import causal_conv, flash_attention, selective_scan_fused, ssd  # noqa: F401  (register the mlpt:: ops the formulas name)


def transformer_flops_per_token(
    num_layers: int,
    hidden: int,
    seq_len: int,
    vocab: int = 0,
    ffn_mult: float = 4.0,
    num_extra_proj: int = 0,
    backward: bool = True,
    remat: bool = False,
) -> float:
    """Dense-transformer FLOPs per token (fwd, or fwd+bwd when backward).

    Per layer per token: QKVO projections 8H^2, FFN 4*ffn_mult*H^2,
    attention score+value matmuls 4*S*H. LM/class head: 2*H*V.
    backward = 2x forward; full remat re-runs the block forward (+1x).
    """
    per_layer = (8 + 4 * ffn_mult) * hidden * hidden + 4 * seq_len * hidden
    fwd = num_layers * per_layer + 2 * hidden * vocab + num_extra_proj
    total = fwd * (3.0 if backward else 1.0)
    if backward and remat:
        total += num_layers * per_layer
    return total


def convnext_flops_per_example(
    depths: tuple, dims: tuple, num_classes: int, image_size: int = 224, backward: bool = True
) -> float:
    """ConvNeXt fwd(+bwd) FLOPs per image: the 4x4/s4 stem conv, stages of
    (7x7 depthwise + 1x1 C->4C + 1x1 4C->C) blocks with 2x2/s2 downsample
    convs between stages, the linear classifier. 2 FLOPs per MAC; backward
    = 2x forward (every parameter trains)."""
    res = image_size // 4
    total = 2.0 * (4 * 4 * 3) * dims[0] * res * res  # stem
    for i, (depth, c) in enumerate(zip(depths, dims)):
        if i > 0:
            res //= 2
            total += 2.0 * (2 * 2 * dims[i - 1]) * c * res * res  # downsample
        # per block: depthwise 49*C + pointwise C->4C and 4C->C (8*C^2)
        total += depth * 2.0 * res * res * c * (49 + 8 * c)
    total += 2.0 * dims[-1] * num_classes
    return total * (3.0 if backward else 1.0)


def _llama_stack_flops(seq: int, layers: int, hidden: int, ffn: int, kv_frac: float) -> float:
    """Forward FLOPs of a Llama-style stack (GQA + swiglu) over ``seq``
    tokens, no head: qkvo (4 + 4*kv_frac)H^2, ffn 6*H*F, attention 4*S*H
    per token per layer."""
    per_tok_layer = (4 + 4 * kv_frac) * hidden * hidden + 6.0 * hidden * ffn + 4.0 * seq * hidden
    return seq * layers * per_tok_layer


def llava_flops_per_example(finetune: bool, text_len: int = 512) -> float:
    """LLaVA fwd+bwd FLOPs per benchmark example (benchmark text seq 512).

    CLIP-L/336 tower (24L, H1024, 577 tokens) -> 2-layer projector ->
    Llama-3.2-1B over the merged 1087-token sequence. The frozen tower sits
    upstream of every trainable parameter, so it costs its forward only; a
    frozen transformer on the gradient path costs about one forward more
    (activation grads only), a trainable one two.

    - pretrain (projector only trainable): tower fwd + 3x projector +
      2x (LM stack + LM head)
    - finetune (projector + LM trainable, tower frozen): tower fwd +
      3x projector + 3x (LM stack + LM head)
    """
    from ..models.llama import FFN, HEADS, HIDDEN, KV_HEADS, LAYERS
    from ..models.llava import NUM_PATCHES, TOWER_HIDDEN, VOCAB_WITH_IMAGE

    s_tower = NUM_PATCHES + 1  # 577
    tower_fwd = s_tower * transformer_flops_per_token(24, TOWER_HIDDEN, s_tower, vocab=0, backward=False)
    projector_fwd = NUM_PATCHES * 2.0 * (TOWER_HIDDEN * HIDDEN + HIDDEN * HIDDEN)
    s_merged = text_len - 1 + NUM_PATCHES  # 1087
    lm_fwd = _llama_stack_flops(s_merged, LAYERS, HIDDEN, FFN, KV_HEADS / HEADS)
    lm_fwd += 2.0 * HIDDEN * VOCAB_WITH_IMAGE * s_merged  # tied lm head
    lm_mult = 3.0 if finetune else 2.0
    return tower_fwd + 3.0 * projector_fwd + lm_mult * lm_fwd


def vilt_flops_per_example(hidden: int, layers: int, ffn: int, patch: int, vocab: int, text_len: int = 512,
                           image_size: int = 224) -> float:
    """ViLT fwd+bwd FLOPs per benchmark example (3 trunk passes a step: MLM,
    ITM, WPA): each pass runs the whole trunk over [text; class + patches]
    forward and backward (3x forward, every parameter trains); the MLM
    vocabulary head runs in the MLM pass only. The text and patch
    embeddings and the IPOT loop (50 iterations of [T x P] elementwise and
    matrix-vector work) are under 1% and left out."""
    s = text_len + (image_size // patch) ** 2 + 1
    trunk_fwd = s * transformer_flops_per_token(layers, hidden, s, vocab=0, ffn_mult=ffn / hidden, backward=False)
    mlm_head_fwd = 2.0 * hidden * vocab * text_len
    return 3.0 * (3.0 * trunk_fwd) + 3.0 * mlm_head_fwd


def analytic_flops_per_example(model_class: BaseModelClass, backward: bool = True, remat: bool = False) -> float | None:
    """Closed-form fwd(+bwd) FLOPs for one example of the model's benchmark
    workload, for the families that have one (all but Mamba)."""
    mt = model_class.model_type
    if mt.startswith("pythia"):
        from ..models.pythia import PYTHIA_SIZES

        L, H, _ = PYTHIA_SIZES[mt]
        S = model_class.sequence_length  # type: ignore[attr-defined]
        return S * transformer_flops_per_token(L, H, S, vocab=model_class.vocab_size, backward=backward, remat=remat)  # type: ignore[attr-defined]
    if mt == "roberta":
        S = model_class.sequence_length  # type: ignore[attr-defined]
        return S * transformer_flops_per_token(24, 1024, S, vocab=model_class.vocab_size, backward=backward, remat=remat)  # type: ignore[attr-defined]
    if mt == "vit":
        # 224/16 -> 196 patches + cls
        S = 197
        return S * transformer_flops_per_token(24, 1024, S, vocab=21841, backward=backward, remat=remat)
    if mt.startswith("convnext"):
        from ..models.convnext import CONFIGS

        cfg = CONFIGS[mt]
        return convnext_flops_per_example(cfg["depths"], cfg["dims"], cfg["num_classes"], backward=backward)
    if mt.startswith("llava") and backward:
        return llava_flops_per_example(finetune=(mt == "llava-finetune"))
    if mt.startswith("vilt") and backward:
        if mt.startswith("vilt-original"):
            from ..models.vilt_original import _ORIGINAL_KWARGS as k

            return vilt_flops_per_example(k["hidden"], k["num_layers"], k["intermediate"], k["patch"], k["vocab_size"])
        return vilt_flops_per_example(1408, 40, 6144, 14, 128256)
    return None


# ---------------------------------------------------------------- flash formulas


def _visible_pairs(q: torch.Tensor, k: torch.Tensor, causal: bool, kv_lens: torch.Tensor | None) -> int:
    """(query, key) pairs of a [BH, S, D] call that some query row sees."""
    bh, q_seq, kv_seq = q.shape[0], q.shape[1], k.shape[1]
    lens = np.full(bh, kv_seq) if kv_lens is None else np.clip(kv_lens.cpu().numpy(), 0, kv_seq)
    if not causal:
        return int(lens.sum()) * q_seq
    return int(np.minimum(np.arange(1, q_seq + 1)[None, :], lens[:, None]).sum())


@register_flop_formula(torch.ops.mlpt.flash_fwd, get_raw=True)
def _flash_fwd_flops(q, k, v, causal, sm_scale, kv_lens=None, *args, **kwargs) -> int:
    return 4 * q.shape[-1] * _visible_pairs(q, k, causal, kv_lens)


@register_flop_formula([torch.ops.mlpt.flash_bwd, torch.ops.mlpt.flash_bwd_split], get_raw=True)
def _flash_bwd_flops(q, k, v, out, lse, dout, causal, sm_scale, kv_lens=None, *args, **kwargs) -> int:
    return 8 * q.shape[-1] * _visible_pairs(q, k, causal, kv_lens)


@register_flop_formula(torch.ops.mlpt.scan_fwd, get_raw=True)
def _scan_fwd_flops(u, delta, A, B, C, D=None, *args, **kwargs) -> int:
    bsz, L, I = u.shape
    return 9 * bsz * L * I * A.shape[-1] + (bsz * L * I if D is not None else 0)


@register_flop_formula(torch.ops.mlpt.scan_bwd, get_raw=True)
def _scan_bwd_flops(u, delta, A, B, C, dy, ckpt, *args, **kwargs) -> int:
    bsz, L, I = u.shape
    return 2 * (9 * bsz * L * I * A.shape[-1] + bsz * L * I)


@register_flop_formula(torch.ops.mlpt.causal_conv_fwd, get_raw=True)
def _causal_conv_fwd_flops(x, weight, bias, *args, **kwargs) -> int:
    return 2 * weight.shape[0] * x.numel()


@register_flop_formula(torch.ops.mlpt.causal_conv_bwd, get_raw=True)
def _causal_conv_bwd_flops(x, weight, bias, dout, *args, **kwargs) -> int:
    return 4 * weight.shape[0] * x.numel()


def ssd_products(x_shape, state_shape, chunk: int) -> int:
    """Products of one SSD forward on x [B, L, H, P] and B, C [B, L, G, N]
    in chunks of ``chunk`` steps (see the module docstring)."""
    bsz, L, H, P = x_shape
    G, N = state_shape[-2:]
    chunks = bsz * -(-L // chunk)
    return chunks * (2 * chunk * chunk * N * G + H * (4 * chunk * N * P + P * chunk * (chunk + 1)))


@register_flop_formula(torch.ops.mlpt.ssd_fwd, get_raw=True)
def _ssd_fwd_flops(x, dt, A, B, C, D, chunk, *args, **kwargs) -> int:
    return ssd_products(x.shape, B.shape, chunk)


@register_flop_formula(torch.ops.mlpt.ssd_bwd, get_raw=True)
def _ssd_bwd_flops(x, dt, A, B, C, D, states, dy, chunk, *args, **kwargs) -> int:
    return 2 * ssd_products(x.shape, B.shape, chunk)


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation, transposed,
                         _output_padding, _groups, output_mask, out_shape, **kwargs) -> int:
    """A convolution's backward: the forward's count for each gradient it
    computes (input and weight), 2 x (outputs, or inputs when transposed) x
    the weight's elements a channel, ``groups`` included. PyTorch's own
    formula counts the weight gradient of a grouped convolution as if
    ungrouped, ``groups`` times too much: for mamba's depthwise conv that is
    d_inner (5,120) times its true count, which would double mamba-2.8b's
    total."""
    per_grad = 2 * math.prod(x_shape if transposed else grad_out_shape) * math.prod(w_shape[1:])
    return per_grad * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def count_flops_per_example(model_class: BaseModelClass, device: torch.device | str = "cuda") -> float:
    """FLOPs of one example's forward and backward as they run: one
    micro-batch of 1 through the session's accumulate step (the model's
    mixed precision, the kernels on), under ``FlopCounterMode``."""
    from ..parallel.mesh import MeshConfig
    from ..train import TrainingPlan

    plan = TrainingPlan(
        num_training_steps=1,
        micro_batch_size=1,
        gradient_accumulation_steps=1,
        bf16=model_class.mixed_precision is not None,
        use_custom_kernels=True,
        optimizer=model_class.optimizer,
        optimizer_kwargs=model_class.optimizer_kwargs,
        scheduler_type=model_class.scheduler_type,
        scheduler_kwargs=model_class.scheduler_kwargs,
        max_grad_norm=model_class.max_grad_norm,
        mesh=MeshConfig(num_hosts=1, chips_per_host=1),
    )
    sess = plan.build_session(model_class, device=device)
    # the parameters only: the optimizer state plays no part, and leaving it
    # out keeps mamba-2.8b's unremat step within one card
    sess.bundle.init_fn(sess.module, torch.Generator(device=sess.device).manual_seed(0))
    batch = sess.make_micro_batch(1)
    with FlopCounterMode(display=False, custom_mapping={torch.ops.aten.convolution_backward: _conv_backward_flops}) as counter:
        sess.accumulate_fn()(None, batch)
    sess.zero_grads()
    return float(counter.get_total_flops())
