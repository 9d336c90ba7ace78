"""Plain GPT-NeoX (pythia) causal LM, after the published description
(EleutherAI/gpt-neox; Biderman et al. 2023): a token embedding, blocks of
parallel attention and MLP residual branches, each behind its own
LayerNorm, rotary position embedding on the first quarter of each head's
dims, a final LayerNorm and an untied output head.

The MLP's GELU is the form the configuration's ``hidden_act`` names: the
exact one for "gelu", the tanh form for "gelu_new" (pythia-1b's file, the
form the measured program computes). Departures from the published model, each
one the measured program's: the q, k and v projections are
one product laid out [q | k | v], each head-major; the output head is
stored [hidden, vocab]; every sequence position, all 2049 of a row, is
computed, and the loss predicts each next token. Weight names and shapes
are the program's, so one seeded draw (``init_spec``) starts both.
"""

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

GELU = {"gelu": "none", "gelu_new": "tanh"}  # hidden_act -> F.gelu's approximate: the exact form, the tanh form

from .common import layer_norm, linear, matmul, shifted_lm_loss

LAYER_LEAVES = ("ln_attn.weight", "ln_attn.bias", "attn.qkv.weight", "attn.qkv.bias", "attn.out.weight",
                "attn.out.bias", "ln_mlp.weight", "ln_mlp.bias", "mlp.up.weight", "mlp.up.bias", "mlp.down.weight",
                "mlp.down.bias")


def init_spec(cfg: dict) -> list[tuple[str, tuple, tuple]]:
    """(name, shape, init) of every weight, named as the program names it: Dense
    weights normal with std sqrt(1 / fan_in), the embedding normal with std
    sqrt(1 / hidden), LayerNorm scales 1, biases 0."""
    h, v, f = cfg["hidden_size"], cfg["vocab_size"], cfg["intermediate_size"]

    def dense(out, inp):
        return (out, inp), ("normal", math.sqrt(1.0 / inp))

    spec = [("embed_in.weight", (v, h), ("normal", math.sqrt(1.0 / h)))]
    shapes = {
        "ln_attn.weight": ((h,), ("const", 1.0)), "ln_attn.bias": ((h,), ("const", 0.0)),
        "attn.qkv.weight": dense(3 * h, h), "attn.qkv.bias": ((3 * h,), ("const", 0.0)),
        "attn.out.weight": dense(h, h), "attn.out.bias": ((h,), ("const", 0.0)),
        "ln_mlp.weight": ((h,), ("const", 1.0)), "ln_mlp.bias": ((h,), ("const", 0.0)),
        "mlp.up.weight": dense(f, h), "mlp.up.bias": ((f,), ("const", 0.0)),
        "mlp.down.weight": dense(h, f), "mlp.down.bias": ((h,), ("const", 0.0)),
    }
    for i in range(cfg["num_hidden_layers"]):
        spec += [(f"layers.{i}.{leaf}", *shapes[leaf]) for leaf in LAYER_LEAVES]
    spec += [("final_ln.weight", (h,), ("const", 1.0)), ("final_ln.bias", (h,), ("const", 0.0)),
             ("embed_out", (h, v), ("normal", math.sqrt(1.0 / h)))]
    return spec


def _rotary(x: torch.Tensor, rot: int, base: float) -> torch.Tensor:
    """Rotate-half rotary embedding on the first ``rot`` dims of x [B, H, S, D]."""
    s = x.shape[2]
    inv = 1.0 / (base ** (torch.arange(0, rot, 2, dtype=torch.float32, device=x.device) / rot))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2, rest = x[..., : rot // 2], x[..., rot // 2 : rot], x[..., rot:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, rest], dim=-1)


def _block(x: torch.Tensor, w: dict, cfg: dict, precision: str) -> torch.Tensor:
    b, s, h = x.shape
    nh = cfg["num_attention_heads"]
    d = h // nh
    eps = cfg["layer_norm_eps"]
    a = layer_norm(x, w["ln_attn.weight"], w["ln_attn.bias"], eps)
    q, k, v = linear(a, w["attn.qkv.weight"], w["attn.qkv.bias"], precision).split(h, dim=-1)
    q, k, v = (t.reshape(b, s, nh, d).transpose(1, 2) for t in (q, k, v))
    rot = int(d * cfg["rotary_pct"])
    q, k = _rotary(q, rot, cfg["rotary_emb_base"]), _rotary(k, rot, cfg["rotary_emb_base"])
    scores = matmul(q * (1.0 / math.sqrt(d)), k.transpose(-1, -2), precision)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    att = matmul(probs, v, precision).transpose(1, 2).reshape(b, s, h)
    att = linear(att, w["attn.out.weight"], w["attn.out.bias"], precision)
    m = layer_norm(x, w["ln_mlp.weight"], w["ln_mlp.bias"], eps)
    m = F.gelu(linear(m, w["mlp.up.weight"], w["mlp.up.bias"], precision), approximate=GELU[cfg["hidden_act"]])
    m = linear(m, w["mlp.down.weight"], w["mlp.down.bias"], precision)
    return x + att + m


def loss(params: dict[str, torch.Tensor], ids: torch.Tensor, cfg: dict, precision: str) -> torch.Tensor:
    """Mean next-token loss of ids [rows, seq]. Each block runs under
    ``checkpoint`` so that one block's intermediates live at a time."""
    x = F.embedding(ids.long(), params["embed_in.weight"])
    for i in range(cfg["num_hidden_layers"]):
        w = {leaf: params[f"layers.{i}.{leaf}"] for leaf in LAYER_LEAVES}
        x = checkpoint(_block, x, w, cfg, precision, use_reentrant=False)
    x = layer_norm(x, params["final_ln.weight"], params["final_ln.bias"], cfg["layer_norm_eps"])
    return shifted_lm_loss(x, params["embed_out"], ids, precision)
