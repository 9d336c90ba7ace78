"""Plain AI21-Jamba2-3B causal LM, after HF ``modeling_jamba.py`` and the
Jamba paper (arXiv:2403.19887) at ``use_mamba_kernels``: a token embedding,
layers of two pre-norm sublayers,

    x = x + Mixer(RMSNorm_in(x)),  x = x + MLP(RMSNorm_ff(x)),

a final RMSNorm and the LM head tied to the embedding. Layer i's mixer is
attention where ``i % attn_layer_period == attn_layer_offset``, else Mamba.

- Mamba: in_proj (u | z) -> depthwise causal conv + bias + SiLU on u ->
  x_proj (dt | B | C) -> an RMSNorm each over dt, B and C (Jamba's inner
  norms) -> dt_proj + bias, softplus -> the selective scan with the D skip
  -> times SiLU(z) -> out_proj. The scan is ``reference/mamba.py``'s, run
  over slices of ``SCAN_CHANNELS`` channels (each channel's recurrence is
  its own), so that a layer's states at 16,384 positions stay a few GB.
- Attention: q from 20 heads, k and v from one head shared by all, no
  positional encoding, causal softmax(q k^T / sqrt(head_dim)) v in f32,
  computed in blocks of ``QUERY_BLOCK`` queries, each against the keys it
  sees; then the output projection. No biases.
- MLP: W_down(SiLU(W_gate g) * W_up g), gate and up one stored matrix
  [gate | up].

Everything but the products is float32: the stream, the norms, the conv,
the gate, the softmax, as mamba_ssm's kernels keep the conv and the gate
(the measured program carries its stream in bf16). Weight names and shapes
are the program's (attention's q, k and v one matrix ``qkv``, the conv
kernel [d_conv, d_inner]), so one seeded draw (``init_spec``) starts both.
"""

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import linear, matmul, rms_norm, shifted_lm_loss
from .mamba import selective_scan

SCAN_CHANNELS = 1280  # a slice's states at 16,384 positions: 1.34 GB in f32, as mamba's whole scan at 4,096
QUERY_BLOCK = 1024  # a block's scores at 16,384 keys and 20 heads: 1.34 GB in f32
INIT_STD = 0.02  # HF JambaConfig's default initializer_range
NORMS = ("input_layernorm.weight", "pre_ff_layernorm.weight")
MLP_LEAVES = ("feed_forward.gate_up.weight", "feed_forward.down.weight")
MAMBA_LEAVES = ("mamba.in_proj.weight", "mamba.conv_weight", "mamba.conv_bias", "mamba.x_proj.weight",
                "mamba.dt_proj.weight", "mamba.dt_proj.bias", "mamba.A_log", "mamba.D", "mamba.out_proj.weight",
                "mamba.dt_layernorm.weight", "mamba.b_layernorm.weight", "mamba.c_layernorm.weight")
ATTN_LEAVES = ("self_attn.qkv.weight", "self_attn.out.weight")


def layer_kinds(cfg: dict) -> list[str]:
    period, offset = cfg["attn_layer_period"], cfg["attn_layer_offset"]
    return ["attention" if i % period == offset else "mamba" for i in range(cfg["num_hidden_layers"])]


def leaves(kind: str) -> tuple[str, ...]:
    return NORMS + (ATTN_LEAVES if kind == "attention" else MAMBA_LEAVES) + MLP_LEAVES


def init_spec(cfg: dict) -> list[tuple[str, tuple, tuple]]:
    """(name, shape, init) of every weight: HF ``JambaPreTrainedModel.
    _init_weights``: normal(0, 0.02) for the embedding, every projection and
    the conv, zero biases, norm scales 1, ``A_log`` row log(1..d_state),
    ``D`` 1."""
    dm, di, ffn, v = cfg["hidden_size"], cfg["d_inner"], cfg["intermediate_size"], cfg["vocab_size"]
    n, k, r = cfg["mamba_d_state"], cfg["mamba_d_conv"], cfg["mamba_dt_rank"]
    heads, kv_heads = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = dm // heads
    normal, one, zero = ("normal", INIT_STD), ("const", 1.0), ("const", 0.0)
    shapes = {
        "input_layernorm.weight": ((dm,), one),
        "pre_ff_layernorm.weight": ((dm,), one),
        "mamba.in_proj.weight": ((2 * di, dm), normal),
        "mamba.conv_weight": ((k, di), normal),
        "mamba.conv_bias": ((di,), zero),
        "mamba.x_proj.weight": ((r + 2 * n, di), normal),
        "mamba.dt_proj.weight": ((di, r), normal),
        "mamba.dt_proj.bias": ((di,), zero),
        "mamba.A_log": ((di, n), ("log_arange",)),
        "mamba.D": ((di,), one),
        "mamba.out_proj.weight": ((dm, di), normal),
        "mamba.dt_layernorm.weight": ((r,), one),
        "mamba.b_layernorm.weight": ((n,), one),
        "mamba.c_layernorm.weight": ((n,), one),
        "self_attn.qkv.weight": (((heads + 2 * kv_heads) * d, dm), normal),
        "self_attn.out.weight": ((dm, heads * d), normal),
        "feed_forward.gate_up.weight": ((2 * ffn, dm), normal),
        "feed_forward.down.weight": ((dm, ffn), normal),
    }
    spec = [("embedding", (v, dm), normal)]
    for i, kind in enumerate(layer_kinds(cfg)):
        spec += [(f"layers.{i}.{leaf}", *shapes[leaf]) for leaf in leaves(kind)]
    return spec + [("final_layernorm.weight", (dm,), one)]


def _mamba(h: torch.Tensor, w: dict, cfg: dict, precision: str) -> torch.Tensor:
    di, n, r, eps = cfg["d_inner"], cfg["mamba_d_state"], cfg["mamba_dt_rank"], cfg["rms_norm_eps"]
    u, z = linear(h, w["mamba.in_proj.weight"], None, precision).split(di, -1)
    k = w["mamba.conv_weight"].shape[0]
    u = F.conv1d(F.pad(u.transpose(1, 2), (k - 1, 0)), w["mamba.conv_weight"].t()[:, None, :], w["mamba.conv_bias"],
                 groups=di)
    u = F.silu(u.transpose(1, 2))
    dt, Bm, Cm = linear(u, w["mamba.x_proj.weight"], None, precision).split([r, n, n], dim=-1)
    dt = rms_norm(dt, w["mamba.dt_layernorm.weight"], eps)
    Bm = rms_norm(Bm, w["mamba.b_layernorm.weight"], eps)
    Cm = rms_norm(Cm, w["mamba.c_layernorm.weight"], eps)
    delta = F.softplus(linear(dt, w["mamba.dt_proj.weight"], w["mamba.dt_proj.bias"], precision))
    A = -torch.exp(w["mamba.A_log"])
    y = torch.cat([selective_scan(u[..., c:c + SCAN_CHANNELS], delta[..., c:c + SCAN_CHANNELS],
                                  A[c:c + SCAN_CHANNELS], Bm, Cm, w["mamba.D"][c:c + SCAN_CHANNELS])
                   for c in range(0, di, SCAN_CHANNELS)], -1)
    return linear(y * F.silu(z), w["mamba.out_proj.weight"], None, precision)


def _attention(h: torch.Tensor, w: dict, cfg: dict, precision: str) -> torch.Tensor:
    b, s, dm = h.shape
    heads, kv_heads = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = dm // heads
    q, k, v = linear(h, w["self_attn.qkv.weight"], None, precision).split([heads * d, kv_heads * d, kv_heads * d], -1)
    q = q.reshape(b, s, heads, d).transpose(1, 2)
    k, v = (t.reshape(b, s, kv_heads, d).transpose(1, 2).repeat_interleave(heads // kv_heads, 1) for t in (k, v))
    pos = torch.arange(s, device=h.device)
    out = []
    for q0 in range(0, s, QUERY_BLOCK):
        q1 = min(s, q0 + QUERY_BLOCK)  # the block's queries see keys 0 .. q1 - 1
        scores = matmul(q[:, :, q0:q1], k[:, :, :q1].transpose(-1, -2), precision) / math.sqrt(d)
        scores = scores.masked_fill(pos[q0:q1, None] < pos[None, :q1], float("-inf"))
        out.append(matmul(torch.softmax(scores, -1), v[:, :, :q1], precision))
    out = torch.cat(out, 2).transpose(1, 2).reshape(b, s, heads * d)
    return linear(out, w["self_attn.out.weight"], None, precision)


def _mlp(h: torch.Tensor, w: dict, precision: str) -> torch.Tensor:
    gate, up = linear(h, w["feed_forward.gate_up.weight"], None, precision).chunk(2, -1)
    return linear(F.silu(gate) * up, w["feed_forward.down.weight"], None, precision)


def _layer(x: torch.Tensor, w: dict, kind: str, cfg: dict, precision: str) -> torch.Tensor:
    eps = cfg["rms_norm_eps"]
    h = rms_norm(x, w["input_layernorm.weight"], eps)
    x = x + (_attention if kind == "attention" else _mamba)(h, w, cfg, precision)
    return x + _mlp(rms_norm(x, w["pre_ff_layernorm.weight"], eps), w, precision)


def loss(params: dict[str, torch.Tensor], ids: torch.Tensor, cfg: dict, precision: str) -> torch.Tensor:
    """Mean next-token loss of ids [rows, seq]. Each layer runs under
    ``checkpoint`` so that one layer's intermediates live at a time."""
    x = F.embedding(ids.long(), params["embedding"])
    for i, kind in enumerate(layer_kinds(cfg)):
        w = {leaf: params[f"layers.{i}.{leaf}"] for leaf in leaves(kind)}
        x = checkpoint(_layer, x, w, kind, cfg, precision, use_reentrant=False)
    x = rms_norm(x, params["final_layernorm.weight"], cfg["rms_norm_eps"])
    return shifted_lm_loss(x, params["embedding"].t(), ids, precision)
