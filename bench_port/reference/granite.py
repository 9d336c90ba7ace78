"""Plain IBM granite-4.0-h-micro causal LM, after HF
``modeling_granitemoehybrid.py`` and the Mamba-2 paper (Dao & Gu 2024,
arXiv:2405.21060): a token embedding times ``embedding_multiplier``, layers
of two pre-norm sublayers whose outputs enter the stream times
``residual_multiplier``,

    x = x + 0.22 Mixer(RMSNorm_in(x)),  x = x + 0.22 MLP(RMSNorm_post(x)),

a final RMSNorm and the LM head tied to the embedding, the logits divided by
``logits_scaling``. Layer i's mixer is ``layer_types[i]``.

- Mamba-2: in_proj (z | xBC | dt) -> depthwise causal conv + bias + SiLU on
  xBC -> x (heads of ``mamba_d_head``), B and C (``mamba_n_groups`` groups of
  ``mamba_d_state``) -> dt = softplus(dt + dt_bias), A = -exp(A_log) -> the
  state-space dual scan (SSD) of the paper's Listing 1 in chunks of
  ``mamba_chunk_size``, plus D x -> RMSNorm(y * SiLU(z)) over the whole
  d_inner -> out_proj. The scan runs over blocks of ``HEAD_BLOCK`` heads
  (each head's recurrence is its own), so that a block's decay masks at
  16,384 positions stay a few hundred MB.
- Attention: q from 32 heads, k and v from 8 heads each shared by 4, no
  positional encoding, causal softmax(q k^T * attention_multiplier) v in
  f32, in blocks of ``QUERY_BLOCK`` queries, each against the keys it sees;
  then the output projection. No biases.
- MLP: W_down(SiLU(W_gate g) * W_up g), gate and up one stored matrix
  [gate | up] (HF's ``input_linear`` chunked in two).

Everything but the products is float32: the stream, the norms, the conv,
the gate, the softmax and the scan (the measured program carries its stream
in bf16 and takes the scan's products from bf16 operands). Weight names and
shapes are the program's (attention's q, k and v one matrix ``qkv``, the
conv kernel [d_conv, channels]), so one seeded draw (``init_spec``) starts
both. The logits' division is applied to the final norm's output, which is
the same division since the head is linear.
"""

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import linear, matmul, rms_norm, shifted_lm_loss

HEAD_BLOCK = 16  # a block's decay masks at 16,384 steps in chunks of 256: 268 MB in f32
QUERY_BLOCK = 1024  # a block's scores at 16,384 keys and 32 heads: 2.1 GB in f32
LOSS_BLOCK = 4096  # positions a block of the LM loss: 1.6 GB of f32 logits over 100,352 rows
INIT_STD = 0.02
MAMBA_LEAVES = ("mamba.conv_weight", "mamba.conv_bias", "mamba.dt_bias", "mamba.A_log", "mamba.D",
                "mamba.in_proj.weight", "mamba.norm.weight", "mamba.out_proj.weight")  # the program's leaf order
ATTN_LEAVES = ("self_attn.qkv.weight", "self_attn.out.weight")
MLP_LEAVES = ("shared_mlp.gate_up.weight", "shared_mlp.down.weight")


def leaves(kind: str) -> tuple[str, ...]:
    mixer = ATTN_LEAVES if kind == "attention" else MAMBA_LEAVES
    return ("input_layernorm.weight", *mixer, "post_attention_layernorm.weight", *MLP_LEAVES)


def init_spec(cfg: dict) -> list[tuple[str, tuple, tuple]]:
    """(name, shape, init) of every weight: HF ``GraniteMoeHybridPreTrainedModel.
    _init_weights`` at a standard deviation of 0.02: normal for the embedding,
    every projection and the conv, zero conv bias, norm scales 1,
    ``dt_bias`` 1, ``A_log`` log(1..heads), ``D`` 1."""
    dm, ffn, v = cfg["hidden_size"], cfg["shared_intermediate_size"], cfg["vocab_size"]
    nh, hd, n, groups, k = (cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"], cfg["mamba_n_groups"],
                            cfg["mamba_d_conv"])
    di = nh * hd
    conv = di + 2 * groups * n
    heads, kv_heads = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = dm // heads
    normal, one, zero = ("normal", INIT_STD), ("const", 1.0), ("const", 0.0)
    shapes = {
        "input_layernorm.weight": ((dm,), one),
        "mamba.in_proj.weight": ((di + conv + nh, dm), normal),
        "mamba.conv_weight": ((k, conv), normal),
        "mamba.conv_bias": ((conv,), zero),
        "mamba.dt_bias": ((nh,), one),
        "mamba.A_log": ((nh,), ("log_arange",)),
        "mamba.D": ((nh,), one),
        "mamba.norm.weight": ((di,), one),
        "mamba.out_proj.weight": ((dm, di), normal),
        "self_attn.qkv.weight": (((heads + 2 * kv_heads) * d, dm), normal),
        "self_attn.out.weight": ((dm, heads * d), normal),
        "post_attention_layernorm.weight": ((dm,), one),
        "shared_mlp.gate_up.weight": ((2 * ffn, dm), normal),
        "shared_mlp.down.weight": ((dm, ffn), normal),
    }
    spec = [("embedding", (v, dm), normal)]
    for i, kind in enumerate(cfg["layer_types"]):
        spec += [(f"layers.{i}.{leaf}", *shapes[leaf]) for leaf in leaves(kind)]
    return spec + [("final_layernorm.weight", (dm,), one)]


def segsum(x: torch.Tensor) -> torch.Tensor:
    """Listing 1's stable segment sum: out[..., i, j] = x[..., j+1] + ... +
    x[..., i] below the diagonal, 0 on it, -inf above."""
    T = x.size(-1)
    x = x[..., None].repeat(*([1] * x.dim()), T)
    x = x.masked_fill(~torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device), diagonal=-1), 0)
    x_segsum = torch.cumsum(x, dim=-2)
    return x_segsum.masked_fill(~torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device), diagonal=0),
                                -torch.inf)


def ssd_minimal(X: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor, block_len: int) -> torch.Tensor:
    """Listing 1 of the paper: X [b, L, h, p] (the input times dt), A [b, L,
    h] (dt times the head's A), B and C [b, L, h, n]; Y [b, L, h, p], from a
    zero initial state. L a multiple of ``block_len``."""
    X, A, B, C = (t.unflatten(1, (-1, block_len)) for t in (X, A, B, C))
    A = A.permute(0, 3, 1, 2)
    A_cumsum = torch.cumsum(A, dim=-1)
    # 1. the diagonal blocks' outputs
    L = torch.exp(segsum(A))
    Y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", C, B, L, X)
    # 2. each chunk's state
    decay_states = torch.exp(A_cumsum[:, :, :, -1:] - A_cumsum)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", B, decay_states, X)
    # 3. the recurrence between chunks
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(A_cumsum[:, :, :, -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    # 4. the states' outputs
    Y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", C, states, torch.exp(A_cumsum))
    return (Y_diag + Y_off).flatten(1, 2)


def _mamba(h: torch.Tensor, w: dict, cfg: dict, precision: str) -> torch.Tensor:
    nh, hd, n, groups, k = (cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"], cfg["mamba_n_groups"],
                            cfg["mamba_d_conv"])
    di = nh * hd
    conv = di + 2 * groups * n
    z, xbc, dt = linear(h, w["mamba.in_proj.weight"], None, precision).split([di, conv, nh], -1)
    xbc = F.conv1d(F.pad(xbc.transpose(1, 2), (k - 1, 0)), w["mamba.conv_weight"].t()[:, None, :],
                   w["mamba.conv_bias"], groups=conv)
    x, B, C = F.silu(xbc.transpose(1, 2)).split([di, groups * n, groups * n], -1)
    dt = F.softplus(dt + w["mamba.dt_bias"])
    A = -torch.exp(w["mamba.A_log"])
    length, chunk = x.shape[1], cfg["mamba_chunk_size"]
    pad = -length % chunk

    def padded(t):  # zero steps past the end: dt 0 leaves the state as it was
        return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))

    x = x.unflatten(-1, (nh, hd))
    B, C = B.unflatten(-1, (groups, n)), C.unflatten(-1, (groups, n))
    group_of = torch.arange(nh, device=h.device) // (nh // groups)
    y = torch.cat([ssd_minimal(padded(x[:, :, hb] * dt[:, :, hb, None]), padded(dt[:, :, hb] * A[hb]),
                               padded(B[:, :, group_of[hb]]), padded(C[:, :, group_of[hb]]), chunk)
                   for hb in (slice(h0, h0 + HEAD_BLOCK) for h0 in range(0, nh, HEAD_BLOCK))], 2)[:, :length]
    y = (y + w["mamba.D"][:, None] * x).flatten(-2)
    y = rms_norm(y * F.silu(z), w["mamba.norm.weight"], cfg["rms_norm_eps"])
    return linear(y, w["mamba.out_proj.weight"], None, precision)


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
        scores = matmul(q[:, :, q0:q1], k[:, :, :q1].transpose(-1, -2), precision) * cfg["attention_multiplier"]
        scores = scores.masked_fill(pos[q0:q1, None] < pos[None, :q1], float("-inf"))
        out.append(matmul(torch.softmax(scores, -1), v[:, :, :q1], precision))
    out = torch.cat(out, 2).transpose(1, 2).reshape(b, s, heads * d)
    return linear(out, w["self_attn.out.weight"], None, precision)


def _mlp(h: torch.Tensor, w: dict, precision: str) -> torch.Tensor:
    gate, up = linear(h, w["shared_mlp.gate_up.weight"], None, precision).chunk(2, -1)
    return linear(F.silu(gate) * up, w["shared_mlp.down.weight"], None, precision)


def _layer(x: torch.Tensor, w: dict, kind: str, cfg: dict, precision: str) -> torch.Tensor:
    eps, m = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    h = rms_norm(x, w["input_layernorm.weight"], eps)
    x = x + m * (_attention if kind == "attention" else _mamba)(h, w, cfg, precision)
    return x + m * _mlp(rms_norm(x, w["post_attention_layernorm.weight"], eps), w, precision)


def loss(params: dict[str, torch.Tensor], ids: torch.Tensor, cfg: dict, precision: str) -> torch.Tensor:
    """Mean next-token loss of ids [rows, seq]. Each layer, and each block of
    ``LOSS_BLOCK`` positions of the loss, runs under ``checkpoint`` so that
    one layer's intermediates, or one block's logits, live at a time."""
    x = F.embedding(ids.long(), params["embedding"]) * cfg["embedding_multiplier"]
    for i, kind in enumerate(cfg["layer_types"]):
        w = {leaf: params[f"layers.{i}.{leaf}"] for leaf in leaves(kind)}
        x = checkpoint(_layer, x, w, kind, cfg, precision, use_reentrant=False)
    x = rms_norm(x, params["final_layernorm.weight"], cfg["rms_norm_eps"]) / cfg["logits_scaling"]
    head, n = params["embedding"].t(), ids.shape[1] - 1
    total = 0.0
    for p0 in range(0, n, LOSS_BLOCK):  # predictions from positions p0 .. p1 - 1, a block's logits at a time
        p1 = min(n, p0 + LOSS_BLOCK)
        part = checkpoint(shifted_lm_loss, x[:, p0:p1 + 1], head, ids[:, p0:p1 + 1], precision, use_reentrant=False)
        total = total + part * (p1 - p0)
    return total / n

