"""Plain Mamba (S6) causal LM, after the published description (Gu and
Dao 2023, state-spaces/mamba): a token embedding, residual blocks of
RMSNorm -> in_proj (u | z) -> depthwise causal conv + SiLU on u ->
x_proj (dt | B | C) -> dt_proj + softplus -> selective scan with the D skip
-> times SiLU(z) -> out_proj, a final RMSNorm and the LM head tied to the
embedding.

The scan: h_t = exp(delta_t A) h_{t-1} + delta_t B_t u_t, y_t = C_t . h_t +
D u_t, with A = -exp(A_log), computed in float32 in chunks of ``CHUNK``
steps (``linear_scan``), forward and, written out, backward. Only products
of decays in (0, 1] appear, so nothing overflows.

The residual stream is float32, as the published ``residual_in_fp32``
states (the measured program carries it in bf16). The conv kernel is
stored [d_conv, d_inner], as the program stores it. Weight names and shapes
are the program's, so one seeded draw (``init_spec``) starts both.
"""

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import linear, rms_norm, shifted_lm_loss

CHUNK = 64
LAYER_LEAVES = ("norm.weight", "in_proj.weight", "conv_weight", "conv_bias", "x_proj.weight", "dt_proj.weight",
                "dt_proj.bias", "A_log", "D", "out_proj.weight")


def init_spec(cfg: dict) -> list[tuple[str, tuple, tuple]]:
    """(name, shape, init) of every weight: mamba_ssm's initialisation
    (``Mamba.__init__`` and ``_init_weights`` with
    ``rescale_prenorm_residual``): PyTorch's default uniform for the
    projections and the conv (bound 1 / sqrt(fan_in); the conv's fan-in is
    d_conv), out_proj's divided by sqrt(n_layer), dt_proj's weight uniform
    within dt_rank^-0.5 and its bias the inverse softplus of a step drawn
    log-uniform in [0.001, 0.1], the embedding normal(0, 0.02), A_log row
    log(1..d_state), D and the norms 1."""
    dm, di, n, k, r, v = (cfg[key] for key in ("d_model", "d_inner", "d_state", "d_conv", "dt_rank",
                                               "padded_vocab_size"))

    def dense(out, inp, scale=1.0):
        return (out, inp), ("uniform", scale / math.sqrt(inp))

    shapes = {
        "norm.weight": ((dm,), ("const", 1.0)),
        "in_proj.weight": dense(2 * di, dm),
        "conv_weight": ((k, di), ("uniform", 1.0 / math.sqrt(k))),
        "conv_bias": ((di,), ("uniform", 1.0 / math.sqrt(k))),
        "x_proj.weight": dense(r + 2 * n, di),
        "dt_proj.weight": ((di, r), ("uniform", r**-0.5)),
        "dt_proj.bias": ((di,), ("inv_softplus_loguniform", 0.001, 0.1)),
        "A_log": ((di, n), ("log_arange",)),
        "D": ((di,), ("const", 1.0)),
        "out_proj.weight": dense(dm, di, 1.0 / math.sqrt(cfg["n_layer"])),
    }
    spec = [("embedding", (v, dm), ("normal", 0.02))]
    for i in range(cfg["n_layer"]):
        spec += [(f"layers.{i}.{leaf}", *shapes[leaf]) for leaf in LAYER_LEAVES]
    return spec + [("final_norm.weight", (dm,), ("const", 1.0))]


def linear_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + x_t along dim 1 from h_{-1} = 0; a, x [b, L,
    ...]. In chunks of ``CHUNK`` steps: every chunk's recurrence from a zero
    state at once, with the running product of its factors, then the state
    carried from chunk to chunk, then each step's share of it."""
    b, L = x.shape[:2]
    rest = x.shape[2:]
    pad = -L % CHUNK
    if pad:
        a = F.pad(a, (0, 0) * len(rest) + (0, pad))
        x = F.pad(x, (0, 0) * len(rest) + (0, pad))
    c = x.shape[1] // CHUNK
    a5, x5 = a.reshape(b, c, CHUNK, *rest), x.reshape(b, c, CHUNK, *rest)
    h, prod = torch.empty_like(x5), torch.empty_like(a5)
    h[:, :, 0], prod[:, :, 0] = x5[:, :, 0], a5[:, :, 0]
    for t in range(1, CHUNK):
        torch.addcmul(x5[:, :, t], a5[:, :, t], h[:, :, t - 1], out=h[:, :, t])
        torch.mul(a5[:, :, t], prod[:, :, t - 1], out=prod[:, :, t])
    carry = torch.zeros_like(h[:, :, 0])
    for j in range(1, c):
        carry[:, j] = prod[:, j - 1, -1] * carry[:, j - 1] + h[:, j - 1, -1]
    h.addcmul_(prod, carry[:, :, None])
    return h.reshape(b, c * CHUNK, *rest)[:, :L]


def _states(u, delta, A, B):
    """The states h [b, L, I, N] and the decays exp(delta A)."""
    decay = torch.exp(delta[..., None] * A)
    return linear_scan(decay, (delta * u)[..., None] * B[:, :, None, :]), decay


class _SelectiveScan(torch.autograd.Function):
    """The scan with its backward written out: the states are recomputed,
    the adjoint runs the same recurrence backwards in time (lam_t = C_t
    dy_t + exp(delta_{t+1} A) lam_{t+1}), and each input's gradient is a
    sum of products of the two. Keeps the inputs only, so one block's scan
    holds a few [L, I, N] tensors at a time."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D):
        h, _ = _states(u, delta, A, B)
        ctx.save_for_backward(u, delta, A, B, C, D)
        return torch.einsum("blin,bln->bli", h, C) + D * u

    @staticmethod
    def backward(ctx, dy):
        u, delta, A, B, C, D = ctx.saved_tensors
        h, decay = _states(u, delta, A, B)
        dC = torch.einsum("blin,bli->bln", h, dy)
        g = dy[..., None] * C[:, :, None, :]
        nxt = torch.cat([decay[:, 1:], torch.zeros_like(decay[:, :1])], 1)
        lam = linear_scan(nxt.flip(1), g.flip(1)).flip(1)
        del g, nxt
        du_drive = torch.einsum("blin,bln->bli", lam, B)  # d(delta * u)
        dB = torch.einsum("blin,bli->bln", lam, delta * u)
        prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)
        w = lam.mul_(prev).mul_(decay)  # d(delta A)
        del prev, h, decay
        ddelta = torch.einsum("blin,in->bli", w, A) + du_drive * u
        dA = torch.einsum("blin,bli->in", w, delta)
        du = du_drive * delta + D * dy
        dD = (dy * u).sum((0, 1))
        return du, ddelta, dA, dB, dC, dD


def selective_scan(u, delta, A, B, C, D):
    """y_t = C_t . h_t + D u_t, h_t = exp(delta_t A) h_{t-1} + delta_t B_t
    u_t; u, delta [b, L, I], A [I, N], B, C [b, L, N], D [I], all float32.
    Returns y [b, L, I]."""
    return _SelectiveScan.apply(u, delta, A, B, C, D)


def _block(x: torch.Tensor, w: dict, cfg: dict, precision: str) -> torch.Tensor:
    di, n, r = cfg["d_inner"], cfg["d_state"], cfg["dt_rank"]
    u, z = linear(rms_norm(x, w["norm.weight"], cfg["norm_eps"]), w["in_proj.weight"], None, precision).split(di, -1)
    k = w["conv_weight"].shape[0]
    u = F.conv1d(F.pad(u.transpose(1, 2), (k - 1, 0)), w["conv_weight"].t()[:, None, :], w["conv_bias"], groups=di)
    u = F.silu(u.transpose(1, 2))
    dt, Bm, Cm = linear(u, w["x_proj.weight"], None, precision).split([r, n, n], dim=-1)
    delta = F.softplus(linear(dt, w["dt_proj.weight"], w["dt_proj.bias"], precision))
    y = selective_scan(u, delta, -torch.exp(w["A_log"]), Bm, Cm, w["D"])
    return x + linear(y * F.silu(z), w["out_proj.weight"], None, precision)


def loss(params: dict[str, torch.Tensor], ids: torch.Tensor, cfg: dict, precision: str) -> torch.Tensor:
    """Mean next-token loss of ids [rows, seq]. Each block runs under
    ``checkpoint`` so that one block's intermediates live at a time."""
    x = F.embedding(ids.long(), params["embedding"])
    for i in range(cfg["n_layer"]):
        w = {leaf: params[f"layers.{i}.{leaf}"] for leaf in LAYER_LEAVES}
        x = checkpoint(_block, x, w, cfg, precision, use_reentrant=False)
    x = rms_norm(x, params["final_norm.weight"], cfg["norm_eps"])
    return shifted_lm_loss(x, params["embedding"].t(), ids, precision)
