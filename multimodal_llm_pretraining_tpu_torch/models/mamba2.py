"""The Mamba-2 mixer (Dao & Gu 2024, arXiv:2405.21060), as HF
``modeling_granitemoehybrid.py`` computes it (its mixer is Bamba's), a layer
of the port alone: the JAX package has no Mamba-2.

    [z | xBC | dt] = in_proj(h)                  (d_inner, d_inner + 2 G N, H)
    xBC = SiLU(causal_conv(xBC) + bias)  ->  x [L, H, P], B [L, G, N], C [L, G, N]
    dt = softplus(dt + dt_bias),  A = -exp(A_log)            (one scalar a head)
    y = SSD(x, dt, A, B, C) + D x                            (``ops/ssd.py``)
    out = out_proj(RMSNorm(y * SiLU(z)))                     (the gated norm over d_inner)

The conv with its bias and SiLU is ``ops/causal_conv.py``'s op, which reads
the xBC columns of ``in_proj``'s output uncopied and writes them contiguous;
x, B and C are views of that output, the scan's operands as they lie. dt is
softplus'd in f32 from the dt columns and the bias. The gated norm is
``ops/gate.py``'s y * SiLU(z), z read in place, rounded to the compute dtype,
then ``layers.RMSNorm`` (``ops/rmsnorm.py``'s kernel pair on the card):
HF keeps y * SiLU(z) in f32 into the norm, so this rounding is a departure.
On the card every step runs on its kernel pair; on the CPU on the plain
versions. The mixer runs in the span ``mamba.forward`` and its backward in
``mamba.backward`` (``tracing.py``), the spans of ``models/mamba.py``'s mixer,
so that one reader times both kinds of Mamba.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.causal_conv import causal_conv_silu
from ..ops.gate import gate_silu
from ..ops.ssd import ssd
from ..tracing import backward_span, span
from .layers import Dense, RMSNorm


class Mamba2Mixer(nn.Module):
    """in_proj -> conv -> SSD -> gated RMSNorm -> out_proj. Parameters, in
    leaf order: ``in_proj`` [d_inner + conv_dim + H, d_model], ``conv_weight``
    [d_conv, conv_dim] (the port's layout, HF's conv1d weight transposed),
    ``conv_bias``, ``dt_bias``, ``A_log`` and ``D`` [H], the gated norm's
    scale ``norm.weight`` [d_inner], ``out_proj`` [d_model, d_inner]; no
    projection bias."""

    def __init__(self, d_model: int, n_heads: int, head_dim: int, d_state: int, n_groups: int, d_conv: int,
                 chunk: int, eps: float, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_heads, self.head_dim, self.d_state, self.n_groups = n_heads, head_dim, d_state, n_groups
        self.d_inner = n_heads * head_dim
        self.conv_dim = self.d_inner + 2 * n_groups * d_state
        self.chunk = chunk
        self.in_proj = Dense(d_model, self.d_inner + self.conv_dim + n_heads, bias=False, dtype=dtype)
        self.conv_weight = nn.Parameter(torch.empty(d_conv, self.conv_dim))
        self.conv_bias = nn.Parameter(torch.empty(self.conv_dim))
        self.dt_bias = nn.Parameter(torch.empty(n_heads))
        self.A_log = nn.Parameter(torch.empty(n_heads))
        self.D = nn.Parameter(torch.empty(n_heads))
        self.norm = RMSNorm(self.d_inner, eps=eps, dtype=dtype)
        self.out_proj = Dense(self.d_inner, d_model, bias=False, dtype=dtype, feeds_residual=True)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        """The mixer's output [B, L, d_model] from the normalised h."""
        gn = self.n_groups * self.d_state
        with span("mamba.forward"):
            z, xbc, dt = self.in_proj(h).split([self.d_inner, self.conv_dim, self.n_heads], dim=-1)
            xbc = causal_conv_silu(xbc, self.conv_weight, self.conv_bias)
            x, B, C = xbc.split([self.d_inner, gn, gn], dim=-1)
            dt = F.softplus(dt.float() + self.dt_bias.float())
            A = -torch.exp(self.A_log.float())
            y = ssd(x.unflatten(-1, (self.n_heads, self.head_dim)), dt, A, B.unflatten(-1, (self.n_groups, -1)),
                    C.unflatten(-1, (self.n_groups, -1)), self.D.float(), self.chunk)
            out = self.out_proj(self.norm(gate_silu(y.flatten(-2), z)))
        backward_span("mamba.backward", out, h)
        return out
