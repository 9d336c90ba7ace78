"""Mamba-2's chunked scan (SSD: Dao & Gu 2024, arXiv:2405.21060) on a
hand-written CUDA kernel pair (``csrc/ssd.cu``, built on first use by
``ops/_build.py``) between cuBLAS products.

``ssd(x, dt, A, B, C, D, chunk=256)`` is, per head h of group g(h),

    state_t = exp(dt_t A_h) state_{t-1} + dt_t x_t (outer) B_t,g    ([P, N])
    y_t     = state_t C_t,g + D_h x_t

for x [B, L, H, P] in the compute dtype (a view whose rows lie further
apart is read where it lies), dt [B, L, H] after its softplus, A and D [H]
in f32, B and C [B, L, G, N]; y [B, L, H, P] in x's dtype, contiguous. The
forward and the backward are ``torch.library`` custom ops,
``mlpt::ssd_fwd`` (y and the state entering each chunk) and
``mlpt::ssd_bwd`` (dx, ddt, dA, dB, dC, dD), so that the FLOP counter counts
them (``benchmarking/flops.py``). ``ssd`` runs the forward op in the span
``ssd.forward`` (a layer's replay under remat included) and its autograd
rule runs the backward op in ``ssd.backward`` (``tracing.py``).

Which version an op runs is decided by where the tensors lie, and nothing
else: CUDA tensors launch the kernels or raise, CPU tensors run the plain
versions, ``ssd_fwd_reference`` and ``ssd_bwd_reference``. The plain
forward is the paper's Listing 1 written out in f32 (the decay mask of each
chunk materialised); the plain backward is its gradient written out term by
term, the same decomposition the card's path computes. The result does not
depend on ``chunk`` beyond rounding.

On the card the decomposition is state-spaces/mamba's ``ssd_combined.py``:

1. the cumulative ``dt A`` within each chunk (f32, PyTorch);
2. each chunk's own final state, ``(x * exp(A_end - A_s) dt)^T B`` (cuBLAS,
   bf16 operands, f32 out);
3. the states passed from chunk to chunk (``ssd_state_fwd_kernel``: f32 in
   registers, one multiply-add a chunk, each entering state stored in bf16);
4. ``C B^T`` once a chunk and group (cuBLAS, f32 out);
5. the chunk scan: ``ssd_fwd_kernel`` computes the decay-masked intra-chunk
   product, ``exp(A_t) C_t state`` and the D skip in one pass, with
   tensor-core products (``mma.sync`` m16n8k16, bf16 operands, f32
   accumulators) and the mask made in registers.

The backward runs the same steps in reverse around ``ssd_bwd_kernel``,
which yields dx (the intra-chunk product's, the D skip's and the chunk
states' terms), ``d(C B^T)`` summed over the heads of a group, and the
partials of ddt and of the cumulative decay; the other gradients are
cuBLAS products and f32 sums. No [B, H, chunks, Q, Q] tensor exists on the
card. ``SSD_FWD_LAUNCHES`` and ``SSD_BWD_LAUNCHES`` count the kernels'
launches.

The kernels take bf16 x and B, C, a head dim of 64, N a multiple of 16 up
to 128, and chunks of a multiple of 32 up to 256; there is no fallback
from a kernel to a plain version. They replace no TPU kernel: the JAX
package has no Mamba-2. At granite-4.0-h-micro's micro-batch (8 x 16,384
tokens, 64 heads of 64, N 128) a forward call moves about 2.25 GB (x and y
in bf16 plus B, C and dt): its bound is 0.67 ms of bytes, above its 0.42
TFLOP of products (``bench_port/yardstick/bounds_ssd.py``).
"""

import torch
import torch.nn.functional as F

from ..tracing import span
from . import _build

HEAD_DIM = 64  # the kernels' P
MAX_STATE = 128  # the kernels' largest N
MAX_CHUNK = 256  # the kernels' largest chunk
TILE = 32  # rows of a kernel block's tile: a chunk is a multiple of it
VEC_MULTIPLE = 8  # x's strides in elements, for the kernels' 16-byte loads

# Kernel launches in this process, counted by the wrappers right where they
# launch; plain-version calls do not count.
SSD_FWD_LAUNCHES = 0
SSD_BWD_LAUNCHES = 0


def reset_launch_counts() -> None:
    global SSD_FWD_LAUNCHES, SSD_BWD_LAUNCHES
    SSD_FWD_LAUNCHES = SSD_BWD_LAUNCHES = 0


# ---------------------------------------------------------------- plain versions


def segsum(a: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = a[..., j+1] + ... + a[..., i] for j <= i, -inf above
    the diagonal: the paper's stable segment sum (Listing 1)."""
    T = a.shape[-1]
    x = a[..., None].expand(*a.shape, T).masked_fill(~torch.ones(T, T, dtype=torch.bool, device=a.device).tril(-1), 0)
    return torch.cumsum(x, dim=-2).masked_fill(~torch.ones(T, T, dtype=torch.bool, device=a.device).tril(0),
                                                float("-inf"))


def _chunked(x, dt, A, B, C, chunk):
    """f32 operands in chunks, heads made explicit: X, B, C [b, c, Q, H, .]
    (B and C repeated over their groups' heads), dt [b, c, Q, H] and the
    log decay a = dt A [b, H, c, Q]; zero rows pad the last chunk."""
    b, L, H, P = x.shape
    rep = H // B.shape[2]
    nc = -(-L // chunk)
    pad = nc * chunk - L

    def rows(t):
        return F.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad)).unflatten(1, (nc, chunk))

    xf, dtf = rows(x), rows(dt)
    Bf, Cf = (rows(t.repeat_interleave(rep, dim=2)) for t in (B, C))
    a = (dtf * A.float()).permute(0, 3, 1, 2)
    return xf, dtf, Bf, Cf, a


def ssd_fwd_reference(x, dt, A, B, C, D, chunk: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward op: Listing 1 in f32 with X = x dt and
    the D skip. Returns (y in x's dtype [B, L, H, P], the state entering each
    chunk [B, chunks, H, P, N] in x's dtype)."""
    b, L, H, P = x.shape
    xf, dtf, Bf, Cf, a = _chunked(x, dt, A, B, C, chunk)
    X = xf * dtf[..., None]
    acs = torch.cumsum(a, dim=-1)
    # 1. the output of each chunk on its own (the diagonal blocks)
    Lm = torch.exp(segsum(a))
    y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", Cf, Bf, Lm, X)
    # 2. each chunk's own final state
    decay_states = torch.exp(acs[..., -1:] - acs)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bf, decay_states, X)
    # 3. the recurrence between chunks
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(acs[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    # 4. each chunk's entering state to its outputs
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Cf, states, torch.exp(acs))
    y = (y_diag + y_off).flatten(1, 2)[:, :L] + D.float()[:, None] * x.float()
    return y.to(x.dtype).contiguous(), states.to(x.dtype).contiguous()


def ssd_bwd_reference(x, dt, A, B, C, D, states, dy, chunk: int = 256):
    """Plain version of the backward op, the gradient of
    ``ssd_fwd_reference`` written out in f32 term by term: the D skip; the
    entering states' outputs (``exp(A_t) C_t state``); the states' backward
    from chunk to chunk; each chunk's own state (``exp(A_end - A_s) dt_s x_s
    B_s``); the intra-chunk product ``(C B^T * L * dt) x``; then the
    cumulative decay's gradient summed back to each step's ``dt A``. The
    entering states are read as saved (in x's dtype). Returns (dx, ddt, dA,
    dB, dC, dD) in the dtypes of x, dt, A, B, C and D."""
    b, L, H, P = x.shape
    G = B.shape[2]
    nc = -(-L // chunk)
    xf, dtf, Bf, Cf, a = _chunked(x, dt, A, B, C, chunk)
    dyf = F.pad(dy.float(), (0, 0, 0, 0, 0, nc * chunk - L)).unflatten(1, (nc, chunk))
    Hs = states.float()
    acs = torch.cumsum(a, dim=-1)
    dtc = dtf.permute(0, 3, 1, 2)  # [b, H, c, Q]
    # the D skip
    dD = torch.einsum("blhp,blhp->h", dy.float(), x.float())
    dx = D.float()[:, None] * dyf
    # the entering states' outputs: y_off[t] = exp(acs_t) C_t . state
    dys = dyf * torch.exp(acs).permute(0, 2, 3, 1)[..., None]
    dC = torch.einsum("bclhp,bchpn->bclhn", dys, Hs)
    dHs = torch.einsum("bclhp,bclhn->bchpn", dys, Cf)
    dacs = torch.einsum("bclhn,bclhn->bhcl", dC, Cf)
    # the states from chunk to chunk: state_{c+1} = exp(T_c) state_c + S_c
    T = acs[..., -1]
    dS, dT = torch.empty_like(Hs), torch.empty_like(T)
    g = torch.zeros_like(Hs[:, 0])
    for c in reversed(range(nc)):
        dS[:, c] = g
        dT[..., c] = torch.exp(T[..., c]) * (g * Hs[:, c]).sum((-1, -2))
        g = dHs[:, c] + torch.exp(T[..., c])[..., None, None] * g
    # each chunk's own state: S_c = sum_s B_s w_s x_s, w_s = exp(T - acs_s) dt_s
    e_end = torch.exp(acs[..., -1:] - acs)
    w = e_end * dtc
    Z = torch.einsum("bcshn,bchpn->bcshp", Bf, dS)
    xz = torch.einsum("bcshp,bcshp->bhcs", xf, Z)
    dx = dx + w.permute(0, 2, 3, 1)[..., None] * Z
    dB = torch.einsum("bcshp,bchpn->bcshn", xf * w.permute(0, 2, 3, 1)[..., None], dS)
    ddt = e_end * xz
    dacs = dacs - w * xz
    dT = dT + (w * xz).sum(-1)
    # the intra-chunk product: y_diag[t] = sum_{s <= t} CB[t, s] L[t, s] dt_s x_s
    Lm = torch.exp(segsum(a))  # [b, H, c, t, s]
    CB = torch.einsum("bclhn,bcshn->bhcls", Cf, Bf)
    Gm = torch.einsum("bclhp,bcshp->bhcls", dyf, xf)
    M = CB * Lm * dtc[..., None, :]
    dx = dx + torch.einsum("bhcls,bclhp->bcshp", M, dyf)
    dCB = Gm * Lm * dtc[..., None, :]
    ddt = ddt + (Gm * Lm * CB).sum(-2)
    W = Gm * M
    dacs = dacs + W.sum(-1) - W.sum(-2)
    dC = dC + torch.einsum("bhcls,bcshn->bclhn", dCB, Bf)
    dB = dB + torch.einsum("bhcls,bclhn->bcshn", dCB, Cf)
    # the cumulative decay back to each step's log decay a = dt A
    dacs[..., -1] += dT
    da = torch.flip(torch.cumsum(torch.flip(dacs, (-1,)), -1), (-1,))
    ddt = ddt + da * A.float()[:, None, None]
    dA = (da * dtc).sum((0, 2, 3))

    def steps(t):  # [b, c, Q, ...] -> [b, L, ...]
        return t.flatten(1, 2)[:, :L]

    def groups(t):  # [b, c, Q, H, N] -> [b, L, G, N], summed over each group's heads
        return steps(t).unflatten(2, (G, H // G)).sum(3)

    grads = (steps(dx).to(x.dtype), ddt.permute(0, 2, 3, 1).flatten(1, 2)[:, :L].to(dt.dtype), dA.to(A.dtype),
             groups(dB).to(B.dtype), groups(dC).to(C.dtype), dD.to(D.dtype))
    return tuple(g.contiguous() for g in grads)


# ---------------------------------------------------------------- kernels


def _check(x, dt, A, B, C, D, chunk: int) -> None:
    if x.device.type != "cuda" or any(t.device != x.device for t in (dt, A, B, C, D)):
        raise ValueError(f"the ssd kernels take CUDA tensors on one device, got x on {x.device}")
    if x.ndim != 4 or 0 in x.shape or x.shape[-1] != HEAD_DIM:
        raise ValueError(f"the ssd kernels take a non-empty x [B, L, H, {HEAD_DIM}], got {tuple(x.shape)}")
    b, L, H, _ = x.shape
    if B.ndim != 4 or B.shape != C.shape or B.shape[:2] != (b, L) or H % B.shape[2]:
        raise ValueError(f"B and C must be [{b}, {L}, G, N] with G dividing {H}, got {tuple(B.shape)} and "
                         f"{tuple(C.shape)}")
    N = B.shape[-1]
    if N % 16 or N > MAX_STATE:
        raise ValueError(f"the ssd kernels take N a multiple of 16 up to {MAX_STATE}, got {N}")
    if chunk % TILE or not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"the ssd kernels take a chunk that is a multiple of {TILE} up to {MAX_CHUNK}, got {chunk}")
    if x.dtype != torch.bfloat16 or B.dtype != torch.bfloat16 or C.dtype != torch.bfloat16:
        raise ValueError(f"the ssd kernels take bf16 x, B and C, got {x.dtype}, {B.dtype} and {C.dtype}")
    if dt.shape != (b, L, H) or A.shape != (H,) or D.shape != (H,):
        raise ValueError(f"dt must be [{b}, {L}, {H}] and A, D [{H}], got {tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(D.shape)}")


def _x_view(x: torch.Tensor) -> torch.Tensor:
    """x with heads P apart and channels contiguous, its rows and batches on
    whole 16-byte pieces: a view as given, else a copy."""
    b, L, H, P = x.shape
    ok = (x.stride(3) == 1 and x.stride(2) == P and x.stride(1) % VEC_MULTIPLE == 0
          and x.stride(0) % VEC_MULTIPLE == 0 and x.data_ptr() % 16 == 0)
    return x if ok else x.contiguous()


class _Setup:
    """What the forward and the backward both compute in PyTorch: the
    chunked dt and its cumulative log decay (f32 [b, H, Lp]), each chunk's
    end decay, B and C padded and grouped [b * chunks * G, Q, N]."""

    def __init__(self, x, dt, A, B, C, chunk):
        b, L, H, P = x.shape
        self.b, self.L, self.H, self.P = b, L, H, P
        self.G, self.N = B.shape[2], B.shape[3]
        self.hg = H // self.G
        self.Q, self.nc = chunk, -(-L // chunk)
        self.Lp = self.nc * chunk
        self.dt = F.pad(dt.float().transpose(1, 2), (0, self.Lp - L)).contiguous()  # [b, H, Lp]
        self.acs = (self.dt.view(b, H, self.nc, chunk) * A.float()[:, None, None]).cumsum(-1).view(b, H, self.Lp)
        q = self.acs.view(b, H, self.nc, chunk)
        self.e_end = torch.exp(q[..., -1:] - q).view(b, H, self.Lp)  # exp(A_end - A_s)
        self.decay = torch.exp(q[..., -1]).transpose(1, 2).contiguous()  # [b, c, H]: exp(T_c)
        self.B, self.C = self.grouped(B), self.grouped(C)

    def grouped(self, t: torch.Tensor) -> torch.Tensor:
        """[b, L, G, n] -> contiguous [b * chunks * G, Q, n], zero rows past L."""
        t = F.pad(t, (0, 0, 0, 0, 0, self.Lp - self.L)).view(self.b, self.nc, self.Q, self.G, t.shape[-1])
        return t.transpose(2, 3).reshape(-1, self.Q, t.shape[-1])

    def by_group(self, t: torch.Tensor) -> torch.Tensor:
        """[b, Lp, H, P] -> [b * chunks * G, Q, hg * P] (a view at one group)."""
        t = t.view(self.b, self.nc, self.Q, self.G, self.hg * self.P).transpose(2, 3)
        return t.reshape(-1, self.Q, self.hg * self.P)

    def states(self, x: torch.Tensor) -> torch.Tensor:
        """Each chunk's own final state, f32 [b, chunks, H, P, N]."""
        xw = _launch_scale(x, self.e_end * self.dt, self.Lp)
        return _bmm(self.by_group(xw).transpose(1, 2), self.B).view(self.b, self.nc, self.H, self.P, self.N)


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.bmm(a, b, out_dtype=torch.float32)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_scale(x: torch.Tensor, scale: torch.Tensor, Lp: int) -> torch.Tensor:
    """``ssd_scale_kernel``: x [B, L, H, P] (rows as ``_x_view`` takes them)
    times scale [B, H, Lp] in f32, rounded once to bf16: [B, Lp, H, P],
    zero rows past L."""
    b, L, H, P = x.shape
    out = torch.empty(b, Lp, H, P, dtype=x.dtype, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.mlpt_ssd_scale(x.data_ptr(), x.stride(0), x.stride(1), scale.data_ptr(), out.data_ptr(), b, L, Lp,
                                 H, _stream(x))
    _build.check(lib, err, "ssd scale kernel")
    return out


def _launch_state_fwd(S: torch.Tensor, decay: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``ssd_state_fwd_kernel``: the state entering each chunk, [B, chunks,
    H, P, N] in ``dtype``, from each chunk's own final state S (f32, same
    shape) and exp(T_c) [B, chunks, H]."""
    b, nc, H, P, N = S.shape
    hs = torch.empty(b, nc, H, P, N, dtype=dtype, device=S.device)
    lib = _build.load()
    with torch.cuda.device(S.device):
        err = lib.mlpt_ssd_state_fwd(S.data_ptr(), decay.data_ptr(), hs.data_ptr(), b, nc, H, P * N, _stream(S))
    _build.check(lib, err, "ssd state forward kernel")
    return hs


def _launch_state_bwd(dstate: torch.Tensor, hs: torch.Tensor, decay: torch.Tensor) -> tuple[torch.Tensor,
                                                                                              torch.Tensor]:
    """``ssd_state_bwd_kernel``: (dS, the gradient of each chunk's own
    final state in hs's dtype, and dT [B, chunks, H] f32, the gradient of
    each chunk's log decay through the states), from the gradient of each
    entering state through the chunk's outputs (f32)."""
    b, nc, H, P, N = dstate.shape
    dS = torch.empty_like(hs)
    lib = _build.load()
    parts = torch.empty(b, nc, H, lib.mlpt_ssd_state_bwd_parts(P * N), dtype=torch.float32, device=hs.device)
    with torch.cuda.device(hs.device):
        err = lib.mlpt_ssd_state_bwd(dstate.data_ptr(), hs.data_ptr(), decay.data_ptr(), dS.data_ptr(),
                                     parts.data_ptr(), b, nc, H, P * N, _stream(hs))
    _build.check(lib, err, "ssd state backward kernel")
    return dS, parts.sum(-1)


def _launch_fwd(x, s: _Setup, cb, hs, D) -> torch.Tensor:
    """``ssd_fwd_kernel``: y contiguous [B, L, H, P]."""
    global SSD_FWD_LAUNCHES
    y = torch.empty(s.b, s.L, s.H, s.P, dtype=x.dtype, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.mlpt_ssd_fwd(x.data_ptr(), x.stride(0), x.stride(1), s.C.data_ptr(), s.dt.data_ptr(),
                               s.acs.data_ptr(), cb.data_ptr(), hs.data_ptr(), D.data_ptr(), y.data_ptr(), s.b, s.L,
                               s.H, s.G, s.N, s.Q, _stream(x))
    _build.check(lib, err, "ssd forward kernel")
    SSD_FWD_LAUNCHES += 1
    return y


def _launch_bwd(x, dy, z, yi, s: _Setup, cbt, D):
    """``ssd_bwd_kernel``: (dx contiguous [B, L, H, P], d(C B^T)^T like
    ``cbt``, u, xz and ai f32 [B, H, Lp], the column sums [Q / TILE, B, H,
    Lp], the warps' dD partials [B, chunks, Q / TILE, H, 8])."""
    global SSD_BWD_LAUNCHES
    dev = x.device
    ntile = s.Q // TILE
    dx = torch.empty(s.b, s.L, s.H, s.P, dtype=x.dtype, device=dev)
    dcbt = torch.empty_like(cbt)
    u = torch.empty(s.b, s.H, s.Lp, dtype=torch.float32, device=dev)
    xz, ai = torch.empty_like(u), torch.empty_like(u)
    col = torch.empty(ntile, s.b, s.H, s.Lp, dtype=torch.float32, device=dev)
    dd = torch.empty(s.b, s.nc, ntile, s.H, 8, dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.mlpt_ssd_bwd(x.data_ptr(), x.stride(0), x.stride(1), dy.data_ptr(), z.data_ptr(), yi.data_ptr(),
                               s.dt.data_ptr(), s.acs.data_ptr(), cbt.data_ptr(), D.data_ptr(), dx.data_ptr(),
                               dcbt.data_ptr(), u.data_ptr(), xz.data_ptr(), ai.data_ptr(), col.data_ptr(),
                               dd.data_ptr(), s.b, s.L, s.H, s.G, s.Q, _stream(x))
    _build.check(lib, err, "ssd backward kernel")
    SSD_BWD_LAUNCHES += 1
    return dx, dcbt, u, xz, ai, col, dd


def ssd_fwd_cuda(x, dt, A, B, C, D, chunk: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """Steps 1-4 (PyTorch, cuBLAS and ``ssd_state_fwd_kernel``), then
    ``ssd_fwd_kernel``: (y contiguous [B, L, H, P], the bf16 state entering
    each chunk)."""
    _check(x, dt, A, B, C, D, chunk)
    x = _x_view(x)
    s = _Setup(x, dt, A, B, C, chunk)
    cb = _bmm(s.C, s.B.transpose(1, 2))  # [b * chunks * G, t, s]
    hs = _launch_state_fwd(s.states(x), s.decay, x.dtype)
    return _launch_fwd(x, s, cb, hs, D.float().contiguous()), hs


def ssd_bwd_cuda(x, dt, A, B, C, D, states, dy, chunk: int = 256):
    """The backward in reverse order: the entering states' outputs (cuBLAS)
    and the states' backward from chunk to chunk (``ssd_state_bwd_kernel``),
    then ``ssd_bwd_kernel``, then the products of ``d(C B^T)`` and the sums
    of the decay's partials. Returns (dx, ddt, dA, dB, dC, dD)."""
    _check(x, dt, A, B, C, D, chunk)
    x = _x_view(x)
    s = _Setup(x, dt, A, B, C, chunk)
    b, L, H, P, N, nc, Q, G = s.b, s.L, s.H, s.P, s.N, s.nc, s.Q, s.G
    dy = dy.to(x.dtype).contiguous()
    if dy.data_ptr() % 16:
        dy = dy.clone()
    states = states.contiguous()
    hs = states.view(-1, s.hg * P, N)  # [b * chunks * G, hg * P, N]
    # the entering states' outputs: C and the states through dy exp(acs)
    dys = s.by_group(_launch_scale(dy, torch.exp(s.acs), s.Lp))  # [b * chunks * G, Q, hg * P]
    dC = _bmm(dys, hs)  # [b * chunks * G, Q, N]
    dS, dT = _launch_state_bwd(_bmm(dys.transpose(1, 2), s.C).view(b, nc, H, P, N), states, s.decay)
    del dys
    dSg = dS.view(-1, s.hg * P, N)
    z = torch.bmm(s.B, dSg.transpose(1, 2))  # B . dS, [b * chunks * G, Q, hg * P]
    yi = torch.bmm(s.C, hs.transpose(1, 2))  # C . state, likewise
    cbt = _bmm(s.B, s.C.transpose(1, 2))  # [b * chunks * G, s, t]
    dx, dcbt, u, xz, ai, col, dd = _launch_bwd(x, dy, z, yi, s, cbt, D.float().contiguous())
    del z, yi, cbt
    # B and C through d(C B^T) (dcbt is its transpose) and the chunk states
    dC += _bmm(dcbt.transpose(1, 2).to(x.dtype), s.B)
    dB = _bmm(dcbt.to(x.dtype), s.C)
    del dcbt
    dB += _bmm(s.by_group(_launch_scale(x, s.e_end * s.dt, s.Lp)), dSg)
    # the cumulative decay, then each step's dt A
    w = s.e_end * s.dt
    dacs = ai + col.sum(0) - s.dt * u - w * xz
    q = dacs.view(b, H, nc, Q)
    q[..., -1] += dT.transpose(1, 2) + (w * xz).view(b, H, nc, Q).sum(-1)
    da = torch.flip(torch.cumsum(torch.flip(q, (-1,)), -1), (-1,)).view(b, H, s.Lp)
    ddt = u + s.e_end * xz + da * A.float()[:, None]
    dA = (da * s.dt).sum((0, 2))

    def ungroup(t):  # [b * chunks * G, Q, N] -> [b, L, G, N]
        return t.view(b, nc, G, Q, N).transpose(2, 3).reshape(b, s.Lp, G, N)[:, :L]

    grads = (dx, ddt.transpose(1, 2)[:, :L].to(dt.dtype), dA.to(A.dtype), ungroup(dB).to(B.dtype),
             ungroup(dC).to(C.dtype), dd.sum((0, 1, 2, 4)).to(D.dtype))
    return tuple(g.contiguous() for g in grads)


# ---------------------------------------------------------------- custom ops
#
# Each op's CUDA implementation launches a kernel, its CPU implementation is
# the plain version: the only place where the choice is made.


def _no_kernel(x: torch.Tensor, *args) -> None:
    raise ValueError(f"the ssd has no kernel for device {x.device}")


@torch.library.custom_op("mlpt::ssd_fwd", mutates_args=())
def ssd_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
            chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(y [B, L, H, P] in x's dtype, the state entering each chunk)."""
    _no_kernel(x)


@torch.library.custom_op("mlpt::ssd_bwd", mutates_args=())
def ssd_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
            states: torch.Tensor, dy: torch.Tensor, chunk: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                                                       torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, ddt, dA, dB, dC, dD), each in its input's dtype."""
    _no_kernel(x)


ssd_fwd.register_kernel("cuda")(ssd_fwd_cuda)
ssd_fwd.register_kernel("cpu")(ssd_fwd_reference)
ssd_bwd.register_kernel("cuda")(ssd_bwd_cuda)
ssd_bwd.register_kernel("cpu")(ssd_bwd_reference)


@ssd_fwd.register_fake
def _(x, dt, A, B, C, D, chunk):
    b, L, H, P = x.shape
    return x.new_empty(b, L, H, P), x.new_empty(b, -(-L // chunk), H, P, B.shape[-1])


@ssd_bwd.register_fake
def _(x, dt, A, B, C, D, states, dy, chunk):
    return (x.new_empty(x.shape), dt.new_empty(dt.shape), A.new_empty(A.shape), B.new_empty(B.shape),
            C.new_empty(C.shape), D.new_empty(D.shape))


def _setup_context(ctx, inputs, output) -> None:
    """Save the inputs (x and B, C as the views given) and the entering
    states: the backward recomputes the rest."""
    x, dt, A, B, C, D, chunk = inputs
    ctx.save_for_backward(x, dt, A, B, C, D, output[1])
    ctx.chunk = chunk


def _backward(ctx, dy, _dstates):
    with span("ssd.backward"):
        grads = ssd_bwd(*ctx.saved_tensors, dy, ctx.chunk)
    return (*grads, None)


ssd_fwd.register_autograd(_backward, setup_context=_setup_context)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
        chunk: int = 256) -> torch.Tensor:
    """y [B, L, H, P] in x's dtype (see the module docstring), in the span
    ``ssd.forward``."""
    with span("ssd.forward"):
        return ssd_fwd(x, dt, A, B, C, D, chunk)[0]
