"""IBM granite-4.0-h-micro in the PyTorch port (``models/granite.py``,
``models/mamba2.py``, ``ops/ssd.py``), a model the JAX package does not
have: held to the benchmark's plain reference (``bench_port/reference/
granite.py``) on one seeded draw of its weights and tokens
(``bench_port/yardstick``'s ``make_weights`` and ``token_batch``), at a tiny
size on the CPU: d_model 64, 4 Mamba-2 heads of 16 with d_state 16 and
chunks of 32, 4 query heads of 16 and 2 KV heads, MLP 128, vocab 256, 64
tokens, and the published layer pattern (attention every 10 layers from
layer 5) cut to 4 layers with attention at layer 2. The kernels run their
plain versions here; the SSD's card path runs with its kernels emulated.

These tests depend on the reference, and a change to it changes what they
hold the port to.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_llm_pretraining_tpu.models import MODEL_TYPES as JAX_MODEL_TYPES
from multimodal_llm_pretraining_tpu_torch import benchmark as cli
from multimodal_llm_pretraining_tpu_torch.models import MODEL_TYPES, PORT_ONLY_MODEL_TYPES, get_model_class
from multimodal_llm_pretraining_tpu_torch.models import granite as tgranite
from multimodal_llm_pretraining_tpu_torch.models import layers as tlayers
from multimodal_llm_pretraining_tpu_torch.models.granite import GraniteLM
from multimodal_llm_pretraining_tpu_torch.models.mamba2 import Mamba2Mixer
from multimodal_llm_pretraining_tpu_torch.ops import ssd
from multimodal_llm_pretraining_tpu_torch.profile_step import make_plan

torch.set_num_threads(2)

TYPES = ("mamba", "mamba", "attention", "mamba")
CFG = {"hidden_size": 64, "shared_intermediate_size": 128, "vocab_size": 256, "mamba_n_heads": 4, "mamba_d_head": 16,
       "mamba_d_state": 16, "mamba_n_groups": 1, "mamba_d_conv": 4, "mamba_chunk_size": 32, "num_attention_heads": 4,
       "num_key_value_heads": 2, "layer_types": list(TYPES), "rms_norm_eps": 1e-5, "attention_multiplier": 1 / 64,
       "embedding_multiplier": 12, "residual_multiplier": 0.22, "logits_scaling": 8}
NARROW = dict(D_MODEL=64, LAYER_TYPES=TYPES, NUM_HEADS=4, NUM_KV_HEADS=2, HEAD_DIM=16, MAMBA_HEADS=4,
              MAMBA_HEAD_DIM=16, D_STATE=16, CHUNK=32, INTERMEDIATE=128, VOCAB=256)
SEQ, SEED = 64, 21
# the published configuration's leaves (see the module docstring of models/granite.py)
MAMBA_MIXER, ATTENTION_MIXER, MLP, EMBEDDING = 25_847_232, 10_485_760, 50_331_648, 205_520_896


def _tiny(dtype=torch.float32, **kw) -> GraniteLM:
    return GraniteLM(64, TYPES, 4, 2, 16, 4, 16, 16, 1, 4, 32, 128, 256, dtype=dtype, **kw)


@pytest.fixture(scope="module")
def draw():
    """One seeded draw of the benchmark's weights and tokens, and the plain
    reference's loss and gradients with f32, bf16 and fp8 products."""
    from bench_port.reference import common
    from bench_port.reference import granite as ref_granite
    from bench_port.yardstick import data, weights

    w = weights.make_weights(ref_granite.init_spec(CFG), SEED, "cpu", torch.float32)
    ids = torch.from_numpy(data.token_batch(SEED, 0, 2, SEQ, 256)).long()
    out = {"weights": w, "ids": ids}
    with common.no_tf32():
        for precision in ("f32", "bf16", "fp8"):
            params = {n: t.clone().requires_grad_() for n, t in w.items()}
            loss = ref_granite.loss(params, ids, CFG, precision)
            loss.backward()
            out[precision] = (float(loss.detach()), {n: p.grad for n, p in params.items()})
    return out


def _port_on(draw, dtype, model: GraniteLM | None = None):
    model = model or _tiny(dtype)
    model.load_state_dict(draw["weights"])
    ids = draw["ids"]
    loss = model(ids, labels=ids)
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}


def _grad_gap(got: dict, want: dict) -> float:
    """All leaves together: |got - want| / |want|."""
    num = sum(float((got[n] - want[n]).square().sum()) for n in want)
    return math.sqrt(num / sum(float(want[n].square().sum()) for n in want))


def test_leaves_are_the_references():
    """The same names, shapes and order as the reference's draw."""
    from bench_port.reference import granite as ref_granite

    assert [(n, tuple(p.shape)) for n, p in _tiny().named_parameters()] == [
        (n, shape) for n, shape, _ in ref_granite.init_spec(CFG)]


def test_matches_the_plain_reference_f32(draw):
    """At f32 compute the port equals the reference up to f32 summation order
    (the SSD's decomposition against the reference's Listing 1, the
    products' blocking, flash's online softmax): the loss to 1e-6 relative,
    all leaves together to 1e-6, every leaf to 3e-4 of its norm (A_log's
    gradient, sum of da dt over the steps of each head, cancels most: 7.9e-5
    at this draw, the others under 1e-6)."""
    want_l, want_g = draw["f32"]
    got_l, got_g = _port_on(draw, torch.float32)
    assert got_l == pytest.approx(want_l, rel=1e-6)
    assert got_g.keys() == want_g.keys()
    assert _grad_gap(got_g, want_g) < 1e-6
    for name, want in want_g.items():
        assert float((got_g[name] - want).norm() / want.norm()) < 3e-4, name


def test_matches_the_plain_reference_bf16_and_fp8_does_not(draw):
    """At bf16 compute against the reference's bf16 operands. The port
    rounds to bf16 where the reference keeps f32: the stream, each norm's,
    sublayer's and gate's output, the conv's, the SSD's operands and y;
    both round the products' operands alike.

    - The loss within 2e-5 relative: at this draw 1.5e-6.
    - The gradients over all leaves together within 1.2e-2: at this draw
      5.6e-3, where the reference's own bf16 operands move its gradients
      4.0e-3 from its f32 products; the bound is about twice the reading.
    - The reference with fp8 operands, the precision below the one the
      configuration states, lies outside that gradient bound (3.1e-2 at
      this draw): the bound is tight enough to tell the two apart."""
    want_l, want_g = draw["bf16"]
    got_l, got_g = _port_on(draw, torch.bfloat16)
    gap = _grad_gap(got_g, want_g)
    assert got_l == pytest.approx(want_l, rel=2e-5)
    assert gap < 1.2e-2, gap
    assert _grad_gap(draw["fp8"][1], want_g) > 1.2e-2


def _ssd_inputs(b=2, L=40, H=4, G=2, P=8, N=16, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64)

    x, B, C = rand(b, L, H, P), rand(b, L, G, N), rand(b, L, G, N)
    dt = F.softplus(rand(b, L, H) + 0.5)
    return [x, dt, -torch.exp(rand(H)), B, C, rand(H)]


def _recurrence(x, dt, A, B, C, D):
    """The state space model step by step: state_t = exp(dt_t A) state_{t-1}
    + dt_t x_t (outer) B_t, y_t = state_t C_t + D x_t, per head of its group."""
    b, L, H, P = x.shape
    rep = H // B.shape[2]
    Bh, Ch = B.repeat_interleave(rep, 2), C.repeat_interleave(rep, 2)
    state = torch.zeros(b, H, P, B.shape[-1], dtype=x.dtype)
    ys = []
    for t in range(L):
        state = torch.exp(dt[:, t] * A)[..., None, None] * state + (dt[:, t, :, None] * x[:, t])[..., None] * Bh[:, t, :, None]
        ys.append((state * Ch[:, t, :, None]).sum(-1) + D[:, None] * x[:, t])
    return torch.stack(ys, 1)


@pytest.mark.parametrize("chunk", [8, 16])
def test_ssd_plain_versions_and_the_reference_against_the_recurrence(chunk):
    """``ops/ssd.py``'s plain forward (Listing 1) and its written-out
    backward, and the reference's ``ssd_minimal`` under autograd, against
    the step-by-step recurrence in f64 under autograd: 2 rows of 40 steps
    (the last chunk ragged), 4 heads in 2 groups, at two chunk sizes. In
    f32 against f64: y and the six gradients within 1e-6 of their norm,
    dA within 1e-4 (its sum over steps and heads cancels)."""
    from bench_port.reference import granite as ref_granite

    ins = _ssd_inputs()
    leaves = [t.clone().requires_grad_() for t in ins]
    want = _recurrence(*leaves)
    dy = torch.randn(want.shape, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    want_g = torch.autograd.grad(want, leaves, dy)
    want = want.detach()
    f32 = [t.float() for t in ins]
    y, states = ssd.ssd_fwd_reference(*f32, chunk)
    assert float((y.double() - want).norm() / want.norm()) < 1e-6
    for name, got, w in zip(("x", "dt", "A", "B", "C", "D"), ssd.ssd_bwd_reference(*f32, states, dy.float(), chunk),
                            want_g):
        assert got.dtype == torch.float32
        assert float((got.double() - w).norm() / w.norm()) < (1e-4 if name == "A" else 1e-6), name
    # the reference's minimal SSD, padded as its mixer pads, its gradients by autograd
    x, dt, A, B, C, D = (t.float().requires_grad_() for t in ins)
    L, pad = x.shape[1], -x.shape[1] % chunk

    def padded(t):
        return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))

    rep = x.shape[2] // B.shape[2]
    y_ref = ref_granite.ssd_minimal(padded(x * dt[..., None]), padded(dt * A), padded(B.repeat_interleave(rep, 2)),
                                    padded(C.repeat_interleave(rep, 2)), chunk)[:, :L] + D[:, None] * x
    assert float((y_ref.detach().double() - want).norm() / want.norm()) < 1e-6
    for name, got, w in zip("x dt A B C D".split(), torch.autograd.grad(y_ref, (x, dt, A, B, C, D), dy.float()),
                            want_g):
        assert float((got.double() - w).norm() / w.norm()) < (1e-4 if name == "A" else 1e-6), name


def test_ssd_op_on_the_cpu_is_the_plain_version():
    """``ssd`` on CPU tensors runs the plain versions through the custom
    ops, launching nothing; its gradients are the plain backward's; the
    kernel wrappers refuse CPU tensors."""
    x, dt, A, B, C, D = (t.float() for t in _ssd_inputs(L=32))
    before = (ssd.SSD_FWD_LAUNCHES, ssd.SSD_BWD_LAUNCHES)
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C, D)]
    y = ssd.ssd(*leaves, chunk=16)
    dy = torch.randn_like(y)
    y.backward(dy)
    want_y, states = ssd.ssd_fwd_reference(x, dt, A, B, C, D, 16)
    assert torch.equal(y, want_y)
    for leaf, want in zip(leaves, ssd.ssd_bwd_reference(x, dt, A, B, C, D, states, dy, 16)):
        assert torch.equal(leaf.grad, want)
    assert (ssd.SSD_FWD_LAUNCHES, ssd.SSD_BWD_LAUNCHES) == before
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_fwd_cuda(x.bfloat16(), dt, A, B.bfloat16(), C.bfloat16(), D, 32)


class _EmulatedKernels:
    """The SSD kernels' contracts (``csrc/ssd.cu``) in plain f32 PyTorch with
    their bf16 roundings, for running the card's steps on the CPU."""

    @staticmethod
    def scale(x, scale, Lp):
        b, L, H, P = x.shape
        out = torch.zeros(b, Lp, H, P, dtype=x.dtype)
        out[:, :L] = (x.float() * scale.transpose(1, 2)[:, :L, :, None]).to(x.dtype)
        return out

    @staticmethod
    def state_fwd(S, decay, dtype):
        hs, h = torch.empty(S.shape, dtype=dtype), torch.zeros_like(S[:, 0])
        for c in range(S.shape[1]):
            hs[:, c] = h.to(dtype)
            h = decay[:, c, :, None, None] * h + S[:, c]
        return hs

    @staticmethod
    def state_bwd(dstate, hs, decay):
        dS, dT, g = torch.empty_like(hs), torch.empty(decay.shape), torch.zeros_like(dstate[:, 0])
        for c in reversed(range(dstate.shape[1])):
            dS[:, c] = g.to(hs.dtype)
            dT[:, c] = decay[:, c] * (g * hs[:, c].float()).sum((-1, -2))
            g = dstate[:, c] + decay[:, c, :, None, None] * g
        return dS, dT

    @staticmethod
    def _common(x, s):
        b, L, H, P, Q, nc = s.b, s.L, s.H, s.P, s.Q, s.nc
        xp = F.pad(x.float(), (0, 0, 0, 0, 0, s.Lp - L)).view(b, nc, Q, H, P)
        return xp, s.acs.view(b, H, nc, Q), s.dt.view(b, H, nc, Q)

    @staticmethod
    def fwd(x, s, cb, hs, D):
        xp, acs, dt = _EmulatedKernels._common(x, s)
        cb, C = cb.view(s.b, s.nc, s.G, s.Q, s.Q), s.C.view(s.b, s.nc, s.G, s.Q, s.N).float()
        keep = torch.ones(s.Q, s.Q, dtype=torch.bool).tril()
        y = torch.empty_like(xp)
        for h in range(s.H):
            g, a = h // s.hg, acs[:, h]
            M = (cb[:, :, g] * torch.exp(a[..., :, None] - a[..., None, :]).masked_fill(~keep, 0)
                 * dt[:, h][..., None, :]).bfloat16().float()
            y[..., h, :] = (M @ xp[..., h, :] + (C[:, :, g] @ hs[:, :, h].float().transpose(-1, -2))
                            * torch.exp(a)[..., None] + D[h] * xp[..., h, :])
        return y.view(s.b, s.Lp, s.H, s.P)[:, :s.L].to(x.dtype)

    @staticmethod
    def bwd(x, dy, z, yi, s, cbt, D):
        xp, acs, dt = _EmulatedKernels._common(x, s)
        dyp, _, _ = _EmulatedKernels._common(dy, s)
        zz, yy = (t.view(s.b, s.nc, s.G, s.Q, s.hg, s.P).float() for t in (z, yi))
        cbt = cbt.view(s.b, s.nc, s.G, s.Q, s.Q)
        keep = torch.ones(s.Q, s.Q, dtype=torch.bool).triu()  # [s, t]: s <= t
        ntile = s.Q // ssd.TILE
        dx, dcbt = torch.empty_like(xp), torch.zeros_like(cbt)
        u, xz, ai = (torch.empty(s.b, s.H, s.nc, s.Q) for _ in range(3))
        col, dd = torch.zeros(ntile, s.b, s.H, s.nc, s.Q), torch.zeros(s.b, s.nc, ntile, s.H, 8)
        for h in range(s.H):
            g, hi, a, d = h // s.hg, h % s.hg, acs[:, h], dt[:, h]
            Lt = torch.exp(a[..., None, :] - a[..., :, None]).masked_fill(~keep, 0)
            Gt = xp[..., h, :] @ dyp[..., h, :].transpose(-1, -2)
            Mt = cbt[:, :, g] * Lt * d[..., :, None]
            dcbt[:, :, g] += Gt * Lt * d[..., :, None]
            u[:, h] = (Gt * cbt[:, :, g] * Lt).sum(-1)
            for j in range(ntile):
                col[j, :, h] = (Gt * Mt)[..., j * ssd.TILE:(j + 1) * ssd.TILE, :].sum(-2)
            w = torch.exp(a[..., -1:] - a) * d
            dx[..., h, :] = (Mt.bfloat16().float() @ dyp[..., h, :] + D[h] * dyp[..., h, :]
                             + w[..., None] * zz[:, :, g, :, hi])
            xz[:, h] = (xp[..., h, :] * zz[:, :, g, :, hi]).sum(-1)
            ai[:, h] = torch.exp(a) * (dyp[..., h, :] * yy[:, :, g, :, hi]).sum(-1)
            dd[:, :, 0, h, 0] = (dyp[..., h, :] * xp[..., h, :]).sum((-1, -2))
        flat = (s.b, s.H, s.Lp)
        return (dx.view(s.b, s.Lp, s.H, s.P)[:, :s.L].to(x.dtype), dcbt.view(-1, s.Q, s.Q), u.view(flat),
                xz.view(flat), ai.view(flat), col.view(ntile, *flat), dd)


def test_the_cards_steps_with_their_kernels_emulated(monkeypatch):
    """``ssd_fwd_cuda`` and ``ssd_bwd_cuda`` (steps 1-4, the states between
    chunks, the products and sums around the kernels) on the CPU with each
    kernel replaced by its contract in plain f32 (``_EmulatedKernels``) and
    cuBLAS's f32-accumulated products by f32 products, against the plain
    chunked form: 2 rows of 200 steps in chunks of 64 (the last ragged),
    4 heads of 64 in 2 groups, N 32, bf16. y, the entering states, dx, dB
    and dC within 5e-3 of their norm (one bf16 rounding of an output and of
    the products' operands: 2.7e-3 here); ddt and dA within 5e-3 (4e-4 and
    9e-4); dD within 1e-5."""
    for name, fn in (("_launch_scale", _EmulatedKernels.scale), ("_launch_state_fwd", _EmulatedKernels.state_fwd),
                     ("_launch_state_bwd", _EmulatedKernels.state_bwd), ("_launch_fwd", _EmulatedKernels.fwd),
                     ("_launch_bwd", _EmulatedKernels.bwd), ("_check", lambda *a: None),
                     ("_bmm", lambda a, b: a.float() @ b.float())):
        monkeypatch.setattr(ssd, name, fn)
    gen = torch.Generator().manual_seed(3)
    b, L, H, G, N = 2, 200, 4, 2, 32
    x = torch.randn(b, L, H, 64, generator=gen).bfloat16()
    dt = F.softplus(torch.randn(b, L, H, generator=gen) + 0.5)
    A, D = -torch.exp(torch.randn(H, generator=gen)), torch.randn(H, generator=gen)
    B, C = (torch.randn(b, L, G, N, generator=gen).bfloat16() for _ in range(2))
    dy = torch.randn(b, L, H, 64, generator=gen).bfloat16()
    y, states = ssd.ssd_fwd_cuda(x, dt, A, B, C, D, 64)
    y_ref, states_ref = ssd.ssd_fwd_reference(x, dt, A, B, C, D, 64)

    def gap(a, w):
        return float((a.float() - w.float()).norm() / w.float().norm())

    assert gap(y, y_ref) < 5e-3 and gap(states, states_ref) < 5e-3
    got = ssd.ssd_bwd_cuda(x, dt, A, B, C, D, states, dy, 64)
    want = ssd.ssd_bwd_reference(x, dt, A, B, C, D, states_ref, dy, 64)
    assert [g.dtype for g in got] == [w.dtype for w in want]
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, want):
        assert gap(g, w) < (1e-5 if name == "dD" else 5e-3), name


def test_published_layout_and_parameter_count():
    """``get_model_class("granite-4.0-h-micro")`` builds the published model:
    40 layers of 2048, attention at layers 5, 15, 25 and 35 (32 heads of 64,
    8 KV heads, no rotary, no bias, causal, scale 1/64), Mamba-2 elsewhere
    (64 heads of 64, d_state 128, one group, d_conv 4, chunks of 256), SwiGLU
    MLPs of 8192, a tied vocabulary of 100,352; 3,191,396,096 parameters (36
    Mamba-2 mixers, 4 attention mixers, 40 MLPs, 81 norms of 2048 and the
    embedding)."""
    module = get_model_class("granite-4.0-h-micro").build_model(device="meta").module
    assert len(module.layers) == 40
    assert [i for i, layer in enumerate(module.layers) if layer.kind == "attention"] == [5, 15, 25, 35]
    for layer in module.layers:
        if layer.kind == "attention":
            attn = layer.self_attn
            assert (attn.num_heads, attn.num_kv_heads, attn.head_dim, attn.rotary_dim, attn.causal) == (32, 8, 64, 0, True)
            assert attn.sm_scale == 1 / 64 and attn.qkv.bias is None and attn.out.bias is None
            assert sum(p.numel() for p in attn.parameters()) == ATTENTION_MIXER
        else:
            m = layer.mamba
            assert isinstance(m, Mamba2Mixer)
            assert (m.n_heads, m.head_dim, m.d_state, m.n_groups, m.conv_dim, m.chunk) == (64, 64, 128, 1, 4352, 256)
            assert sum(p.numel() for p in m.parameters()) == MAMBA_MIXER
        assert sum(p.numel() for p in layer.shared_mlp.parameters()) == MLP
    assert tuple(module.embedding.shape) == (100352, 2048)
    total = sum(p.numel() for p in module.parameters())
    assert total == 36 * MAMBA_MIXER + 4 * ATTENTION_MIXER + 40 * MLP + 81 * 2048 + EMBEDDING == 3_191_396_096


def test_recipe_and_registry():
    """The port-only type sits beside the JAX package's, which stay equal to
    its own; the recipe is the one the configuration file states."""
    assert MODEL_TYPES == JAX_MODEL_TYPES and "granite-4.0-h-micro" not in MODEL_TYPES
    assert PORT_ONLY_MODEL_TYPES == ("jamba2-3b", "granite-4.0-h-micro")
    mc = get_model_class("granite-4.0-h-micro")
    assert (mc.batch_size, mc.sequence_length, mc.vocab_size, mc.mixed_precision) == (32, 16384, 100352, "bf16")
    assert mc.optimizer == "adamw" and mc.optimizer_kwargs == {"lr": 3e-4, "weight_decay": 0.1, "betas": (0.9, 0.95)}
    assert mc.scheduler_kwargs == {"num_warmup_steps": 1000, "min_lr": 3e-5} and mc.max_grad_norm == 1.0


def test_method_search_cli_takes_the_model(monkeypatch):
    """``benchmark.py --model granite-4.0-h-micro`` is accepted and reaches
    the sweep with the model's own grid."""
    seen = {}
    monkeypatch.setattr(cli, "Sweep", type("S", (), {"run": staticmethod(lambda sweep, cmd: seen.update(sweep=sweep,
                                                                                                    cmd=cmd))}))
    cli.main(["--num-hosts", "1", "--chips-per-host", "1", "--gpu-type", "h100-sxm", "--model", "granite-4.0-h-micro",
              "--methods", "naive", "--cmd", "count"])
    assert seen["cmd"] == "count" and seen["sweep"].search_space["model"] == ["granite-4.0-h-micro"]


def test_remat_keeps_the_layer_input_alone_and_changes_nothing(draw):
    """Under remat each whole layer is one ``layers.remat`` unit whose
    checkpoint keeps one tensor, the bf16 stream it was given; loss and
    gradients equal the unrematerialised model's bit for bit."""
    runs, saved = [], []
    remat = tlayers.remat

    def recording_remat(block, x, **kw):
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append((t, x)) or t, lambda t: t):
            return remat(block, x, **kw)

    for use_remat in (False, True):
        model = _tiny(torch.bfloat16, remat=use_remat)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tgranite, "remat", recording_remat)
            runs.append(_port_on(draw, torch.bfloat16, model))
    kept = [(t, x) for t, x in saved if t.numel()]
    assert len(kept) == 4 and all(t is x and t.dtype == torch.bfloat16 for t, x in kept)
    (loss, grads), (loss_r, grads_r) = runs
    assert loss == loss_r and all(torch.equal(grads[n], grads_r[n]) for n in grads)


def test_one_bf16_sr_session_step_through_the_normal_path():
    """``get_model_class`` -> ``TrainingPlan`` -> ``build_session`` at the
    tiny size (the module's constants narrowed), whole-layer remat, the
    ``bf16_sr`` layout: a micro-batch's loss near log(256) and an update
    that moves most parameters."""
    with pytest.MonkeyPatch.context() as mp:
        for name, value in NARROW.items():
            mp.setattr(tgranite, name, value)
        mp.setattr(tgranite.GraniteModelClass, "sequence_length", property(lambda self: SEQ))
        mc = get_model_class("granite-4.0-h-micro")
        sess = make_plan(mc, 2, 1, True, "bf16_sr").build_session(mc, device="cpu")
        state = sess.init_state(seed=0)
        before = {n: p.detach().clone() for n, p in state.params.items()}
        ids = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, SEQ))).long()
        loss = sess.accumulate_fn()(state, {"input_ids": ids, "labels": ids})
        sess.optimizer_update_fn()(state, 1.0)
    assert abs(float(loss) - math.log(256)) < 0.5
    moved = [n for n in before if not torch.equal(before[n], state.params[n])]
    assert len(moved) > len(before) // 2


@pytest.mark.parametrize("shape", ["pythia", "jamba"])
def test_self_attention_scale_defaults_to_before_and_reaches_flash(monkeypatch, shape):
    """``SelfAttention``'s ``sm_scale``: None (the default, pythia's rotary
    heads and Jamba's MQA) hands the dispatcher no scale, so it computes
    1/sqrt(d) as before, bit for bit the output of the dispatcher called
    without one; a given scale, Granite's 1/64, reaches ``flash_attention``
    and gives the output of the plain attention at that scale."""
    from multimodal_llm_pretraining_tpu_torch.ops import attention

    seen = []
    flash = attention.flash_attention
    monkeypatch.setattr(attention, "flash_attention", lambda *a, **kw: seen.append(kw["sm_scale"]) or flash(*a, **kw))
    torch.manual_seed(0)
    heads, kv, d, rotary = (4, 4, 32, 8) if shape == "pythia" else (4, 1, 32, 0)
    x = torch.randn(2, 24, heads * d)
    default = tlayers.SelfAttention(heads * d, heads, d, num_kv_heads=kv, causal=True, rotary_dim=rotary)
    scaled = tlayers.SelfAttention(heads * d, heads, d, num_kv_heads=kv, causal=True, rotary_dim=rotary,
                                   sm_scale=1 / 64)
    scaled.load_state_dict(default.state_dict())
    out = default(x)
    calls = []
    monkeypatch.setattr(tlayers, "dot_product_attention",
                        lambda *a, **kw: calls.append(kw) or attention.dot_product_attention(
                            *a, **{k: v for k, v in kw.items() if k != "sm_scale"}))
    assert torch.equal(default(x), out) and calls[0]["sm_scale"] is None
    monkeypatch.setattr(tlayers, "dot_product_attention", attention.dot_product_attention)
    got = scaled(x)
    assert seen == [d**-0.5, d**-0.5, 1 / 64]
    q, k, v = scaled.qkv(x).split([heads * d, kv * d, kv * d], -1)
    q, k, v = (t.reshape(2, 24, -1, d).transpose(1, 2) for t in (q, k, v))
    if rotary:
        cos, sin = tlayers.rotary_angles(torch.arange(24), rotary)
        q, k = tlayers.apply_rotary(q, cos, sin), tlayers.apply_rotary(k, cos, sin)
    k, v = (t.repeat_interleave(heads // kv, 1) for t in (k, v))
    want = attention.dot_product_attention(q, k, v, causal=True, impl="naive", sm_scale=1 / 64)
    want = scaled.out(want.transpose(1, 2).reshape(2, 24, heads * d))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
