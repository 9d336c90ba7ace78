"""AI21-Jamba2-3B in the PyTorch port (``models/jamba.py``), a model the JAX
package does not have: held to the benchmark's plain reference
(``bench_port/reference/jamba.py``) on one seeded draw of its weights and
tokens (``bench_port/yardstick``'s ``make_weights`` and ``token_batch``), at
a tiny size on the CPU: d_model 64, d_inner 128, d_state 16, dt_rank 8, 4
layers with ``attn_layer_period`` 4 and offset 1 (layer 1 attention, the
others Mamba), 4 query heads of 16 and one KV head, MLP 128, vocab 256, 64
tokens. The kernels run their plain versions here.

These tests depend on the reference, and a change to it changes what they
hold the port to.
"""

import math

import numpy as np
import pytest
import torch

from multimodal_llm_pretraining_tpu.models import MODEL_TYPES as JAX_MODEL_TYPES
from multimodal_llm_pretraining_tpu_torch import benchmark as cli
from multimodal_llm_pretraining_tpu_torch.models import MODEL_TYPES, PORT_ONLY_MODEL_TYPES, get_model_class
from multimodal_llm_pretraining_tpu_torch.models import jamba as tjamba
from multimodal_llm_pretraining_tpu_torch.models import layers as tlayers
from multimodal_llm_pretraining_tpu_torch.models.jamba import JambaLM
from multimodal_llm_pretraining_tpu_torch.models.mamba import MambaMixer
from multimodal_llm_pretraining_tpu_torch.profile_step import make_plan

torch.set_num_threads(2)

CFG = {"hidden_size": 64, "d_inner": 128, "intermediate_size": 128, "vocab_size": 256, "mamba_d_state": 16,
       "mamba_d_conv": 4, "mamba_dt_rank": 8, "num_attention_heads": 4, "num_key_value_heads": 1,
       "num_hidden_layers": 4, "attn_layer_period": 4, "attn_layer_offset": 1, "rms_norm_eps": 1e-6}
NARROW = dict(D_MODEL=64, N_LAYER=4, D_INNER=128, DT_RANK=8, NUM_HEADS=4, HEAD_DIM=16, INTERMEDIATE=128, VOCAB=256,
              ATTN_LAYER_PERIOD=4, ATTN_LAYER_OFFSET=1)
SEQ, SEED = 64, 21
# the published configuration's leaves (see the module docstring of models/jamba.py)
MAMBA_MIXER, ATTENTION_MIXER, MLP, EMBEDDING = 41_241_792, 13_762_560, 62_914_560, 167_772_160


def _tiny(dtype=torch.float32, **kw) -> JambaLM:
    return JambaLM(64, 4, 128, 16, 4, 8, 4, 1, 16, 128, 256, 4, 1, dtype=dtype, **kw)


@pytest.fixture(scope="module")
def draw():
    """One seeded draw of the benchmark's weights (HF's initialisation) and
    tokens, and the plain reference's loss and gradients with f32, bf16 and
    fp8 products."""
    from bench_port.reference import common
    from bench_port.reference import jamba as ref_jamba
    from bench_port.yardstick import data, weights

    w = weights.make_weights(ref_jamba.init_spec(CFG), SEED, "cpu", torch.float32)
    ids = torch.from_numpy(data.token_batch(SEED, 0, 2, SEQ, 256)).long()
    out = {"weights": w, "ids": ids}
    with common.no_tf32():
        for precision in ("f32", "bf16", "fp8"):
            params = {n: t.clone().requires_grad_() for n, t in w.items()}
            loss = ref_jamba.loss(params, ids, CFG, precision)
            loss.backward()
            out[precision] = (float(loss.detach()), {n: p.grad for n, p in params.items()})
    return out


def _port_on(draw, dtype, model: JambaLM | None = None):
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
    from bench_port.reference import jamba as ref_jamba

    spec = {n: shape for n, shape, _ in ref_jamba.init_spec(CFG)}
    assert {n: tuple(p.shape) for n, p in _tiny().named_parameters()} == spec


def test_matches_the_plain_reference_f32(draw):
    """At f32 compute the port equals the reference up to f32 summation order
    (the scans' chunks of 256 against 64, the products' blocking, flash's
    online softmax against the reference's blocks of queries): the loss to
    1e-6 relative, every leaf's gradient to 1e-5 of its norm (at this draw
    0 and 7e-7)."""
    want_l, want_g = draw["f32"]
    got_l, got_g = _port_on(draw, torch.float32)
    assert got_l == pytest.approx(want_l, rel=1e-6)
    assert got_g.keys() == want_g.keys()
    for name, want in want_g.items():
        assert float((got_g[name] - want).norm() / want.norm()) < 1e-5, name


def test_matches_the_plain_reference_bf16_and_fp8_does_not(draw):
    """At bf16 compute against the reference's bf16 operands. The port
    rounds to bf16 where the reference keeps f32: the stream, each norm's
    and each sublayer's output, the softplus, the scan's y; both round the
    products' operands alike.

    - The loss within 5e-5 relative: at this draw 1.4e-5, three and a half
      times under the bound.
    - The gradients over all leaves together within 1.3e-2: at this draw
      6.3e-3, where the reference's own bf16 operands move its gradients
      4.4e-3 from its f32 products; the bound is twice the reading.
    - The reference with fp8 operands, the precision below the one the
      configuration states, lies outside that gradient bound (4.9e-2 at
      this draw): the bound is tight enough to tell the two apart."""
    want_l, want_g = draw["bf16"]
    got_l, got_g = _port_on(draw, torch.bfloat16)
    gap = _grad_gap(got_g, want_g)
    assert got_l == pytest.approx(want_l, rel=5e-5)
    assert gap < 1.3e-2, gap
    assert _grad_gap(draw["fp8"][1], want_g) > 1.3e-2


def test_inner_norms_are_there_and_train(draw):
    """Every Mamba mixer has its dt, B and C norms (scales over 8, 16 and 16
    channels) and they take a gradient. A port without them is told apart
    from the reference: its loss moves 2.4e-5 relative at this draw, 24
    times the f32 test's 1e-6 (the mixers add little to the stream under
    HF's initialisation, so the loss moves less than the bf16 test's 5e-5);
    every mixer's x_proj and dt_proj gradient lies wholly elsewhere (a gap
    of about 1 of its norm), and the gradients over all leaves together,
    1.9e-2 from the reference's, lie outside the bf16 test's 1.3e-2."""
    model = _tiny()
    mixers = [layer.mamba for layer in model.layers if layer.kind == "mamba"]
    assert len(mixers) == 3
    assert [tuple(m.dt_layernorm.weight.shape) + tuple(m.b_layernorm.weight.shape) + tuple(m.c_layernorm.weight.shape)
            for m in mixers] == [(8, 16, 16)] * 3
    want_l, want_g = draw["f32"]
    _, grads = _port_on(draw, torch.float32, model)
    inner = [n for n in grads if ".mamba." in n and "_layernorm" in n]
    assert len(inner) == 9 and all(float(grads[n].norm()) > 0 for n in inner)
    without = _tiny()
    for layer in without.layers:
        if layer.kind == "mamba":
            layer.mamba.inner_norms = False
    dropped_l, dropped_g = _port_on(draw, torch.float32, without)
    assert abs(dropped_l - want_l) / want_l > 10 * 1e-6, (dropped_l, want_l)
    dropped_g = {n: torch.zeros_like(want_g[n]) if g is None else g for n, g in dropped_g.items()}
    for name in want_g:
        if ".mamba.x_proj." in name or ".mamba.dt_proj.weight" in name:
            assert float((dropped_g[name] - want_g[name]).norm() / want_g[name].norm()) > 0.5, name
    assert _grad_gap(dropped_g, want_g) > 1.3e-2


def test_published_layout_and_parameter_count():
    """``get_model_class("jamba2-3b")`` builds the published model: 28 layers
    of 2560, attention at layers 7 and 21 (20 heads of 128, one KV head, no
    rotary, no bias, causal), Mamba elsewhere with the inner norms and the
    conv and gate in f32, SwiGLU MLPs of 8192, a tied vocabulary of 65,536;
    3,029,337,472 parameters (26 Mamba mixers, 2 attention mixers, 28 MLPs,
    57 norms of 2560 and the embedding)."""
    module = get_model_class("jamba2-3b").build_model(device="meta").module
    assert len(module.layers) == 28
    assert [i for i, layer in enumerate(module.layers) if layer.kind == "attention"] == [7, 21]
    for layer in module.layers:
        if layer.kind == "attention":
            attn = layer.self_attn
            assert (attn.num_heads, attn.num_kv_heads, attn.head_dim, attn.rotary_dim, attn.causal) == (20, 1, 128, 0, True)
            assert attn.qkv.bias is None and attn.out.bias is None
            assert sum(p.numel() for p in attn.parameters()) == ATTENTION_MIXER
        else:
            assert isinstance(layer.mamba, MambaMixer) and layer.mamba.f32_conv_gate and layer.mamba.inner_norms
            assert sum(p.numel() for p in layer.mamba.parameters()) == MAMBA_MIXER
        assert sum(p.numel() for p in layer.feed_forward.parameters()) == MLP
    assert tuple(module.embedding.shape) == (65536, 2560)
    total = sum(p.numel() for p in module.parameters())
    assert total == 26 * MAMBA_MIXER + 2 * ATTENTION_MIXER + 28 * MLP + 57 * 2560 + EMBEDDING == 3_029_337_472


def test_recipe_and_registry():
    """The port-only type sits beside the JAX package's, which stay equal to
    its own; the recipe is the one the configuration file states."""
    assert MODEL_TYPES == JAX_MODEL_TYPES and "jamba2-3b" not in MODEL_TYPES
    assert PORT_ONLY_MODEL_TYPES == ("jamba2-3b",)
    mc = get_model_class("jamba2-3b")
    assert (mc.batch_size, mc.sequence_length, mc.vocab_size, mc.mixed_precision) == (32, 16384, 65536, "bf16")
    assert mc.optimizer == "adamw" and mc.optimizer_kwargs == {"lr": 3e-4, "weight_decay": 0.1, "betas": (0.9, 0.95)}
    assert mc.scheduler_kwargs == {"num_warmup_steps": 1000, "min_lr": 3e-5} and mc.max_grad_norm == 1.0


def test_method_search_cli_takes_the_model(monkeypatch):
    """``benchmark.py --model jamba2-3b`` is accepted and reaches the sweep
    with the model's own grid."""
    seen = {}
    monkeypatch.setattr(cli, "Sweep", type("S", (), {"run": staticmethod(lambda sweep, cmd: seen.update(sweep=sweep,
                                                                                                    cmd=cmd))}))
    cli.main(["--num-hosts", "1", "--chips-per-host", "1", "--gpu-type", "h100-sxm", "--model", "jamba2-3b",
              "--methods", "naive", "--cmd", "count"])
    assert seen["cmd"] == "count" and seen["sweep"].search_space["model"] == ["jamba2-3b"]


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
            mp.setattr(tjamba, "remat", recording_remat)
            runs.append(_port_on(draw, torch.bfloat16, model))
    kept = [(t, x) for t, x in saved if t.numel()]
    assert len(kept) == 4 and all(t is x and t.dtype == torch.bfloat16 for t, x in kept)
    (loss, grads), (loss_r, grads_r) = runs
    assert loss == loss_r and all(torch.equal(grads[n], grads_r[n]) for n in grads)


def test_one_bf16_sr_session_step_through_the_normal_path():
    """``get_model_class`` -> ``TrainingPlan`` -> ``build_session`` at the
    tiny size (the module's constants narrowed), whole-layer remat, the
    ``bf16_sr`` layout: a micro-batch's loss near log(256) and an update
    that moves every parameter the first gradient reaches."""
    with pytest.MonkeyPatch.context() as mp:
        for name, value in NARROW.items():
            mp.setattr(tjamba, name, value)
        mp.setattr(tjamba.JambaModelClass, "sequence_length", property(lambda self: SEQ))
        mc = get_model_class("jamba2-3b")
        sess = make_plan(mc, 2, 1, True, "bf16_sr").build_session(mc, device="cpu")
        state = sess.init_state(seed=0)
        before = {n: p.detach().clone() for n, p in state.params.items()}
        ids = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, SEQ))).long()
        loss = sess.accumulate_fn()(state, {"input_ids": ids, "labels": ids})
        sess.optimizer_update_fn()(state, 1.0)
    assert abs(float(loss) - math.log(256)) < 0.5
    moved = [n for n in before if not torch.equal(before[n], state.params[n])]
    assert len(moved) > len(before) // 2
