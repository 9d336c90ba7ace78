"""The port's spans (``tracing.py``) under ``torch.profiler`` on the CPU: a
tiny pythia (2 layers of 64, the port's plain kernels, f32) trained one
micro-batch at a time through the session, with no remat and under the
"flash" and "dots" policies, and a tiny mamba under its whole-block remat.

Each span appears as often as the micro-batch has such regions, and holds
the ops it names: the loss's backward inside ``xent.backward`` and the
final LayerNorm's outside it, each block's recompute inside
``step.backward``. With no profiler recording, nothing is registered or
wrapped, the autograd graph is the same, and loss and gradients equal a
profiled run's bit for bit.
"""

import collections
import contextlib
import functools
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multimodal_llm_pretraining_tpu_torch import tracing
from multimodal_llm_pretraining_tpu_torch.models import get_model_class
from multimodal_llm_pretraining_tpu_torch.models import layers as tlayers
from multimodal_llm_pretraining_tpu_torch.models import pythia as tpythia
from multimodal_llm_pretraining_tpu_torch.models.mamba import MambaLM
from multimodal_llm_pretraining_tpu_torch.profile_step import make_plan

torch.set_num_threads(2)

SEQ = 33
REMATS = [None, "flash", "dots"]
SPANS = ("step.forward", "step.backward", "xent.forward", "xent.backward", "remat.replay")


@pytest.fixture
def tiny_pythia(monkeypatch):
    """A session builder for pythia at 2 layers of 64 (2 heads of 32)."""
    monkeypatch.setitem(tpythia.PYTHIA_SIZES, "pythia-14m", (2, 64, 2))
    mc = get_model_class("pythia-14m")

    def build(remat):
        plan = make_plan(mc, 2, 1, remat is not None, "f32", remat or "flash")
        sess = plan.build_session(mc, device="cpu")
        return sess, sess.init_state(seed=0)

    return build


def _batch(seed=0):
    ids = torch.randint(0, 50304, (2, SEQ), generator=torch.Generator().manual_seed(seed))
    return {"input_ids": ids, "labels": ids}


def _traced(fn, tmp_path):
    """Run ``fn`` under the CPU profiler; its chrome trace's events."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _spans(events, name):
    return [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation" and e.get("name") == name]


def _starts(events, name):
    return [e["ts"] for e in events if e.get("cat") == "cpu_op" and e.get("name") == name]


def _inside(ts, spans):
    return any(t0 <= ts <= t1 for t0, t1 in spans)


@pytest.mark.parametrize("remat", REMATS)
def test_each_span_once_a_region(remat, tiny_pythia, tmp_path):
    """One micro-batch: one forward, backward and loss span each, and one
    ``remat.replay`` a block under remat, none without."""
    sess, state = tiny_pythia(remat)
    acc = sess.accumulate_fn()
    acc(state, _batch(1))  # warm
    events = _traced(lambda: acc(state, _batch(2)), tmp_path)
    counts = collections.Counter(e["name"] for e in events if e.get("cat") == "user_annotation")
    assert {n: counts[n] for n in SPANS} == {"step.forward": 1, "step.backward": 1, "xent.forward": 1,
                                             "xent.backward": 1, "remat.replay": 0 if remat is None else 2}


@pytest.mark.parametrize("remat", REMATS)
def test_loss_backward_is_inside_xent_backward(remat, tiny_pythia, tmp_path):
    """The loss's backward (``_ChunkedXentBackward``: the chunks'
    recompute, the gradient of the logits and the head's products) starts
    inside ``xent.backward``; no LayerNorm backward does, and the first, the
    final LayerNorm's, starts after it. The loss's forward ops start inside
    ``xent.forward``, inside ``step.forward``."""
    sess, state = tiny_pythia(remat)
    events = _traced(lambda: sess.accumulate_fn()(state, _batch()), tmp_path)
    xb, xf = _spans(events, "xent.backward"), _spans(events, "xent.forward")
    loss_bwd = _starts(events, "_ChunkedXentBackward")
    ln_bwd = _starts(events, "aten::native_layer_norm_backward")
    assert loss_bwd and all(_inside(ts, xb) for ts in loss_bwd)
    assert len(ln_bwd) == 5 and not any(_inside(ts, xb) for ts in ln_bwd)
    assert min(ln_bwd) > xb[0][1]
    lse_fwd = _starts(events, "aten::logsumexp")
    assert lse_fwd and all(_inside(ts, xf) for ts in lse_fwd)
    assert all(_inside(t0, _spans(events, "step.forward")) for t0, _ in xf)


@pytest.mark.parametrize("remat", ["flash", "dots"])
def test_replay_is_inside_step_backward(remat, tiny_pythia, tmp_path):
    """Each block's recompute runs inside ``step.backward`` and outside the
    loss's span, and holds ops of the block (its LayerNorms' forward)."""
    sess, state = tiny_pythia(remat)
    events = _traced(lambda: sess.accumulate_fn()(state, _batch()), tmp_path)
    sb, xb, replay = _spans(events, "step.backward"), _spans(events, "xent.backward"), _spans(events, "remat.replay")
    assert len(replay) == 2
    ops = [e["ts"] for e in events if e.get("cat") == "cpu_op" and _inside(e["ts"], replay)]
    assert ops and all(_inside(ts, sb) for ts in ops)
    assert not any(_inside(ts, xb) for ts in ops)
    ln = _starts(events, "aten::native_layer_norm")
    assert all(any(_inside(ts, [r]) for ts in ln) for r in replay)


def _graph(t: torch.Tensor) -> list:
    """The autograd graph from ``t``, node by node in a fixed order: each
    node's name and its inputs' names."""
    seen, out, todo = set(), [], [t.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or id(node) in seen:
            continue
        seen.add(id(node))
        nxt = [f for f, _ in node.next_functions]
        out.append((node.name(), tuple(f.name() if f is not None else None for f in nxt)))
        todo.extend(reversed(nxt))
    return out


def _accumulate(sess, state, batch, profiled, monkeypatch, tmp_path):
    """One micro-batch through the session: (loss, grads, graph, hooks
    registered, what ``checkpoint`` was handed)."""
    seen = {"hooks": 0, "checkpoint": [], "graph": None}
    register_hook, backward, checkpoint = torch.Tensor.register_hook, torch.Tensor.backward, tlayers.checkpoint

    def counting_hook(self, hook):
        seen["hooks"] += 1
        return register_hook(self, hook)

    def graphing_backward(self, *args, **kwargs):
        seen["graph"] = _graph(self)
        return backward(self, *args, **kwargs)

    def recording_checkpoint(fn, *args, **kwargs):
        seen["checkpoint"].append((fn, kwargs["context_fn"]))
        return checkpoint(fn, *args, **kwargs)

    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "register_hook", counting_hook)
        m.setattr(torch.Tensor, "backward", graphing_backward)
        m.setattr(tlayers, "checkpoint", recording_checkpoint)
        sess.zero_grads()
        with profile(activities=[ProfilerActivity.CPU]) if profiled else contextlib.nullcontext():
            loss = sess.accumulate_fn()(state, batch)
    grads = {n: p.grad.clone() for n, p in sess.module.named_parameters()}
    return loss, grads, seen


@pytest.mark.parametrize("remat", REMATS)
def test_no_profiler_no_hooks_same_graph_same_bits(remat, tiny_pythia, monkeypatch, tmp_path):
    """With no profiler recording, the spans register no hook and hand
    ``checkpoint`` the block and the policy's context as they are; under
    the profiler the loss's two hooks and the replay's context are the only
    additions. The graph is the same node for node, and loss and every
    gradient are bit-identical."""
    sess, state = tiny_pythia(remat)
    batch = _batch()
    plain = _accumulate(sess, state, batch, False, monkeypatch, tmp_path)
    traced = _accumulate(sess, state, batch, True, monkeypatch, tmp_path)
    assert plain[2]["hooks"] == 0 and traced[2]["hooks"] == 2
    assert len(plain[2]["checkpoint"]) == len(traced[2]["checkpoint"]) == (0 if remat is None else 2)
    for (fn, ctx), block in zip(plain[2]["checkpoint"], sess.module.layers):
        assert fn is block and ctx.func is tlayers.create_selective_checkpoint_contexts
    for (fn, ctx), block in zip(traced[2]["checkpoint"], sess.module.layers):
        assert fn is block and not isinstance(ctx, functools.partial)
    assert plain[2]["graph"] == traced[2]["graph"] and len(plain[2]["graph"]) > 20
    assert torch.equal(plain[0], traced[0])
    assert plain[1].keys() == traced[1].keys()
    for name in plain[1]:
        assert torch.equal(plain[1][name], traced[1][name]), name


def test_mamba_whole_block_remat_replays_in_spans(tmp_path):
    """Mamba's whole-block remat goes through ``layers.remat`` too: one
    ``remat.replay`` a block, and the loss's spans once."""
    torch.manual_seed(0)
    model = MambaLM(d_model=16, num_layers=2, d_inner=32, d_state=4, d_conv=4, dt_rank=2, vocab_size=64,
                    use_custom_kernels=False, remat=True)
    model.reset_parameters(torch.Generator().manual_seed(0))
    ids = torch.randint(0, 64, (2, 17), generator=torch.Generator().manual_seed(1))
    events = _traced(lambda: model(ids, labels=ids).backward(), tmp_path)
    counts = collections.Counter(e["name"] for e in events if e.get("cat") == "user_annotation")
    assert (counts["remat.replay"], counts["xent.forward"], counts["xent.backward"]) == (2, 1, 1)


def test_span_is_a_no_op_without_a_profiler(monkeypatch, tmp_path):
    """``span`` is a ``nullcontext`` unless a profiler records, then a
    ``record_function``. ``backward_span`` registers nothing without a
    profiler, nor under one for tensors that need no gradient; under one it
    spans the region's backward, leaving the gradient as it is."""
    hooks = []
    register_hook = torch.Tensor.register_hook
    monkeypatch.setattr(torch.Tensor, "register_hook", lambda self, hook: hooks.append(hook) or register_hook(self, hook))
    assert not tracing.profiling()
    assert isinstance(tracing.span("x"), contextlib.nullcontext)
    x = torch.ones(3, requires_grad=True)
    tracing.backward_span("x.backward", (x * 2).sum(), x)
    assert hooks == []

    def region():
        assert tracing.profiling()
        assert isinstance(tracing.span("x"), torch.profiler.record_function)
        y = torch.ones(3)
        tracing.backward_span("x.backward", y * 2, y)
        assert hooks == []
        z = (x * 3).sum()
        tracing.backward_span("x.backward", z, x)
        assert len(hooks) == 2
        z.backward()

    events = _traced(region, tmp_path)
    assert not tracing.profiling()
    assert torch.equal(x.grad, torch.full((3,), 3.0))
    assert len(_spans(events, "x.backward")) == 1
    assert all(_inside(ts, _spans(events, "x.backward")) for ts in _starts(events, "MulBackward0"))
