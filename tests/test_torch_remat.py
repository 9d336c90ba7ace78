"""Activation checkpointing in the port: ``models/layers.py``
``checkpoint_block`` under the "flash" and "dots" policies, on the flash
attention custom ops, against no remat and against the JAX ``make_stack``
remat.

Remat recomputes the same ops on the same inputs, in the same order, on the
CPU, and the backward consumes the same saved or recomputed values, so loss
and every gradient equal the no-remat ones bit for bit (pythia-14m at
sequence 33 in f32 and bf16 compute, llava at the JAX toy dims, a 2-layer
ViT with dropout drawing from one generator seed). The forward op runs once
per block either way: the recompute takes its saved outputs.

The saved residuals are compared with the JAX block's
(``jax.ad_checkpoint.print_saved_residuals`` on one ``GPTNeoXBlock`` under
the same policy): the per-example ones, those that grow with the batch (the
JAX "dots" policy also keeps the rotary angle table, a product of constants
of shape [S, rot/2], which is the same for every example). Shapes are
compared with their leading dims merged, since the port's ``F.linear``
products are [B*S, N] where JAX's are [B, S, N].

The custom ops on CPU tensors are the plain versions the old autograd
``Function`` called, bit for bit, and pass ``torch.library.opcheck``.
"""

import collections
import contextlib
import io
import re

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.ad_checkpoint import print_saved_residuals
from torch.utils._python_dispatch import TorchDispatchMode

from multimodal_llm_pretraining_tpu.models import pythia as jpythia
from multimodal_llm_pretraining_tpu_torch.models import get_model_class
from multimodal_llm_pretraining_tpu_torch.models import layers as tlayers
from multimodal_llm_pretraining_tpu_torch.models import llava as tllava
from multimodal_llm_pretraining_tpu_torch.models import pythia as tpythia
from multimodal_llm_pretraining_tpu_torch.models import vit as tvit
from multimodal_llm_pretraining_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

SEQ = 33
_POLICY_FN = tlayers.remat_policy_fn
FWD, BWD, SPLIT = "mlpt.flash_fwd", "mlpt.flash_bwd", "mlpt.flash_bwd_split"


class OpCounter(TorchDispatchMode):
    """Counts the ops that really run under it, by overload packet: an op
    whose saved outputs a remat recompute takes is not run again."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def _loss_and_grads(module, loss_fn):
    module.zero_grad(set_to_none=True)
    with OpCounter() as counter:
        loss = loss_fn(module)
        loss.backward()
    grads = {n: p.grad.clone() for n, p in module.named_parameters() if p.grad is not None}
    return loss.detach(), grads, counter.counts


def _assert_equal_runs(ref, got):
    assert torch.equal(got[0], ref[0]), (got[0], ref[0])
    assert got[1].keys() == ref[1].keys()
    for name in ref[1]:
        assert torch.equal(got[1][name], ref[1][name]), name
    assert got[2][FWD] == ref[2][FWD] and got[2][BWD] == ref[2][BWD]


# ---------------------------------------------------------------- pythia


def _pythia(policy, dtype):
    bundle = get_model_class("pythia-14m").build_model(
        activation_checkpointing=policy is not None, checkpoint_policy=policy or "flash", compute_dtype=dtype,
        device="cpu")
    bundle.init_fn(bundle.module, torch.Generator().manual_seed(0))
    return bundle.module


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("policy", ["flash", "dots"])
def test_pythia_remat_gives_the_same_loss_and_grads(policy, dtype):
    """pythia-14m (6 blocks) at sequence 33: loss and every grad bit for
    bit, one forward and one backward op per block in both runs."""
    ids = torch.randint(0, 50304, (2, SEQ), generator=torch.Generator().manual_seed(1))

    def loss_fn(m):
        return m(ids, labels=ids)

    ref = _loss_and_grads(_pythia(None, dtype), loss_fn)
    got = _loss_and_grads(_pythia(policy, dtype), loss_fn)
    assert ref[2][FWD] == ref[2][BWD] == 6
    _assert_equal_runs(ref, got)
    assert _pythia(policy, dtype).remat_policy == policy


def test_plain_block_recomputes_what_the_policy_does_not_keep():
    """Under "flash" the recompute runs every product of the block again
    but the attention forward; under "dots" only the output projection is
    run again (the MLP's down projection comes after the last value the
    backward needs, so the recompute stops before it)."""
    block = tpythia.GPTNeoXBlock(64, 4, dtype=torch.bfloat16)
    x = torch.randn(2, SEQ, 64, dtype=torch.bfloat16, requires_grad=True)
    runs = {}
    for policy in (None, "flash", "dots"):
        with OpCounter() as counter:
            tlayers.checkpoint_block(block, x, policy=policy).float().sum().backward()
        runs[policy] = counter.counts
    fwd_products = 4  # qkv, out, up, down
    assert runs[None][FWD] == runs["flash"][FWD] == runs["dots"][FWD] == 1
    assert runs["flash"]["aten.addmm"] - runs[None]["aten.addmm"] == fwd_products - 1
    assert runs["dots"]["aten.addmm"] - runs[None]["aten.addmm"] == 1


def _jax_residuals(policy: str, batch: int) -> list[tuple[str, tuple[int, ...]]]:
    """(dtype, shape) of each residual ``jax.checkpoint`` keeps for one
    ``GPTNeoXBlock`` under ``policy``, arguments and constants left out."""
    block = jpythia.GPTNeoXBlock(hidden=64, num_heads=4, attn_impl="pallas", dtype=jnp.bfloat16)
    x = jnp.ones((batch, SEQ, 64), jnp.bfloat16)
    params = block.init(jax.random.key(0), x)
    flash_names = jax.checkpoint_policies.save_only_these_names("flash_out", "flash_lse")
    jpolicy = flash_names if policy == "flash" else jax.checkpoint_policies.save_from_both_policies(
        jax.checkpoint_policies.dots_with_no_batch_dims_saveable, flash_names)
    fn = jax.checkpoint(lambda p, x: block.apply(p, x)[0], policy=jpolicy)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        print_saved_residuals(fn, params, x)
    found = []
    for line in out.getvalue().splitlines():
        if "from the argument" in line or "from a constant" in line:
            continue
        m = re.match(r"(\w+)\[([\d,]*)\]", line)
        found.append((m.group(1), tuple(int(d) for d in m.group(2).split(",") if d)))
    return found


def _torch_residuals(policy: str, batch: int, monkeypatch) -> list[tuple[str, tuple[int, ...]]]:
    """(dtype, shape) of each output ``checkpoint_block``'s policy keeps for
    one ``GPTNeoXBlock`` (bf16 compute, f32 params, as the JAX block)."""
    kept = []

    def recording(save_dots, ctx, op, *args, **kwargs):
        decision = _POLICY_FN(save_dots, ctx, op, *args, **kwargs)
        if decision == tlayers.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            outs = ctx.op_output if isinstance(ctx.op_output, tuple) else (ctx.op_output,)
            kept.extend(({torch.bfloat16: "bf16", torch.float32: "f32"}[t.dtype], tuple(t.shape)) for t in outs)
        return decision

    monkeypatch.setattr(tlayers, "remat_policy_fn", recording)
    block = tpythia.GPTNeoXBlock(64, 4, dtype=torch.bfloat16)
    x = torch.randn(batch, SEQ, 64, dtype=torch.bfloat16, requires_grad=True)
    tlayers.checkpoint_block(block, x, policy=policy).float().sum().backward()
    return kept


def _per_example(small, large):
    """The residuals that grow with the batch, leading dims merged, sorted."""
    assert len(small) == len(large)
    grown = [(dt, s) for (dt, s), (_, l) in zip(small, large) if torch.Size(l).numel() != torch.Size(s).numel()]
    return sorted((dt, (torch.Size(s[:-1]).numel(), s[-1])) for dt, s in grown)


@pytest.mark.parametrize("policy", ["flash", "dots"])
def test_saved_residuals_match_jax_per_block(policy, monkeypatch):
    """"flash": the attention's out [BH, S, D] bf16 and lse [BH, S] f32.
    "dots": those and the qkv and MLP-up products, the two products a
    backward reads (JAX's remat drops the output and down projections,
    which only enter residual sums)."""
    jax_side = _per_example(_jax_residuals(policy, 2), _jax_residuals(policy, 4))
    torch_side = _per_example(_torch_residuals(policy, 2, monkeypatch), _torch_residuals(policy, 4, monkeypatch))
    assert torch_side == jax_side
    assert len(jax_side) == {"flash": 2, "dots": 4}[policy]


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="checkpoint_policy"):
        get_model_class("pythia-14m").build_model(activation_checkpointing=True, checkpoint_policy="full", device="meta")
    block = tpythia.GPTNeoXBlock(64, 4)
    with pytest.raises(ValueError, match="checkpoint_policy"):
        tlayers.checkpoint_block(block, torch.randn(1, 3, 64), policy="dots_saveable")


# ---------------------------------------------------------------- llava


TOWER = dict(hidden=32, num_layers=2, num_heads=2, intermediate=64, patch=14, image_size=28)
LM = dict(hidden=64, num_layers=2, num_heads=4, num_kv_heads=2, ffn=128)
VOCAB, IMAGE = 300, 299


def _llava(policy):
    torch.manual_seed(0)
    mod = tllava.LlavaModule(tower_kwargs=TOWER, lm_kwargs=LM, vocab_with_image=VOCAB, image_token=IMAGE,
                             remat_policy=policy, dtype=torch.bfloat16)
    mod.reset_parameters(torch.Generator().manual_seed(0))
    for name, p in mod.named_parameters():  # llava-pretrain: tower and LM frozen
        p.requires_grad_(not name.startswith(("vision_tower", "language_model")))
    return mod


def test_llava_remat_gives_the_same_loss_and_grads_and_runs_no_tower_backward():
    """llava at the JAX toy dims (1 tower block, 2 decoder blocks), bf16, on
    a right-padded batch: loss and the projector's grads bit for bit; the
    frozen tower's block needs no gradient, so it runs no checkpoint and no
    backward: 3 forwards and 2 backwards in both runs."""
    rng = torch.Generator().manual_seed(2)
    ids = torch.randint(0, IMAGE, (2, 12), generator=rng)
    ids[:, 2] = IMAGE
    pix = torch.rand(2, 28, 28, 3, generator=rng)
    mask = (torch.arange(12)[None, :] < torch.tensor([12, 8])[:, None]).long()
    labels = torch.where(mask > 0, ids, -100)

    def loss_fn(m):
        return m(ids, pix, labels=labels, attention_mask=mask)

    ref = _loss_and_grads(_llava(None), loss_fn)
    got = _loss_and_grads(_llava("flash"), loss_fn)
    _assert_equal_runs(ref, got)
    assert (ref[2][FWD], ref[2][BWD]) == (3, 2)
    assert set(got[1]) == {"projector_in.weight", "projector_in.bias", "projector_out.weight", "projector_out.bias"}
    assert get_model_class("llava-pretrain").build_model(activation_checkpointing=True, device="meta").module.language_model.remat_policy == "flash"


# ---------------------------------------------------------------- ViT


def _vit(policy):
    mod = tvit.ViTClassifier(num_classes=10, image_size=32, hidden=64, num_layers=2, num_heads=2, ffn=128,
                             remat_policy=policy)
    mod.reset_parameters(torch.Generator().manual_seed(0))
    return mod


def test_vit_remat_replays_dropout_and_leaves_the_generator_where_no_remat_does():
    """A 2-layer ViT (head_dim 32, 5 tokens) with dropout 0.1 drawing from a
    generator seeded alike in both runs: the recompute replays the masks,
    so loss and every grad are bit for bit the no-remat ones, and the
    generator ends in the same state (the recompute drew nothing of its
    own), so a second micro-batch draws the same masks too."""
    pix = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(3))
    labels = torch.tensor([1, 5, 7, 0])
    runs, states = {}, {}
    for policy in (None, "flash"):
        gen = torch.Generator().manual_seed(11)
        mod = _vit(policy)

        def loss_fn(m):
            return tlayers.cross_entropy_loss(m(pix, gen), labels)

        runs[policy] = [_loss_and_grads(mod, loss_fn) for _ in range(2)]
        states[policy] = gen.get_state()
    for ref, got in zip(runs[None], runs["flash"]):
        _assert_equal_runs(ref, got)
    assert not torch.equal(runs[None][0][0], runs[None][1][0])  # the second micro-batch drew other masks
    assert torch.equal(states["flash"], states[None])
    assert get_model_class("vit").build_model(activation_checkpointing=True, device="meta").module.remat_policy == "flash"


def test_recompute_restores_the_generator_state_it_began_with():
    """``checkpoint_block``'s recompute sets the generator to its state
    before the block, and on leaving puts back the state it found."""
    block = tvit.ViTBlock(64, 2, 128)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 5, 64, requires_grad=True)
    y = tlayers.checkpoint_block(block, x, policy="flash", generator=gen)
    after_forward = gen.get_state()
    torch.rand(7, generator=gen)  # draws between the forward and the backward
    before_backward = gen.get_state()
    y.sum().backward()
    assert torch.equal(gen.get_state(), before_backward)
    assert not torch.equal(after_forward, before_backward)


# ---------------------------------------------------------------- the ops on CPU


def _qkv(varlen: bool):
    g = torch.Generator().manual_seed(4)
    q, k, v, do = (torch.randn(6, 33, 32, generator=g).to(torch.bfloat16) for _ in range(4))
    lens = torch.tensor([33, 0, 5, 17, 33, 1], dtype=torch.int32) if varlen else None
    return q, k, v, do, lens


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("varlen", [False, True])
def test_ops_on_cpu_are_the_plain_versions(varlen, fused, monkeypatch):
    """The forward op and, through its autograd, the backward that
    ``PREFER_FUSED_BWD`` picks give the plain versions' results bit for
    bit, as the autograd ``Function`` they replace did; nothing launches."""
    monkeypatch.setattr(fa, "PREFER_FUSED_BWD", fused)
    q, k, v, do, lens = _qkv(varlen)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (fa.FWD_LAUNCHES, fa.VARLEN_FWD_LAUNCHES, fa.BWD_LAUNCHES, fa.DQ_LAUNCHES)
    out, lse = fa.flash_fwd(*leaves, True, 0.2, lens)
    out.backward(do)
    out_ref, lse_ref = fa.flash_fwd_reference(q, k, v, True, 0.2, lens)
    bwd = fa.flash_bwd_reference if fused else fa.flash_bwd_split_reference
    grads_ref = bwd(q, k, v, out_ref, lse_ref, do, True, 0.2, lens)
    assert torch.equal(out, out_ref) and torch.equal(lse, lse_ref)
    for leaf, want in zip(leaves, grads_ref):
        assert torch.equal(leaf.grad, want)
    assert not lse.requires_grad
    assert (fa.FWD_LAUNCHES, fa.VARLEN_FWD_LAUNCHES, fa.BWD_LAUNCHES, fa.DQ_LAUNCHES) == before


@pytest.mark.parametrize("varlen", [False, True])
@pytest.mark.parametrize("op", ["flash_fwd", "flash_bwd", "flash_bwd_split"])
def test_opcheck_on_cpu(op, varlen):
    """Schema, autograd registration, fake implementation and AOT dispatch
    of each op, on CPU tensors."""
    q, k, v, do, lens = _qkv(varlen)
    if op == "flash_fwd":
        args = (q.requires_grad_(), k.requires_grad_(), v.requires_grad_(), True, 0.2, lens)
    else:
        out, lse = fa.flash_fwd_reference(q, k, v, True, 0.2, lens)
        args = (q, k, v, out, lse, do, True, 0.2, lens)
    torch.library.opcheck(getattr(fa, op), args)
