"""Mamba's causal conv with its SiLU (``ops/causal_conv.py``) on the CPU,
where the ``mlpt::causal_conv_*`` ops run their plain versions.

The plain versions are the composition the port computed before the
kernels, ``F.silu(causal_conv1d(x.float(), w.float(), b.float())).to(x.dtype)``,
and autograd's gradient of it: on a strided half of a [B, L, 2I] tensor, as
``MambaBlock`` hands ``in_proj``'s output over, the op's output and all three
gradients equal the composition's bit for bit, and so does a block with
``residual_in_fp32`` (the published arithmetic, which routes its conv
through the op). With ``residual_in_fp32=False`` the block keeps the JAX
arithmetic and never calls the op. The kernels' launch counters stay at 0
here, and the FLOP counter counts the ops as it counted the convolution.
The kernels themselves are held to these plain versions on the card
(``tests/test_torch_kernels.py``, marked ``cuda``).
"""

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from multimodal_llm_pretraining_tpu_torch.benchmarking import flops as tflops
from multimodal_llm_pretraining_tpu_torch.models import mamba as tmamba
from multimodal_llm_pretraining_tpu_torch.models.mamba import MambaBlock
from multimodal_llm_pretraining_tpu_torch.ops import causal_conv as cc
from multimodal_llm_pretraining_tpu_torch.ops.selective_scan import causal_conv1d, selective_scan

torch.set_num_threads(2)
BF16, F32 = torch.bfloat16, torch.float32


def _composition(x, w, b):
    """The block's conv before the kernels: f32 conv, bias and SiLU, one cast."""
    return F.silu(causal_conv1d(x.to(F32), w.to(F32), b.to(F32))).to(x.dtype)


def _inputs(B, L, I, K, x_dtype, p_dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    base = torch.randn(B, L, 2 * I, generator=g).to(x_dtype)
    w = (torch.rand(K, I, generator=g) - 0.5).to(p_dtype)
    b = (torch.rand(I, generator=g) - 0.5).to(p_dtype)
    dout = torch.randn(B, L, I, generator=g).to(x_dtype)
    return base, w, b, dout


# (B, L, I, K, x dtype, parameter dtype)
CASES = [
    (2, 3, 16, 4, BF16, BF16),  # L < K
    (2, 300, 24, 4, BF16, BF16),  # L a multiple of no kernel tile (256 steps forward, 1024 backward)
    (3, 37, 13, 4, BF16, F32),  # I not a multiple of 8
    (1, 130, 40, 4, F32, F32),  # batch 1, f32 compute
    (1, 2, 8, 4, F32, BF16),  # batch 1, L < K, f32 compute over bf16 parameters
    (2, 65, 20, 3, BF16, F32),  # K 3
    (2, 19, 8, 1, F32, F32),  # K 1
]


@pytest.mark.parametrize("B,L,I,K,x_dtype,p_dtype", CASES)
def test_plain_op_equals_the_composition(B, L, I, K, x_dtype, p_dtype):
    """On the strided first half of [B, L, 2I]: the op's output and the
    gradients of x (scattered into the whole tensor), the taps and the bias
    equal the composition's bit for bit, in their dtypes; the output is
    contiguous."""
    base, w, b, dout = _inputs(B, L, I, K, x_dtype, p_dtype, seed=B * L + I)
    results = []
    for fn in (_composition, cc.causal_conv_silu):
        bb, ww, bi = (t.clone().requires_grad_() for t in (base, w, b))
        out = fn(bb[..., :I], ww, bi)
        out.backward(dout)
        results.append((out.detach(), bb.grad, ww.grad, bi.grad))
    (out, *grads), (out_op, *grads_op) = results
    assert out_op.dtype == x_dtype and out_op.is_contiguous() and torch.equal(out_op, out)
    for got, want in zip(grads_op, grads):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_plain_backward_is_the_ops_and_counts_no_launch():
    """The backward op on CPU tensors is its plain version; neither op counts
    a kernel launch on the CPU."""
    base, w, b, dout = _inputs(2, 40, 16, 4, BF16, BF16, seed=3)
    x = base[..., :16]
    cc.reset_launch_counts()
    out = cc.causal_conv_fwd(x, w, b)
    grads = cc.causal_conv_bwd(x, w, b, dout)
    assert torch.equal(out, cc.causal_conv_fwd_reference(x, w, b))
    for got, want in zip(grads, cc.causal_conv_bwd_reference(x, w, b, dout)):
        assert torch.equal(got, want)
    assert (cc.CONV_FWD_LAUNCHES, cc.CONV_BWD_LAUNCHES) == (0, 0)


@pytest.mark.parametrize("x_dtype,p_dtype", [(BF16, BF16), (F32, F32)])
def test_ops_pass_opcheck_on_the_cpu(x_dtype, p_dtype):
    """``mlpt::causal_conv_fwd`` (with its autograd rule, on a strided half)
    and ``mlpt::causal_conv_bwd`` under ``torch.library.opcheck``: schema,
    fakes and the forward's autograd registration."""
    base, w, b, dout = _inputs(2, 21, 12, 4, x_dtype, p_dtype, seed=5)
    x = base[..., :12]
    torch.library.opcheck(cc.causal_conv_fwd, (x.detach().requires_grad_(), w.clone().requires_grad_(),
                                                b.clone().requires_grad_()))
    torch.library.opcheck(cc.causal_conv_bwd, (x, w, b, dout))


def test_cuda_wrappers_refuse_cpu_tensors():
    base, w, b, dout = _inputs(1, 8, 8, 4, BF16, BF16)
    with pytest.raises(ValueError, match="causal-conv kernels take CUDA tensors"):
        cc.causal_conv_fwd_cuda(base[..., :8], w, b)
    with pytest.raises(ValueError, match="causal-conv kernels take CUDA tensors"):
        cc.causal_conv_bwd_cuda(base[..., :8], w, b, dout)


def test_flop_formulas_count_the_convolution():
    """2·K·B·L·I forward and twice that backward, what ``F.conv1d`` and its
    backward counted before (``_conv_backward_flops`` for the backward)."""
    B, L, I, K = 2, 40, 24, 4
    base, w, b, dout = _inputs(B, L, I, K, F32, F32)
    assert tflops._causal_conv_fwd_flops(base[..., :I], w, b) == 2 * K * B * L * I
    assert tflops._causal_conv_bwd_flops(base[..., :I], w, b, dout) == 4 * K * B * L * I
    counts = []
    for fn in (cc.causal_conv_silu, _composition):
        bb, ww, bi = (t.clone().requires_grad_() for t in (base, w, b))
        with FlopCounterMode(display=False,
                             custom_mapping={torch.ops.aten.convolution_backward: tflops._conv_backward_flops}) as c:
            fn(bb[..., :I], ww, bi).backward(dout)
        counts.append(c.get_total_flops())
    assert counts == [6 * K * B * L * I] * 2


def _block(dtype, p_dtype, residual_in_fp32):
    torch.manual_seed(0)
    blk = MambaBlock(32, 64, 16, 4, 4, use_custom_kernels=True, dtype=dtype, residual_in_fp32=residual_in_fp32)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            p.copy_(torch.log(torch.arange(1, 17.0)).expand_as(p) if name == "A_log" else torch.randn(p.shape) * 0.3)
    return blk.to(p_dtype)


def _block_forward_before_the_kernels(self, x):
    """``MambaBlock.forward`` with ``residual_in_fp32`` as it was before the
    conv had its op: the composition on the strided half."""
    cdt = self.compute_dtype
    h, x = self.norm(x.float(), residual=True)
    u, z = self.in_proj(h).chunk(2, dim=-1)
    u = _composition(u, self.conv_weight, self.conv_bias).to(cdt)
    dt, B, C = self.x_proj(u).split([self.dt_rank, self.d_state, self.d_state], dim=-1)
    delta = F.softplus(self.dt_proj(dt))
    y = selective_scan(u, delta, -torch.exp(self.A_log), B, C, self.D, use_custom_kernels=self.use_custom_kernels)
    return x + self.out_proj((y * F.silu(z.float())).to(cdt))


@pytest.mark.parametrize("bsz", [1, 2])
@pytest.mark.parametrize("dtype,p_dtype", [(BF16, BF16), (BF16, F32), (F32, F32)])
def test_block_with_published_arithmetic_computes_as_before(bsz, dtype, p_dtype):
    """A ``MambaBlock`` with ``residual_in_fp32`` on the CPU: output, the
    stream's gradient and every parameter's gradient bit for bit those of
    the block before its conv went through the op."""
    blk = _block(dtype, p_dtype, True)
    g = torch.Generator().manual_seed(bsz)
    x, dy = torch.randn(bsz, 40, 32, generator=g), torch.randn(bsz, 40, 32, generator=g)
    results = []
    for forward in (MambaBlock.forward, _block_forward_before_the_kernels):
        blk.zero_grad(set_to_none=True)
        xx = x.clone().requires_grad_()
        out = forward(blk, xx)
        out.backward(dy)
        results.append([out.detach(), xx.grad] + [p.grad for p in blk.parameters()])
    assert all(torch.equal(a, c) for a, c in zip(*results))


def test_block_with_jax_arithmetic_does_not_call_the_op(monkeypatch):
    """``residual_in_fp32=False`` keeps the JAX arithmetic (the conv and its
    SiLU in the compute dtype) and never reaches the op."""
    blk = _block(BF16, BF16, False)
    x = torch.randn(2, 24, 32).to(BF16)
    want = blk(x)

    def refuse(*args):
        raise AssertionError("the JAX arithmetic called the conv op")

    monkeypatch.setattr(tmamba, "causal_conv_silu", refuse)
    assert torch.equal(blk(x), want)
    with pytest.raises(AssertionError, match="called the conv op"):
        _block(BF16, BF16, True)(x.float())
