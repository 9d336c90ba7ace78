"""Mamba's gate y * SiLU(z) (``ops/gate.py``) on the CPU, where the
``mlpt::gate_silu_*`` ops run their plain versions.

The plain versions are the composition the port computed before the
kernels, ``(y * F.silu(z.to(f32))).to(y.dtype)``, and autograd's gradient of
it: with z a strided half of a [B, L, 2I] tensor, as ``MambaBlock`` hands
``in_proj``'s output over, and with z contiguous, the op's output and both
gradients equal the composition's bit for bit, and so does a block with
``residual_in_fp32`` (the published arithmetic, which routes its gate
through the op). With ``residual_in_fp32=False`` the block keeps the JAX
arithmetic and never calls the op. The kernels' launch counters stay at 0
here. The kernels themselves are held to these plain versions on the card
(``tests/test_torch_kernels.py``, marked ``cuda``).
"""

import pytest
import torch
import torch.nn.functional as F

from multimodal_llm_pretraining_tpu_torch.models import mamba as tmamba
from multimodal_llm_pretraining_tpu_torch.models.mamba import MambaBlock
from multimodal_llm_pretraining_tpu_torch.ops import gate
from multimodal_llm_pretraining_tpu_torch.ops.causal_conv import causal_conv_silu
from multimodal_llm_pretraining_tpu_torch.ops.selective_scan import selective_scan

torch.set_num_threads(2)
BF16, F32 = torch.bfloat16, torch.float32


def _composition(y, z):
    """The block's gate before the kernels: y times SiLU of the f32 z, one cast."""
    return (y * F.silu(z.to(F32))).to(y.dtype)


def _inputs(B, L, I, dtype, strided, seed=0):
    """y and dout [B, L, I], z the second half of a [B, L, 2I] tensor where
    ``strided`` (returned whole, with the view), all N(0, 2^2) so that
    SiLU's both tails are reached."""
    g = torch.Generator().manual_seed(seed)
    y = (torch.randn(B, L, I, generator=g) * 2).to(dtype)
    base = (torch.randn(B, L, 2 * I if strided else I, generator=g) * 2).to(dtype)
    dout = (torch.randn(B, L, I, generator=g) * 2).to(dtype)
    return y, base, dout


def _z(base, I):
    return base[..., base.shape[-1] - I:]


# (B, L, I, dtype, z a strided half of [B, L, 2I])
CASES = [
    (2, 40, 24, BF16, True),
    (2, 40, 24, BF16, False),
    (1, 33, 13, BF16, True),  # I not a multiple of 8
    (3, 1, 16, BF16, True),  # L 1
    (2, 21, 20, F32, True),
    (1, 30, 12, F32, False),
]


@pytest.mark.parametrize("B,L,I,dtype,strided", CASES)
def test_plain_op_equals_the_composition(B, L, I, dtype, strided):
    """The op's output and the gradients of y and of z (scattered into the
    whole tensor z is a half of) equal the composition's bit for bit, in
    their dtypes; the output is contiguous."""
    y, base, dout = _inputs(B, L, I, dtype, strided, seed=B * L + I)
    results = []
    for fn in (_composition, gate.gate_silu):
        yy, bb = y.clone().requires_grad_(), base.clone().requires_grad_()
        out = fn(yy, _z(bb, I))
        out.backward(dout)
        results.append((out.detach(), yy.grad, bb.grad))
    (out, *grads), (out_op, *grads_op) = results
    assert out_op.dtype == dtype and out_op.is_contiguous() and torch.equal(out_op, out)
    for got, want in zip(grads_op, grads):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_plain_backward_is_the_ops_and_counts_no_launch():
    """The backward op on CPU tensors is its plain version; neither op counts
    a kernel launch on the CPU."""
    y, base, dout = _inputs(2, 40, 16, BF16, True, seed=3)
    z = _z(base, 16)
    gate.reset_launch_counts()
    out = gate.gate_silu_fwd(y, z)
    dy, dz = gate.gate_silu_bwd(y, z, dout)
    assert torch.equal(out, gate.gate_silu_fwd_reference(y, z))
    want_dy, want_dz = gate.gate_silu_bwd_reference(y, z, dout)
    assert torch.equal(dy, want_dy) and torch.equal(dz, want_dz)
    assert (dy.dtype, dz.dtype) == (BF16, BF16)
    assert (gate.GATE_FWD_LAUNCHES, gate.GATE_BWD_LAUNCHES) == (0, 0)


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_ops_pass_opcheck_on_the_cpu(dtype):
    """``mlpt::gate_silu_fwd`` (with its autograd rule, z a strided half)
    and ``mlpt::gate_silu_bwd`` under ``torch.library.opcheck``: schema,
    fakes and the forward's autograd registration."""
    y, base, dout = _inputs(2, 21, 12, dtype, True, seed=5)
    z = _z(base, 12)
    torch.library.opcheck(gate.gate_silu_fwd, (y.clone().requires_grad_(), z.detach().requires_grad_()))
    torch.library.opcheck(gate.gate_silu_bwd, (y, z, dout))


def test_cuda_wrappers_refuse_cpu_tensors():
    y, base, dout = _inputs(1, 8, 8, BF16, True)
    with pytest.raises(ValueError, match="gate kernels take CUDA tensors"):
        gate.gate_silu_fwd_cuda(y, _z(base, 8))
    with pytest.raises(ValueError, match="gate kernels take CUDA tensors"):
        gate.gate_silu_bwd_cuda(y, _z(base, 8), dout)


@pytest.mark.parametrize("shape,strides,expected", [
    ((2, 5, 8), (80, 16, 1), 16),  # the strided half of [2, 5, 16]
    ((2, 5, 8), (40, 8, 1), 8),  # contiguous
    ((1, 5, 8), (99, 16, 1), 16),  # one sequence: its own rows' stride
    ((3, 1, 8), (24, 999, 1), 24),  # one step: the sequences' stride
    ((2, 5, 8), (96, 16, 1), None),  # sequences not L rows apart
])
def test_row_stride_of_a_view(shape, strides, expected):
    """The kernels take B x L rows at one stride: the views the block hands
    over have one, others are copied by the wrappers."""
    t = torch.empty(400).as_strided(shape, strides)
    assert gate._row_stride(t) == expected


def _block(dtype, p_dtype, residual_in_fp32):
    torch.manual_seed(0)
    blk = MambaBlock(32, 64, 16, 4, 4, use_custom_kernels=True, dtype=dtype, residual_in_fp32=residual_in_fp32)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            p.copy_(torch.log(torch.arange(1, 17.0)).expand_as(p) if name == "A_log" else torch.randn(p.shape) * 0.3)
    return blk.to(p_dtype)


def _block_forward_before_the_kernels(self, x):
    """``MambaBlock.forward`` with ``residual_in_fp32`` as it was before the
    gate had its op: the composition over the f32 z."""
    cdt = self.compute_dtype
    h, x = self.norm(x.float(), residual=True)
    u, z = self.in_proj(h).chunk(2, dim=-1)
    u = causal_conv_silu(u, self.conv_weight, self.conv_bias)
    dt, B, C = self.x_proj(u).split([self.dt_rank, self.d_state, self.d_state], dim=-1)
    delta = F.softplus(self.dt_proj(dt))
    y = selective_scan(u, delta, -torch.exp(self.A_log), B, C, self.D, use_custom_kernels=self.use_custom_kernels)
    return x + self.out_proj((y * F.silu(z.to(F32))).to(cdt))


@pytest.mark.parametrize("bsz", [1, 2])
@pytest.mark.parametrize("dtype,p_dtype", [(BF16, BF16), (BF16, F32), (F32, F32)])
def test_block_with_published_arithmetic_computes_as_before(bsz, dtype, p_dtype):
    """A ``MambaBlock`` with ``residual_in_fp32`` on the CPU: output, the
    stream's gradient and every parameter's gradient bit for bit those of
    the block before its gate went through the op."""
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
    """``residual_in_fp32=False`` keeps the JAX arithmetic (the gate in the
    compute dtype) and never reaches the op."""
    blk = _block(BF16, BF16, False)
    x = torch.randn(2, 24, 32).to(BF16)
    want = blk(x)

    def refuse(*args):
        raise AssertionError("the JAX arithmetic called the gate op")

    monkeypatch.setattr(tmamba, "gate_silu", refuse)
    assert torch.equal(blk(x), want)
    with pytest.raises(AssertionError, match="called the gate op"):
        _block(BF16, BF16, True)(x.float())
