"""The port's CUDA flash-attention kernels against their plain versions.

This file imports no JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda

The tests marked ``cuda`` skip where no GPU is visible (the kernels have no
CPU mode); the others check the wrappers' guards and run anywhere.

Tolerances (bf16 inputs): out, dq, dk and dv within 1e-2 of their norm (the
two sides round the same operands to bf16 and differ in summation order and
in the online softmax's rescaling); lse within 1e-3 absolute (f32, no bf16
output rounding). dq is summed with f32 atomics in an order that changes
from run to run, so two runs may differ by one bf16 ulp of the larger value
per element (plus f32 noise where terms cancel); dk and dv have no atomics
and repeat bit for bit.
"""

import pytest
import torch

from multimodal_llm_pretraining_tpu_torch.ops import flash_attention as fa

NORM_REL = 1e-2
LSE_ABS = 1e-3


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _rand(*shape, seed=0, dtype=torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(*shape, generator=g, device="cuda").to(dtype)


def _close(got, want, tol=NORM_REL):
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).norm() / want.float().norm()
    assert err <= tol, err.item()


def test_wrappers_refuse_cpu_tensors():
    """CPU tensors never reach a kernel wrapper: the plain version is chosen
    by where the tensors lie, not as a fallback."""
    q = torch.randn(2, 16, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd_cuda(q, q, q, True, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd_cuda(q, q, q, q, torch.zeros(2, 16), q, True, 0.125)


def test_function_takes_plain_versions_on_cpu_without_launching():
    before = (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES)
    q = torch.randn(1, 2, 9, 16, requires_grad=True)
    fa.flash_attention(q, q, q, causal=True).sum().backward()
    assert (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES) == before
    assert q.grad is not None


@pytest.mark.cuda
@pytest.mark.parametrize("seq,head_dim,causal", [(77, 64, True), (130, 128, False), (257, 256, True), (64, 256, False)])
def test_kernels_match_plain_versions(seq, head_dim, causal):
    _needs_cuda()
    q, k, v, do = (_rand(6, seq, head_dim, seed=i) for i in range(4))
    scale = head_dim**-0.5
    out, lse = fa.flash_fwd_cuda(q, k, v, causal, scale)
    out_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal, scale)
    _close(out, out_ref)
    torch.testing.assert_close(lse, lse_ref, atol=LSE_ABS, rtol=0)
    grads = fa.flash_bwd_cuda(q, k, v, out_ref, lse_ref, do, causal, scale)
    for got, want in zip(grads, fa.flash_bwd_reference(q, k, v, out_ref, lse_ref, do, causal, scale)):
        assert got.dtype == torch.bfloat16
        _close(got, want)


@pytest.mark.cuda
def test_kernels_take_f32_inputs():
    """f32 inputs are rounded to bf16 where they enter the tensor cores, as a
    default-precision f32 dot does on the TPU: the outputs stay f32 and
    agree with the f32 plain version to bf16 accuracy."""
    _needs_cuda()
    q, k, v, do = (_rand(4, 100, 64, seed=i, dtype=torch.float32) for i in range(4))
    out, lse = fa.flash_fwd_cuda(q, k, v, True, 0.125)
    out_ref, lse_ref = fa.flash_fwd_reference(q, k, v, True, 0.125)
    assert out.dtype == torch.float32
    _close(out, out_ref)
    torch.testing.assert_close(lse, lse_ref, atol=2e-2, rtol=0)  # q*scale and k round to bf16 here
    for got, want in zip(fa.flash_bwd_cuda(q, k, v, out_ref, lse_ref, do, True, 0.125),
                         fa.flash_bwd_reference(q, k, v, out_ref, lse_ref, do, True, 0.125)):
        _close(got, want, tol=2e-2)


@pytest.mark.cuda
def test_autograd_function_launches_kernels_on_strided_views():
    """[B, S, H, D] -> [B, H, S, D] transposed views, as ``SelfAttention``
    makes them, go through the autograd Function: one forward and one
    backward launch, results equal to the plain versions."""
    _needs_cuda()
    b, s, h, d = 2, 90, 3, 64
    base = [_rand(b, s, h, d, seed=i).requires_grad_() for i in range(3)]
    q, k, v = (t.transpose(1, 2) for t in base)
    do = _rand(b, h, s, d, seed=9)
    fa.reset_launch_counts()
    fa.flash_attention(q, k, v, causal=True).backward(do)
    assert (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES) == (1, 1)
    flat = [t.detach().transpose(1, 2).reshape(b * h, s, d) for t in base]
    out_ref, lse_ref = fa.flash_fwd_reference(*flat, True, d**-0.5)
    grads_ref = fa.flash_bwd_reference(*flat, out_ref, lse_ref, do.reshape(b * h, s, d), True, d**-0.5)
    for t, want in zip(base, grads_ref):
        _close(t.grad.transpose(1, 2).reshape(b * h, s, d), want)


@pytest.mark.cuda
def test_dq_varies_by_at_most_one_ulp_between_runs():
    _needs_cuda()
    q, k, v, do = (_rand(8, 257, 256, seed=i) for i in range(4))
    out, lse = fa.flash_fwd_cuda(q, k, v, True, 1 / 16)
    dq1, dk1, dv1 = fa.flash_bwd_cuda(q, k, v, out, lse, do, True, 1 / 16)
    dq2, dk2, dv2 = fa.flash_bwd_cuda(q, k, v, out, lse, do, True, 1 / 16)
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)
    # one bf16 ulp of the larger value, plus f32 summation-order noise
    # where the terms cancel to near zero
    ulp = torch.maximum(dq1.float().abs(), dq2.float().abs()) * 2.0**-7
    assert ((dq1.float() - dq2.float()).abs() <= ulp + 1e-6).all()


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take():
    _needs_cuda()
    q = _rand(2, 16, 96)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd_cuda(q, q, q, True, 0.1)
    q = _rand(2, 16, 64, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fa.flash_fwd_cuda(q, q, q, True, 0.1)
