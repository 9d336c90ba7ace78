"""CPU checks of the benchmark's yardstick: the FLOP closed forms, the
kernel bounds, the kind table and the trace arithmetic, the traffic
generator, the seeded weights, and the plain references against the port
at small sizes.

    python -m pytest bench_port/tests -q
"""

import math

import numpy as np
import pytest
import torch

from bench_port.reference import common, gptneox, mamba
from bench_port.yardstick import bounds, data, flops, trace, weights


def test_gptneox_closed_form_is_the_ports():
    from multimodal_llm_pretraining_tpu_torch.benchmarking.flops import analytic_flops_per_example
    from multimodal_llm_pretraining_tpu_torch.models import get_model_class

    cfg = {"family": "gptneox", "sequence_length": 2049, "num_hidden_layers": 16, "hidden_size": 2048,
           "intermediate_size": 8192, "vocab_size": 50304}
    assert flops.flops_per_sequence(cfg) == pytest.approx(analytic_flops_per_example(get_model_class("pythia-1b")),
                                                          rel=1e-12)


def test_mamba_closed_form_against_the_ports_count():
    """PR 12's ``FlopCounterMode`` count of mamba-2.8b, 6.951503e13 an
    example, is the closed form plus the LM head's logits recomputed in the
    backward over the 4095 shifted positions."""
    cfg = {"family": "mamba", "sequence_length": 4096, "n_layer": 64, "d_model": 2560, "d_inner": 5120,
           "d_state": 16, "d_conv": 4, "dt_rank": 160, "padded_vocab_size": 50280}
    counted = 6.951503e13
    closed = flops.flops_per_sequence(cfg)
    assert closed / counted - 1 == pytest.approx(-0.01515, abs=1e-4)
    assert (closed + 2 * 2560 * 50280 * 4095) / counted == pytest.approx(1.0, abs=5e-5)


def test_bounds_reproduce_the_repos_table():
    """PERF.md's kernel table: pythia's [4, 8, 2049, 256] causal bf16 forward
    0.0696 ms and backward 0.1740 ms (operations); the scan at [2, 4096,
    5120] bf16 forward 0.1605 ms (exps) and backward 0.2041 ms (684 MB)."""
    fb = bounds.flash_bounds(4, 8, 2049, 256, True)
    assert fb["fwd"] * 1e3 == pytest.approx(0.0696, abs=5e-5)
    assert fb["bwd"] * 1e3 == pytest.approx(0.1740, abs=5e-5)
    sb = bounds.scan_bounds(2, 4096, 5120, 16)
    assert sb["fwd"] * 1e3 == pytest.approx(0.1605, abs=5e-5)
    assert sb["bwd"] * 1e3 == pytest.approx(0.2041, abs=5e-5)
    assert bounds.visible_pairs(3, 5, 5, True) == 3 * 15
    assert bounds.visible_pairs(3, 5, 7, False) == 3 * 35


def test_kinds_are_the_ports():
    from multimodal_llm_pretraining_tpu_torch import profile_step

    assert trace.KINDS == profile_step.KINDS
    assert trace.OTHER == profile_step.OTHER
    assert trace.kind_of("void (anonymous namespace)::flash_bwd_kernel<256, 2, false, true>") == "flash backward"
    assert trace.kind_of("void at::native::vectorized_elementwise_kernel<4, ...>") == trace.OTHER


def _synthetic_trace():
    # host: an annotation around two ops, each launching one kernel; a copy
    ev = [
        {"cat": "user_annotation", "name": "bench.optimizer", "tid": 1, "ts": 100, "dur": 50},
        {"cat": "cpu_op", "name": "aten::mul", "tid": 1, "ts": 105, "dur": 10},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 1, "ts": 108, "dur": 2, "args": {"correlation": 1}},
        {"cat": "cpu_op", "name": "aten::add", "tid": 1, "ts": 130, "dur": 10},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 1, "ts": 132, "dur": 2, "args": {"correlation": 2}},
        {"cat": "cpu_op", "name": "aten::copy_", "tid": 1, "ts": 200, "dur": 10},
        {"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "tid": 1, "ts": 202, "dur": 2, "args": {"correlation": 3}},
        {"cat": "kernel", "name": "mul_kernel", "ts": 110, "dur": 20, "args": {"correlation": 1}},
        {"cat": "kernel", "name": "add_kernel", "ts": 125, "dur": 20, "args": {"correlation": 2}},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 205, "dur": 5, "args": {"correlation": 3}},
    ]
    return trace.DeviceTrace.from_events(ev)


def test_trace_arithmetic():
    tr = _synthetic_trace()
    assert tr.busy_s() == pytest.approx(40e-6)  # [110, 145] and [205, 210]
    assert tr.device_s() == pytest.approx(45e-6)
    assert {e["name"] for e in tr.in_span("bench.optimizer")} == {"mul_kernel", "add_kernel"}
    assert tr.by_kind()["memcpy/memset, cat"] == pytest.approx(5e-6)
    assert tr.top_ops(1) == [["mul_kernel", pytest.approx(20e-6)]]
    assert tr.idle_gaps() == [["aten::copy_", pytest.approx(60e-6)]]
    assert trace.union_seconds([(0, 10), (5, 20), (30, 31)]) == pytest.approx(21e-6)


def test_token_batches():
    a = data.token_batch(2**31 + 17, 3, 4, 9, 50304)
    assert a.shape == (4, 9) and a.dtype == np.int32 and a.min() >= 0 and a.max() < 50304
    np.testing.assert_array_equal(a, data.token_batch(2**31 + 17, 3, 4, 9, 50304))
    assert not np.array_equal(a, data.token_batch(2**31 + 17, 4, 4, 9, 50304))
    assert data.token_batch(-5, 0, 2, 3, 10).shape == (2, 3)

    from multimodal_llm_pretraining_tpu_torch.benchmarking.data import random_lm_batch

    seq = np.random.SeedSequence([2**31 + 17, 3])
    np.testing.assert_array_equal(a, random_lm_batch(seq, 50304, 4, 9))


def test_seeded_weights():
    spec = [("w", (64, 32), ("normal", 0.5)), ("b", (32,), ("const", 0.0)), ("s", (3, 4), ("log_arange",)),
            ("v", (1000,), ("normal", 2.0))]
    w = weights.make_weights(spec, 2**31 + 3, "cpu")
    again = weights.make_weights(spec, 2**31 + 3, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)
    assert w["w"].dtype == torch.bfloat16 and w["w"].shape == (64, 32)
    assert float(w["v"].float().std()) == pytest.approx(2.0, rel=0.1)
    assert torch.equal(w["b"], torch.zeros(32, dtype=torch.bfloat16))
    assert torch.allclose(w["s"][2].float(), torch.log(torch.arange(1, 5.0)), rtol=1e-2)
    assert not torch.equal(w["w"], weights.make_weights(spec, 2**31 + 4, "cpu")["w"])


def test_schedule_is_the_ports():
    from multimodal_llm_pretraining_tpu_torch.models import SchedulerType
    from multimodal_llm_pretraining_tpu_torch.training.optimizer import build_schedule

    for opt, kwargs in (({"lr": 3e-4, "warmup_steps": 1430, "min_lr_rate": 0.1},
                         {"num_warmup_steps": 1430, "min_lr_rate": 0.1}),
                        ({"lr": 8e-4, "warmup_steps": 57220, "min_lr": 1e-5}, {"num_warmup_steps": 57220, "min_lr": 1e-5})):
        for steps in (8, 100000):
            port = build_schedule(SchedulerType.COSINE_WITH_MIN_LR, kwargs, opt["lr"], steps)
            for count in (1, 2, 3, 7, 8, 9, 50):
                assert common.learning_rate(opt, steps, count) == pytest.approx(port(count), rel=1e-9, abs=1e-15)


def test_stochastic_round_is_unbiased_and_on_the_bf16_grid():
    x = torch.full((200000,), 1.0 + 2**-9, dtype=torch.float32)  # a quarter of the way to the next bf16 value
    y = common.stochastic_round(x, torch.Generator().manual_seed(0))
    assert torch.equal(y.to(torch.bfloat16).float(), y)
    assert float(y.mean()) == pytest.approx(1.0 + 2**-9, abs=2e-5)


def test_fp8_operands_are_coarser_than_bf16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(1))
    err8 = float((common.round_operand(x, "fp8").float() - x).norm() / x.norm())
    err16 = float((common.round_operand(x, "bf16").float() - x).norm() / x.norm())
    assert 0.01 < err8 < 0.05 and err16 < 3e-3


def _sequential_scan(u, delta, A, B, C, D):
    h = torch.zeros(u.shape[0], u.shape[2], A.shape[1])
    ys = []
    for t in range(u.shape[1]):
        h = torch.exp(delta[:, t, :, None] * A) * h + (delta[:, t] * u[:, t])[..., None] * B[:, t, None, :]
        ys.append((h * C[:, t, None, :]).sum(-1) + D * u[:, t])
    return torch.stack(ys, 1)


def test_chunked_scan_equals_the_recurrence():
    g = torch.Generator().manual_seed(0)
    b, L, I, N = 2, 150, 6, 4  # L not a multiple of the chunk
    u, C, B = torch.randn(b, L, I, generator=g), torch.randn(b, L, N, generator=g), torch.randn(b, L, N, generator=g)
    delta = torch.rand(b, L, I, generator=g) * 0.5 + 0.01
    A, D = -(torch.rand(I, N, generator=g) + 0.5), torch.randn(I, generator=g)
    torch.testing.assert_close(mamba.selective_scan(u, delta, A, B, C, D), _sequential_scan(u, delta, A, B, C, D),
                               rtol=1e-5, atol=1e-5)


def _to_port(port_module, ref_weights):
    with torch.no_grad():
        for name, p in port_module.named_parameters():
            p.copy_(ref_weights[name].float())


def test_gptneox_reference_equals_the_port_in_f32():
    from multimodal_llm_pretraining_tpu_torch.models.pythia import GPTNeoXLM

    cfg = {"hidden_size": 64, "intermediate_size": 256, "num_attention_heads": 2, "num_hidden_layers": 2,
           "vocab_size": 96, "layer_norm_eps": 1e-5, "rotary_pct": 0.25, "rotary_emb_base": 10000,
           "hidden_act": "gelu_new"}
    w = weights.make_weights(gptneox.init_spec(cfg), 11, "cpu", torch.float32)
    port = GPTNeoXLM(2, 64, 2, vocab_size=96, attn_impl="xla")
    assert {n for n, _ in port.named_parameters()} == {n for n, _, _ in gptneox.init_spec(cfg)}
    _to_port(port, w)
    ids = torch.from_numpy(data.token_batch(11, 0, 3, 17, 96)).long()
    with common.no_tf32():
        ref = gptneox.loss({k: v.float() for k, v in w.items()}, ids, cfg, "f32")
    assert float(port(ids, labels=ids)) == pytest.approx(float(ref), rel=1e-5)


def test_mamba_reference_equals_the_port_in_f32():
    from multimodal_llm_pretraining_tpu_torch.models.mamba import MambaLM

    cfg = {"d_model": 32, "n_layer": 2, "d_inner": 64, "d_state": 4, "d_conv": 4, "dt_rank": 2, "norm_eps": 1e-5,
           "padded_vocab_size": 80}
    w = weights.make_weights(mamba.init_spec(cfg), 12, "cpu", torch.float32)
    port = MambaLM(32, 2, 64, 4, 4, 2, 80, use_custom_kernels=False)
    assert {n for n, _ in port.named_parameters()} == {n for n, _, _ in mamba.init_spec(cfg)}
    _to_port(port, w)
    ids = torch.from_numpy(data.token_batch(12, 0, 2, 70, 80)).long()
    ref = mamba.loss({k: v.float() for k, v in w.items()}, ids, cfg, "f32")
    assert float(port(ids, labels=ids)) == pytest.approx(float(ref), rel=1e-5)
    assert math.isfinite(float(ref))


def test_scan_backward_equals_autograd_of_the_recurrence():
    g = torch.Generator().manual_seed(1)
    b, L, I, N = 2, 100, 5, 3
    args = [torch.randn(b, L, I, generator=g), torch.rand(b, L, I, generator=g) * 0.5 + 0.01,
            -(torch.rand(I, N, generator=g) + 0.5), torch.randn(b, L, N, generator=g),
            torch.randn(b, L, N, generator=g), torch.randn(I, generator=g)]
    dy = torch.randn(b, L, I, generator=g)
    mine = [a.clone().requires_grad_(True) for a in args]
    want = [a.clone().requires_grad_(True) for a in args]
    got = torch.autograd.grad(mamba.selective_scan(*mine), mine, dy)
    ref = torch.autograd.grad(_sequential_scan(*want), want, dy)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4)


def test_uniform_and_dt_bias_draws():
    spec = [("u", (20000,), ("uniform", 0.25)), ("dt", (20000,), ("inv_softplus_loguniform", 0.001, 0.1))]
    w = weights.make_weights(spec, 9, "cpu", torch.float32)
    assert float(w["u"].abs().max()) <= 0.25 and float(w["u"].std()) == pytest.approx(0.25 / math.sqrt(3), rel=0.05)
    step = torch.nn.functional.softplus(w["dt"])
    assert 0.001 * 0.99 <= float(step.min()) and float(step.max()) <= 0.1 * 1.01
    assert float(torch.log(step).mean()) == pytest.approx((math.log(0.001) + math.log(0.1)) / 2, abs=0.05)
