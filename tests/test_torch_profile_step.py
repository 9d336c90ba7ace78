"""The profiling tool's trace arithmetic, on a hand-made chrome trace (the
profile itself needs the card)."""

import json

import pytest
import torch

from multimodal_llm_pretraining_tpu_torch.models import get_model_class
from multimodal_llm_pretraining_tpu_torch.profile_step import device_breakdown, kind_of, make_plan, span_kernels


@pytest.mark.parametrize("name, kind", [
    ("void (anonymous namespace)::flash_fwd_kernel<__nv_bfloat16, 64>(...)", "flash forward"),
    ("void (anonymous namespace)::flash_bwd_kernel<__nv_bfloat16, 64>(...)", "flash backward"),
    ("void (anonymous namespace)::flash_bwd_prep_kernel<float>(...)", "flash backward"),
    ("void (anonymous namespace)::flash_bwd_dq_kernel<float, 64>(...)", "flash backward dq"),
    ("void (anonymous namespace)::flash_bwd_dkv_kernel<__nv_bfloat16, 256>(...)", "flash backward dkv"),
    ("scan_bwd_kernel", "scan backward"),
    ("nvjet_tst_192x208_64x4_1x2_h_bz_coopB_NNT", "GEMM"),
    ("cutlass_75_tensorop_s1688gemm_bf16_256x128_32x2_nn_align1", "GEMM"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>(...)", "reductions"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<...>", "memcpy/memset, cat"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor<...>>", "elementwise and other"),
])
def test_kind_of(name, kind):
    assert kind_of(name) == kind


def test_device_breakdown_unions_overlaps(tmp_path):
    """Busy time is the union of the device intervals (overlaps counted
    once, gaps not at all); CPU events are ignored; times in seconds."""
    events = [
        {"cat": "kernel", "name": "flash_fwd_kernel", "ts": 0.0, "dur": 10.0},
        {"cat": "kernel", "name": "nvjet_x", "ts": 5.0, "dur": 10.0},  # overlaps the first by 5
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 20.0, "dur": 2.0},
        {"cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 100.0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    b = device_breakdown(str(path))
    assert b["busy_s"] == pytest.approx(17e-6)
    assert b["kernels"] == 2
    assert b["by_kind"] == {"flash forward": [pytest.approx(10e-6), 1], "GEMM": [pytest.approx(10e-6), 1],
                            "memcpy/memset, cat": [pytest.approx(2e-6), 1]}


@pytest.mark.parametrize("layout, master, moments",
                         [("bf16_sr", "sr", "bf16"), ("bf16_master", "device", "bf16"), ("bf16", False, None)])
def test_make_plan_layouts(layout, master, moments):
    mc = get_model_class("llava-pretrain")
    plan = make_plan(mc, 16, 2, False, layout)
    assert (plan.master_weights, plan.opt_state_dtype, plan.grad_accum_dtype) == (master, moments, moments)
    assert plan.bf16 and plan.use_custom_kernels
    assert (plan.micro_batch_size, plan.gradient_accumulation_steps) == (16, 2)
    assert (plan.optimizer, plan.optimizer_kwargs, plan.max_grad_norm) == ("adamw", mc.optimizer_kwargs, 0.0)


def test_make_plan_f32_layout_for_vit():
    """ViT's recipe trains in f32: f32 compute, parameters, accumulators and
    moments, TF32 products (``matmul_precision="default"``); an unknown
    layout is refused."""
    mc = get_model_class("vit")
    plan = make_plan(mc, 128, 2, False, "f32")
    assert not plan.bf16 and plan.compute_dtype == torch.float32 and plan.matmul_precision == "default"
    assert (plan.master_weights, plan.opt_state_dtype, plan.grad_accum_dtype) == (False, None, None)
    assert (plan.optimizer, plan.optimizer_kwargs, plan.max_grad_norm) == ("adam", mc.optimizer_kwargs, 1.0)
    with pytest.raises(ValueError, match="layout"):
        make_plan(mc, 128, 2, False, "fp16")


def test_main_accepts_vit_and_the_f32_layout(monkeypatch):
    """The command line takes ``--model vit --layout f32`` and then needs the
    card: on a machine without one it stops at ``require_cuda``."""
    import sys

    from multimodal_llm_pretraining_tpu_torch import profile_step

    def no_card():
        raise RuntimeError("no CUDA device")

    monkeypatch.setattr(profile_step, "require_cuda", no_card)
    monkeypatch.setattr(sys, "argv", ["profile_step", "--model", "vit", "--mbs", "128", "--acc", "2", "--layout", "f32"])
    with pytest.raises(RuntimeError, match="no CUDA"):
        profile_step.main()


def test_device_breakdown_sums_the_ipot_span(tmp_path):
    """A span's kernels are those whose launch (the runtime event of the
    same correlation id) starts inside a ``record_function`` span of that
    name, on any thread; each is counted in its kind too."""
    events = [
        {"cat": "user_annotation", "name": "ipot", "tid": 1, "ts": 100.0, "dur": 50.0},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 1, "ts": 110.0, "dur": 1.0, "args": {"correlation": 7}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 1, "ts": 200.0, "dur": 1.0, "args": {"correlation": 8}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 2, "ts": 120.0, "dur": 1.0, "args": {"correlation": 9}},
        {"cat": "kernel", "name": "gemm_a", "ts": 300.0, "dur": 4.0, "args": {"correlation": 7}},
        {"cat": "kernel", "name": "gemm_b", "ts": 310.0, "dur": 6.0, "args": {"correlation": 8}},
        {"cat": "kernel", "name": "elementwise", "ts": 320.0, "dur": 3.0, "args": {"correlation": 9}},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    b = device_breakdown(str(path))
    assert b["spans"] == {"ipot": (pytest.approx(7e-6), 2)}
    assert b["by_kind"]["GEMM"] == [pytest.approx(10e-6), 2]


def test_span_kernels_launched_from_another_thread(tmp_path):
    """``step.backward`` is opened on the main thread while autograd launches
    the backward's kernels from its own: those launched (runtime or driver
    call) while the span is open count, on whichever thread; a launch on
    that thread after the span closes does not. ``remat.replay``, opened
    on the autograd thread inside it, gets its own kernels."""
    events = [
        {"cat": "user_annotation", "name": "step.backward", "tid": 1, "ts": 100.0, "dur": 100.0},
        {"cat": "user_annotation", "name": "remat.replay", "tid": 2, "ts": 130.0, "dur": 20.0},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 2, "ts": 110.0, "dur": 1.0, "args": {"correlation": 1}},
        {"cat": "cuda_driver", "name": "cuLaunchKernel", "tid": 2, "ts": 140.0, "dur": 1.0, "args": {"correlation": 2}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 2, "ts": 250.0, "dur": 1.0, "args": {"correlation": 3}},
        {"cat": "kernel", "name": "nvjet_a", "ts": 300.0, "dur": 4.0, "args": {"correlation": 1}},
        {"cat": "kernel", "name": "elementwise", "ts": 310.0, "dur": 6.0, "args": {"correlation": 2}},
        {"cat": "kernel", "name": "nvjet_b", "ts": 320.0, "dur": 3.0, "args": {"correlation": 3}},
    ]
    assert [e["name"] for e in span_kernels(events, "step.backward")] == ["nvjet_a", "elementwise"]
    assert [e["name"] for e in span_kernels(events, "remat.replay")] == ["elementwise"]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    b = device_breakdown(str(path))
    assert b["spans"] == {"step.backward": (pytest.approx(10e-6), 2), "remat.replay": (pytest.approx(6e-6), 1)}
