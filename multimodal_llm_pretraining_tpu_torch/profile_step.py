"""Time training steps on the card and profile one: where the device time goes.

    python -m multimodal_llm_pretraining_tpu_torch.profile_step --model llava-pretrain --mbs 16 --acc 2 --layout bf16
    python -m multimodal_llm_pretraining_tpu_torch.profile_step --model vit --mbs 128 --acc 2 --layout f32
    python -m multimodal_llm_pretraining_tpu_torch.profile_step --model vilt-pretrain --mbs 4 --acc 2 --layout f32

Builds the session through the user's entry points (``get_model_class`` ->
``TrainingPlan`` -> ``build_session``, random weights from the session's
seed), runs 1 warmup and 3 timed steps, then one step under
``torch.profiler``. Prints each step's time and loss, the median timed step,
the profiled step's wall time, the device's busy time (the union of kernel
and copy intervals), its idle share of the median timed step (the
profiler's own host cost lengthens the profiled step), and the device time
by kind of kernel and of the kernels launched inside each of the port's
spans in ``SPANS`` (``tracing.py``).
``--table`` gets the profiler's ``key_averages`` table. ``chip_smoke.py``
builds its main paths with ``make_plan``.

To compare two versions of the code, run this in a checkout of each, in one
call to the card, in the order old, new, new, old.
"""

import argparse
import json
import os
import statistics
import tempfile
import time

import torch

from .models import get_model_class
from .parallel.mesh import MeshConfig
from .train import TrainingPlan
from .utils import block_on, require_cuda

# (kind, substrings of the lower-cased kernel name), first match wins
KINDS = (
    ("flash forward", ("flash_fwd_kernel",)),
    ("flash backward dq", ("flash_bwd_dq_kernel",)),
    ("flash backward dkv", ("flash_bwd_dkv_kernel",)),
    ("flash backward", ("flash_bwd_kernel", "flash_bwd_prep_kernel")),
    ("scan forward", ("scan_fwd_kernel",)),
    ("scan backward", ("scan_bwd_kernel",)),
    ("GEMM", ("gemm", "nvjet", "xmma")),
    ("reductions", ("reduce", "softmax")),
    ("memcpy/memset, cat", ("memcpy", "memset", "catarray")),
)
OTHER = "elementwise and other"
# the port's spans (``tracing.py``) whose kernels are also summed apart
SPANS = ("step.forward", "step.backward", "xent.forward", "xent.backward", "remat.replay", "ipot")


LAYOUTS = ("bf16", "bf16_sr", "bf16_master", "f32")


def make_plan(mc, mbs: int, acc: int, remat: bool, layout: str, checkpoint_policy: str = "flash") -> TrainingPlan:
    """The model's own optimizer and schedule, with remat under
    ``checkpoint_policy`` (pythia takes "flash" or "dots"; the others remat
    as their stacks do) when ``remat``, in one of four layouts:
    "bf16_sr" (bf16 compute, ``master_weights="sr"``, bf16 moments and
    accumulators), "bf16_master" (the same with an f32 master in place of
    SR, ``master_weights="device"``), "bf16" (bf16 compute, f32 params,
    accumulators and moments; a model with a trainable mask stores its
    frozen leaves in bf16) or "f32" (f32 compute, params, accumulators and
    moments; the f32 products run in TF32, as ``matmul_precision="default"``
    maps them)."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    lowp = layout in ("bf16_sr", "bf16_master")
    return TrainingPlan(
        num_training_steps=8,
        micro_batch_size=mbs,
        gradient_accumulation_steps=acc,
        activation_checkpointing=remat,
        checkpoint_policy=checkpoint_policy,
        bf16=layout != "f32",
        use_custom_kernels=True,
        matmul_precision="default",
        optimizer=mc.optimizer,
        optimizer_kwargs=mc.optimizer_kwargs,
        scheduler_type=mc.scheduler_type,
        scheduler_kwargs=mc.scheduler_kwargs,
        grad_accum_dtype="bf16" if lowp else None,
        opt_state_dtype="bf16" if lowp else None,
        master_weights={"bf16_sr": "sr", "bf16_master": "device"}.get(layout, False),
        max_grad_norm=mc.max_grad_norm,
        mesh=MeshConfig(num_hosts=1, chips_per_host=1),
    )


def kind_of(name: str) -> str:
    low = name.lower()
    return next((kind for kind, keys in KINDS if any(k in low for k in keys)), OTHER)


def span_kernels(trace: list[dict], name: str) -> list[dict]:
    """The kernels launched inside the host spans ``name``
    (``record_function``): those whose launch (a runtime or driver event
    with the same correlation id) starts within one of the spans, on any
    thread, since autograd launches a backward's kernels from a thread of
    its own while the span's thread waits for it."""
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in trace
             if e.get("cat") == "user_annotation" and e.get("name") == name and "dur" in e]
    inside = {e["args"]["correlation"] for e in trace
              if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})
              and any(t0 <= e["ts"] <= t1 for t0, t1 in spans)}
    return [e for e in trace if e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in inside]


def device_breakdown(trace_path: str) -> dict:
    """Busy time (union of intervals), kernel count and time by kind from a
    chrome trace's kernel, memcpy and memset events, and the kernel time of
    each of ``SPANS``; times in seconds."""
    with open(trace_path) as f:
        trace = json.load(f)["traceEvents"]
    events = [e for e in trace if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    by_kind: dict[str, list] = {}
    for e in events:
        kind = "memcpy/memset, cat" if e["cat"] != "kernel" else kind_of(e["name"])
        acc = by_kind.setdefault(kind, [0.0, 0])
        acc[0] += e["dur"] * 1e-6
        acc[1] += 1
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    kernels = sum(1 for e in events if e["cat"] == "kernel")
    spans = {}
    for name in SPANS:
        inside = span_kernels(trace, name)
        if inside:
            spans[name] = (sum(e["dur"] for e in inside) * 1e-6, len(inside))
    return {"busy_s": busy * 1e-6, "kernels": kernels, "by_kind": by_kind, "spans": spans}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", required=True)
    ap.add_argument("--mbs", type=int, required=True)
    ap.add_argument("--acc", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--checkpoint-policy", choices=("flash", "dots"), default="flash", help="remat policy (pythia)")
    ap.add_argument("--layout", choices=LAYOUTS, default="bf16_sr")
    ap.add_argument("--table", help="file for the profiler's key_averages table")
    args = ap.parse_args()

    require_cuda()
    mc = get_model_class(args.model)
    sess = make_plan(mc, args.mbs, args.acc, args.remat, args.layout, args.checkpoint_policy).build_session(mc, device="cuda")
    state = sess.init_state()
    step = sess.train_step_fn()

    def run(i: int) -> float:
        nonlocal state
        batch = sess.make_train_batch(seed=i)
        block_on("cuda")
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        block_on("cuda")
        dt = time.perf_counter() - t0
        print(f"[profile] {args.model} step {i}: loss {loss:.5f}, {dt:.4f} s", flush=True)
        return dt

    times = [run(i) for i in range(4)][1:]
    median = statistics.median(times)
    print(f"[profile] {args.model} median step {median:.4f} s over {len(times)} steps, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run(4)
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        b = device_breakdown(trace)
    total = sum(s for s, _ in b["by_kind"].values())
    print(f"[profile] profiled step: wall {wall:.4f} s, device busy {b['busy_s']:.4f} s, "
          f"idle share of the median step {1 - b['busy_s'] / median:.3f}, {b['kernels']} kernels", flush=True)
    for kind, (secs, calls) in sorted(b["by_kind"].items(), key=lambda kv: -kv[1][0]):
        print(f"[profile]   {kind}: {secs:.4f} s, {calls} calls, {secs / total:.3f} of device time", flush=True)
    for name, (secs, calls) in b["spans"].items():
        print(f"[profile]   span {name} (its kernels, counted in the kinds above too): {secs:.4f} s, {calls} "
              f"kernels, {secs / total:.3f} of device time", flush=True)
    if args.table:
        with open(args.table, "w") as f:
            f.write(prof.key_averages().table(sort_by="cuda_time_total", row_limit=60))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
