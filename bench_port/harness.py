"""One run of one cell: the port's training session driven as users drive
it, its first updates held to the plain reference, a measured window at the
cell's published accumulation, and with ``trace`` a profiled stretch of
one more update of the compared size, read by the cell's per-layer metrics.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its traffic in ``bench_port/workloads/<traffic>.json``, its configuration in
the file ``BENCHMARK.json`` names, and each per-layer metric in
``bench_port/metrics/<metric>.py``.
"""

import contextlib
import gc
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from .reference import train as reference
from .yardstick.data import token_batch
from .yardstick.flops import flops_per_sequence
from .yardstick.trace import DeviceTrace
from .yardstick.weights import make_weights

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
OUT_DIR = HERE / "_out"  # the profiler's trace, deleted once read
COMPARED_STEPS = 2  # the reference follows the program's first two updates
FAULTS = ("unchanged", "half_batch")


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict
    workload: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_cell(name: str, benchmark_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = read_json(benchmark_path)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {benchmark_path.name}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])

    def mine(metric: dict) -> bool:
        return name in metric.get("workloads", [name])

    return Cell(name, read_json(benchmark_path.parent / conf["file"]),
                read_json(HERE / "workloads" / f"{entry['traffic']}.json"),
                [m for m in bench["end_to_end"] if mine(m)], [m for m in bench["per_layer"] if mine(m)])


# ---------------------------------------------------------------- the program


class Program:
    """The port's session for a cell, reached through ``get_model_class`` ->
    ``TrainingPlan`` -> ``build_session``, started from the seeded weights.
    ``fault`` breaks the timed path underneath, for the checks that
    ``correct`` catches it: "unchanged" makes every update return the state
    as it was, "half_batch" leaves out the second half of every
    micro-batch's rows and takes the mean over the rest.

    The plan accumulates ``accumulation`` micro-batches an update, the
    cell's published global batch; the compared first updates run the same
    calls over ``compared_accumulation`` micro-batches each, so that the
    reference can follow them inside a run."""

    def __init__(self, cfg: dict, wl: dict, seed: int, device, fault: str | None = None):
        marks = [time.perf_counter()]
        from multimodal_llm_pretraining_tpu_torch.models import get_model_class
        from multimodal_llm_pretraining_tpu_torch.parallel.mesh import MeshConfig
        from multimodal_llm_pretraining_tpu_torch.train import TrainingPlan

        if cfg["state_layout"] != "bf16_sr":
            raise ValueError(f"state layout {cfg['state_layout']!r}: the reference holds bf16_sr only")
        if fault not in (None, *FAULTS):
            raise ValueError(f"unknown fault {fault!r}")
        mc = get_model_class(cfg["model_type"])
        marks.append(time.perf_counter())
        remat = wl["remat"]
        plan = TrainingPlan(
            num_training_steps=cfg["num_training_steps"],
            micro_batch_size=wl["micro_batch_size"],
            gradient_accumulation_steps=wl["accumulation"],
            activation_checkpointing=remat is not None,
            checkpoint_policy="flash" if remat in (None, "block") else remat,
            bf16=True,
            use_custom_kernels=True,
            matmul_precision="default",
            optimizer=mc.optimizer,
            optimizer_kwargs=mc.optimizer_kwargs,
            scheduler_type=mc.scheduler_type,
            scheduler_kwargs=mc.scheduler_kwargs,
            grad_accum_dtype="bf16",
            opt_state_dtype="bf16",
            master_weights="sr",
            max_grad_norm=mc.max_grad_norm,
            mesh=MeshConfig(num_hosts=1, chips_per_host=1),
        )
        self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, torch.device(device)
        self.sess = plan.build_session(mc, device=self.device)
        sync(self.device)
        marks.append(time.perf_counter())
        self.weights = make_weights(reference.init_spec(cfg), seed, self.device)
        self.state = self.sess.init_state(state_dict=self.weights)
        sync(self.device)
        marks.append(time.perf_counter())
        # seconds of each phase, for the log: the port's import, the session, the weights
        self.phases = dict(zip(("import", "session", "weights"), (round(b - a, 2) for a, b in zip(marks, marks[1:]))))
        self.accumulate = self.sess.accumulate_fn()
        self.update = self.sess.optimizer_update_fn()
        if fault == "unchanged":
            self.update = lambda state, acc_steps: self.sess.zero_grads()
        elif fault == "half_batch":
            whole = self.accumulate
            self.accumulate = lambda state, mb: whole(state, {k: v[: v.shape[0] // 2] for k, v in mb.items()})
        self.index = 0  # the next micro-batch's index in the seed's stream
        self.pending = 0  # micro-batches accumulated since the last update

    def feed(self) -> dict[str, torch.Tensor]:
        """The next micro-batch on the device; labels are the ids (the model
        shifts them)."""
        ids = token_batch(self.seed, self.index, self.wl["micro_batch_size"], self.cfg["sequence_length"],
                          self.cfg["data_vocab_size"])
        self.index += 1
        t = torch.from_numpy(ids).to(self.device, torch.long, non_blocking=False)
        return {"input_ids": t, "labels": t}

    def micro_batch(self, spans: bool = False) -> torch.Tensor:
        """The next micro-batch's forward and backward; its loss, unread.
        With ``spans`` the feed and the call each sit in a profiler
        annotation of their own."""
        span = torch.profiler.record_function if spans else (lambda name: contextlib.nullcontext())
        with span("bench.batch"):
            mb = self.feed()
        with span("bench.accumulate"):
            loss = self.accumulate(self.state, mb)
        self.pending += 1
        return loss

    def update_now(self, spans: bool = False) -> None:
        """The update over the micro-batches accumulated since the last."""
        span = torch.profiler.record_function if spans else (lambda name: contextlib.nullcontext())
        with span("bench.optimizer"):
            self.update(self.state, float(self.pending))
        self.pending = 0

    def first_steps(self) -> dict:
        """The compared updates, through the window's own calls and feed: each
        update's mean loss, the first gradient's leaf norms worked out from
        the optimizer's first moments after one update, and each leaf's
        change after the last compared update. Drops the starting weights."""
        b1 = self.cfg["optimizer"]["betas"][0]
        names = self.sess.trainable
        out = {"losses": []}
        for k in range(COMPARED_STEPS):
            losses = [self.micro_batch() for _ in range(self.wl["compared_accumulation"])]
            self.update_now()
            out["losses"].append(float(torch.stack(losses).float().mean()))
            if k == 0:
                out["first_grads"] = {n: float(torch.linalg.vector_norm(m.float())) / (1 - b1)
                                      for n, m in zip(names, self.state.opt_state.mu)}
        with torch.no_grad():
            out["change"] = {n: float(torch.linalg.vector_norm(self.state.params[n].float() - self.weights[n].float()))
                             for n in names}
        self.weights = None
        return out


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure_window(prog: Program, seconds: float) -> dict:
    """Micro-batches until ``seconds`` have passed, each followed by the
    update where it closes the cell's accumulation. The window opens just
    after an update (the last compared one), so every window holds its
    updates at the same places, and closes on a synchronise."""
    dev = prog.device
    if prog.pending:
        raise RuntimeError("the window opens just after an update")
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, updates, acc = [], 0, prog.wl["accumulation"]
    t0 = time.perf_counter()
    while True:
        losses.append(prog.micro_batch())
        if prog.pending == acc:
            prog.update_now()
            updates += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    failed = int((~torch.isfinite(torch.stack(losses).float())).sum())
    mbs, seq = prog.wl["micro_batch_size"], prog.cfg["sequence_length"]
    return {"start": t0, "seconds": wall, "updates": updates, "micro_batches": len(losses),
            "sequences": len(losses) * mbs, "tokens": len(losses) * mbs * seq, "failed": failed, "peak_bytes": peak}


# ---------------------------------------------------------------- the trace


@dataclass
class Reading:
    """What a per-layer metric reads: the cell, its untraced window, and the
    profiled stretch (one more update of the compared size: the workload's
    ``compared_accumulation`` micro-batches, then the update)."""

    config: dict
    workload: dict
    window: dict
    traced_seconds: float
    trace: DeviceTrace


def trace_stretch(prog: Program) -> tuple[DeviceTrace, float]:
    """Profile ``compared_accumulation`` micro-batches and then an update;
    the trace and the stretch's wall time."""
    from torch.profiler import ProfilerActivity, profile

    OUT_DIR.mkdir(exist_ok=True)
    path = OUT_DIR / "trace.json"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sync(prog.device)
        t0 = time.perf_counter()
        for _ in range(prog.wl["compared_accumulation"]):
            prog.micro_batch(spans=True)
        prog.update_now(spans=True)
        sync(prog.device)
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(str(path))
    del prof
    try:
        return DeviceTrace.from_file(str(path)), wall
    finally:
        path.unlink(missing_ok=True)


def load_metric(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_port_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


# ---------------------------------------------------------------- correctness


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers ``correct`` may compare, program against reference:

    - ``loss_gap``: the largest |program - reference| / reference over the
      compared steps' mean losses;
    - ``grad_gap``: over the leaves, the largest gap between the program's
      and the reference's norm of the first gradient, against the larger of
      the reference's norm of that leaf and of the median leaf;
    - ``change_gap``: the same for each leaf's change over the compared
      steps, among the leaves whose first reference gradient is at least a
      thousandth of the median leaf's (the others move by round-off alone);
    - ``change_gap_median``: the median of those per-leaf change gaps.
    """
    out = {"loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))}
    if set(prog["first_grads"]) != set(ref["first_grads"]):
        raise ValueError("the program's leaves differ from the reference's")
    g_ref = ref["first_grads"]
    g_med = statistics.median(g_ref.values())
    out["grad_gap"] = max(abs(prog["first_grads"][n] - r) / max(r, g_med) for n, r in g_ref.items())
    moving = [n for n, r in g_ref.items() if r >= 1e-3 * g_med]
    c_med = statistics.median(ref["change"][n] for n in moving)
    per_leaf = [abs(prog["change"][n] - ref["change"][n]) / max(ref["change"][n], c_med) for n in moving]
    out["change_gap"] = max(per_leaf)
    out["change_gap_median"] = statistics.median(per_leaf)
    return out


def worst_leaves(prog: dict, ref: dict) -> dict:
    """Where the gaps come from, for the log: the leaves the change leaves
    out, the leaf with the largest first-gradient gap and its two norms,
    the median over leaves of the program's norm over the reference's, and
    the same for the change."""
    g_med = statistics.median(ref["first_grads"].values())
    out = {"left_out": sorted(n for n, r in ref["first_grads"].items() if r < 1e-3 * g_med)}
    for key in ("first_grads", "change"):
        med = statistics.median(ref[key].values())
        name = max(ref[key], key=lambda n: abs(prog[key][n] - ref[key][n]) / max(ref[key][n], med))
        ratios = [prog[key][n] / r for n, r in ref[key].items() if r > 0]
        out[key] = {"worst": [name, prog[key][name], ref[key][name]], "median_leaf": med,
                    "ratio_median": statistics.median(ratios), "ratio_min": min(ratios), "ratio_max": max(ratios)}
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Every number the cell compares against its limit; a number that is
    not finite fails."""
    compared = {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in compared.values())
    return ok, compared


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- a run


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float, device="cuda",
        fault: str | None = None) -> dict:
    """One run; returns the result line's object."""
    cfg, wl = cell.config, cell.workload
    t_built = time.perf_counter()
    prog = Program(cfg, wl, seed, device, fault=fault)
    t_first = time.perf_counter()
    first = prog.first_steps()
    log(f"program first steps: losses {first['losses']}")
    window = measure_window(prog, seconds)
    log(f"set-up: imports {t_built - t_start:.1f} s, program {t_first - t_built:.1f} s ({prog.phases}), "
        f"compared updates {window['start'] - t_first:.1f} s")
    setup_s = window["start"] - t_start
    log(f"window: {window}")
    result = {"correct": False, "attempted": window["micro_batches"], "failed": window["failed"]}
    metrics = {}
    device_info = {"platform": "gpu" if prog.device.type == "cuda" else prog.device.type,
                   "kind": torch.cuda.get_device_name(prog.device) if prog.device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": window["peak_bytes"]}
    if trace:
        tr, traced_s = trace_stretch(prog)
        reading = Reading(cfg, wl, window, traced_s, tr)
        for m in cell.per_layer:
            value = load_metric(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = traced_s
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        del tr, reading
    else:
        e2e = {"tokens_per_s": window["tokens"] / window["seconds"], "peak_mem_gib": window["peak_bytes"] / 2**30,
               "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    del prog
    free(device)
    t_ref = time.perf_counter()
    ref = reference.train_steps(cfg, wl, seed, device, cfg["reference_precision"], COMPARED_STEPS, log=log)
    log(f"reference: {time.perf_counter() - t_ref:.1f} s")
    numbers = gaps(first, ref)
    log(f"numbers: {numbers}")
    log(f"leaves: {worst_leaves(first, ref)}")
    ok, compared = judge(numbers, wl["limits"])
    result["correct"] = ok and window["failed"] == 0
    result["metrics"] = metrics
    result["device"] = device_info
    card = card_line() if torch.device(device).type == "cuda" else "cpu"
    log(f"card: {card}; flops a sequence {flops_per_sequence(cfg):.6e}")
    result["compared"] = compared
    for k, v in compared.items():
        print(f"{k} {v['value']:.6g} limit {v['limit']:.6g}", file=sys.stderr, flush=True)
    return result
