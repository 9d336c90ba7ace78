"""The readings that the limits of ``correct`` are set from, for one cell,
in one process: on each seed the program's compared numbers against the
plain reference (the lower reading), and on the seeds asked for the
control's (the reference in the precision below the configuration's, in
the program's place) and each fault's (the upper readings).

    python3 bench_port/readings.py --workload pythia-1b.noremat.mbs16 --seeds 1,2,3 \\
        --control-seeds 1,2,3 --fault-seeds 1,2,3

One JSON line per seed and side on standard output; the benchmark's own
runs never run this.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path[0] == str(Path(__file__).resolve().parent):
    sys.path[0] = str(ROOT)

import argparse  # noqa: E402

import torch  # noqa: E402

from bench_port import harness  # noqa: E402
from bench_port.reference import train as reference  # noqa: E402


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def readings(cell: harness.Cell, seed_list, control_seeds, fault_seeds, device="cuda", emit=print) -> list[dict]:
    cfg, wl = cell.config, cell.workload
    out = []

    def record(seed, side, numbers, seconds):
        row = {"workload": cell.name, "seed": seed, "side": side, "seconds": round(seconds, 1), **numbers}
        out.append(row)
        emit(json.dumps(row))

    for seed in sorted(set(seed_list) | set(control_seeds) | set(fault_seeds)):
        sides = {}
        t = time.perf_counter()
        ref = reference.train_steps(cfg, wl, seed, device, cfg["reference_precision"], harness.COMPARED_STEPS)
        t_ref = time.perf_counter() - t
        harness.free(device)
        runs = ([("program", None)] if seed in seed_list else []) + \
               ([(f"fault:{f}", f) for f in ("half_batch",)] if seed in fault_seeds else [])
        for side, fault in runs:
            t = time.perf_counter()
            prog = harness.Program(cfg, wl, seed, device, fault=fault)
            sides[side] = (prog.first_steps(), time.perf_counter() - t)
            del prog
            harness.free(device)
        if seed in control_seeds:
            t = time.perf_counter()
            sides["control"] = (reference.train_steps(cfg, wl, seed, device, cfg["control_precision"],
                                                      harness.COMPARED_STEPS), time.perf_counter() - t)
        record(seed, "reference", {"losses": ref["losses"]}, t_ref)
        for side, (got, secs) in sides.items():
            record(seed, side, {**harness.gaps(got, ref), "losses": got["losses"],
                                "leaves": harness.worst_leaves(got, ref)}, secs)
        harness.free(device)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card visible", file=sys.stderr)
        return 3
    rows = readings(harness.load_cell(args.workload), args.seeds, args.control_seeds, args.fault_seeds)
    for side in sorted({r["side"] for r in rows} - {"reference"}):
        mine = [r for r in rows if r["side"] == side]
        worst = {k: max(r[k] for r in mine) for k in ("loss_gap", "grad_gap", "change_gap", "change_gap_median")}
        least = {k: min(r[k] for r in mine) for k in worst}
        print(json.dumps({"workload": args.workload, "side": side, "seeds": len(mine), "max": worst, "min": least}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
