"""One run of one benchmark cell of the port, on the card this process sees.

    python3 bench_port/run.py --workload pythia-1b.noremat.mbs16 --seed 7 --seconds 30 --trace 0

Prints progress and, last on standard error, each number that decides
``correct`` beside its limit; then one JSON line on standard output: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, the device's busy time and the trace's breakdown. Exits
with 3 and prints no result where no CUDA card, or fewer than the cell asks
for, is visible.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path[0] == str(Path(__file__).resolve().parent):
    sys.path[0] = str(ROOT)  # run as a script: import the benchmark and the port from the checkout's root

import torch  # noqa: E402

from bench_port import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), T_START)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
