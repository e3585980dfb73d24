"""Run one cell of the benchmark once and print its result as the last line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic mix
and its metrics are found by name from BENCHMARK.json and the files under
gpubench/ (see gpubench/README.md).  With --trace 0 the result holds the
cell's end-to-end metrics, with --trace 1 its per-layer metrics and the
device trace's busy time and breakdown.  A run needs a CUDA card: without
one, or with fewer cards than the cell asks for, it exits with code 2 and
prints no result.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402

# One process with few threads: the frame path runs on the card and on the
# host's Python threads, so the numeric libraries' own thread pools only
# take cores from them.  Set before numpy and torch load.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

from gbench import spec  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    bench = spec.load_benchmark()
    cell = spec.resolve(bench, args.workload)["cell"]

    import torch
    marks = {"import torch": time.perf_counter() - T_START}
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on a card",
              file=sys.stderr)
        sys.exit(2)
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        sys.exit(2)
    # one card: the renderers split a frame over every card they see
    torch.cuda.set_device(0)
    torch.zeros(1, device="cuda")
    marks["CUDA context"] = time.perf_counter() - T_START

    from gbench.cell import run_cell
    result, lines, notes = run_cell(args.workload, args.seed, args.seconds,
                                    bool(args.trace), T_START, marks=marks)
    with open("/proc/loadavg") as f:
        notes.append(f"host load average {f.read().split()[:3]} on "
                     f"{len(os.sched_getaffinity(0))} cores")
    for note in notes:
        print(note, file=sys.stderr)
    for name, (value, limit) in lines.items():
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    if lines["jax_modules"][0]:
        sys.exit(3)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
