"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <config>.<mix> --seed N \\
        --seconds S --trace 0|1

from the root of a checkout, on a machine with the CUDA cards the cell asks
for.  Prints the set-up by part, the window and each checked answer on
standard error, the numbers compared and their limits as its last lines
there, and one JSON object as the last line of standard output.  Exits 3
without a result where CUDA or cards are missing, 4 where the process has
loaded JAX or the JAX package, 2 where the program under test is not this
checkout's.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def process_age() -> float:
    """Seconds since this process started (0 where /proc has no answer)."""
    try:
        stat = Path("/proc/self/stat").read_text()
        start = float(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def temp_dir():
    """The program builds its kernels with nvcc into build/cuda/ inside the
    checkout; nvcc writes its intermediate files under TMPDIR and fails
    where that directory does not exist."""
    tmp = os.environ.get("TMPDIR")
    if tmp:
        os.makedirs(tmp, exist_ok=True)


def main(argv=None) -> int:
    t_start = _T0 - process_age()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    temp_dir()

    import torch
    # one process with few threads; the rate reads the same as with torch's
    # default of one a core (PERF.md, Findings)
    torch.set_num_threads(2)
    from portbench import harness, registry

    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        harness.log(f"{args.workload} needs {cell['chips']} CUDA card(s); "
                    f"CUDA available: {torch.cuda.is_available()}, cards: "
                    f"{torch.cuda.device_count()}")
        return 3
    try:
        import stereoreconstruction_tpu_torch as port
    except ImportError as exc:
        harness.log(f"the program under test is missing: {exc}")
        return 2
    if ROOT not in Path(port.__file__).resolve().parents:
        harness.log(f"the program under test, {port.__file__}, is not this "
                    f"checkout's ({ROOT})")
        return 2

    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              t_start, bench=bench)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"the run loaded {', '.join(bad)}: no result")
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
