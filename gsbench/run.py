"""Run one cell of the benchmark once and print its result line.

    python3 -m gsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic mix,
metrics and check limits are found by name from ``BENCHMARK.json``. The
program's kernels build into its fixed ``build/kernels/`` and any other
compiler cache goes under ``build/`` of the checkout, so only a
checkout's first run compiles. Exits 3 without a result when CUDA or
enough cards are missing, 4 when the run loaded JAX or the JAX package.
"""

import time

T0 = time.perf_counter()  # process start, as near as the interpreter allows

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", required=True, type=int)
    parser.add_argument("--seconds", required=True, type=float)
    parser.add_argument("--trace", default=0, type=int, choices=(0, 1))
    args = parser.parse_args(argv)
    cache = ROOT / "build" / "gsbench-cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    bench_path = ROOT / "BENCHMARK.json"
    if not bench_path.exists():
        print(f"no {bench_path}", file=sys.stderr)
        return 2
    with open(bench_path) as f:
        bench = json.load(f)
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from gsbench import harness

    try:
        run = harness.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                               device="cuda", t0=T0)
    except SystemExit as stop:
        print(f"{stop}", file=sys.stderr)
        return 4
    line = harness.result_line(run)
    # the check and the metric readers ran after the window: look again
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    harness.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
