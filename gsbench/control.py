"""The lower-precision control of a cell: the reference, computed in
bfloat16 (the precision below the configurations' float32), put in the
program's place for the requests a run checks, then checked as a run
checks the program. Every number it prints should read far past its
limit.

    python3 -m gsbench.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]

Prints one JSON line per seed with each number compared and its limit.
The benchmark's own runs never run it.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    import torch

    from gsbench import harness

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 3
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    for seed in args.seeds:
        run = harness.run_cell(bench, args.workload, seed, args.seconds, False, control=True)
        line = harness.result_line(run)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": line["correct"],
                          "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
