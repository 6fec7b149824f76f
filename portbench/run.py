"""Run one cell of the port's benchmark once, on the card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result as one JSON object; the last lines of standard error give each
number the comparison checked beside its limit.  Exits non-zero and
prints no result when the cell's cards are missing, or when JAX or the
JAX package was loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# The checkout's root, not this folder, heads the path: the port and
# this package import from there.
sys.path[0] = str(ROOT)


def parse(argv):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import harness, spec

    chips = spec.cell(spec.load(ROOT), args.workload)["chips"]
    device = harness.look_for_chips(chips)
    if device is None:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); none or too few found", file=sys.stderr)
        return 2
    result, lines = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), device, STARTED)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    for check in result["checks"].values():
        check["value"] = harness.finite(check["value"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
