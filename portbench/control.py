"""The control of a cell's comparison: the reference put in the port's
place and computed one precision below the configuration's (bfloat16
for the float32 regrid), judged exactly as a run's outputs are.  It has to come out not correct.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

prints one JSON line per seed: the readings beside their limits, and
whether they would pass.  It needs no card to run (the CPU is used
without one) and loads nothing of the port.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

#: The precision below each configuration's.
BELOW = {"float64": "float32", "float32": "bfloat16"}


def readings(root, workload: str, seed: int, device) -> dict:
    """The control's readings for ``workload`` on ``seed``: as many
    calls as a run keeps, each computed by the reference in the lower
    precision."""
    import importlib

    import torch

    from portbench import harness, spec

    benchmark = spec.load(root)
    cell = spec.cell(benchmark, workload)
    traffic = spec.traffic(root, cell["traffic"])
    config = spec.config(root, benchmark, cell["config"])
    generator = importlib.import_module(f"portbench.generators.{traffic['generator']}").Generator(
        harness.Run(cell, config, traffic, seed, device)
    )
    generator.make_inputs()
    stated = config["precision"]
    dtype = getattr(torch, BELOW[stated])
    kept = [(k, generator.control_output(k, dtype)) for k in range(traffic["keep_calls"] + 1)]
    checks = generator.check(kept)
    return {
        "workload": workload,
        "seed": seed,
        "precision": BELOW[stated],
        "passes": all(value <= limit for value, limit in checks.values()),
        "checks": {name: {"value": value, "limit": limit} for name, (value, limit) in checks.items()},
    }


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    for seed in args.seeds:
        print(json.dumps(readings(ROOT, args.workload, seed, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
