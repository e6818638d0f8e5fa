#!/usr/bin/env python3
"""Runs one cell of the benchmark once, on the card of this machine.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result as one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` a ``breakdown``, and ``compared`` last: each number the
check compared, with its limit).  The compared numbers are also the last
lines of standard error.  Without an NVIDIA card, or with fewer cards than
the cell asks for, it exits with 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = harness.load_benchmark()
    entry = harness.by_name(bench["workloads"], args.workload, "workload")
    harness.cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"perfbench: the cell needs {entry['chips']} NVIDIA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(f"perfbench: {args.workload} seed {args.seed} on {harness.power_limit()}", file=sys.stderr)
    env = harness.make_env(bench, args.workload, args.seed, device, bool(args.trace))
    run = harness.run_cell(bench, env, args.seconds, T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"perfbench: JAX or the JAX package is loaded: {loaded}", file=sys.stderr)
        return 3
    for note in run["notes"]:
        print(f"perfbench: {note}", file=sys.stderr)
    for name, c in run["result"]["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(run["result"]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
