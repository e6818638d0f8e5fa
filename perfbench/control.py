#!/usr/bin/env python3
"""Reads the numbers a cell's check compares, for the program and for its
control, over several seeds in one process: the readings its limits are
set from.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 [--control-seeds 11,12,13] [--seconds 20]

Per seed it builds the program, runs a short window at the cell's own load
(long enough to finish the requests the check draws), and prints one JSON
line: the program's readings and, for a seed in ``--control-seeds``, the
readings of the control (the plain reference in the precision below the
configuration's, the mix file's ``control``) in the program's place, each
beside the cell's limit.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness  # noqa: E402


def read_seed(bench, cell: str, seed: int, seconds: float, device, control: bool) -> dict:
    import torch

    env = harness.make_env(bench, cell, seed, device, False)
    driver = harness.load_plugin("drivers", env.mix["driver"])
    check = harness.load_plugin("checks", env.mix["check"])
    state = driver.setup(env)
    out = driver.window(state, seconds)
    items = driver.check_items(state, out)
    driver.close(state)
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    line = {"cell": cell, "seed": seed, "requests": len(items), "limits": env.mix["limits"],
            "program": check.readings(env, items)}
    if control:
        t0 = time.perf_counter()
        line["control"] = check.readings(env, items, control=env.mix["control"])
        line["control_precision"] = env.mix["control"]
        line["control_s"] = time.perf_counter() - t0
    line["program_correct"] = harness.judge(line["program"], env.mix["limits"])
    if control:
        line["control_correct"] = harness.judge(line["control"], env.mix["limits"])
    return line


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    harness.cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("perfbench control: needs an NVIDIA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    bench = harness.load_benchmark()
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    print(f"perfbench control: {args.workload} on {harness.power_limit()}", file=sys.stderr)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(read_seed(bench, args.workload, seed, args.seconds, device, seed in controls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
