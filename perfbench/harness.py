"""The benchmark's engine: finds a cell's files by name, runs its driver,
judges the outputs, reads the metrics and assembles the result line.

Everything particular to a configuration, a traffic mix or a metric sits in
files of its own, found by the names in ``BENCHMARK.json``:

* ``BENCHMARK.json``'s ``configs[].file``: the configuration's sizes;
* ``perfbench/workloads/<cell>.json``: the cell's traffic mix, which names
  its ``driver`` (``perfbench/drivers/<driver>.py``), its ``check``
  (``perfbench/checks/<check>.py``) and the ``limits`` of the numbers the
  check compares;
* ``perfbench/metrics/<metric>.py``: one reader per metric, ``read(ctx)``,
  which returns a number or None (nothing to read: left out).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "enhance_cb_whisper_tpu")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_plugin(kind: str, name: str, base: Path = BENCH_DIR):
    """The module ``<base>/<kind>/<name>.py`` (a name may hold dots),
    loaded as part of the ``perfbench`` package so its relative imports
    work."""
    path = base / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    mod_name = f"perfbench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench: dict, cell: str, per_layer: bool) -> List[dict]:
    """The metrics a cell reports: its end-to-end ones, or its per-layer
    ones (those that list it, or that list no cells and move an end-to-end
    metric the cell reports)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not per_layer:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def cache_dirs(root: Path = ROOT) -> None:
    """Fixed build and kernel-cache directories inside the checkout."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "build" / "perfbench" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "perfbench" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")  # transformers, if anything loads it, must not load JAX


def power_limit() -> str:
    """``nvidia-smi``'s card name and power limit, or why there is none."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi unavailable: {err}"


@dataclasses.dataclass
class Env:
    cell: str
    config: dict
    mix: dict
    seed: int
    device: Any
    trace: bool


@dataclasses.dataclass
class Ctx:
    """What a metric reader sees."""
    env: Env
    out: dict
    setup_s: float
    summary: Optional[dict]
    peaks: Optional[dict]
    slice_s: float


def make_env(bench: dict, cell: str, seed: int, device, trace: bool, root: Path = ROOT) -> Env:
    entry = by_name(bench["workloads"], cell, "workload")
    config = load_json(root / by_name(bench["configs"], entry["config"], "configuration")["file"])
    mix = load_json(BENCH_DIR / "workloads" / f"{cell}.json")
    return Env(cell, config, mix, int(seed), device, bool(trace))


def judge(compared: Dict[str, float], limits: Dict[str, float]) -> bool:
    missing = set(limits) - set(compared)
    if missing:
        raise KeyError(f"the check compared nothing under {sorted(missing)}")
    return all(math.isfinite(compared[k]) and compared[k] <= limits[k] for k in limits)


def run_cell(bench: dict, env: Env, seconds: float, t0: float) -> dict:
    """One run of a cell; returns the result line's fields (``compared``
    last) and ``notes``, earlier lines for standard error."""
    import torch

    from . import trace

    driver = load_plugin("drivers", env.mix["driver"])
    check = load_plugin("checks", env.mix["check"])
    cuda = env.device.type == "cuda"
    state = driver.setup(env)
    out = driver.window(state, seconds)
    setup_s = out["setup_end"] - t0
    summary = trace.summarize(state.slice) if env.trace and state.slice is not None else None
    slice_s = state.slice.wall_s if summary is not None else 0.0
    device = {"platform": "gpu" if cuda else env.device.type,
              "kind": torch.cuda.get_device_name(env.device) if cuda else "cpu",
              "count": 1,
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated(env.device)) if cuda else 0}
    if summary is not None:
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = slice_s
    items = driver.check_items(state, out)
    driver.close(state)
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if len(items) < env.mix["check_requests_min"]:
        raise RuntimeError(f"only {len(items)} requests to judge; the mix asks for {env.mix['check_requests_min']}")
    t_ref = time.perf_counter()
    compared = check.readings(env, items)
    ref_s = time.perf_counter() - t_ref
    limits = env.mix["limits"]
    correct = judge(compared, limits)

    peaks = load_json(BENCH_DIR / "peaks.json")["cards"].get(device["kind"])
    ctx = Ctx(env, out, setup_s, summary, peaks, slice_s)
    metrics = {}
    for m in cell_metrics(bench, env.cell, per_layer=env.trace):
        value = load_plugin("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    result["compared"] = {k: {"value": compared[k], "limit": limits[k]} for k in limits}
    notes = [f"reference and check: {ref_s!r} s over {len(items)} requests"]
    notes += [f"{k}: {v!r}" for k, v in out.items() if k in ("steps", "occupied", "prompt_tokens", "features_ms", "launch_s")]
    return {"result": result, "notes": notes}
