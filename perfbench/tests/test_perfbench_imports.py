"""Nothing the benchmark runs loads JAX or the JAX package: a fresh
interpreter imports the harness, every driver, check, metric reader and
the reference, then runs a tiny cell on the CPU, and lists the loaded
modules whose top-level name (before the first dot) is one of them."""

import json
import subprocess
import sys

from perfbench import harness

SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from perfbench import harness, trace, flops, weights, traffic, readers
from perfbench.reference import cbw, lef, mel, whisper, resnet, logits, precision
from pathlib import Path
for kind in ("drivers", "checks", "systems", "metrics"):
    for path in sorted((harness.BENCH_DIR / kind).glob("*.py")):
        if path.stem != "__init__":
            harness.load_plugin(kind, path.stem)
import tiny, time
bench = harness.load_benchmark()
harness.run_cell(bench, tiny.env("kws-lef.exact-1k"), 0.5, time.perf_counter())
harness.run_cell(bench, tiny.env("cbw-whisper-medium.spot"), 0.5, time.perf_counter())
print(json.dumps(harness.forbidden_modules()))
"""


def test_no_jax_in_a_fresh_interpreter():
    code = SCRIPT.format(root=str(harness.ROOT), tests=str(harness.BENCH_DIR / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(harness.ROOT / "build"), "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "enhance_cb_whisper_tpu_torch_fake", object())
    assert "enhance_cb_whisper_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax.numpy" in harness.forbidden_modules()
