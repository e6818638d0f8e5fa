"""BENCHMARK.json against the contract's rules, and every name it holds
against the files the harness finds by name."""

import json
import re
import shutil

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def test_keys_names_and_units(bench):
    assert set(bench) == TOP_KEYS
    metrics = bench["end_to_end"] + bench["per_layer"]
    for entry in bench["configs"] + bench["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for w in bench["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for field in ("configs", "workloads"):
        names = [e["name"] for e in bench[field]]
        assert len(names) == len(set(names))
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_bounds_and_sources(bench):
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200


def test_every_cell_reports_what_its_metrics_move(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(bench, w["name"], per_layer=False)}
        per_layer = harness.cell_metrics(bench, w["name"], per_layer=True)
        assert "setup_s" in e2e and len(e2e) >= 2 and per_layer, w["name"]
        for m in per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])
    e2e_names = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e_names
        for cell in m.get("workloads", []):
            reported = {x["name"] for x in harness.cell_metrics(bench, cell, per_layer=False)}
            assert m["moves"] in reported, (m["name"], cell)


def test_files_found_by_name(bench):
    for c in bench["configs"]:
        assert (harness.ROOT / c["file"]).is_file() and c["file"].startswith("perfbench/")
    for w in bench["workloads"]:
        mix = harness.load_json(harness.BENCH_DIR / "workloads" / f"{w['name']}.json")
        harness.load_plugin("drivers", mix["driver"])
        harness.load_plugin("checks", mix["check"])
        assert set(mix["limits"]) and mix["control"] in ("tf32", "fp8")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.load_plugin("metrics", m["name"]).read)


def test_a_new_cell_and_metric_are_found_as_files(tmp_path):
    """A later change adds a mix and a metric as files; the harness finds
    them by name without an edit to any file that is there."""
    for kind in ("metrics", "workloads"):
        (tmp_path / kind).mkdir()
    (tmp_path / "metrics" / "extra_rate.per-cell.py").write_text("def read(ctx):\n    return 42.0\n")
    src = harness.BENCH_DIR / "workloads" / "kws-lef.exact-1k.json"
    shutil.copy(src, tmp_path / "workloads" / "kws-lef.exact-4k.json")
    reader = harness.load_plugin("metrics", "extra_rate.per-cell", base=tmp_path)
    assert reader.read(None) == 42.0
    assert harness.load_json(tmp_path / "workloads" / "kws-lef.exact-4k.json")["driver"] == "catalog"
