"""The port's ``runtime/profiler.py`` against the JAX package's: the events
of JAX ``tests/test_flops_profiler.py:_fake_trace`` written once in JAX's
trace format (device tracks named by process, an "XLA Modules" track over
the op track) and once as a Kineto trace (device work by category, a user
annotation over the kernels, host ops beside them).  The port's
``device_op_breakdown`` on the Kineto one gives JAX's ``(total, ops)`` on
its own, leaf ops only, with a nested event too."""

import gzip
import json

import pytest
import torch

from enhance_cb_whisper_tpu.runtime.profiler import device_op_breakdown as jax_breakdown
from enhance_cb_whisper_tpu_torch.runtime.profiler import device_op_breakdown, trace

# (name, ts, dur) on the device's op track, and one host event
OPS = [("fusion.1", 0, 40), ("fusion.1", 50, 40), ("copy.2", 90, 10)]
NESTED = [("outer.4", 200, 30), ("inner.5", 205, 10)]
HOST = ("np.asarray", 0, 999)


def _write(directory, name, events):
    directory.mkdir(parents=True, exist_ok=True)
    with gzip.open(directory / name, "wt") as f:
        json.dump({"traceEvents": events}, f)


def _jax_trace(tmp_path, ops):
    events = [
        {"ph": "M", "pid": 1, "name": "process_name", "args": {"name": "/device:TPU:0"}},
        {"ph": "M", "pid": 9, "name": "process_name", "args": {"name": "/host:CPU"}},
        {"ph": "M", "pid": 1, "tid": 1, "name": "thread_name", "args": {"name": "XLA Modules"}},
        {"ph": "M", "pid": 1, "tid": 2, "name": "thread_name", "args": {"name": "XLA Ops"}},
        {"ph": "X", "pid": 1, "tid": 1, "name": "jit_f", "ts": 0, "dur": 100},
        *({"ph": "X", "pid": 1, "tid": 2, "name": n, "ts": ts, "dur": d} for n, ts, d in ops),
        {"ph": "X", "pid": 9, "tid": 1, "name": HOST[0], "ts": HOST[1], "dur": HOST[2]},
    ]
    _write(tmp_path / "jax" / "plugins" / "profile" / "run1", "host.trace.json.gz", events)
    return str(tmp_path / "jax")


def _kineto_trace(tmp_path, ops):
    """The same events as torch.profiler writes them: the host process
    named after the program, kernels on the GPU's stream track, a
    ``record_function`` mirrored onto the GPU as a user annotation."""
    events = [
        {"ph": "M", "pid": 4242, "name": "process_name", "args": {"name": "python3 chip_smoke.py"}},
        {"ph": "M", "pid": 0, "name": "process_name", "args": {"name": "CUDA GPU 0"}},
        {"ph": "M", "pid": 0, "tid": 7, "name": "thread_name", "args": {"name": "stream 7"}},
        {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 8, "name": "jit_f", "ts": 0, "dur": 100},
        *({"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": n, "ts": ts, "dur": d} for n, ts, d in ops),
        {"ph": "X", "cat": "cpu_op", "pid": 4242, "tid": 1, "name": HOST[0], "ts": HOST[1], "dur": HOST[2]},
        {"ph": "X", "cat": "cuda_runtime", "pid": 4242, "tid": 1, "name": "cudaLaunchKernel", "ts": 1, "dur": 3},
    ]
    _write(tmp_path / "kineto", "00000000000000000001.1.trace.json.gz", events)
    return str(tmp_path / "kineto")


@pytest.mark.parametrize("ops", [OPS, OPS + NESTED], ids=["flat", "nested"])
def test_device_op_breakdown_matches_jax(tmp_path, ops):
    want = jax_breakdown(_jax_trace(tmp_path, ops))
    got = device_op_breakdown(_kineto_trace(tmp_path, ops))
    assert got[0] == pytest.approx(want[0])
    assert got[1] == want[1]
    names = [o["name"] for o in got[1]]
    assert "jit_f" not in names and HOST[0] not in names and "cudaLaunchKernel" not in names
    if ops is not OPS:
        assert "outer.4" not in names and "inner.5" in names  # the leaf, not its parent


def test_device_op_breakdown_reads_the_newest_trace(tmp_path):
    _write(tmp_path, "00000000000000000001.1.trace.json.gz",
           [{"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": "old", "ts": 0, "dur": 5}])
    _write(tmp_path, "00000000000000000002.1.trace.json.gz",
           [{"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7, "name": "Memcpy HtoD", "ts": 0, "dur": 5}])
    total, ops = device_op_breakdown(str(tmp_path))
    assert total == pytest.approx(5e-6) and [o["name"] for o in ops] == ["Memcpy HtoD"]
    with pytest.raises(FileNotFoundError):
        device_op_breakdown(str(tmp_path / "missing"))


def test_trace_of_a_cpu_forward_has_no_device_time(tmp_path):
    x = torch.randn(8, 16)
    w = torch.randn(16, 4)
    with trace(str(tmp_path), cuda=False) as prof:
        torch.relu(x @ w).sum()
    assert any(e.key for e in prof.key_averages())
    assert list(tmp_path.glob("*.trace.json.gz"))
    assert device_op_breakdown(str(tmp_path)) == (0.0, [])
