"""The port's kernel build names each library by a digest of its source,
the local headers the source includes (and theirs), and the flags: a change
to any of them gives a new library name, so a stale build is never loaded.
A launch through :class:`NativeLibrary` raises on a nonzero CUDA error and
counts only the launches that succeeded.  Pure Python: no nvcc needed."""

import pytest
import torch

from enhance_cb_whisper_tpu_torch.build import CSRC_DIR, NativeLibrary, local_headers, source_digest


def test_digest_follows_included_headers_and_flags(tmp_path):
    (tmp_path / "inner.cuh").write_text("#pragma once\nconstexpr int kA = 1;\n")
    (tmp_path / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    src = tmp_path / "kernel.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "outer.cuh"\n__global__ void k() {}\n')
    assert [h.name for h in local_headers(src)] == ["outer.cuh", "inner.cuh"]

    before = source_digest(src, ("-O3",))
    assert source_digest(src, ("-O3",)) == before
    (tmp_path / "inner.cuh").write_text("#pragma once\nconstexpr int kA = 2;\n")
    after = source_digest(src, ("-O3",))
    assert after != before
    assert source_digest(src, ("-O3", "-Xptxas=-v")) != after


def test_k2_source_includes_its_header():
    assert "hopper.cuh" in [h.name for h in local_headers(CSRC_DIR / "matmul_s8.cu")]


def test_k3_source_includes_its_header():
    assert "hopper.cuh" in [h.name for h in local_headers(CSRC_DIR / "maxsim.cu")]


def test_launch_raises_on_a_cuda_error_and_counts_only_successes(monkeypatch):
    """A stub entry point in place of the built library, and stand-ins for
    the stream fetch and the current card, which the CPU build of torch
    lacks: the entry point gets the arguments and card 1's stream; a nonzero
    return raises with the kernel's name and leaves the count unchanged, a
    zero return adds ``launches``."""
    calls, errors = [], [0, 700]
    lib = NativeLibrary("maxsim.cu", "ecw_maxsim_proxy", [])
    monkeypatch.setattr(lib, "_load", lambda: lambda *args: calls.append(args) or errors.pop(0))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda idx: f"stream {idx}", raising=False)

    lib.launch(torch.device("cuda", 1), 11, None, launches=2)
    assert lib.launches == 2 and calls == [(11, None, "stream 1")]
    with pytest.raises(RuntimeError, match="maxsim kernel launch failed: CUDA error 700"):
        lib.launch(torch.device("cuda"), 12, None, launches=2)
    assert lib.launches == 2 and calls[1] == (12, None, "stream 1")
