"""The port's kernel build names each library by a digest of its source,
the local headers the source includes (and theirs), and the flags: a change
to any of them gives a new library name, so a stale build is never loaded.
Pure Python: no nvcc needed."""

from enhance_cb_whisper_tpu_torch.build import CSRC_DIR, local_headers, source_digest


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
