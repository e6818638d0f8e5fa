"""Build the package's native sources into shared libraries at first use.

Each kernel file under ``csrc/`` exposes a plain C entry point (pointers,
sizes and the stream; returns ``cudaGetLastError()``), so it compiles with
``nvcc`` alone in seconds, without PyTorch's headers, and loads with
:mod:`ctypes`.  The host resampler (``csrc/resample.cpp``) is plain C++
and compiles with ``g++``.  Libraries land in ``build/kernels/`` at the
repository root (git-ignored), named by a hash of the source, every local
header it includes and the flags, so a changed source or header is rebuilt
and an unchanged one is reused.  The compiler's output is kept beside the
library (``<library>.log``).  A failed build raises.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

# Hopper only: the `a` keeps wgmma/setmaxnreg available to later kernels
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
# the JAX package's flags for the same resampler source
# (enhance_cb_whisper_tpu/audio/native/__init__.py)
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the host resampler needs a C++ compiler")
    return found


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    for path in candidates:
        if os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def local_headers(src: Path) -> list:
    """The files that ``src`` includes with ``#include "..."``, found next to
    the including file, and theirs in turn, each once, in include order."""
    seen, order, todo = {src.resolve()}, [], [src]
    while todo:
        path = todo.pop(0)
        for name in _LOCAL_INCLUDE.findall(path.read_bytes()):
            header = (path.parent / name.decode()).resolve()
            if header not in seen and header.exists():
                seen.add(header)
                order.append(header)
                todo.append(header)
    return order


def source_digest(src: Path, flags) -> str:
    """Hash of a source, the local headers it includes and the flags."""
    h = hashlib.sha1(src.read_bytes())
    for header in local_headers(src):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:12]


def build_library(source: str, extra_flags=()) -> Path:
    """Compile ``csrc/<source>`` to a shared library with ``NVCC_FLAGS``
    and the library's own ``extra_flags``; returns its path."""
    return _build(CSRC_DIR / source, (*NVCC_FLAGS, *extra_flags), _nvcc)


def build_host_library(source: str) -> Path:
    """Compile the plain C++ ``csrc/<source>`` with g++ and ``HOST_FLAGS``;
    returns the library's path."""
    return _build(CSRC_DIR / source, HOST_FLAGS, _gxx)


def _build(src: Path, flags, compiler) -> Path:
    out = BUILD_DIR / f"lib{src.stem}_{source_digest(src, flags)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never sees
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [compiler(), *flags, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(proc.args[0]).name} failed on {src.name}:\n{proc.stdout}{proc.stderr}")
        out.with_suffix(".so.log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
