"""Build, load, launch and count the package's native libraries.

Each kernel file under ``csrc/`` exposes a plain C entry point (pointers,
sizes and the stream; returns ``cudaGetLastError()``), so it compiles with
``nvcc`` alone in seconds, without PyTorch's headers, and loads with
:mod:`ctypes`.  The host resampler (``csrc/resample.cpp``) is plain C++
and compiles with ``g++``.  Libraries land in ``build/kernels/`` at the
repository root (git-ignored), named by a hash of the source, every local
header it includes and the flags, so a changed source or header is rebuilt
and an unchanged one is reused.  The compiler's output is kept beside the
library (``<library>.log``).  A failed build raises.

:class:`NativeLibrary` is the one way the package reaches such a library:
built and loaded at first use, its entry point bound, each kernel launched
on the current stream of its tensors' card and counted.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

# Hopper only: the `a` keeps wgmma/setmaxnreg available to later kernels;
# -Xptxas=-v writes each kernel's registers, shared memory and spills into
# the build's log
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
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


class NativeLibrary:
    """One library compiled from ``csrc/<source>``: with nvcc and
    ``NVCC_FLAGS``, or, for ``host`` code, with g++ and ``HOST_FLAGS``.
    Its entry point ``symbol`` takes ``argtypes`` (a CUDA entry point the
    stream last) and returns an int, 0 on success.  ``name`` (the source's
    stem unless given) names the kernel in a launch's error.

    Nothing is built until first use; then the library is built and loaded
    once, whichever thread asks first.  ``launches`` counts the kernel
    launches since import (or since a caller set it to 0); only
    :meth:`launch` adds to it, under the library's lock, since a kernel runs
    from more than one thread (``run_test``'s prefetch thread, serving
    workers)."""

    def __init__(self, source: str, symbol: str, argtypes, host: bool = False, name: str = None):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.host = host
        self.name = name or Path(source).stem
        self.launches = 0
        self.path = None  # the library's file, once loaded
        self._entry = None
        # what launch calls: the bound entry point once loaded, until then
        # a stand-in that loads it, so a launch tests nothing
        self._call = self._load_and_call
        self._lock = threading.Lock()

    def _load(self):
        src = CSRC_DIR / self.source
        path = _build(src, HOST_FLAGS, _gxx) if self.host else _build(src, NVCC_FLAGS, _nvcc)
        entry = getattr(ctypes.CDLL(str(path)), self.symbol)
        entry.argtypes = self.argtypes
        entry.restype = ctypes.c_int
        self.path = str(path)
        return entry

    def entry(self):
        """The bound entry point; a failed build raises in the thread that
        hit it (and the next caller builds again)."""
        if self._entry is None:
            with self._lock:
                if self._entry is None:
                    self._entry = self._call = self._load()
        return self._entry

    def _load_and_call(self, *args):
        return self.entry()(*args)

    def build(self) -> str:
        """Compile and load the library now (otherwise: at first use);
        returns its path."""
        self.entry()
        return self.path

    def launch(self, device: torch.device, *args, launches: int = 1) -> None:
        """Call the CUDA entry point with ``args`` and the raw current stream
        of ``device``'s card (a thread that sets no stream of its own gets
        the legacy default stream); raise on a nonzero CUDA error, else
        count ``launches`` kernel launches."""
        current = torch.cuda.current_device()
        idx = current if device.index is None else device.index
        # the raw handle: torch.cuda.current_stream() would build a Stream
        # object, which costs more than the rest of a launch
        if idx == current:
            err = self._call(*args, torch._C._cuda_getCurrentRawStream(idx))
        else:
            with torch.cuda.device(idx):
                err = self._call(*args, torch._C._cuda_getCurrentRawStream(idx))
        if err:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error {err}")
        with self._lock:
            self.launches += launches
