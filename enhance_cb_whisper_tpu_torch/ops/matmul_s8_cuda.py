"""Wrapper of the fused s8 matmul + requant kernel ``csrc/matmul_s8.cu``
(kernel K2 of the port).

Replaces ``enhance_cb_whisper_tpu/ops/matmul_s8.py:matmul_s8_requant`` (its
Pallas bodies ``_kernel_plain`` and ``_kernel_residual``).  On the H100 it
is bound by device-memory bytes: at the int8 ResNet's 1×1 shapes the
arithmetic intensity sits below the int8 tensor cores' ridge, so the design
keeps the int32 accumulators and the whole requant epilogue in registers
(1 B read and 1 B written per activation element) and runs the product on
the int8 tensor cores (``mma.sync`` m16n8k32).  The ragged edge of M is
masked in the kernel, so every M launches; N must be a multiple of 128 and
K of 64.

The library is compiled from the repository's sources with ``nvcc`` at
first use (:mod:`..build`) and bound with :mod:`ctypes`.  A tensor on the
CPU takes the plain torch version (:func:`.matmul_s8.matmul_s8_requant_plain`);
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from .matmul_s8 import matmul_s8_requant_plain

# kernel launches since import (or since a caller reset it to 0); the
# launch path below is the only place that increments it
launches = 0

_lib = None


def _library():
    global _lib
    if _lib is None:
        from ..build import build_library

        lib = ctypes.CDLL(str(build_library("matmul_s8.cu")))
        lib.ecw_matmul_s8_requant.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.ecw_matmul_s8_requant.restype = ctypes.c_int
        _lib = lib
    return _lib


def build() -> None:
    """Compile and load the kernel library now (otherwise: at first launch)."""
    _library()


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"matmul_s8_requant: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"matmul_s8_requant: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"matmul_s8_requant: {name} is on {t.device}, x on {device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"matmul_s8_requant: {name} must be contiguous and 16-byte aligned")


def matmul_s8_requant(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    relu: bool = True,
    residual: Optional[torch.Tensor] = None,
    res_scale: Union[torch.Tensor, float, None] = None,
) -> torch.Tensor:
    """x [M, K] int8, w [K, N] int8, scale/bias [N] f32, residual [M, N]
    int8, res_scale [N] or scalar f32 → [M, N] int8.

    The kernel reads w as [N, K] (K contiguous): pass ``w`` as the
    transposed view of a contiguous [N, K] tensor (``w_nk.t()``) and no copy
    is made."""
    global launches
    if x.device.type == "cpu":
        return matmul_s8_requant_plain(
            x, w, scale, bias, relu=relu, residual=residual, res_scale=res_scale
        )
    if x.device.type != "cuda":
        raise ValueError(f"matmul_s8_requant: unsupported device {x.device}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_s8_requant: x {tuple(x.shape)} and w {tuple(w.shape)} do not chain")
    m, k = x.shape
    n = w.shape[1]
    if m < 1 or n % 128 or k % 64:
        raise ValueError(f"matmul_s8_requant: needs N % 128 == 0 and K % 64 == 0, got M={m} K={k} N={n}")
    dev = x.device
    w_nk = w.t().contiguous()
    _check("x", x, torch.int8, (m, k), dev)
    _check("w", w_nk, torch.int8, (n, k), dev)
    _check("scale", scale, torch.float32, (n,), dev)
    _check("bias", bias, torch.float32, (n,), dev)
    res_ptr = rs_ptr = None
    if residual is not None:
        if res_scale is None:
            raise ValueError("matmul_s8_requant: a residual needs res_scale")
        rs = torch.as_tensor(res_scale, dtype=torch.float32, device=dev)
        rs = rs.reshape(-1).expand(n).contiguous() if rs.numel() == 1 else rs
        _check("residual", residual, torch.int8, (m, n), dev)
        _check("res_scale", rs, torch.float32, (n,), dev)
        res_ptr, rs_ptr = residual.data_ptr(), rs.data_ptr()
    out = torch.empty((m, n), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().ecw_matmul_s8_requant(
            x.data_ptr(), w_nk.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            res_ptr, rs_ptr, out.data_ptr(), m, n, k, int(relu), stream,
        )
    if err != 0:
        raise RuntimeError(f"matmul_s8 kernel launch failed: CUDA error {err}")
    launches += 1
    return out
