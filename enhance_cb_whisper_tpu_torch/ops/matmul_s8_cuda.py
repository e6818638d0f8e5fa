"""Wrapper of the fused s8 matmul + requant kernel ``csrc/matmul_s8.cu``
(kernel K2 of the port), and its launch planner.

Replaces ``enhance_cb_whisper_tpu/ops/matmul_s8.py:matmul_s8_requant`` (its
Pallas bodies ``_kernel_plain`` and ``_kernel_residual``).  On the H100 it
is bound by device-memory bytes: at the int8 ResNet's 1×1 shapes the
arithmetic intensity sits below the int8 tensor cores' ridge.  The kernel
streams x and w through a TMA ring into ``wgmma``, keeps the int32
accumulators and the whole requant epilogue on chip, and stores int8 tiles
with TMA (1 B read and 1 B written per activation element).  Its shape
rule is the JAX kernel's: K and N multiples of 128; any M ≥ 1.

:func:`launch_plan` picks the tile height and the split of K for each (M, K, N);
the split blocks of a tile sum their partials inside the one launch, so
every call is one launch.  A tensor on the CPU takes the plain torch
version (:func:`.matmul_s8.matmul_s8_requant_plain`); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import functools
from ctypes import c_int, c_void_p
from typing import NamedTuple, Optional, Union

import torch

from ..build import NativeLibrary
from .matmul_s8 import matmul_s8_requant_plain

NUM_SMS = 132  # H100 SXM
K_TILE = 128  # bytes of K per pipeline stage
BN = 128  # output columns per tile
MAX_SPLIT = 8  # blocks of one cluster

kernel = NativeLibrary("matmul_s8.cu", "ecw_matmul_s8_requant",
                       [c_void_p] * 6 + [c_int, c_void_p] + [c_int] * 6 + [c_void_p])


class Plan(NamedTuple):
    """One launch of K2: output tiles of ``bm`` × 128, K cut into ``split``
    slices of whole 128-byte k-tiles (the split blocks of a tile form one
    cluster)."""

    m: int
    k: int
    n: int
    bm: int
    split: int

    @property
    def tiles(self) -> int:
        return -(-self.m // self.bm) * (self.n // BN)

    @property
    def ctas(self) -> int:
        return self.tiles * self.split

    def k_slices(self):
        """[k0, k1) of each split block, as the kernel cuts them."""
        kt = self.k // K_TILE
        return [(i * kt // self.split * K_TILE, (i + 1) * kt // self.split * K_TILE)
                for i in range(self.split)]


@functools.lru_cache(maxsize=None)
def launch_plan(m: int, k: int, n: int) -> Plan:
    """The tile height and the split of K for an (M, K, N) launch.

    BM = 128 (two consumer warpgroups, w read half as often) where that
    still makes at least ``NUM_SMS`` tiles and each tile has two or more
    k-tiles; else BM = 64, whose smaller blocks fit more to an SM.  K is
    split only where the tiles fill fewer than half the SMs: into the
    smallest power of two of slices (at most ``MAX_SPLIT`` and at most
    K / 128) that fills half of them.  On the H100, splitting at 118 tiles
    was slower than not, and the cluster's reduction costs about what the
    extra blocks gain at 60 tiles (PERF.md)."""
    if m < 1 or k < K_TILE or k % K_TILE or n < BN or n % BN:
        raise ValueError(f"matmul_s8_requant: needs K % 128 == 0 and N % 128 == 0, got M={m} K={k} N={n}")
    tall = Plan(m, k, n, 128, 1)
    plan = tall if k >= 2 * K_TILE and tall.tiles >= NUM_SMS else Plan(m, k, n, 64, 1)
    split = 1
    while 2 * plan.tiles * split < NUM_SMS and split * 2 <= min(MAX_SPLIT, k // K_TILE):
        split *= 2
    return plan._replace(split=split)


def _diagnose(x, w_nk, scale, bias, residual, rs, m, n, k) -> None:
    """Raises the error that names the operand the kernel cannot take."""
    operands = [("x", x, torch.int8, (m, k)), ("w", w_nk, torch.int8, (n, k)),
                ("scale", scale, torch.float32, (n,)), ("bias", bias, torch.float32, (n,))]
    if residual is not None:
        operands.append(("residual", residual, torch.int8, (m, n)))
        if rs.numel() != 1:
            operands.append(("res_scale", rs, torch.float32, (n,)))
    for name, t, dtype, shape in operands:
        if t.dtype != dtype:
            raise TypeError(f"matmul_s8_requant: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"matmul_s8_requant: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if t.device != x.device:
            raise ValueError(f"matmul_s8_requant: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"matmul_s8_requant: {name} must be contiguous and 16-byte aligned")
    raise AssertionError("matmul_s8_requant: operands rejected without a reason")


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
    is made.  A scalar ``res_scale`` is read by the kernel where it lies."""
    dev = x.device
    if dev.type == "cpu":
        return matmul_s8_requant_plain(
            x, w, scale, bias, relu=relu, residual=residual, res_scale=res_scale
        )
    if dev.type != "cuda":
        raise ValueError(f"matmul_s8_requant: unsupported device {dev}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_s8_requant: x {tuple(x.shape)} and w {tuple(w.shape)} do not chain")
    m, k = x.shape
    n = w.shape[1]
    plan = launch_plan(m, k, n)
    # w as the [K, N] view of a contiguous [N, K] tensor, whose storage the kernel reads
    w_kn = w if w.stride() == (1, k) else w.t().contiguous().t()
    idx = dev.index
    tensors = [x, w_kn, scale, bias]
    res_ptr = rs_ptr = None
    rs = None
    rs_stride = 0
    if residual is not None:
        if res_scale is None:
            raise ValueError("matmul_s8_requant: a residual needs res_scale")
        rs = res_scale
        if not (isinstance(rs, torch.Tensor) and rs.dtype is torch.float32 and rs.get_device() == idx):
            rs = torch.as_tensor(rs, dtype=torch.float32, device=dev)
        rs_stride = 0 if rs.numel() == 1 else 1  # a single value is read where it lies
        tensors += [residual, rs] if rs_stride else [residual]
        res_ptr, rs_ptr = residual.data_ptr(), rs.data_ptr()
    # one pass over the operands; _diagnose names the one that fails
    ok = (
        x.dtype is torch.int8 and w_kn.dtype is torch.int8
        and scale.dtype is torch.float32 and bias.dtype is torch.float32
        and scale.shape == bias.shape == (n,)
        and all(t.get_device() == idx and t.data_ptr() % 16 == 0 for t in tensors)
        and x.is_contiguous() and scale.is_contiguous() and bias.is_contiguous()
    )
    if residual is not None:
        ok = ok and (residual.dtype is torch.int8 and residual.shape == (m, n) and residual.is_contiguous()
                     and (rs_stride == 0 or (rs.shape == (n,) and rs.is_contiguous())))
    if not ok:
        _diagnose(x, w_kn.t(), scale, bias, residual, rs, m, n, k)
    out = torch.empty((m, n), dtype=torch.int8, device=dev)
    # on the caller's current stream: a thread that sets no stream of its own
    # (a serving worker) gets the legacy default stream, the one every other
    # op of the scorer runs on
    kernel.launch(dev, x.data_ptr(), w_kn.data_ptr(), scale.data_ptr(), bias.data_ptr(), res_ptr, rs_ptr,
                  rs_stride, out.data_ptr(), m, n, k, int(relu), plan.bm, plan.split)
    return out
