"""Wrapper of the fused MaxSim proxy kernel ``csrc/maxsim.cu`` (kernel K3
of the port), and its launch planner.

Stage 1 of the cascade scorer (``efficient_kws/catalog.py:
maxsim_proxy_fast``) over a whole catalog in one call: the keyword frames
normalized on the way into shared memory, their bf16 (or f16) ``wgmma``
products with the utterance summed in f32, each frame's masked maximum
over the utterance kept in registers, then a second launch for the
mask-weighted means.  The similarity maps never reach device memory.  K3
replaces no TPU kernel (the JAX package leaves this proxy to XLA); the
source's note says why it was added and what bounds it.

Only CUDA tensors are taken: the plain version is the catalog module's
own, and the caller takes it for CPU tensors.  What the kernel does not
take raises.
"""

from __future__ import annotations

import functools
from ctypes import c_int, c_void_p
from typing import NamedTuple, Optional

import torch

from ..build import NativeLibrary

BK = 64  # elements of U per chunk (128 bytes of a 16-bit operand)
UNIT = 8  # U is a multiple of this: 16-byte loads of a 16-bit catalog
BN = 128  # utterance frames per tile
MAX_STAGES = 4
SMEM_LIMIT = 232448  # dynamic shared memory a block may use on sm_90
LAUNCHES_PER_CALL = 2  # the row maxima, then the means
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

kernel = NativeLibrary("maxsim.cu", "ecw_maxsim_proxy",
                       [c_void_p, c_int] * 4 + [c_void_p] * 2 + [c_int] * 7 + [c_void_p])


def smem_bytes(bm: int, chunks: int, stages: int, n_tiles: int) -> int:
    """A block's dynamic shared memory, as ``csrc/maxsim.cu`` lays it out:
    the alignment slack, the normalized keyword frames (``chunks`` of 64
    elements), the utterance ring, the column bias and tile flags, the
    barriers."""
    return 1024 + bm * chunks * BK * 2 + stages * BN * 128 + n_tiles * BN * 4 + (n_tiles * 4 + 7) // 8 * 8 \
        + 8 * 2 * MAX_STAGES


class Plan(NamedTuple):
    """One call of K3: blocks of ``bm`` keyword frames of one layer, a ring
    of ``stages`` utterance tiles."""

    rows: int  # keyword frames of one layer, N * T_k
    layers: int
    bm: int
    stages: int
    n_tiles: int  # utterance tiles of 128 frames
    smem: int

    @property
    def blocks(self) -> int:
        return -(-self.rows // self.bm) * self.layers


@functools.lru_cache(maxsize=None)
def launch_plan(n: int, layers: int, t_k: int, t_u: int, units: int) -> Plan:
    """The tile height and the ring's depth for a catalog of ``n`` keywords
    [layers, t_k, units] against ``t_u`` utterance frames.

    U is cut into chunks of 64 (the last zero-padded).  BM = 256 keyword
    frames where U <= 64 (one chunk: four groups of 64 rows meet each
    utterance tile, two blocks to an SM), else 64 (a tile's chunks
    accumulate in turn); as many stages (at most 4, at most the chunks to
    stream) as fit beside it.  Raises ValueError on a shape the kernel does
    not take: U not a positive multiple of 8, or a tile that leaves no room
    for one stage."""
    if n < 1 or layers < 1 or t_k < 1 or t_u < 1:
        raise ValueError(f"maxsim_proxy: empty shape N={n} L={layers} T_k={t_k} T_u={t_u}")
    if units < UNIT or units % UNIT:
        raise ValueError(f"maxsim_proxy: needs U % 8 == 0, got U={units}")
    if n * t_k >= 2**31 or layers * t_u >= 2**31 or layers > 65535:
        raise ValueError(f"maxsim_proxy: shape too large, N={n} L={layers} T_k={t_k} T_u={t_u}")
    chunks = -(-units // BK)
    bm = 256 if chunks == 1 else 64
    n_tiles = -(-t_u // BN)
    stages = min(MAX_STAGES, n_tiles * chunks)
    while stages > 1 and smem_bytes(bm, chunks, stages, n_tiles) > SMEM_LIMIT:
        stages -= 1
    smem = smem_bytes(bm, chunks, stages, n_tiles)
    if smem > SMEM_LIMIT:
        raise ValueError(f"maxsim_proxy: U={units} with T_u={t_u} needs {smem} B of shared memory "
                         f"(limit {SMEM_LIMIT})")
    return Plan(n * t_k, layers, bm, stages, n_tiles, smem)


def _mask(mask: Optional[torch.Tensor], shape, device, name: str):
    """(the mask as the kernel reads it, its dtype code)"""
    if mask is None:
        return None, 0
    if mask.dtype not in DTYPES:
        raise TypeError(f"maxsim_proxy: {name} must be float32, bfloat16 or float16, got {mask.dtype}")
    if tuple(mask.shape) != tuple(shape):
        raise ValueError(f"maxsim_proxy: {name} has shape {tuple(mask.shape)}, expected {tuple(shape)}")
    if mask.device != device:
        raise ValueError(f"maxsim_proxy: {name} is on {mask.device}, kwd on {device}")
    return mask.contiguous(), DTYPES[mask.dtype]


def maxsim_proxy(kwd: torch.Tensor, utt_n: torch.Tensor, kwd_mask: Optional[torch.Tensor],
                 utt_mask: Optional[torch.Tensor], dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """kwd [N, L, T_k, U] (float32, bfloat16 or float16), utt_n [L, T_u, U]
    (the normalized utterance), kwd_mask [N, L, T_k] and utt_mask [L, T_u]
    or None → the proxy [N] f32, products in ``dtype`` (bfloat16 or
    float16) summed in f32.  CUDA tensors only; two launches on the current
    stream (none for N = 0)."""
    dev = kwd.device
    if dev.type != "cuda":
        raise ValueError(f"maxsim_proxy: the kernel takes CUDA tensors, kwd is on {dev}")
    if dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"maxsim_proxy: the products run in bfloat16 or float16, not {dtype}")
    if kwd.dtype not in DTYPES:
        raise TypeError(f"maxsim_proxy: kwd must be float32, bfloat16 or float16, got {kwd.dtype}")
    if kwd.ndim != 4 or utt_n.ndim != 3 or utt_n.shape[0] != kwd.shape[1] or utt_n.shape[2] != kwd.shape[3]:
        raise ValueError(f"maxsim_proxy: kwd {tuple(kwd.shape)} and utt_n {tuple(utt_n.shape)} do not chain")
    if utt_n.device != dev:
        raise ValueError(f"maxsim_proxy: utt_n is on {utt_n.device}, kwd on {dev}")
    n, layers, t_k, units = kwd.shape
    t_u = utt_n.shape[1]
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    kmask, kmask_type = _mask(kwd_mask, (n, layers, t_k), dev, "kwd_mask")
    umask, umask_type = _mask(utt_mask, (layers, t_u), dev, "utt_mask")
    if n == 0:
        return out
    plan = launch_plan(n, layers, t_k, t_u, units)
    kwd = kwd.contiguous()
    # the utterance in the operand dtype, zero-padded to whole chunks of 64
    utt = torch.nn.functional.pad(utt_n.to(dtype), (0, -units % BK)).contiguous()
    if kwd.data_ptr() % 16 or utt.data_ptr() % 16:
        raise ValueError("maxsim_proxy: kwd and utt_n must be 16-byte aligned")
    best = torch.empty((n, layers, t_k), dtype=torch.float32, device=dev)
    kernel.launch(
        dev, kwd.data_ptr(), DTYPES[kwd.dtype], utt.data_ptr(), DTYPES[dtype],
        None if umask is None else umask.data_ptr(), umask_type,
        None if kmask is None else kmask.data_ptr(), kmask_type,
        best.data_ptr(), out.data_ptr(), n, layers, t_k, t_u, units, plan.bm, plan.stages,
        launches=LAUNCHES_PER_CALL,
    )
    return out
