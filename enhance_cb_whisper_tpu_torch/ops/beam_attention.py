"""Beam-search self-attention through an ancestry map: kernel K4
(``csrc/beam_attention.cu``), its wrapper and its plain version.

A beam step's self-attention reads the cache where each logical beam
appended its tokens: ``anc[b, k, t]`` names the physical beam row of item
``b`` that holds logical beam ``k``'s token at position ``t``
(``decoding/beam.py`` keeps the map; the JAX package's ``anc`` layout).
The rows are never reordered, so the beam step copies no cache.

:func:`ancestry_attention` takes CPU tensors to :func:`ancestry_attention_plain`
(the rows gathered by the map, then ``models/whisper.py:_attention``) and
CUDA tensors to K4 (:func:`ancestry_attention_cuda`), which raises on what
it does not take.  K4 replaces no TPU kernel (the JAX package's
``_ancestry_attention`` is left to XLA); the source's note says what bounds
it.
"""

from __future__ import annotations

from ctypes import c_int, c_longlong, c_void_p
from typing import Optional

import torch

from ..build import NativeLibrary

MAX_HEAD_DIM = 64  # every Whisper's head size is 64
MAX_BEAMS = 32767  # a 16-bit map entry in shared memory, its top bit the mask's
MAX_LEN = 448  # Whisper's max_target_positions
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MASK_DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int32, torch.int64)

kernel = NativeLibrary("beam_attention.cu", "ecw_beam_attention",
                       [c_void_p] * 5 + [c_int, c_longlong, c_void_p] + [c_int] * 8 + [c_void_p],
                       name="beam attention")


def ancestry_attention(q: torch.Tensor, k_slab: torch.Tensor, v_slab: torch.Tensor, anc: torch.Tensor,
                       attention_mask: Optional[torch.Tensor], length: int) -> torch.Tensor:
    """One decode step's self-attention of every beam row.

    q [B·K, 1, H, Dh] (already scaled); k_slab, v_slab [B·K, max_len, H, Dh],
    this step's K/V already written at ``length - 1``; anc [B, K, >= length]
    int32, item-local physical beam indices; attention_mask [B·K, >= length]
    (nonzero = attend) or None.  Attends positions ``[0, length)``.
    Returns [B·K, 1, H, Dh] in q's dtype: the plain version on the CPU, K4
    on the card."""
    if q.device.type == "cpu":
        return ancestry_attention_plain(q, k_slab, v_slab, anc, attention_mask, length)
    return ancestry_attention_cuda(q, k_slab, v_slab, anc, attention_mask, length)


def gather_rows(slab: torch.Tensor, anc: torch.Tensor, length: int) -> torch.Tensor:
    """[B·K, length, H, Dh]: each logical beam's prefix, its position ``t``
    taken from the physical row ``anc[b, k, t]`` of its item."""
    batch, beams = anc.shape[:2]
    items = torch.arange(batch, device=anc.device)[:, None, None] * beams
    rows = (items + anc[:, :, :length].long()).reshape(batch * beams, length)
    return slab[rows, torch.arange(length, device=anc.device)]


def ancestry_attention_plain(q: torch.Tensor, k_slab: torch.Tensor, v_slab: torch.Tensor, anc: torch.Tensor,
                             attention_mask: Optional[torch.Tensor], length: int) -> torch.Tensor:
    """:func:`ancestry_attention` in torch: the rows gathered by the map,
    then the decoder's own attention, so its result is bit for bit that of
    a cache reordered in place."""
    from ..models.whisper import _attention

    mask = None if attention_mask is None else attention_mask[:, None, None, :length].bool()
    return _attention(q, gather_rows(k_slab, anc, length), gather_rows(v_slab, anc, length), mask)


def _check(q, k_slab, v_slab, anc, attention_mask, length) -> None:
    """Raise on what K4 does not take."""
    if q.dtype not in DTYPES:
        raise TypeError(f"ancestry_attention: q must be float32 or bfloat16, got {q.dtype}")
    if k_slab.dtype != q.dtype or v_slab.dtype != q.dtype:
        raise TypeError(f"ancestry_attention: the slabs ({k_slab.dtype}, {v_slab.dtype}) must be in q's "
                        f"dtype {q.dtype}")
    if anc.dtype != torch.int32:
        raise TypeError(f"ancestry_attention: anc must be int32, got {anc.dtype}")
    if attention_mask is not None and attention_mask.dtype not in MASK_DTYPES:
        raise TypeError(f"ancestry_attention: attention_mask must be bool or integer, got {attention_mask.dtype}")
    if q.ndim != 4 or q.shape[1] != 1 or not (q.shape[3] <= 32 or q.shape[3] % 2 == 0 and q.shape[3] <= MAX_HEAD_DIM):
        raise ValueError(f"ancestry_attention: q must be [B·K, 1, H, Dh] with Dh <= 32 or even and <= "
                         f"{MAX_HEAD_DIM}, got {tuple(q.shape)}")
    rows, _, heads, head_dim = q.shape
    if k_slab.ndim != 4 or k_slab.shape != v_slab.shape or k_slab.shape[0] != rows \
            or tuple(k_slab.shape[2:]) != (heads, head_dim):
        raise ValueError(f"ancestry_attention: slabs {tuple(k_slab.shape)}, {tuple(v_slab.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if anc.ndim != 3 or anc.shape[0] * anc.shape[1] != rows or not 1 <= anc.shape[1] <= MAX_BEAMS:
        raise ValueError(f"ancestry_attention: anc must be [B, K <= {MAX_BEAMS}, T] with B·K = {rows}, "
                         f"got {tuple(anc.shape)}")
    if not 1 <= length <= min(k_slab.shape[1], anc.shape[2], MAX_LEN):
        raise ValueError(f"ancestry_attention: length {length} outside [1, {min(k_slab.shape[1], anc.shape[2], MAX_LEN)}]")
    if attention_mask is not None and (attention_mask.ndim != 2 or attention_mask.shape[0] != rows
                                       or attention_mask.shape[1] < length or attention_mask.stride(1) != 1):
        raise ValueError(f"ancestry_attention: attention_mask must be [{rows}, >= {length}] with unit column "
                         f"stride, got {tuple(attention_mask.shape)}")
    for name, t in (("q", q), ("k_slab", k_slab), ("v_slab", v_slab), ("anc", anc)):
        if not t.is_contiguous():
            raise ValueError(f"ancestry_attention: {name} must be contiguous")
    for name, t in (("k_slab", k_slab), ("v_slab", v_slab), ("anc", anc), ("attention_mask", attention_mask)):
        if t is not None and t.device != q.device:
            raise ValueError(f"ancestry_attention: {name} is on {t.device}, q on {q.device}")


def ancestry_attention_cuda(q: torch.Tensor, k_slab: torch.Tensor, v_slab: torch.Tensor, anc: torch.Tensor,
                            attention_mask: Optional[torch.Tensor], length: int) -> torch.Tensor:
    """K4: :func:`ancestry_attention` in one launch on the current stream.
    Takes f32 or bf16 with Dh <= 32 or even and <= 64, at most ``MAX_BEAMS``
    beams and 448 positions, contiguous q, slabs and map; raises on anything else."""
    _check(q, k_slab, v_slab, anc, attention_mask, length)
    if q.device.type != "cuda":
        raise ValueError(f"ancestry_attention: the kernel takes CUDA tensors, q is on {q.device}")
    out = torch.empty_like(q)
    heads, head_dim = q.shape[2:]
    batch, beams = anc.shape[:2]
    mask = attention_mask
    if mask is not None and mask.dtype == torch.bool:
        mask = mask.view(torch.uint8)
    kernel.launch(
        q.device, q.data_ptr(), k_slab.data_ptr(), v_slab.data_ptr(), anc.data_ptr(),
        None if mask is None else mask.data_ptr(), 0 if mask is None else mask.element_size(),
        0 if mask is None else mask.stride(0), out.data_ptr(), DTYPES[q.dtype],
        batch, beams, heads, head_dim, k_slab.shape[1], anc.shape[2], int(length),
    )
    return out
