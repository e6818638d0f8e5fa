"""Fused s8×s8→s32 matmul with a requantizing epilogue (port of
enhance_cb_whisper_tpu/ops/matmul_s8.py).

    q = clip(round(relu((x·w)·scale + bias [+ residual·res_scale])), -127, 127)

x [M, K] int8, w [K, N] int8, scale and bias [N] f32 (already divided by
the OUTPUT site's activation scale), residual [M, N] int8 with res_scale
[N] or a scalar f32.  This is the int8 ResNet's 1×1 convolution over
[B·H·W, C] with the whole dequant → bias → residual → ReLU → requant
epilogue fused, so an activation moves 1 B in and 1 B out.

:func:`matmul_s8_requant_plain` is the plain torch version of the CUDA
kernel (``ops/matmul_s8_cuda.py`` / ``csrc/matmul_s8.cu``).  Its
accumulator is exact: an int32 matmul on the CPU; a float64 matmul on the
card (torch has no integer GEMM there), exact because
|acc| ≤ 127²·K < 2⁵³ — float32 or TF32 would not be (127²·2048 > 2²⁴).
The epilogue runs as separate steps in the kernel's order, each rounded to
f32, and ``torch.round`` rounds half to even like ``jnp.round``, so both
versions are bit-exact to the JAX reference.

The dispatching ``matmul_s8_requant`` (the JAX function's signature and
layouts) is the kernel's wrapper, :func:`.matmul_s8_cuda.matmul_s8_requant`,
which takes this plain version only for tensors on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def matmul_s8_requant_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    relu: bool = True,
    residual: Optional[torch.Tensor] = None,
    res_scale: Union[torch.Tensor, float, None] = None,
) -> torch.Tensor:
    """``clip(round(relu((x·w)·scale + bias [+ residual·res_scale])))`` → int8."""
    if x.device.type == "cpu":
        acc = torch.matmul(x.to(torch.int32), w.to(torch.int32))
    else:
        acc = torch.matmul(x.to(torch.float64), w.to(torch.float64))
    y = acc.to(torch.float32) * scale.reshape(1, -1).to(torch.float32)
    y = y + bias.reshape(1, -1).to(torch.float32)
    if residual is not None:
        rs = torch.as_tensor(res_scale, dtype=torch.float32, device=x.device).reshape(1, -1)
        y = y + residual.to(torch.float32) * rs
    if relu:
        y = torch.clamp_min(y, 0.0)
    return torch.clamp(torch.round(y), -127.0, 127.0).to(torch.int8)
