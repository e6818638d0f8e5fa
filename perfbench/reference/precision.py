"""The reference's arithmetic, in the precision it is asked for.

``Prec("fp32")`` is full float32: products and convolutions in FP32 with
TF32 off on the card.  The controls round every operand of every product
and convolution first, then compute in float32, as the lower-precision
hardware path does:

* ``"tf32"``: each operand rounded to TF32's 10-bit mantissa (round to
  nearest), what a TF32 tensor-core product reads;
* ``"fp8"``: each operand scaled per tensor to its largest magnitude,
  rounded to float8 e4m3 and scaled back (the usual fp8 recipe).

Rounding the operands explicitly makes a control the same on every device,
the CPU included.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) with its mantissa rounded to 10 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) through e4m3 with a per-tensor scale."""
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Prec:
    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def r(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        if self.mode == "tf32":
            return round_tf32(x)
        if self.mode == "fp8":
            return round_fp8(x)
        return x

    def matmul(self, a, b):
        return torch.matmul(self.r(a), self.r(b))

    def einsum(self, eq, *xs):
        return torch.einsum(eq, *[self.r(x) for x in xs])

    def linear(self, x, w, b=None):
        y = torch.matmul(self.r(x), self.r(w).t())
        return y if b is None else y + b

    def conv1d(self, x, w, b=None, stride=1, padding=0):
        return F.conv1d(self.r(x), self.r(w), b, stride=stride, padding=padding)

    def conv2d(self, x, w, stride=1, padding=0):
        return F.conv2d(self.r(x), self.r(w), None, stride=stride, padding=padding)


def full_fp32() -> None:
    """TF32 and reduced-precision reductions off for this process's cuBLAS
    and cuDNN calls (the card's defaults allow TF32 in convolutions)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
