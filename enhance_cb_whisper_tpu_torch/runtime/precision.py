"""Full-FP32 matmuls and convolutions on the card, and f32 accumulation in
bf16 ones.

The JAX package runs its parity-critical products at
``precision="highest"``.  PyTorch lets cuDNN convolutions take TF32 by
default (``torch.backends.cudnn.allow_tf32`` is ``True``), which would put
the fp32 scorer's ResNet convolutions about 1e-3 away from the reference.
It also lets cuBLAS reduce split-K partial sums of bf16 GEMMs in bf16
(``allow_bf16_reduced_precision_reduction`` is ``True``), where XLA
accumulates in f32.  :func:`reference_precision` turns all three off; the
entry points that run on the card (``CBWhisper``, ``WhisperGenerator``,
``KWSEngine``, ``EfficientKWSEngine`` and the paper-2 catalog scorers)
call it when their device is CUDA.  The flags are global to
the process and stay off: nothing restores them.
"""

from __future__ import annotations

import torch


def reference_precision() -> None:
    """Disallow TF32 in cuBLAS matmuls and cuDNN convolutions, and bf16
    partial sums in cuBLAS bf16 matmuls."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
