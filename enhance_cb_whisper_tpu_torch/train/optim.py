"""Optimizers and learning-rate schedules (port of
enhance_cb_whisper_tpu/train/optim.py).

* paper 1: Adam with ``betas=(0.9, 0.99)`` and a StepLR schedule
  (``gamma=0.1`` every ``step_size`` epochs): one parameter group normally,
  three (features, classifier, discriminator) under adversarial training,
  each with its own base rate.  The JAX package chains
  ``add_decayed_weights`` *before* Adam, so its weight decay is L2 added to
  the gradient: ``torch.optim.Adam``'s ``weight_decay``;
* paper 2: AdamW over one group, or two ("resnet" and "proj") when the
  model has a projector, with CosineAnnealingLR (``eta_min=1e-6``).  optax's
  ``adamw`` steps a weight by ``-lr·(u + wd·p)``, ``torch.optim.AdamW`` by
  ``p·(1 - lr·wd) - lr·u``: the same update in exact arithmetic, which the
  port takes (the tests hold it to optax at a nonzero decay).

The schedules are per epoch: the trainer writes each group's rate at every
epoch boundary (:func:`set_learning_rate`), where the JAX package writes
optax's injected hyperparameter.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import math
from typing import Callable, Dict, Iterable

import numpy as np
import torch

_libm = None


def _cosf(x: float) -> float:
    """The C library's single-precision cosine, the function XLA's CPU
    backend calls for a float32 ``cos``."""
    global _libm
    if _libm is None:
        lib = ctypes.CDLL(ctypes.util.find_library("m"))
        lib.cosf.restype, lib.cosf.argtypes = ctypes.c_float, [ctypes.c_float]
        _libm = lib
    return _libm.cosf(x)


def step_lr(base_lr: float, step_size: int, gamma: float = 0.1) -> Callable[[int], float]:
    """``torch.optim.lr_scheduler.StepLR`` over the epoch index."""

    def schedule(epoch: int) -> float:
        return base_lr * gamma ** (epoch // step_size)

    return schedule


def cosine_lr(base_lr: float, t_max: int, eta_min: float = 1e-6) -> Callable[[int], float]:
    """``torch.optim.lr_scheduler.CosineAnnealingLR`` in closed form over the
    epoch index, rounded op by op to float32 as the JAX package evaluates
    it (its rate is a float32 array), so both packages step at the same
    rate."""
    f = np.float32
    half_span = f((base_lr - eta_min) * 0.5)

    def schedule(epoch: int) -> float:
        x = f(f(math.pi) * f(min(epoch, t_max))) / f(t_max)
        return float(f(eta_min) + half_span * (f(1.0) + f(_cosf(float(x)))))

    return schedule


def make_adam(groups: Dict[str, Iterable[torch.nn.Parameter]], learning_rates: Dict[str, float],
              beta_1: float = 0.9, beta_2: float = 0.99, weight_decay: float = 0.0,
              adamw: bool = False) -> torch.optim.Optimizer:
    """Adam (or, with ``adamw``, AdamW: decoupled weight decay) over named
    parameter groups (``{"features": params, ...}``), each starting at its
    ``learning_rates[name]``."""
    param_groups = [{"params": list(params), "lr": learning_rates[name], "name": name}
                    for name, params in groups.items()]
    cls = torch.optim.AdamW if adamw else torch.optim.Adam
    return cls(param_groups, betas=(beta_1, beta_2), eps=1e-8, weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, name: str, learning_rate: float) -> None:
    """Write the rate of the parameter group called ``name``."""
    for group in optimizer.param_groups:
        if group["name"] == name:
            group["lr"] = learning_rate
            return
    raise KeyError(f"the optimizer has no parameter group {name!r}")
