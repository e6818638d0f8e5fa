"""Paper-1 optimizer and learning-rate schedule (port of the paper-1 half of
enhance_cb_whisper_tpu/train/optim.py).

Adam with ``betas=(0.9, 0.99)`` and a StepLR schedule (``gamma=0.1`` every
``step_size`` epochs): one parameter group normally, three (features,
classifier, discriminator) under adversarial training, each with its own
base rate.  The JAX package chains ``add_decayed_weights`` *before* Adam, so
its weight decay is L2 added to the gradient: ``torch.optim.Adam``'s
``weight_decay``, not AdamW's.  The schedule is per epoch: the trainer
writes each group's rate at every epoch boundary
(:func:`set_learning_rate`), where the JAX package writes optax's
injected hyperparameter.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

import torch


def step_lr(base_lr: float, step_size: int, gamma: float = 0.1) -> Callable[[int], float]:
    """``torch.optim.lr_scheduler.StepLR`` over the epoch index."""

    def schedule(epoch: int) -> float:
        return base_lr * gamma ** (epoch // step_size)

    return schedule


def make_adam(groups: Dict[str, Iterable[torch.nn.Parameter]], learning_rates: Dict[str, float],
              beta_1: float = 0.9, beta_2: float = 0.99, weight_decay: float = 0.0) -> torch.optim.Adam:
    """Adam over named parameter groups (``{"features": params, ...}``),
    each starting at its ``learning_rates[name]``."""
    param_groups = [{"params": list(params), "lr": learning_rates[name], "name": name}
                    for name, params in groups.items()]
    return torch.optim.Adam(param_groups, betas=(beta_1, beta_2), eps=1e-8,
                            weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, name: str, learning_rate: float) -> None:
    """Write the rate of the parameter group called ``name``."""
    for group in optimizer.param_groups:
        if group["name"] == name:
            group["lr"] = learning_rate
            return
    raise KeyError(f"the optimizer has no parameter group {name!r}")
