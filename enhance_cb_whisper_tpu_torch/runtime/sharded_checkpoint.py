"""Sharded checkpoints for the mesh paths on ``torch.distributed.checkpoint``
(port of enhance_cb_whisper_tpu/runtime/sharded_checkpoint.py).

The JAX package writes Orbax checkpoints; the port writes DCP ones, and
neither package reads the other's sharded checkpoints (the card's machine
has neither Orbax nor tensorstore).  The msgpack checkpoints of
:mod:`.checkpoint` stay the format both packages read.

* :func:`save_sharded` — ``state`` is a nested dict of tensors, ``DTensor``
  leaves for sharded arrays (each rank writes only its shards) and plain
  values (ints, floats) that every rank holds alike.  Every rank of the
  process group calls it.
* :func:`restore_sharded` — with ``template`` (a matching dict of tensors
  or ``DTensor``s, any placements: the target layout) the arrays are read
  straight into the template's shards, so a checkpoint saved under one
  layout restores onto another; without one, and in a process without a
  group, every leaf comes back whole.
"""

from __future__ import annotations

import contextlib
import os
import warnings
from typing import Any, Optional

import torch.distributed as dist
import torch.distributed.checkpoint as dcp


def _no_dist() -> bool:
    return not (dist.is_available() and dist.is_initialized())


@contextlib.contextmanager
def _quiet_without_group():
    """DCP warns that a process without a group saves or loads alone: here
    that is the intent."""
    with warnings.catch_warnings():
        if _no_dist():
            warnings.filterwarnings("ignore", message=".*single process", category=UserWarning)
        yield


def save_sharded(path: str, state: Any) -> None:
    """Write ``state`` under the directory ``path`` (made if missing)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    with _quiet_without_group():
        dcp.save(state, checkpoint_id=path, no_dist=_no_dist())


def restore_sharded(path: str, template: Optional[Any] = None) -> Any:
    """Read a :func:`save_sharded` checkpoint: into ``template``'s leaves
    (which it returns), or, without one, as a new dict of whole tensors."""
    path = os.path.abspath(path)
    with _quiet_without_group():
        if template is None:
            from torch.distributed.checkpoint.state_dict_loader import _load_state_dict_from_keys

            return _load_state_dict_from_keys(checkpoint_id=path)
        dcp.load(template, checkpoint_id=path, no_dist=_no_dist())
    return template
