"""Checkpoint directories in the JAX package's format, best-by-metric
checkpoints and early stopping (port of
enhance_cb_whisper_tpu/runtime/checkpoint.py).

A checkpoint is ``<dir>/state.msgpack`` (flax's msgpack serialization of
the state tree) + ``meta.json`` (hyperparameters, monitored values, epoch).
The tree is written and read here with the ``msgpack`` package alone,
without flax: flax writes each array as an extension record (code 1: an
ndarray; code 3: a numpy scalar) whose payload is itself msgpack
``(shape, dtype name, C-order bytes)``, dict keys as strings, and splits
arrays over 2**30 bytes into ``__msgpack_chunked_array__`` dicts (read
here; the port writes no array that large).  Leaves come back as numpy
arrays (bfloat16 ones upcast to float32, numpy having no bfloat16).

:class:`CheckpointManager` keeps one checkpoint per monitor (the best
value so far) and ``final``, written every epoch; :class:`EarlyStopping`
stops on one monitored metric.  Both are copies of the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_MAX_ARRAY_BYTES = 2**30


def _msgpack(path: str):
    try:
        import msgpack
    except ImportError as err:
        raise ImportError(
            f"the checkpoint directory {path} (state.msgpack) needs the msgpack "
            "package, which is not installed"
        ) from err
    return msgpack


def _ndarray_from_bytes(msgpack, data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        import torch

        flat = torch.frombuffer(bytearray(buffer), dtype=torch.bfloat16).to(torch.float32)
        return flat.numpy().reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode()), count=-1).reshape(shape, order="C")


def _unchunk(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def _ndarray_to_bytes(msgpack, arr: np.ndarray) -> bytes:
    if arr.nbytes > _MAX_ARRAY_BYTES:
        raise ValueError(f"an array of {arr.nbytes} bytes is over the 2**30 a record holds")
    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")), use_bin_type=True)


def _to_state(tree):
    """The state as flax serializes it: dicts with string keys, numpy
    arrays (tensors moved to the host), Python scalars as they are."""
    if isinstance(tree, dict):
        return {str(k): _to_state(v) for k, v in tree.items()}
    if hasattr(tree, "detach"):  # a torch tensor
        tree = tree.detach().cpu().numpy()
    return tree


def _to_jsonable(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _to_jsonable(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    return obj


def save_checkpoint(path: str, state: Dict[str, Any], meta: Optional[dict] = None) -> None:
    """Write ``state`` (nested dicts of arrays, tensors and Python scalars)
    as ``<path>/state.msgpack`` in flax's format, and ``meta`` as JSON."""
    msgpack = _msgpack(path)

    def ext(x):
        if isinstance(x, np.ndarray):
            return msgpack.ExtType(_EXT_NDARRAY, _ndarray_to_bytes(msgpack, x))
        if isinstance(x, np.generic):
            return msgpack.ExtType(_EXT_NPSCALAR, _ndarray_to_bytes(msgpack, np.asarray(x)))
        raise TypeError(f"cannot serialize {type(x).__name__} into a checkpoint")

    os.makedirs(path, exist_ok=True)
    data = msgpack.packb(_to_state(state), default=ext, strict_types=True, use_bin_type=True)
    with open(os.path.join(path, "state.msgpack"), "wb") as f:
        f.write(data)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(_to_jsonable(meta or {}), f, indent=2)


def _restore(template, state, where: str):
    """``state`` checked against ``template``: the same dict keys all the
    way down, arrays of the template's shapes (cast to its dtypes),
    Python scalars of its types."""
    if isinstance(template, dict):
        if not isinstance(state, dict) or set(state) != set(map(str, template)):
            got = sorted(state) if isinstance(state, dict) else type(state).__name__
            raise ValueError(f"checkpoint {where or 'state'}: keys {got}, expected "
                             f"{sorted(map(str, template))}")
        return {k: _restore(v, state[str(k)], f"{where}/{k}") for k, v in template.items()}
    if isinstance(template, (np.ndarray, np.generic)):
        arr = np.asarray(state)
        if arr.shape != template.shape:
            raise ValueError(f"checkpoint {where}: shape {arr.shape}, expected {template.shape}")
        return arr.astype(template.dtype, copy=False)
    return type(template)(state)


def load_checkpoint(path: str, template: Optional[Dict[str, Any]] = None) -> Tuple[Dict[str, Any], dict]:
    """(state, meta) of a checkpoint directory: the state as nested dicts of
    numpy arrays; with a ``template`` (nested dicts of numpy arrays and
    Python scalars) the state must have its structure and shapes, and comes
    back cast to its dtypes."""
    msgpack = _msgpack(path)

    def ext_hook(code, data):
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(msgpack, data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(msgpack, data)[()]
        return msgpack.ExtType(code, data)

    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        state = _unchunk(msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False))
    if template is not None:
        state = _restore(template, state, "")
    meta_path = os.path.join(path, "meta.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state, meta


class CheckpointManager:
    """monitor -> best checkpoint; 'final' saved unconditionally."""

    def __init__(self, directory: str, monitors: Dict[str, str], hparams: Optional[dict] = None):
        """``monitors``: name -> "metric_key:max" or "metric_key:min"."""
        self.directory = directory
        self.monitors = {}
        for name, spec in monitors.items():
            key, _, mode = spec.partition(":")
            self.monitors[name] = (key, mode or "max")
        self.best: Dict[str, float] = {}
        self.hparams = hparams or {}
        os.makedirs(directory, exist_ok=True)

    def restore_best(self) -> Dict[str, float]:
        """Seed ``best`` from the monitor checkpoints already on disk (a
        resume restores them: without this, the first validation after it
        always "improves" and can overwrite a better best checkpoint)."""
        for name in self.monitors:
            meta_path = os.path.join(self.directory, name, "meta.json")
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    meta = json.load(f)
                if "value" in meta:
                    self.best[name] = float(meta["value"])
        return dict(self.best)

    def step(self, epoch: int, metrics: Dict[str, float], state: Dict[str, Any]) -> list:
        """Save improved monitors + 'final'; returns the saved paths (fed to
        ``MetricsLogger.log_artifact`` when log_model is enabled)."""
        saved = []
        for name, (key, mode) in self.monitors.items():
            if key not in metrics:
                continue
            value = float(metrics[key])
            best = self.best.get(name)
            improved = best is None or (value > best if mode == "max" else value < best)
            if improved:
                self.best[name] = value
                path = os.path.join(self.directory, name)
                save_checkpoint(
                    path, state,
                    {"epoch": epoch, "monitor": key, "value": value, "hparams": self.hparams},
                )
                saved.append(path)
        final = os.path.join(self.directory, "final")
        save_checkpoint(
            final, state,
            {"epoch": epoch, "metrics": _to_jsonable(metrics), "hparams": self.hparams},
        )
        saved.append(final)
        return saved


class EarlyStopping:
    """Lightning-equivalent early stopping on one monitored metric."""

    def __init__(self, monitor: str, patience: int = 10, mode: str = "max",
                 min_delta: float = 0.0):
        self.monitor = monitor
        self.patience = patience
        self.mode = mode
        self.min_delta = min_delta
        self.best: Optional[float] = None
        self.count = 0

    def step(self, metrics: Dict[str, float]) -> bool:
        """Returns True when training should stop."""
        if self.monitor not in metrics:
            return False
        value = float(metrics[self.monitor])
        improved = self.best is None or (
            value > self.best + self.min_delta
            if self.mode == "max"
            else value < self.best - self.min_delta
        )
        if improved:
            self.best = value
            self.count = 0
        else:
            self.count += 1
        return self.count >= self.patience
