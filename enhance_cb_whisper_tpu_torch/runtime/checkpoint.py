"""Read-only loader for the JAX package's checkpoint directories (port of
``load_checkpoint`` in enhance_cb_whisper_tpu/runtime/checkpoint.py).

A checkpoint is ``<dir>/state.msgpack`` (flax's msgpack serialization of
the state tree) + ``meta.json``.  The tree is decoded here with the
``msgpack`` package alone, without flax: flax writes each array as an
extension record (code 1: an ndarray; code 3: a numpy scalar) whose payload
is itself msgpack ``(shape, dtype name, C-order bytes)``, and splits arrays
over 2**30 bytes into ``__msgpack_chunked_array__`` dicts.  Leaves come back
as numpy arrays (bfloat16 ones upcast to float32, numpy having no bfloat16).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


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


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], dict]:
    """(state, meta) of a checkpoint directory: the state as nested dicts of
    numpy arrays."""
    try:
        import msgpack
    except ImportError as err:
        raise ImportError(
            f"reading the checkpoint directory {path} (state.msgpack) needs the msgpack "
            "package, which is not installed"
        ) from err

    def ext_hook(code, data):
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(msgpack, data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(msgpack, data)[()]
        return msgpack.ExtType(code, data)

    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        state = _unchunk(msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False))
    meta_path = os.path.join(path, "meta.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state, meta
