"""Weight conversion from the JAX package's layouts to this port's.

* :func:`from_jax_whisper_params` — the JAX Whisper pytree (plain dicts,
  HF names, linear kernels ``[in, out]``, conv kernels ``[W, C_in, C_out]``
  for ``NWC`` convs; layers either a list or stacked ``[L, ...]`` arrays for
  ``lax.scan``) → the nested torch dict of :mod:`.models.whisper`
  (``nn.Linear``/``F.conv1d`` layouts, layers as a list).  The JAX
  package's quantized trees convert too: int8 ``qweight`` codes (a linear's
  transposed to ``[out, in]``) with their ``scale``, the vocab's
  ``embed_tokens_q``, and the s8 encoder's ``act_scales`` (one 0-d tensor
  per site and layer).
* :func:`from_flax_resnet_variables` — flax ``KWSModel`` variables
  (``params`` + ``batch_stats``; NHWC convs with ``[kh, kw, in, out]``
  kernels) → a ``state_dict`` for :class:`.models.kws.KWSModel` (NCHW,
  ``[out, in, kh, kw]``); the same for a flax ``Discriminator``'s params
  (``head.linear`` or ``head.dense_0..2``) and
  :class:`.models.kws.Discriminator`;
* :func:`from_flax_efficient_variables` — flax ``EfficientKWSModel``
  variables (paper 2: the bare ``model`` ResNet, the sibling
  ``classifier``, the ``projector`` Dense pairs and the ``time_projector``
  NWC Conv1d kernels ``[k, in, out]`` with their BatchNorms) → a
  ``state_dict`` for :class:`.efficient_kws.model.EfficientKWSModel`
  (Conv1d ``[out, in, k]``);
* :func:`to_flax_variables` — the inverse of both: a ``state_dict`` →
  flax-layout ``params`` + ``batch_stats`` trees of numpy arrays, which the
  checkpoints hold, so the JAX package reads them.
* :func:`from_jax_quantized_params` — the JAX int8 ResNet pytree
  (``models/quant.py``: per conv ``wq`` int8 ``[kh, kw, in, out]``, ``s_w``
  and ``b`` f32 ``[out]``; the head's ``kernel``/``bias``; optional
  ``act_scales``) → the same tree on ``device`` with ``wq`` as
  ``[out, in, kh, kw]``.

Inputs are numpy arrays (or anything ``np.asarray`` accepts).  The
functions that place tensors put them on the card unless the caller asks
for another device.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Optional

import numpy as np
import torch

_LINEARS = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")
_CONVS = ("conv1", "conv2")


def _unstack(layers: Any) -> list:
    """Stacked scan layout (dict of [L, ...] arrays) → list of layer dicts."""
    if isinstance(layers, list):
        return layers

    def first_leaf(tree):
        return first_leaf(next(iter(tree.values()))) if isinstance(tree, dict) else tree

    def take(tree, i):
        if isinstance(tree, dict):
            return {k: take(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    n = np.asarray(first_leaf(layers)).shape[0]
    return [take(layers, i) for i in range(n)]


def _convert_tree(tree: Any, name: Optional[str], device) -> Any:
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            if key == "weight" and not isinstance(value, dict):
                arr = np.asarray(value, dtype=np.float32)
                if name in _LINEARS:
                    arr = arr.T  # [in, out] → [out, in]
                elif name in _CONVS:
                    arr = arr.transpose(2, 1, 0)  # [W, C_in, C_out] → [C_out, C_in, W]
                out[key] = torch.tensor(arr, device=device)
            elif key == "qweight":
                # int8 codes stay int8; a linear's [in, out] → [out, in]
                # (the vocab table's [vocab, d_model] is already the port's)
                arr = np.asarray(value, dtype=np.int8)
                out[key] = torch.tensor(np.ascontiguousarray(arr.T if name in _LINEARS else arr), device=device)
            elif key == "layers":
                out[key] = [_convert_tree(layer, None, device) for layer in _unstack(value)]
            else:
                out[key] = _convert_tree(value, key, device)
        return out
    return torch.tensor(np.asarray(tree, dtype=np.float32), device=device)


def from_jax_whisper_params(params: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """JAX Whisper params (stacked or unstacked) → torch params on ``device``."""
    return {side: _convert_tree(params[side], side, device) for side in ("encoder", "decoder")}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(value, Mapping):  # dict or flax FrozenDict
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value, dtype=np.float32)
    return flat


def from_flax_resnet_variables(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``KWSModel`` variables → ``KWSModel.state_dict()`` entries (or a
    flax ``Discriminator``'s ``{"params": ...}`` → ``Discriminator``'s).

    Module names match one to one (``model.feature_extractor.embedder.
    convolution``, ``...stage_0_block_0.layer_1.normalization``,
    ``model.classifier``, ``head.dense_0``); only the leaf names and
    layouts change."""
    state: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(variables["params"]).items():
        module, leaf = path.rsplit(".", 1)
        if leaf == "kernel" and arr.ndim == 4:
            state[f"{module}.weight"] = torch.tensor(arr.transpose(3, 2, 0, 1))
        elif leaf == "kernel" and arr.ndim == 3:  # NWC Conv1d [k, in, out]
            state[f"{module}.weight"] = torch.tensor(arr.transpose(2, 1, 0))
        elif leaf == "kernel" and arr.ndim == 2:
            state[f"{module}.weight"] = torch.tensor(arr.T)
        elif leaf == "scale":
            state[f"{module}.weight"] = torch.tensor(arr)
        elif leaf == "bias":
            state[f"{module}.bias"] = torch.tensor(arr)
        else:
            raise ValueError(f"unexpected flax parameter {path}")
    for path, arr in _flatten(variables.get("batch_stats", {})).items():
        module, leaf = path.rsplit(".", 1)
        names = {"mean": "running_mean", "var": "running_var"}
        if leaf not in names:
            raise ValueError(f"unexpected flax batch statistic {path}")
        state[f"{module}.{names[leaf]}"] = torch.tensor(arr)
    return state


def flax_entry(key: str, tensor: torch.Tensor):
    """One ``state_dict`` entry in the flax layout: ``(collection, path,
    array)`` with ``collection`` "params" or "batch_stats", or None for
    ``num_batches_tracked``.  Kernels are transposed to flax's
    ``[kh, kw, in, out]``, ``[k, in, out]`` or ``[in, out]``.  The array is
    a copy: a later training step does not change it."""
    *path, leaf = key.split(".")
    if leaf == "num_batches_tracked":
        return None
    a = tensor.detach().to(torch.float32, copy=True).cpu().numpy()
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", path + [leaf[len("running_"):]], a
    if leaf == "bias":
        return "params", path + ["bias"], a
    if a.ndim == 4:
        return "params", path + ["kernel"], a.transpose(2, 3, 1, 0)
    if a.ndim == 3:
        return "params", path + ["kernel"], a.transpose(2, 1, 0)
    if a.ndim == 2:
        return "params", path + ["kernel"], a.T
    return "params", path + ["scale"], a


def from_flax_efficient_variables(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``EfficientKWSModel`` variables → ``EfficientKWSModel.state_dict()``
    entries: the module names match one to one (``model.stage_0_block_0.
    layer_1.normalization``, ``classifier``, ``projector.proj_0_1``,
    ``time_projector.conv_0``, ``time_projector.bn_0``), so this is
    :func:`from_flax_resnet_variables` under the name paper 2's callers
    look for; a paper-2 leaf it could not place would be added here."""
    return from_flax_resnet_variables(variables)


def to_flax_variables(state: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, Any]]:
    """A ``state_dict`` of ``KWSModel``, ``Discriminator`` or
    ``EfficientKWSModel`` → flax ``{"params": ..., "batch_stats": ...}``
    nested dicts of f32 numpy arrays (the inverse of
    :func:`from_flax_resnet_variables` and
    :func:`from_flax_efficient_variables`)."""
    trees: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for key, t in state.items():
        entry = flax_entry(key, t)
        if entry is None:
            continue
        collection, path, a = entry
        node = trees[collection]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return trees


def from_jax_quantized_params(qparams: Mapping, device="cuda") -> Dict[str, Any]:
    """JAX int8 ResNet pytree → the port's (:mod:`.models.quant`) on ``device``."""
    out: Dict[str, Any] = {}
    for key, value in qparams.items():
        if key == "act_scales":
            out[key] = {site: float(s) for site, s in value.items()}
        elif key == "classifier":
            out[key] = {k: torch.tensor(np.asarray(v, np.float32), device=device)
                        for k, v in value.items()}
        elif "wq" in value:
            wq = np.asarray(value["wq"], np.int8).transpose(3, 2, 0, 1)
            out[key] = {
                "wq": torch.from_numpy(np.ascontiguousarray(wq)).to(device),
                "s_w": torch.tensor(np.asarray(value["s_w"], np.float32), device=device),
                "b": torch.tensor(np.asarray(value["b"], np.float32), device=device),
            }
        else:
            out[key] = from_jax_quantized_params(value, device)
    return out
