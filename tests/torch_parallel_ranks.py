"""Rank bodies of the port's scale-out tests (``tests/test_torch_parallel_*.py``,
``tests/test_torch_sharded_checkpoint.py``).

Each runs in a rank started by ``enhance_cb_whisper_tpu_torch.parallel.mesh.
launch``, so this module imports torch, numpy and the port only (a rank
never loads JAX).  Each body runs all of one test file's cases in a single
launch and returns plain numpy results; the test file holds them to the JAX
package's single-device results, computed in the test process.
"""

import numpy as np
import torch
import torch.distributed as dist

from enhance_cb_whisper_tpu_torch.parallel import dryrun
from enhance_cb_whisper_tpu_torch.parallel.mesh import make_mesh
from enhance_cb_whisper_tpu_torch.train.kws_train import KWSTrainConfig


def _both(pair):
    ref, got = pair
    return {"ref": ref, "got": got}


def train_cases(cases):
    """``cases``: name -> (KWSTrainConfig kwargs, batch, flax variables,
    ArrayNoise or None, reference).  Every case: one step at data=2 on a
    2 × 2 mesh (each model replica a data-parallel pair) and, with
    ``reference``, one rank's step (on rank 0 alone: the others would
    repeat it)."""
    mesh = make_mesh({"data": 2, "model": 2})
    out = {"rank": dist.get_rank()}
    for name, (kwargs, batch, variables, noise, reference) in cases.items():
        out[name] = _both(dryrun.dp_train_stage(mesh, KWSTrainConfig(**kwargs), batch, variables=variables,
                                                noise=noise, reference=reference and dist.get_rank() == 0))
    return out


def catalog_cases(kws_state, stacks, utt, cascade, encoder, flagship):
    """model=2: the sharded catalog, the sharded cascade, the TP encoder and
    int8 spotting's calibration."""
    mesh = make_mesh({"data": 1, "model": 2})
    return {
        "catalog": _both(dryrun.catalog_stage(mesh, kws_state, stacks, utt)),
        "cascade": _both(dryrun.cascade_stage(mesh, **cascade)),
        "encoder": _both(dryrun.tp_encoder_stage(mesh, *encoder)),
        "int8": _both(dryrun.int8_spotting_stage(mesh, flagship)),
    }


DECODE_CASES = {
    "mesh": dict(reference=False),
    "tp": dict(tp=True, reference=False),
    "packed": dict(packed=True),
    "levers": dict(packed=True, kv_int8=True, xkv_int8=True, lang_detect=True, num_beams=1, kv_staging=4),
}


def decode_cases(inputs):
    """data=2 × model=2: the flagship decode in each of :data:`DECODE_CASES`
    (one rank's decode, where a case takes it, on rank 0 alone)."""
    mesh = make_mesh({"data": 2, "model": 2})
    first = dist.get_rank() == 0
    return {name: _both(dryrun.flagship_longform_stage(
                mesh, inputs, **dict(kwargs, reference=kwargs.get("reference", True) and first)))
            for name, kwargs in DECODE_CASES.items()}


def checkpoint_cases(path, w, b):
    """data=2 × model=2: save a state with ``w`` sharded over both dims,
    restore it onto the same layout and onto ``w`` sharded by rows over
    ``model`` alone; returns each restore's local shard and whole array."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from enhance_cb_whisper_tpu_torch.runtime.sharded_checkpoint import restore_sharded, save_sharded

    mesh = make_mesh({"data": 2, "model": 2})
    w_t = torch.from_numpy(w)
    state = {"params": {"w": distribute_tensor(w_t, mesh, [Shard(0), Shard(1)]),
                        "b": torch.from_numpy(b)},
             "step": 7}
    save_sharded(path, state)

    def restore(placements):
        template = {"params": {"w": distribute_tensor(torch.zeros_like(w_t), mesh, placements),
                               "b": torch.zeros(b.shape)},
                    "step": 0}
        got = restore_sharded(path, template)
        dt = got["params"]["w"]
        return {"local": dt.to_local(), "full": dt.full_tensor(), "placements": repr(dt.placements),
                "b": got["params"]["b"], "step": got["step"]}

    return {"saved_local": state["params"]["w"].to_local(),
            "same": restore([Shard(0), Shard(1)]),
            "relaid": restore([Replicate(), Shard(0)]),
            "coords": [int(c) for c in mesh.get_coordinate()]}


def fail_on_rank_1(mode):
    """Rank 1 raises, dies without a word, or hangs; rank 0 returns."""
    import os
    import time

    if dist.get_rank() == 1:
        if mode == "raise":
            raise ValueError("rank 1 gives up")
        if mode == "die":
            os._exit(3)
        time.sleep(120)
    return dist.get_rank()
