"""Scale-out on ``torch.distributed``: the (``data``, ``model``) mesh, the
data-parallel train step, model-sharded catalogs and tensor-parallel
Whisper (port of enhance_cb_whisper_tpu/parallel)."""

from .mesh import gather_rows, launch, make_mesh, replicate, shard_batch
from .sharding import make_sharded_train_step, shard_catalog, whisper_param_sharding

__all__ = ["gather_rows", "launch", "make_mesh", "replicate", "shard_batch",
           "make_sharded_train_step", "shard_catalog", "whisper_param_sharding"]
