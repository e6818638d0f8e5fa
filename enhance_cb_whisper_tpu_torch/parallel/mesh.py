"""The (``data``, ``model``) device mesh on ``torch.distributed`` (port of
enhance_cb_whisper_tpu/parallel/mesh.py).

The JAX package places arrays on a ``jax.sharding.Mesh`` and lets XLA's
partitioner insert the collectives.  Here every rank is a process:

* :func:`make_mesh` — a ``DeviceMesh`` with the dims ``data`` (the batch:
  data parallelism) and ``model`` (keyword-catalog rows and, optionally,
  the Whisper heads and MLP hidden units) over the initialised process
  group;
* :func:`shard_batch` — this rank's rows of every leading dim, by its
  ``data`` coordinate;
* :func:`replicate` — rank 0's values on every rank (a broadcast);
* :func:`gather_rows` — the rows every rank of a group holds, concatenated
  in rank order (an all-gather of blocks of any length);
* :func:`launch` — ``n`` ranks in processes forked from a fork server
  (a fresh interpreter that imported torch once), each with one thread and
  a ``FileStore`` rendezvous under a temporary directory (no TCP port, so
  concurrent launches never collide); any rank's exception, death or
  timeout fails the launch;
* :func:`shutdown` — stops the fork server and its resource tracker and
  waits for them; it runs at interpreter exit once a launch has started
  them, so a program that launched ranks leaves no process behind.

Collectives run where their tensors lie.  NCCL refuses two ranks on one
GPU, so several ranks on the one card run gloo, which reduces and
broadcasts CUDA tensors but gathers only host tensors: :func:`gather_rows`
stages a CUDA gather over gloo through pinned host memory.
"""

from __future__ import annotations

import atexit
import datetime
import multiprocessing.forkserver
import multiprocessing.resource_tracker
import os
import queue as queue_module
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..runtime.precision import reference_precision

# the device of this process's rank, set by :func:`launch`
_RANK_DEVICE: Optional[torch.device] = None
# whether :func:`shutdown` is registered to run at exit
_SHUTDOWN_AT_EXIT = False


def rank_device() -> torch.device:
    """This rank's device: the one :func:`launch` gave it, else the current
    CUDA device when there is one, else the CPU."""
    if _RANK_DEVICE is not None:
        return _RANK_DEVICE
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(shape: Optional[Dict[str, int]] = None, device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh over the initialised process group; default: every rank on
    ``data``.  ``shape`` maps dim names to sizes in order (``{"data": d,
    "model": m}``), their product the world size.  Ranks are laid out
    row-major: the ranks of one ``model`` group are adjacent."""
    world = dist.get_world_size()
    if shape is None:
        shape = {"data": world, "model": 1}
    sizes = tuple(int(s) for s in shape.values())
    assert int(np.prod(sizes)) == world, f"mesh {shape} does not match {world} ranks"
    return init_device_mesh(device_type or rank_device().type, sizes, mesh_dim_names=tuple(shape))


def dim_size(mesh: DeviceMesh, dim: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(dim)) if dim in mesh.mesh_dim_names else 1


def dim_rank(mesh: DeviceMesh, dim: str) -> int:
    return mesh.get_local_rank(dim) if dim in mesh.mesh_dim_names else 0


def shard_batch(batch, mesh: DeviceMesh, axis: str = "data"):
    """This rank's contiguous block of the leading dim of every array or
    tensor in ``batch`` (a dict, list, tuple or leaf), by its coordinate on
    ``axis``; the leading dim must divide by the axis size."""
    n, r = dim_size(mesh, axis), dim_rank(mesh, axis)

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(take(v) for v in x)
        assert x.shape[0] % n == 0, f"leading dim {x.shape[0]} does not divide over {axis}={n}"
        block = x.shape[0] // n
        return x[r * block:(r + 1) * block]

    return take(batch)


def replicate(tree, mesh: DeviceMesh):
    """Every tensor of ``tree`` broadcast from the mesh's first rank, in
    place, on every rank; returns ``tree``."""
    src = int(mesh.mesh.flatten()[0])

    def bcast(x):
        if isinstance(x, dict):
            for v in x.values():
                bcast(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                bcast(v)
        elif isinstance(x, torch.Tensor):
            dist.broadcast(x, src=src)

    bcast(tree)
    return tree


def gather_rows(x: torch.Tensor, group, lengths: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The blocks of rows that the ranks of ``group`` hold, concatenated in
    group-rank order, on every rank.  ``lengths`` (each rank's row count,
    known to all) allows blocks of different lengths; without it every
    block has ``x``'s length.  A CUDA tensor under gloo goes through pinned
    host memory: gloo gathers host tensors only."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    lengths = [x.shape[0]] * n if lengths is None else [int(v) for v in lengths]
    width = max(lengths)
    block = x
    if x.shape[0] < width:
        block = torch.cat([x, x.new_zeros((width - x.shape[0], *x.shape[1:]))])
    staged = block.is_cuda and dist.get_backend(group) == "gloo"
    if staged:
        host = torch.empty(block.shape, dtype=block.dtype, pin_memory=True)
        host.copy_(block)
        block = host
    parts = [torch.empty_like(block) for _ in range(n)]
    dist.all_gather(parts, block.contiguous(), group=group)
    out = torch.cat([p[:length] for p, length in zip(parts, lengths)])
    return out.to(x.device) if staged else out


def gather_objects(obj: Any, group) -> List[Any]:
    """Every rank's picklable ``obj`` in group-rank order, on every rank."""
    out: List[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


# --------------------------------------------------------------------------
# launching ranks


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_host(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _rank_main(fn, rank: int, n: int, backend: str, device: str, store_path: str,
               timeout: float, args, results) -> None:
    global _RANK_DEVICE
    try:
        torch.set_num_threads(1)
        # TF32 and bf16 partial sums are per-process flags: a rank has the
        # fork server's (torch's defaults), not its caller's
        reference_precision()
        if device == "cuda":
            index = rank % torch.cuda.device_count()
            torch.cuda.set_device(index)
            _RANK_DEVICE = torch.device("cuda", index)
        else:
            _RANK_DEVICE = torch.device("cpu")
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, n), rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=timeout),
        )
        try:
            out = _to_host(fn(*args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def shutdown() -> None:
    """Stop the fork server that :func:`launch` started, then the resource
    tracker that the fork server started, and reap both.  Left alone they
    outlive their parent: each stops only when it reads the end of its
    pipe, after the parent has exited.  The next launch starts them anew."""
    multiprocessing.forkserver._forkserver._stop()
    multiprocessing.resource_tracker._resource_tracker._stop()


def launch(fn: Callable, n: int, backend: str = "gloo", device: str = "cuda",
           timeout: float = 120.0, args: Sequence = ()) -> List[Any]:
    """Run ``fn(*args)`` on ``n`` ranks, each a process (forked from the
    fork server) with the default process group initialised (``backend``), one torch thread and
    TF32 off, its device ``cuda:<rank mod GPUs>`` or the CPU.  ``fn`` must
    be importable by name (a module-level function) and ``args``
    picklable.  Returns each rank's result in rank order, tensors as numpy
    arrays.

    A rank that raises fails the launch with its traceback; a rank that
    dies without a result, or a launch still running after ``timeout``
    seconds, fails it too.  Every rank still alive then is killed."""
    # a fork server that has imported torch and this module once hands
    # out the ranks: a fresh interpreter per rank would import torch each
    # time (seconds a rank), and forking the caller could copy its
    # threads (JAX's, the card's context) into every rank
    global _SHUTDOWN_AT_EXIT
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", __name__])
    if not _SHUTDOWN_AT_EXIT:
        atexit.register(shutdown)
        _SHUTDOWN_AT_EXIT = True
    results = ctx.Queue()
    out: Dict[int, Any] = {}
    with tempfile.TemporaryDirectory(prefix="ecw_launch_") as tmp:
        store_path = os.path.join(tmp, "store")
        procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(fn, r, n, backend, device, store_path, timeout, tuple(args), results))
            for r in range(n)
        ]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(out) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"launch of {getattr(fn, '__name__', fn)} on {n} ranks: ranks "
                        f"{sorted(set(range(n)) - set(out))} still running after {timeout} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 0.5))
                except queue_module.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode is not None]
                    if dead:
                        # a result may still be in the pipe: look once more
                        try:
                            rank, ok, payload = results.get(timeout=1.0)
                        except queue_module.Empty:
                            raise RuntimeError(
                                f"ranks {dead} exited (codes {[procs[r].exitcode for r in dead]}) "
                                "without a result") from None
                    else:
                        continue
                if not ok:
                    # the rank at fault usually reports after its peers'
                    # broken collectives: give every failure a moment
                    failures = {rank: payload}
                    end = time.monotonic() + 2.0
                    while time.monotonic() < end:
                        try:
                            r, ok_r, p_r = results.get(timeout=max(0.0, end - time.monotonic()))
                        except queue_module.Empty:
                            break
                        if not ok_r:
                            failures[r] = p_r
                    lines = [f"rank {r} of {n} failed:\n{failures[r]}" for r in sorted(failures)]
                    silent = [r for r, p in enumerate(procs)
                              if r not in out and r not in failures and p.exitcode is not None]
                    if silent:
                        lines.append(f"ranks {silent} exited (codes {[procs[r].exitcode for r in silent]}) "
                                     "without a result")
                    raise RuntimeError("\n".join(lines))
                out[rank] = payload
        finally:
            for p in procs:
                p.join(timeout=10 if len(out) == n else 0)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [out[r] for r in range(n)]
