"""The port's sharded checkpoints (``runtime/sharded_checkpoint.py``, DCP)
on the CPU: the state of JAX ``tests/test_sharded_checkpoint.py``
(``_sharded_state``: w [16, 8] over data × model, b [8] replicated, step 7,
from the same numpy seed) saved by 4 ranks (data=2 × model=2, gloo),
restored onto the same layout, onto another (w by rows over ``model``
alone), and in a process without a group as whole tensors."""

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from enhance_cb_whisper_tpu_torch.parallel.mesh import launch
from enhance_cb_whisper_tpu_torch.runtime.sharded_checkpoint import restore_sharded, save_sharded


def _state_arrays():
    """JAX ``_sharded_state``'s values."""
    rng = np.random.default_rng(0)
    return rng.standard_normal((16, 8), dtype=np.float32), rng.standard_normal((8,), dtype=np.float32)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    path = str(tmp_path_factory.mktemp("dcp") / "ckpt")
    w, b = _state_arrays()
    per_rank = launch(ranks.checkpoint_cases, 4, backend="gloo", device="cpu", timeout=120, args=(path, w, b))
    torch.set_num_threads(threads)
    return path, per_rank


def test_sharded_roundtrip(saved):
    _, per_rank = saved
    w, b = _state_arrays()
    for r in per_rank:
        d, m = r["coords"]
        same = r["same"]
        np.testing.assert_array_equal(same["local"], w[8 * d:8 * (d + 1), 4 * m:4 * (m + 1)])
        np.testing.assert_array_equal(same["local"], r["saved_local"])
        np.testing.assert_array_equal(same["full"], w)
        np.testing.assert_array_equal(same["b"], b)
        assert same["step"] == 7
        assert "Shard(dim=0)" in same["placements"] and "Shard(dim=1)" in same["placements"]


def test_restore_onto_different_layout(saved):
    """Restore re-lays w out: replicated over ``data``, its rows over
    ``model``."""
    _, per_rank = saved
    w, _ = _state_arrays()
    for r in per_rank:
        _, m = r["coords"]
        relaid = r["relaid"]
        assert relaid["placements"].startswith("(Replicate()")
        np.testing.assert_array_equal(relaid["local"], w[8 * m:8 * (m + 1)])
        np.testing.assert_array_equal(relaid["full"], w)


def test_restore_without_a_group_gives_whole_tensors(saved, tmp_path):
    path, _ = saved
    w, b = _state_arrays()
    whole = restore_sharded(path)
    np.testing.assert_array_equal(whole["params"]["w"].numpy(), w)
    np.testing.assert_array_equal(whole["params"]["b"].numpy(), b)
    assert whole["step"] == 7
    template = {"params": {"w": torch.zeros(16, 8), "b": torch.zeros(8)}, "step": 0}
    got = restore_sharded(path, template)
    np.testing.assert_array_equal(got["params"]["w"].numpy(), w)
    # one process saves and restores plain tensors too
    save_sharded(str(tmp_path / "local"), {"x": torch.arange(6.0), "n": 3})
    back = restore_sharded(str(tmp_path / "local"), {"x": torch.zeros(6), "n": 0})
    assert back["n"] == 3 and torch.equal(back["x"], torch.arange(6.0))
