"""The port's data-parallel paper-1 train step against the JAX package's
single-device step, on the CPU (gloo).

One launch of 4 ranks (``parallel/mesh.py:launch``) lays them out as
data=2 × model=2: each model replica is a data-parallel pair taking half of
every minibatch, with the BatchNorm statistics of the global batch
(``models/resnet.py:sync_batch_norm``) and the gradients summed over
``data``.  The JAX reference is ``train/kws_train.py:make_train_step`` on one
device, from the same initial variables (the port's init, converted), at
JAX ``tests/test_parallel.py``'s tolerances: ``class_loss`` rtol 1e-5, the
classifier kernel rtol 1e-4 / atol 1e-6.  The noise-carrying modes
(``kw_type='all'``'s coin, the large heads' dropout, DANNCE) are held to
the port's own single-rank step with the same draws: each rank slices the
global batch's draws.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from enhance_cb_whisper_tpu.models import ResNetConfig as JaxResNetConfig
from enhance_cb_whisper_tpu.train import kws_train as jt
from enhance_cb_whisper_tpu.train.optim import make_adam, make_multi_optimizer
from enhance_cb_whisper_tpu_torch.convert import to_flax_variables
from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig
from enhance_cb_whisper_tpu_torch.parallel.dryrun import TRAIN_RESNET, ArrayNoise
from enhance_cb_whisper_tpu_torch.parallel.mesh import launch, shutdown
from enhance_cb_whisper_tpu_torch.train import kws_train as pt

FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
BETA, SUPPRESSION = 0.1, 0.5


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"features": rng.standard_normal((8, 3, 32, 32), dtype=np.float32),
            "labels": rng.integers(0, 2, 8), "domain": rng.integers(0, 4, 8)}


def _raw_batch(seed=1):
    """JAX tests/test_parallel.py's device_features batch."""
    rng = np.random.default_rng(seed)
    return {"kwd_hs": rng.standard_normal((8, 3, 8, 6), dtype=np.float32),
            "utt_hs": rng.standard_normal((8, 3, 64, 6), dtype=np.float32),
            "kwd_len": rng.integers(2, 8, 8).astype(np.int32),
            "utt_len": rng.integers(20, 64, 8).astype(np.int32),
            "labels": rng.integers(0, 2, 8), "domain": rng.integers(0, 4, 8)}


# name -> (config, batch); the first three are held to JAX
JAX_CASES = {
    "plain": (dict(num_domains=4, learning_rate=1e-3), _batch(0)),
    "device_features": (dict(num_domains=4, learning_rate=1e-3, device_features=(32, 48)), _raw_batch()),
    # parallel/dryrun.py's stage 1
    "adversarial": (dict(adversarial_training=True, entropy=True, num_domains=4,
                         accumulate_grad_batches=2), _batch(2)),
}
NOISE_CONFIG = dict(adversarial_training=True, entropy=True, num_domains=4, accumulate_grad_batches=2,
                    large_heads=True, kw_type="all", dannce=True, adversarial_train_steps=1,
                    adversarial_examples_lr=0.01)


def _variables(config):
    """The port's initial variables (seed 0) in the flax layout."""
    state = pt.init_train_state(config, ResNetConfig(**TRAIN_RESNET), seed=0, device="cpu")
    kws = to_flax_variables(state.kws.state_dict())
    params = {"kws": kws["params"]}
    if state.disc is not None:
        params["disc"] = to_flax_variables(state.disc.state_dict())["params"]
    return {"params": params, "batch_stats": {"kws": kws["batch_stats"]}}


def _jax_step(kwargs, batch, variables):
    """JAX's single-device step from ``variables``: (params, stats, metrics)."""
    config = jt.KWSTrainConfig(**kwargs)
    kws, disc = jt.build_models(config, JaxResNetConfig(**TRAIN_RESNET))
    params = variables["params"]
    if config.adversarial_training:
        tx = make_multi_optimizer(jt._label_tree(params), {
            name: make_adam(lr, config.beta_1, config.beta_2, config.weight_decay)
            for name, lr in (("features", config.features_lr), ("classifier", config.classifier_lr),
                             ("discriminator", config.discriminator_lr))})
    else:
        tx = make_adam(config.learning_rate, config.beta_1, config.beta_2, config.weight_decay)
    step = jt.make_train_step(config, kws, disc, tx)
    args = (params, variables["batch_stats"], tx.init(params), {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(1), BETA, SUPPRESSION)
    p, s, _, m = step.lower(*args).compile(compiler_options=FAST)(*args)
    return jax.tree.map(np.asarray, (p, s, {k: float(v) for k, v in m.items()}))


def _noise_case():
    """The noise-carrying modes with fixed draws for a global batch of 8
    (tts, natural) pairs: the coin keeps 8 examples, two minibatches of 4,
    dropout over the large heads' 16 hidden units."""
    rng = np.random.default_rng(7)
    keep = [rng.random((4, 16)) < 0.5 for _ in range(4)]
    adversarial = [rng.random(4) < 0.5 for _ in range(2)]
    rng = np.random.default_rng(3)
    batch = {"features": rng.standard_normal((16, 3, 32, 32), dtype=np.float32),
             "labels": rng.integers(0, 2, 16), "domain": rng.integers(0, 4, 16)}
    return NOISE_CONFIG, batch, ArrayNoise(rng.random(8) < 0.5, keep, adversarial)


@pytest.fixture(scope="module")
def results():
    """Each rank's results and JAX's: the ranks run while JAX compiles."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cases = {name: (kwargs, batch, _variables(pt.KWSTrainConfig(**kwargs)), None, name == "plain")
             for name, (kwargs, batch) in JAX_CASES.items()}
    kwargs, batch, noise = _noise_case()
    cases["noise"] = (kwargs, batch, _variables(pt.KWSTrainConfig(**kwargs)), noise, True)
    with ThreadPoolExecutor(1) as pool:
        ranks_run = pool.submit(launch, ranks.train_cases, 4, backend="gloo", device="cpu", timeout=120,
                                args=(cases,))
        jax_out = {name: _jax_step(kwargs, batch, cases[name][2]) for name, (kwargs, batch) in JAX_CASES.items()}
        per_rank = ranks_run.result()
    torch.set_num_threads(threads)
    return per_rank, jax_out


def _kernel(params):
    return params["kws"]["model"]["classifier"]["kernel"]


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_dp_step_matches_jax_single_device(results, case):
    per_rank, jax_out = results
    want_params, _, want_metrics = jax_out[case]
    got = per_rank[0][case]["got"]
    np.testing.assert_allclose(got["metrics"]["class_loss"], want_metrics["class_loss"], rtol=1e-5)
    for k in want_metrics:
        np.testing.assert_allclose(got["metrics"][k], want_metrics[k], rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(_kernel(got["params"]), _kernel(want_params), rtol=1e-4, atol=1e-6)


def test_sync_batch_norm_running_statistics(results):
    """The running mean and (biased) variance after a step at data=2 are
    the global batch's: JAX's single-device statistics, and the port's."""
    per_rank, jax_out = results
    for case in ("plain", "adversarial"):
        _, want_stats, _ = jax_out[case]
        got = per_rank[0][case]["got"]["batch_stats"]
        flat_want = jax.tree_util.tree_flatten_with_path(want_stats)[0]
        flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(flat_want) == len(flat_got) > 0
        for path, w in flat_want:
            scale = float(np.abs(w).max()) or 1.0
            np.testing.assert_allclose(flat_got[path], w, rtol=1e-4, atol=1e-5 * scale,
                                       err_msg=f"{case} {jax.tree_util.keystr(path)}")
    # and the port's one-rank statistics, closer
    ref = dict(jax.tree_util.tree_flatten_with_path(per_rank[0]["plain"]["ref"]["batch_stats"])[0])
    for path, g in jax.tree_util.tree_flatten_with_path(per_rank[0]["plain"]["got"]["batch_stats"])[0]:
        scale = float(np.abs(ref[path]).max()) or 1.0
        np.testing.assert_allclose(g, ref[path], rtol=1e-5, atol=1e-6 * scale)


def test_dp_noise_modes_match_one_rank(results):
    """kw_type='all', the large heads' dropout and DANNCE at data=2: each
    rank's slice of the global draws gives the single-rank step."""
    per_rank, _ = results
    got, ref = per_rank[0]["noise"]["got"], per_rank[0]["noise"]["ref"]
    for k in ref["metrics"]:
        np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k], rtol=1e-5, atol=1e-7, err_msg=k)
    for tree in ("params", "batch_stats"):
        for path, r in jax.tree_util.tree_flatten_with_path(ref[tree])[0]:
            g = dict(jax.tree_util.tree_flatten_with_path(got[tree])[0])[path]
            scale = float(np.abs(r).max()) or 1.0
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5 * scale,
                                       err_msg=f"{tree} {jax.tree_util.keystr(path)}")


def test_every_rank_holds_the_same_state(results):
    """Parameters, statistics and metrics are replicated: the two data
    ranks and the two model replicas end the step with equal values."""
    per_rank, _ = results
    assert [r["rank"] for r in per_rank] == [0, 1, 2, 3]
    for case in [*JAX_CASES, "noise"]:
        first = jax.tree.leaves(per_rank[0][case]["got"])
        for other in per_rank[1:]:
            for a, b in zip(first, jax.tree.leaves(other[case]["got"])):
                np.testing.assert_array_equal(a, b, err_msg=case)


@pytest.mark.parametrize("mode, timeout, error, match", [
    ("raise", 60, RuntimeError, "(?s)rank 1 of 2 failed:.*ValueError: rank 1 gives up"),
    ("die", 60, RuntimeError, r"ranks \[1\] exited \(codes \[3\]\) without a result"),
    ("hang", 6, TimeoutError, r"ranks \[1\] still running after 6"),
])
def test_launch_fails_on_a_failed_or_hung_rank(mode, timeout, error, match):
    """A rank's exception, death or hang fails the launch (a hang at the
    launch's timeout) and leaves no rank running."""
    import multiprocessing

    with pytest.raises(error, match=match):
        launch(ranks.fail_on_rank_1, 2, backend="gloo", device="cpu", timeout=timeout, args=(mode,))
    assert multiprocessing.active_children() == []


def test_shutdown_leaves_no_process():
    """After :func:`shutdown` neither the fork server that hands out the
    ranks nor its resource tracker is running: a program that launched
    ranks exits without leaving a process behind."""
    import multiprocessing.forkserver
    import multiprocessing.resource_tracker
    import os

    import torch.distributed as dist

    assert launch(dist.get_world_size, 1, backend="gloo", device="cpu", timeout=60) == [1]
    pids = [multiprocessing.forkserver._forkserver._forkserver_pid,
            multiprocessing.resource_tracker._resource_tracker._pid]
    assert None not in pids
    shutdown()
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
