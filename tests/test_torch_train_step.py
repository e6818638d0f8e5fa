"""The port's paper-1 train step against the JAX package's, on the CPU.

The tiny ResNet of JAX ``tests/test_train_step.py`` (widths 8-32, one block
a stage) at 3 × 32 × 32, with JAX's initial variables converted into the
port.  For each mode of ``KWSTrainConfig`` the same batch goes through
JAX's ``make_grad_fn`` and the port's, and every gradient leaf, every
BatchNorm running statistic and the metric sums are compared:

* fp32 modes: rtol 1e-4, atol 1e-5 × the leaf's largest magnitude (XLA's
  and PyTorch's convolutions sum in other orders; a BatchNorm over a
  handful of values amplifies the last bits);
* bf16 (the plain case's config and batch in bf16): XLA on the CPU keeps
  fused bf16 chains in f32 where PyTorch rounds each op's output, and a
  random tiny network's bf16 gradients are mostly rounding noise (JAX's
  bf16 gradient is 0.25 away from its own f32 one in relative L2).  So the
  port's bf16 gradient is held to JAX's bf16 one by a cosine of at least
  0.85 and a relative L2 distance of at most twice JAX's own bf16-vs-f32
  distance, the statistics to 0.05 in relative L2, the losses to 3 %;
* the random draws (the ``kw_type='all'`` coin, the large heads' dropout
  masks, DANNCE's masks) are JAX's own, taken from its keys or recorded
  from its dropout modules and handed to the port's step.

The optimizers take *the same* gradients (Adam's first update is about
``lr · sign(g)``, so a rounding-level gradient could flip a sign between
frameworks without either being wrong) and their updates are compared at
rtol 1e-5 over two steps, for one group and for three, with
``update_epoch_lr`` across a step boundary of the schedule.
"""

import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhance_cb_whisper_tpu.models import ResNetConfig as JaxResNetConfig
from enhance_cb_whisper_tpu.models.kws import cross_entropy as jax_cross_entropy
from enhance_cb_whisper_tpu.train import kws_train as jt
from enhance_cb_whisper_tpu.train import optim as jax_optim
from enhance_cb_whisper_tpu_torch.convert import from_flax_resnet_variables, to_flax_variables
from enhance_cb_whisper_tpu_torch.models.kws import cross_entropy, grad_reverse
from enhance_cb_whisper_tpu_torch.models.resnet import BatchNorm, ResNetConfig
from enhance_cb_whisper_tpu_torch.train import kws_train as pt

TINY = dict(num_channels=3, embedding_size=8, hidden_sizes=(8, 16, 24, 32), depths=(1, 1, 1, 1),
            num_labels=2)
SHAPE = (3, 48, 48)
SIZE = (32, 40)  # device_features target
FP32 = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(n, domains=4, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "features": rng.standard_normal((n, *SHAPE), dtype=np.float32),
        "labels": rng.integers(0, 2, n).astype(np.int64),
        "domain": rng.integers(0, domains, n).astype(np.int64),
    }


def _raw_batch(n, seed=5):
    """Raw hidden-state items through the JAX package's raw collator."""
    from enhance_cb_whisper_tpu.data.collators import RawKWSDataCollator

    rng = np.random.default_rng(seed)
    items = []
    for _ in range(n):
        items.append({
            "label": int(rng.integers(0, 2)), "mask": 1, "domain": int(rng.integers(0, 4)),
            "kwd_hs": rng.standard_normal((3, int(rng.integers(2, 12)), 8)).astype(np.float32),
            "utt_hs": rng.standard_normal((3, int(rng.integers(20, 60)), 8)).astype(np.float32),
        })
    return RawKWSDataCollator(bucket_kwd=4, bucket_utt=16)(items)


class JaxNoise:
    """The port's noise-source interface serving JAX's draws."""

    def __init__(self, coin=None, keep=(), adversarial=()):
        self._coin, self._keep, self._adv = coin, list(keep), list(adversarial)

    def coin(self, n, p):
        assert self._coin.shape == (n,)
        return torch.from_numpy(self._coin.copy())

    def dropout_keep(self, minibatch, n, width):
        a, b = self._keep[2 * minibatch], self._keep[2 * minibatch + 1]
        assert a.shape == b.shape == (n, width)
        return torch.from_numpy(a.copy()), torch.from_numpy(b.copy())

    def adversarial_mask(self, minibatch, n, p):
        assert self._adv[minibatch].shape == (n,)
        return torch.from_numpy(self._adv[minibatch].copy())


def _dropout_recorder(masks):
    """A flax interceptor that records each Dropout's kept positions (it
    runs the module on ones: the kept values come back as 1/keep_prob) and
    gives the same values and gradients as the module itself."""

    def interceptor(next_fun, args, kwargs, context):
        module = context.module
        if (not isinstance(module, fnn.Dropout) or context.method_name != "__call__"
                or module.deterministic):  # DANNCE's discriminator runs without dropout
            return next_fun(*args, **kwargs)
        x = args[0]
        scaled = next_fun(jnp.ones_like(x), *args[1:], **kwargs)
        jax.debug.callback(lambda m: masks.append(np.asarray(m) > 0), scaled, ordered=True)
        return x * scaled

    return interceptor


# XLA's quicker CPU compile: the JAX side of these tests is a handful of
# tiny programs whose compile, not their run, is the cost
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
_INIT = {}


def _fast(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST)(*args)


def _jax_init(config):
    """JAX's initial variables (flax's own init, once per head type) and
    the JAX models of ``config``."""
    kws, disc = jt.build_models(config, JaxResNetConfig(**TINY))
    shape = (1, TINY["num_channels"], *(config.device_features or SHAPE[1:]))
    if "kws" not in _INIT:
        _INIT["kws"] = _fast(kws.init, jax.random.PRNGKey(0), jnp.zeros(shape))
    params = {"kws": _INIT["kws"]["params"]}
    if disc is not None:
        if config.large_heads not in _INIT:
            _INIT[config.large_heads] = _fast(
                lambda r: disc.init(r, jnp.zeros((1, TINY["hidden_sizes"][-1])),
                                    jnp.zeros((1,), jnp.int32)),
                jax.random.PRNGKey(1))
        params["disc"] = _INIT[config.large_heads]["params"]
    return params, {"kws": _INIT["kws"]["batch_stats"]}, kws, disc


def _jax_grads(config, batch, key=3, beta=0.1, suppression=0.5):
    """JAX's gradients, new statistics and metric sums, plus its draws."""
    params, stats, kws, disc = _jax_init(config)
    rng = jax.random.PRNGKey(key)
    masks = []
    grad_fn = jt.make_grad_fn(config, kws, disc)
    with fnn.intercept_methods(_dropout_recorder(masks)):
        out = _fast(grad_fn, params, stats, {k: jnp.asarray(v) for k, v in batch.items()},
                    rng, beta, suppression)
        jax.effects_barrier()
    grads, new_stats, metrics, n = out
    n_labels = batch["labels"].shape[0]
    coin = None
    if config.kw_type == "all":
        coin = np.asarray(jax.random.bernoulli(jax.random.fold_in(rng, 0), 1.0 - config.kw_p,
                                               (n_labels // 2,)))
        n_labels //= 2
    n_mb = config.accumulate_grad_batches if config.adversarial_training else 1
    adversarial = [
        np.asarray(jax.random.bernoulli(jax.random.fold_in(rng, 100 + i),
                                        config.adversarial_examples_ratio, (n_labels // n_mb,)))
        for i in range(n_mb)
    ] if config.dannce else []
    noise = JaxNoise(coin, masks, adversarial)
    initial = types.SimpleNamespace(params=params, batch_stats=stats)
    return initial, jax.tree.map(np.asarray, (grads, new_stats, metrics)), int(n), noise


def _port_state(config, state):
    """The port's train state on the CPU holding JAX's initial variables."""
    port = pt.init_train_state(config, ResNetConfig(**TINY), device="cpu")
    port.kws.load_converted(from_flax_resnet_variables(
        {"params": state.params["kws"], "batch_stats": state.batch_stats["kws"]}))
    if port.disc is not None:
        port.disc.load_state_dict(from_flax_resnet_variables({"params": state.params["disc"]}))
    return port


def _port_grads(config, port, batch, noise, beta=0.1, suppression=0.5):
    params = [p for g in port.optimizer.param_groups for p in g["params"]]
    for p in params:
        p.grad = None
    grad_fn = pt.make_grad_fn(config, port.kws, port.disc)
    sums, n = grad_fn({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
                      noise, beta, suppression)
    grads = {"kws": to_flax_variables({k: p.grad for k, p in port.kws.named_parameters()})["params"]}
    if port.disc is not None:
        grads["disc"] = to_flax_variables(
            {k: p.grad for k, p in port.disc.named_parameters()})["params"]
    stats = {"kws": to_flax_variables(port.kws.state_dict())["batch_stats"]}
    return grads, stats, {k: float(v) for k, v in sums.items()}, n


def _flat(tree):
    return np.concatenate([np.ravel(x) for x in jax.tree.leaves(tree)])


def _cosine(a, b):
    a, b = _flat(a), _flat(b)
    return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


def _rel_l2(a, b):
    a, b = _flat(a), _flat(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _assert_trees(got, want, rtol, atol_scale, what):
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert flat_got.keys() == flat_want.keys(), what
    for path, w in flat_want.items():
        g = flat_got[path]
        assert g.shape == w.shape, (what, path)
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_scale * scale,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


ADV = dict(adversarial_training=True, entropy=True, num_domains=4, accumulate_grad_batches=2)
# each case's config and batch size; the adversarial case carries every
# adversarial mode at once (one JAX compile): entropy, two accumulated
# minibatches, the large heads' dropout, the kw_type='all' coin and DANNCE
# (its inner rate raised from 1.5e-6 so that the rewrite shows)
CASES = {
    "plain_unsuppressed_entropy": (dict(num_domains=4, entropy=True,
                                        early_adversary_supression=False), 4),
    "adversarial_large_heads_all_dannce": (dict(
        ADV, large_heads=True, kw_type="all", dannce=True, adversarial_train_steps=2,
        adversarial_examples_lr=0.01), 16),
    "device_features": (dict(num_domains=4, device_features=SIZE), 8),
    "bfloat16": (dict(num_domains=4, entropy=True, early_adversary_supression=False,
                      compute_dtype="bfloat16"), 4),
}
FP32_GRAD = dict(rtol=1e-4, atol_scale=2e-4)
_RESULTS = {}


def _case(name):
    """(JAX's initial variables, JAX's result, its draws, the batch), once
    per case."""
    if name not in _RESULTS:
        kwargs, n = CASES[name]
        batch = _raw_batch(n) if "device_features" in kwargs else _batch(n)
        initial, want, n_want, noise = _jax_grads(jt.KWSTrainConfig(**kwargs), batch)
        _RESULTS[name] = (initial, want, n_want, noise, batch)
    return _RESULTS[name]


@pytest.mark.parametrize("name", list(CASES))
def test_grads_and_statistics_match_jax(name):
    kwargs, _ = CASES[name]
    config = pt.KWSTrainConfig(**kwargs)
    initial, (g_want, s_want, m_want), n_want, noise, batch = _case(name)
    port = _port_state(config, initial)
    g_got, s_got, m_got, n_got = _port_grads(config, port, batch, noise)
    assert n_got == n_want
    assert m_got.keys() == m_want.keys()
    if config.compute_dtype == "bfloat16":
        g_f32 = _case("plain_unsuppressed_entropy")[1][0]
        assert _cosine(g_got, g_want) >= 0.85
        assert _rel_l2(g_got, g_want) <= 2 * _rel_l2(g_want, g_f32)
        assert _rel_l2(s_got, s_want) <= 0.05
        for k in m_want:
            assert m_got[k] == pytest.approx(float(m_want[k]), rel=0.03), k
        assert all(p.dtype == torch.float32 for p in port.kws.parameters())
        assert all(b.dtype == torch.float32 for b in port.kws.buffers() if b.is_floating_point())
        return
    _assert_trees(g_got, g_want, FP32_GRAD["rtol"], FP32_GRAD["atol_scale"], "grad")
    _assert_trees(s_got, s_want, 1e-4, 1e-5, "batch_stats")
    for k in m_want:
        assert m_got[k] == pytest.approx(float(m_want[k]), rel=1e-5, abs=1e-6), k
    if config.large_heads:
        assert len(noise._keep) == 4  # two masks in each of two minibatches
    if config.dannce:
        # the rewrite moved the inputs: without it the gradients differ
        plain_config = pt.KWSTrainConfig(**dict(kwargs, dannce=False))
        g_plain = _port_grads(plain_config, _port_state(plain_config, initial), batch, noise)[0]
        leaf = g_plain["kws"]["model"]["classifier"]["kernel"]
        assert not np.allclose(leaf, g_got["kws"]["model"]["classifier"]["kernel"], rtol=1e-3)


@pytest.mark.parametrize("name", ["plain_unsuppressed_entropy", "adversarial_large_heads_all_dannce"])
def test_remat_gives_the_same_gradients(name):
    """Recomputing each block in the backward changes nothing: the port's
    remat step is bit-equal to its plain step (running statistics moved
    once, not twice) and so within the fp32 tolerance of JAX (whose own
    remat equals its plain path, JAX ``tests/test_train_step.py``)."""
    kwargs, _ = CASES[name]
    initial, (g_want, s_want, _), _, noise, batch = _case(name)
    results = []
    for remat in (False, True):
        config = pt.KWSTrainConfig(**dict(kwargs, remat=remat))
        results.append(_port_grads(config, _port_state(config, initial), batch, noise))
    (g_plain, s_plain, m_plain, _), (g_remat, s_remat, m_remat, _) = results
    _assert_trees(g_remat, g_plain, 0, 0, "remat grad")
    _assert_trees(s_remat, s_plain, 0, 0, "remat batch_stats")
    assert m_remat == m_plain
    _assert_trees(g_remat, g_want, FP32_GRAD["rtol"], FP32_GRAD["atol_scale"], "remat vs JAX")
    _assert_trees(s_remat, s_want, 1e-4, 1e-5, "remat statistics vs JAX")


def test_batchnorm_running_variance_is_flax_biased():
    """n = 2 values a channel: torch's own BatchNorm2d would move the
    running variance toward twice the batch variance."""
    x = np.random.default_rng(0).standard_normal((2, 5, 1, 1)).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x.transpose(0, 2, 3, 1)))
    y_j, upd = bn.apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1)), mutable=["batch_stats"])
    port = BatchNorm(5).train()
    y_p = port(torch.from_numpy(x))
    np.testing.assert_allclose(y_p.detach().numpy().transpose(0, 2, 3, 1), np.asarray(y_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-7)
    unbiased = torch.nn.BatchNorm2d(5).train()
    unbiased(torch.from_numpy(x))
    biased_var = x.var(axis=(0, 2, 3))
    np.testing.assert_allclose(port.running_var.numpy(), 0.9 + 0.1 * biased_var, rtol=1e-6)
    np.testing.assert_allclose(unbiased.running_var.numpy(), 0.9 + 0.2 * biased_var, rtol=1e-6)


def test_cross_entropy_all_ignored_is_zero():
    logits = np.random.default_rng(1).standard_normal((4, 2)).astype(np.float32)
    ignored = np.full(4, -100, np.int64)
    mixed = np.array([1, -100, 0, -100], np.int64)
    for labels in (ignored, mixed):
        got = float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)))
        want = float(jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7)
    assert float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(ignored))) == 0.0
    # the torch built-in would give NaN here
    assert np.isnan(float(torch.nn.functional.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(ignored), ignore_index=-100)))


def test_grad_reverse_scales_by_minus_beta():
    x = torch.randn(3, 4, requires_grad=True)
    y = grad_reverse(x, 0.25)
    assert torch.equal(y, x)
    y.sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, -0.25))


@pytest.mark.parametrize("adversarial", [False, True], ids=["one_group", "three_groups"])
def test_optimizer_updates_match_optax_on_shared_gradients(adversarial):
    kwargs = dict(num_domains=4, adversarial_training=adversarial, learning_rate=1e-3,
                  features_lr=1e-3, classifier_lr=2e-3, discriminator_lr=5e-4, lr_step=1,
                  weight_decay=0.01)
    config_j, config_p = jt.KWSTrainConfig(**kwargs), pt.KWSTrainConfig(**kwargs)
    params, stats, _, _ = _jax_init(config_j)
    # the JAX package's optimizer, as its init_train_state builds it
    adam = [(lr, config_j.beta_1, config_j.beta_2, config_j.weight_decay) for lr in
            (config_j.features_lr, config_j.classifier_lr, config_j.discriminator_lr)]
    tx = (jax_optim.make_adam(config_j.learning_rate, *adam[0][1:]) if not adversarial else
          jax_optim.make_multi_optimizer(jt._label_tree(params), {
              name: jax_optim.make_adam(*a)
              for name, a in zip(("features", "classifier", "discriminator"), adam)}))
    opt_state = _fast(tx.init, params)
    port = _port_state(config_p, types.SimpleNamespace(params=params, batch_stats=stats))
    modules = {"kws": port.kws, **({"disc": port.disc} if adversarial else {})}
    rng = np.random.default_rng(2)
    update = None
    for epoch in (0, 1):  # the step schedule divides every rate by 10 at epoch 1
        port.epoch = epoch
        opt_state = jt.update_epoch_lr(config_j, types.SimpleNamespace(epoch=epoch), opt_state)
        pt.update_epoch_lr(config_p, port)
        grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        for name, module in modules.items():
            converted = from_flax_resnet_variables({"params": grads[name]})
            for key, p in module.named_parameters():
                p.grad = converted[key].clone()
        if update is None:
            update = jax.jit(tx.update).lower(grads, opt_state, params).compile(
                compiler_options=FAST)
        updates, opt_state = update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: np.asarray(p) + np.asarray(u), params, updates)
        port.optimizer.step()
        for name, module in modules.items():
            got = to_flax_variables(module.state_dict())["params"]
            _assert_trees(got, jax.tree.map(np.asarray, params[name]), 1e-5, 1e-6, f"{name} {epoch}")
    want_lrs = {"all": 1e-4} if not adversarial else {
        "features": 1e-4, "classifier": 2e-4, "discriminator": 5e-5}
    got_lrs = {g["name"]: g["lr"] for g in port.optimizer.param_groups}
    assert got_lrs == pytest.approx(want_lrs, rel=1e-12)


def test_train_step_divides_metrics_like_jax():
    """A whole step: the metric sums of the adversarial case divided as
    the JAX step divides them (losses by the minibatches, disc_correct by
    the examples), then one Adam update that moves every parameter."""
    kwargs, _ = CASES["adversarial_large_heads_all_dannce"]
    config = pt.KWSTrainConfig(**kwargs)
    initial, (_, _, sums), n_examples, noise, batch = _case("adversarial_large_heads_all_dannce")
    port = _port_state(config, initial)
    before = {k: p.detach().clone() for k, p in port.kws.named_parameters()}
    got = pt.make_train_step(config, port)(
        {k: torch.from_numpy(v) for k, v in batch.items()}, noise, 0.1, 0.5)
    for k, v in sums.items():
        want = float(v) / (n_examples if k == "disc_correct" else config.accumulate_grad_batches)
        assert float(got[k]) == pytest.approx(want, rel=1e-5, abs=1e-6), k
    for k, p in port.kws.named_parameters():
        assert not torch.equal(p, before[k]), k


def test_step_noise_is_seeded_per_step():
    a = pt.StepNoise(pt.step_seed(124, 7), device="cpu")
    b = pt.StepNoise(pt.step_seed(124, 7), device="cpu")
    c = pt.StepNoise(pt.step_seed(124, 8), device="cpu")
    assert torch.equal(a.coin(64, 0.5), b.coin(64, 0.5))
    assert not torch.equal(pt.StepNoise(pt.step_seed(124, 7), "cpu").coin(64, 0.5), c.coin(64, 0.5))
    keep = a.dropout_keep(0, 8, 16)
    assert keep[0].dtype == torch.bool and keep[0].shape == (8, 16)
    assert 0.3 < float(keep[0].float().mean()) < 0.7
