"""The port's paper-2 train step against the JAX package's, on the CPU.

Tiny dims: 2 slabs of 12-wide stacks (``make_mls``), ``embedding_dim`` 8 (so
the stacks are wider than it: the projector takes its input width from
the data, as flax's ``Dense`` does), 4 projection units, features (32, 64)
and a two-stage bottleneck ResNet (widths 8 and 16, one block each) in
place of ResNet-18 on both sides, to keep XLA's compiles short.  One flax
init of LEF gives every variant's initial variables (L and LE are its
subtrees), and each package trains from them with the same batches and
JAX's own coin draws (``kw_type='all'``):

* two steps of L, LE and LEF: the loss within 1e-5 relative; AdamW's
  moments, whose first is ``0.1 ×`` the gradient after one step, within
  rtol 1e-4 and 2e-4 × the leaf's largest magnitude (the gradient
  tolerance of the paper-1 step tests); the BatchNorm statistics within
  rtol 1e-4 and 1e-5 × the leaf's scale; the weights, which Adam moves by
  about its rate whatever a gradient's size (a gradient at rounding level,
  such as LEF's time-convolution bias ahead of a BatchNorm, can step the
  other way in the other framework), each within two rates a step, at
  least 98 % of them and all of the classifier within rtol 1e-4 and 1e-5 ×
  the leaf's scale.  Two kinds of leaf are held otherwise: LEF's
  time-convolution bias, ahead of a BatchNorm, whose gradient vanishes in
  exact arithmetic (its moments below 1e-4 of the largest in both
  packages), and, in a batch with a ghost keyword, the last projection
  layer's bias: the ghost's zero stand-in frame is unmasked (as in the
  reference), projects to exactly 0, and the safe norm's clamp scales its
  gradient by 1/eps = 1e6 into a sum of thousands-large terms that cancel
  (within 25 % in relative L2; fed JAX's embedding in place of its own,
  2e-5 away, the port moves that leaf's gradient by ~5 % itself); the time
  projector's running means, which follow that noisy bias, are held
  within the bias's own gap on top of the statistics' tolerance;
* the audio mode (LE, a random 4-layer Whisper encoder of width 12, K1's
  plain version on the CPU): the in-step embedding against the JAX
  engine's ``_embed_utterances`` within rtol 2e-4 / atol 2e-5 (the tolerance
  of JAX ``tests/test_audio_mode_training.py``), zeros past each
  utterance, then one step at the tolerances above;
* bf16 (LE): the first moment against JAX's bf16 one by a cosine of at least
  0.85 and a relative L2 distance of at most twice JAX's own bf16-vs-fp32
  distance, the statistics within 0.05 relative L2, the loss within 3 %
  (XLA keeps fused bf16 chains in f32 where PyTorch rounds every op);
* AdamW at weight decay 0.01 over the two groups ("resnet" at 1e-3,
  "proj" at 2e-3) on shared gradients for two epochs of the cosine
  schedule: every weight within rtol 1e-5 of optax's;
* the projector-width repair: JAX variables initialised on 12-wide stacks
  (``embedding_dim`` 8) load into the port and score the same
  probabilities within rtol 1e-4 / atol 1e-5;
* finite LE gradients with zero-padded frames (JAX
  ``tests/test_audio_mode_training.py``'s case).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from enhance_cb_whisper_tpu.efficient_kws import data as jd
from enhance_cb_whisper_tpu.efficient_kws import engine as je
from enhance_cb_whisper_tpu.efficient_kws import model as jm
from enhance_cb_whisper_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from enhance_cb_whisper_tpu.models.whisper import WhisperConfig as JaxWhisperConfig
from enhance_cb_whisper_tpu.models.whisper import init_whisper_params
from enhance_cb_whisper_tpu_torch.convert import from_jax_whisper_params, to_flax_variables
from enhance_cb_whisper_tpu_torch.efficient_kws import engine as pe
from enhance_cb_whisper_tpu_torch.efficient_kws import model as pm
from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig
from enhance_cb_whisper_tpu_torch.models.whisper import WhisperConfig
from enhance_cb_whisper_tpu_torch.train.kws_train import adam_tree

from fixtures import make_mls

LANGS = ("English", "German")
FS = (32, 64)
WIDTH = 12  # the stacks' width, wider than embedding_dim
TINY = dict(embedding_size=8, hidden_sizes=(8, 16), depths=(1, 1), num_labels=2)
FIELDS = dict(n_layers=2, embedding_dim=8, proj_mlp_units=4)
VARIANTS = {"L": {}, "LE": {"learn_features": True, "proj_mlp": True},
            "LEF": {"learn_features": True, "proj_mlp": True, "frames_conv": True}}
TRAIN = dict(kw_type="all", learning_rate=1e-3, learning_rate_sru=2e-3, max_epochs=4)
SEED = 5
WHISPER = dict(vocab_size=64, num_mel_bins=80, d_model=WIDTH, encoder_layers=4,
               encoder_attention_heads=2, decoder_layers=1, decoder_attention_heads=2,
               encoder_ffn_dim=24, decoder_ffn_dim=24, max_source_positions=1500,
               max_target_positions=16)
LAYER_SLICE = (1, 5)
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@dataclasses.dataclass(frozen=True)
class _JaxTiny(jm.EfficientKWSConfig):
    def resnet_config(self):
        return JaxResNetConfig(num_channels=self.n_layers, **TINY)


@dataclasses.dataclass(frozen=True)
class _PortTiny(pm.EfficientKWSConfig):
    def resnet_config(self):
        return ResNetConfig(num_channels=self.n_layers, **TINY)


class _FastJit:
    """``jax.jit(fn)`` compiled with XLA's quicker CPU settings, once per
    argument signature."""

    def __init__(self, jitted):
        self.jitted, self.compiled = jitted, {}

    def __call__(self, *args):
        leaves, tree = jax.tree.flatten(args)
        key = (tree, tuple((np.shape(x), np.result_type(x)) for x in leaves))
        if key not in self.compiled:
            self.compiled[key] = self.jitted.lower(*args).compile(compiler_options=FAST)
        return self.compiled[key](*args)


class JaxNoise:
    """The port's noise-source interface serving JAX's coin."""

    def __init__(self, coin):
        self._coin = coin

    def coin(self, n, p):
        assert self._coin.shape == (n,)
        return torch.from_numpy(self._coin.copy())


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    """Two collated kw_type='all' batches (4 pairs each) from the caches and
    two from the audio, through the JAX package's datamodule."""
    root = str(tmp_path_factory.mktemp("mls"))
    make_mls(root, languages=LANGS, with_audio=True, dim=WIDTH)
    out = {}
    for mode, load in (("cache", True), ("audio", False)):
        dm = jd.EfficientKWSDataMod(
            batch_size=4, sampling="utterance-examples", features_size=FS, n_layers=2,
            languages=list(LANGS), load_embeddings=load, learn_features=True,
            kws_whisper_ckpt="unused", train_info=[{"name": "mls", "root": root, "kw_type": "all"}])
        dm.setup("fit")
        it = iter(dm.train_dataloader())
        out[mode] = [next(it), next(it)]
    return out


_INIT = {}


def _initial(variant, batches):
    """JAX's initial variables of ``variant``: one flax init of LEF (on the
    12-wide stacks), L and LE taking its subtrees."""
    if "LEF" not in _INIT:
        b = batches["cache"][0]
        model = jm.EfficientKWSModel(_JaxTiny(**FIELDS, **VARIANTS["LEF"]))
        args = [jnp.asarray(b[k][:1]) for k in ("kwd_features", "utt_features", "kwd_mask", "utt_mask")]
        _INIT["LEF"] = jax.tree.map(np.asarray, jax.jit(model.init).lower(
            jax.random.PRNGKey(SEED), *args).compile(compiler_options=FAST)(jax.random.PRNGKey(SEED), *args))
    full = _INIT["LEF"]
    keep = {"L": ("model", "classifier"), "LE": ("projector", "model", "classifier")}.get(variant)
    if keep is None:
        return full
    return {c: {k: v for k, v in full[c].items() if k in keep} for c in ("params", "batch_stats")}


def _jax_engine(variant, batches, monkeypatch, **kwargs):
    """A JAX engine whose ``init_state`` starts from :func:`_initial` and
    whose step compiles with the quicker settings: (engine, step, params,
    statistics, optimizer state)."""
    cfg = _JaxTiny(**FIELDS, **VARIANTS[variant])
    train = dict(TRAIN, **kwargs.pop("train", {}))
    engine = je.EfficientKWSEngine(cfg, je.EfficientTrainConfig(**train), seed=SEED, **kwargs)
    variables = _initial(variant, batches)
    with monkeypatch.context() as m:
        m.setattr(jm.EfficientKWSModel, "init", lambda self, rng, *a, **kw: variables)
        params, stats, opt_state = engine.init_state(batches["cache"][0])
        real_jit = jax.jit
        m.setattr(jax, "jit", lambda fn, **kw: _FastJit(real_jit(fn, **kw)))
        step = engine.make_train_step()
    return engine, step, params, stats, opt_state


def _coin(step_index, n_pairs, kw_p=0.5):
    rng = jax.random.fold_in(jax.random.PRNGKey(SEED + 1), step_index)
    return rng, np.asarray(jax.random.bernoulli(rng, 1.0 - kw_p, (n_pairs,)))


def _jax_steps(variant, batches, monkeypatch, mode="cache", n=2, **kwargs):
    """(initial tree, [(coin, loss, params, statistics, opt tree)] per step)."""
    engine, step, params, stats, opt = _jax_engine(variant, batches, monkeypatch, **kwargs)
    initial = {"params": params, "batch_stats": stats,
               "opt_state": serialization.to_state_dict(opt)}
    out = []
    for k, b in enumerate(batches[mode][:n]):
        rng, coin = _coin(k, b["labels"].shape[0] // 2)
        params, stats, opt, metrics = step(params, stats, opt,
                                           {key: jnp.asarray(v) for key, v in b.items()}, rng)
        out.append((coin, float(metrics["loss"]), jax.tree.map(np.asarray, params),
                    jax.tree.map(np.asarray, stats),
                    jax.tree.map(np.asarray, serialization.to_state_dict(opt))))
    return initial, out


_RUNS = {}


def _fp32_steps(variant, batches, monkeypatch):
    """:func:`_jax_steps` of ``variant`` from the caches, once per module."""
    if variant not in _RUNS:
        _RUNS[variant] = _jax_steps(variant, batches, monkeypatch)
    return _RUNS[variant]


def _port_steps(variant, initial, runs, batches, mode="cache", whisper=None, **train):
    cfg = _PortTiny(**FIELDS, **VARIANTS[variant])
    kwargs = dict(whisper=whisper, kws_layer_slice=LAYER_SLICE, utt_frames_budget=FS[1]) if whisper else {}
    engine = pe.EfficientKWSEngine(cfg, pe.EfficientTrainConfig(**dict(TRAIN, **train)), seed=SEED,
                                   device="cpu", **kwargs)
    state = engine.init_state(batches["cache"][0])
    engine.restore_state(state, initial)
    step = engine.make_train_step(state)
    out = []
    for (coin, *_), b in zip(runs, batches[mode]):
        metrics = step({k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}, JaxNoise(coin))
        variables = to_flax_variables(state.model.state_dict())
        out.append((float(metrics["loss"]), variables["params"], variables["batch_stats"],
                    adam_tree(state.optimizer, {"": state.model})))
    return engine, state, out


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _moments(opt_tree, which):
    """{leaf path: moment} of every group (masked leaves dropped)."""
    groups = ([g["inner_state"] for g in opt_tree["inner_states"].values()]
              if "inner_states" in opt_tree else [opt_tree])
    out = {}
    for g in groups:
        out.update(_flat(g["inner_state"]["0"][which]))
    return out


def _close(got, want, rtol, atol_scale, what):
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol_scale * scale, err_msg=f"{what} {k}")


# LEF's time-convolution bias feeds a BatchNorm, which takes the mean out:
# its gradient is 0 in exact arithmetic and rounding noise in each package
VANISHING = "['time_projector']['conv_"
# a ghost keyword's zero stand-in frame is unmasked (as in the reference)
# and projects to exactly 0 through zero biases, where the safe norm's
# clamp scales the gradient by 1/eps = 1e6: the last projection layer's
# bias alone then sums thousands-large terms that cancel
GHOST_BIAS = ("['projector']['proj_", "_1']['bias']")


def _assert_moments(got, want, ghost_batch):
    """AdamW's moments: the gradient tolerance elementwise, a vanishing
    gradient's leaf by its size (below 1e-4 of the largest moment in both
    packages), and, in a batch with a ghost keyword, the ghost-scaled
    biases within 25 % in relative L2."""
    top = max(float(np.abs(w).max()) for w in want.values())
    plain_got, plain_want = {}, {}
    for k, w in want.items():
        if VANISHING in k and k.endswith("['bias']"):
            assert max(np.abs(w).max(), np.abs(got[k]).max()) <= 1e-4 * top, k
        elif ghost_batch and all(part in k for part in GHOST_BIAS):
            assert np.linalg.norm(got[k] - w) <= 0.25 * np.linalg.norm(w), k
        else:
            plain_got[k], plain_want[k] = got[k], w
    _close(plain_got, plain_want, 1e-4, 2e-4, "moment")


def _assert_step(got, want, n_steps, lr_max=2e-3, ghost_batch=False):
    loss, params, stats, opt = got
    _, want_loss, want_params, want_stats, want_opt = want
    assert loss == pytest.approx(want_loss, rel=1e-5, abs=1e-6)
    for which in ("mu", "nu"):
        _assert_moments(_moments(opt, which), _moments(want_opt, which), ghost_batch)
    got_p, want_p = _flat(params), _flat(want_params)
    got_s, want_s = _flat(stats), _flat(want_stats)
    for k in [k for k in want_s if "['time_projector']" in k and k.endswith("['mean']")]:
        # the running mean follows the time-convolution bias, whose noise
        # steps (above) it takes on in full at most
        bias = k.replace("['bn_", "['conv_").replace("['mean']", "['bias']")
        drift = float(np.abs(got_p[bias] - want_p[bias]).max())
        np.testing.assert_allclose(got_s.pop(k), want_s.pop(k), rtol=1e-4, atol=1e-5 + drift,
                                   err_msg=k)
    _close(got_s, want_s, 1e-4, 1e-5, "batch_stats")
    assert got_p.keys() == want_p.keys()
    close = []
    for k, w in want_p.items():
        scale = float(np.abs(w).max()) or 1.0
        diff = np.abs(got_p[k] - w)
        assert diff.max() <= 2 * n_steps * lr_max, (k, diff.max())
        near = diff <= 1e-4 * np.abs(w) + 1e-5 * scale
        if "classifier" in k:
            assert near.all(), k
        close.append(near.ravel())
    assert np.concatenate(close).mean() >= 0.98, np.concatenate(close).mean()


def _has_ghost(batch, coin):
    """Whether the coin's half of ``batch`` holds a ghost keyword: an
    all-zero keyword frame under a mask of 1."""
    sel = 2 * np.arange(coin.shape[0]) + (~coin).astype(int)
    k, m = batch["kwd_features"][sel], batch["kwd_mask"][sel]
    return bool(((np.abs(k).sum(-1) == 0) & (m > 0)).any())


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_two_steps_match_jax(variant, batches, monkeypatch):
    initial, runs = _fp32_steps(variant, batches, monkeypatch)
    _, state, got = _port_steps(variant, initial, runs, batches)
    for i, (g, w) in enumerate(zip(got, runs)):
        _assert_step(g, w, i + 1, ghost_batch=_has_ghost(batches["cache"][i], w[0]))
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert state.model.training
    if variant == "LEF":  # the time projector's statistics moved
        assert "time_projector" in got[-1][2]


def _whisper():
    cfg = JaxWhisperConfig(**WHISPER)
    params = init_whisper_params(np.random.default_rng(SEED), cfg)
    return (cfg, params), (WhisperConfig(**WHISPER), from_jax_whisper_params(params, device="cpu"))


def test_audio_mode_embedding_and_step_match_jax(batches, monkeypatch):
    jax_whisper, port_whisper = _whisper()
    kwargs = dict(whisper=jax_whisper, kws_layer_slice=LAYER_SLICE, utt_frames_budget=FS[1])
    engine, *_ = _jax_engine("LE", batches, monkeypatch, **kwargs)
    b = batches["audio"][0]
    audio, frames = b["utt_audio"][:3], b["utt_frames"][:3]
    want_utt, want_mask = jax.tree.map(np.asarray, _FastJit(jax.jit(engine._embed_raw))(
        engine._whisper_params, jnp.asarray(audio), jnp.asarray(frames)))
    port = pe.EfficientKWSEngine(_PortTiny(**FIELDS, **VARIANTS["LE"]), whisper=port_whisper,
                                 kws_layer_slice=LAYER_SLICE, utt_frames_budget=FS[1], device="cpu")
    utt, mask = port.embed_utterances(torch.from_numpy(audio), torch.from_numpy(frames))
    assert not utt.requires_grad and utt.shape == want_utt.shape == (3, 2, FS[1], WIDTH)
    np.testing.assert_allclose(utt.numpy(), want_utt, rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    for i, n in enumerate(frames):
        if n < FS[1]:
            assert not utt[i, :, n:].any()
        assert mask[i, 0].sum() == min(n, FS[1])
    # one step in the audio mode: the coin picks the audio, the encoder embeds it
    initial, runs = _jax_steps("LE", batches, monkeypatch, mode="audio", n=1, **kwargs)
    _, _, got = _port_steps("LE", initial, runs, batches, mode="audio", whisper=port_whisper)
    assert _has_ghost(batches["audio"][0], runs[0][0])  # the ghost-scaled biases are loose
    _assert_step(got[0], runs[0], 1, ghost_batch=True)


def test_bf16_step_is_within_jax_bf16_distance(batches, monkeypatch):
    _, f32 = _fp32_steps("LE", batches, monkeypatch)
    initial, bf16 = _jax_steps("LE", batches, monkeypatch, n=1, train={"compute_dtype": "bfloat16"})
    _, state, got = _port_steps("LE", initial, bf16, batches, compute_dtype="bfloat16")
    mu_got, mu_want, mu_f32 = (_moments(t, "mu") for t in (got[0][3], bf16[0][4], f32[0][4]))

    def vec(d):
        return np.concatenate([d[k].ravel() for k in sorted(mu_want)])

    a, b, c = vec(mu_got), vec(mu_want), vec(mu_f32)
    cosine = float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))
    assert cosine >= 0.85
    assert np.linalg.norm(a - b) / np.linalg.norm(b) <= 2 * np.linalg.norm(b - c) / np.linalg.norm(c)
    s_got, s_want = _flat(got[0][2]), _flat(bf16[0][3])
    s_gap = np.linalg.norm(np.concatenate([s_got[k].ravel() - s_want[k].ravel() for k in s_want]))
    assert s_gap / np.linalg.norm(np.concatenate([v.ravel() for v in s_want.values()])) <= 0.05
    assert got[0][0] == pytest.approx(bf16[0][1], rel=0.03)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(b.dtype == torch.float32 for b in state.model.buffers() if b.is_floating_point())


def test_adamw_with_weight_decay_matches_optax(batches, monkeypatch):
    train = dict(TRAIN, weight_decay=0.01, max_epochs=3)
    engine, _, params, _, opt_state = _jax_engine("LEF", batches, monkeypatch, train=train)
    port = pe.EfficientKWSEngine(_PortTiny(**FIELDS, **VARIANTS["LEF"]), pe.EfficientTrainConfig(**train),
                                 device="cpu")
    state = port.init_state(batches["cache"][0])
    port.restore_state(state, {"params": params, "batch_stats": _initial("LEF", batches)["batch_stats"]})
    assert isinstance(state.optimizer, torch.optim.AdamW)
    assert [g["name"] for g in state.optimizer.param_groups] == ["resnet", "proj"]
    rng = np.random.default_rng(3)
    update = None
    for epoch in (0, 1):
        opt_state = engine.update_epoch_lr(opt_state, epoch)
        port.update_epoch_lr(state, epoch)
        grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        converted = pe.from_flax_efficient_variables({"params": grads})
        for key, p in state.model.named_parameters():
            p.grad = converted[key].clone()
        if update is None:
            update = _FastJit(jax.jit(engine._tx.update))
        updates, opt_state = update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: np.asarray(p) + np.asarray(u), params, updates)
        state.optimizer.step()
        _close(_flat(to_flax_variables(state.model.state_dict())["params"]), _flat(params), 1e-5, 1e-6,
               f"epoch {epoch}")
    rates = {g["name"]: g["lr"] for g in state.optimizer.param_groups}
    want = serialization.to_state_dict(opt_state)["inner_states"]
    for name in ("resnet", "proj"):
        assert rates[name] == float(np.asarray(want[name]["inner_state"]["hyperparams"]["learning_rate"]))


def test_wider_stacks_load_and_score_as_jax(batches):
    variables = _initial("LE", batches)
    kernel = variables["params"]["projector"]["proj_0_0"]["kernel"]
    assert kernel.shape == (WIDTH, FIELDS["embedding_dim"] // 2)  # wider than embedding_dim
    engine = pe.EfficientKWSEngine(_PortTiny(**FIELDS, **VARIANTS["LE"]), device="cpu")
    assert pm.EfficientKWSModel(engine.model_config).projector.proj_0_0.in_features == FIELDS["embedding_dim"]
    model = engine.build_model(variables)
    assert model.projector.proj_0_0.in_features == WIDTH
    b = batches["cache"][0]
    logits, _ = jm.EfficientKWSModel(_JaxTiny(**FIELDS, **VARIANTS["LE"])).apply(
        variables, *(jnp.asarray(b[k]) for k in ("kwd_features", "utt_features")),
        kwd_mask=jnp.asarray(b["kwd_mask"]), utt_mask=jnp.asarray(b["utt_mask"]))
    want = np.asarray(jax.nn.softmax(logits, -1)[:, 1])
    with torch.no_grad():
        got, _ = model(*(torch.from_numpy(b[k]) for k in ("kwd_features", "utt_features", "kwd_mask",
                                                          "utt_mask")))
    np.testing.assert_allclose(torch.softmax(got, -1)[:, 1].numpy(), want, rtol=1e-4, atol=1e-5)


def test_le_grads_finite_with_zero_padded_frames():
    engine = pe.EfficientKWSEngine(pm.EfficientKWSConfig(n_layers=2, embedding_dim=16, learn_features=True,
                                                         proj_mlp=True, resnet_version="resnet-18"),
                                   device="cpu")
    rng = np.random.default_rng(0)
    kwd = rng.standard_normal((4, 2, 6, 16)).astype(np.float32)
    utt = rng.standard_normal((4, 2, 40, 16)).astype(np.float32)
    kwd[:, :, 3:] = 0.0  # zero-padded frames: zero projections through zero biases
    utt[:, :, 20:] = 0.0
    kwd_mask = np.zeros((4, 2, 6), np.float32)
    kwd_mask[:, :, :3] = 1
    utt_mask = np.zeros((4, 2, 40), np.float32)
    utt_mask[:, :, :20] = 1
    batch = {"kwd_features": kwd, "utt_features": utt, "kwd_mask": kwd_mask, "utt_mask": utt_mask,
             "labels": np.asarray([0, 1, 0, -100])}
    state = engine.init_state(batch)
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    engine.make_train_step(state)({k: torch.from_numpy(v) for k, v in batch.items()}, None)
    assert all(bool(torch.isfinite(p.grad).all()) for p in params)
    assert all(bool(torch.isfinite(p).all()) for p in params)
    assert float(state.model.projector.proj_0_0.weight.grad.abs().sum()) > 0
