"""The port's paper-2 training data against the JAX package's, on the CPU.

A synthetic MLS layout (``tests/fixtures.py:make_mls``: English and German,
5 keywords with one ghost, 3 utterances, 12-wide stacks, 1-2 s WAVs for the
audio mode) at features_size (32, 64) over the last 2 slabs:

* every ``EfficientMLSKWSDataset`` item equal to JAX's, bit for bit, for
  tts and natural keywords, from the hidden-state caches and in the audio
  mode (the 30 s zero-padded waveform and its valid encoder frames);
* the datamodule's training loader, two epochs of collated batches, equal
  to JAX's for ``natural``, ``tts`` and ``all`` (tts + natural pairs), in
  cache and audio modes, under utterance-examples sampling;
* the constructor's asserts as JAX's; the batch-size check of
  utterance-examples sampling at ``setup("fit")`` (JAX checks it in the
  constructor, and so refuses the eval configs);
* the cosine schedule per epoch equal to JAX's float32 rate, bit for bit.
"""

import numpy as np
import pytest
import torch

from enhance_cb_whisper_tpu.efficient_kws import data as jd
from enhance_cb_whisper_tpu.train import optim as jax_optim
from enhance_cb_whisper_tpu_torch.efficient_kws import data as pd
from enhance_cb_whisper_tpu_torch.train import optim as port_optim

from fixtures import make_mls

LANGS = ("English", "German")
FS = (32, 64)
WIDTH = 12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("mls")
    make_mls(str(root), languages=LANGS, with_audio=True, dim=WIDTH)
    return str(root)


def _same(got, want, where):
    assert got.keys() == want.keys(), where
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (where, k)
        np.testing.assert_array_equal(g, w, err_msg=f"{where} {k}")


@pytest.mark.parametrize("kw_type,load_embeddings", [("natural", True), ("tts", True),
                                                     ("natural", False)],
                         ids=["natural-cache", "tts-cache", "natural-audio"])
def test_mls_items_match_jax(root, kw_type, load_embeddings):
    args = dict(languages=LANGS, kw_type=kw_type, features_size=FS, n_layers=2,
                load_embeddings=load_embeddings)
    port, jax_ds = pd.EfficientMLSKWSDataset(root, **args), jd.EfficientMLSKWSDataset(root, **args)
    assert len(port) == len(jax_ds) == 2 * 3 * 10
    assert (port.n_channels, port.hidden_dim) == (jax_ds.n_channels, jax_ds.hidden_dim) == (3, WIDTH)
    for i in range(len(jax_ds)):
        _same(port[i], jax_ds[i], f"item {i}")
    item = port[3]  # English keyword 3 is a ghost: a zero stand-in, masked
    assert item["mask"] == 0 and not item["kwd_features"].any()
    if not load_embeddings:
        assert item["utt_audio"].shape == (480000,) and 0 < item["utt_frames"] <= 1500


def _datamodule(module, root, kw_type, load_embeddings, **extra):
    return module.EfficientKWSDataMod(
        batch_size=4, sampling="utterance-examples", features_size=FS, n_layers=2,
        languages=list(LANGS), keywords_per_group=2, load_embeddings=load_embeddings,
        learn_features=True, kws_whisper_ckpt="unused",
        train_info=[{"name": "mls", "root": root, "kw_type": kw_type}], **extra)


@pytest.mark.parametrize("kw_type,load_embeddings", [("natural", True), ("tts", True), ("all", True),
                                                     ("all", False)],
                         ids=["natural-cache", "tts-cache", "all-cache", "all-audio"])
def test_train_loader_streams_match_jax(root, kw_type, load_embeddings):
    """Two epochs of the training loader (the sampler resamples each
    epoch), as ``fit`` draws them: one loader for the first batch, then one
    per epoch."""
    port = _datamodule(pd, root, kw_type, load_embeddings)
    jax_dm = _datamodule(jd, root, kw_type, load_embeddings)
    port.setup("fit")
    jax_dm.setup("fit")
    assert type(port.fit_dataset).__name__ == type(jax_dm.fit_dataset).__name__
    streams = []
    for dm in (port, jax_dm):
        batches = [next(iter(dm.train_dataloader()))]
        for _ in range(2):
            batches += list(dm.train_dataloader())
        streams.append(batches)
    assert len(streams[0]) == len(streams[1]) > 3
    for i, (got, want) in enumerate(zip(*streams)):
        _same(got, want, f"batch {i}")
    first = streams[0][0]
    # a kw_type 'all' batch holds each (tts, natural) pair side by side
    assert first["labels"].shape == ((8,) if kw_type == "all" else (4,))
    keys = {"utt_audio", "utt_frames"} if not load_embeddings else {"utt_features", "utt_mask"}
    assert keys <= set(first)


def test_datamodule_asserts_match_jax(root):
    for module in (pd, jd):
        with pytest.raises(AssertionError, match="learn_features"):
            module.EfficientKWSDataMod(batch_size=4, load_embeddings=False, learn_features=False,
                                       kws_whisper_ckpt="x")
        with pytest.raises(AssertionError, match="kws_whisper_ckpt"):
            module.EfficientKWSDataMod(batch_size=4, load_embeddings=False, learn_features=True)
    info = [{"name": "mls", "root": root, "kw_type": "natural"}]
    # utterance-examples batches come in blocks of 4: JAX refuses the batch
    # size when it is built, the port when training asks for batches
    with pytest.raises(AssertionError):
        jd.EfficientKWSDataMod(batch_size=6, train_info=info)
    port = pd.EfficientKWSDataMod(batch_size=6, train_info=info, languages=list(LANGS))
    with pytest.raises(AssertionError, match="multiple of 4"):
        port.setup("fit")
    random = pd.EfficientKWSDataMod(batch_size=6, sampling="random", train_info=info,
                                    languages=list(LANGS), features_size=FS)
    random.setup("fit")
    assert next(iter(random.train_dataloader()))["labels"].shape == (6,)


@pytest.mark.parametrize("t_max", [1, 3, 7, 200])
def test_cosine_schedule_is_jax_float32(t_max):
    for base in (1e-4, 3e-4, 1.0):
        for epoch in range(min(t_max, 60) + 2):
            want = np.asarray(jax_optim.cosine_lr(base, t_max)(epoch))
            got = port_optim.cosine_lr(base, t_max)(epoch)
            assert want.dtype == np.float32
            assert got == float(want), (base, t_max, epoch)
    # the last epochs sit at eta_min
    assert port_optim.cosine_lr(1e-4, t_max)(t_max) == float(np.float32(1e-6))
