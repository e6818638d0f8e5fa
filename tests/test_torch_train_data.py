"""The port's training data layer against the JAX package's, on the CPU.

On the synthetic AISHELL-KWS and MLS layouts of ``tests/fixtures.py``
(``make_aishell_kws``, ``make_mls``; one ghost keyword each):

* ``KWSSampler`` draws bit-equal index streams (numpy RNG, the same seed)
  over several epochs, for ``random`` and ``utterance-examples`` sampling,
  with and without resampling each epoch, on both layouts;
* the training datasets give bit-equal items (AISHELL tts/natural, MLS,
  the ``kw_type='all'`` pairs, ``raw_features``);
* ``KWSDataCollator`` (fixed and batch-max sizes, the multi-keyword ghost
  rewrite), ``RawKWSDataCollator`` and ``HotwordDataCollator`` give
  bit-equal batches, and so does ``KWSDataMod.train_dataloader`` after
  ``setup("fit")``, with the utterance-examples batch rewrite and
  ``device_features``;
* ``resize_matrix_dynamic`` and ``features_from_hidden_states`` match JAX
  at rtol 1e-4 / atol 1e-5 (the JAX package's own tolerance for the fused
  features against the host collator).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from enhance_cb_whisper_tpu.data import collators as jax_collators
from enhance_cb_whisper_tpu.data import datasets as jax_datasets
from enhance_cb_whisper_tpu.data.datamodule import KWSDataMod as JaxDataMod
from enhance_cb_whisper_tpu.data.samplers import KWSSampler as JaxSampler
from enhance_cb_whisper_tpu.ops.resize import features_from_hidden_states as jax_features
from enhance_cb_whisper_tpu.ops.resize import resize_matrix_dynamic as jax_dynamic
from enhance_cb_whisper_tpu_torch.data import collators, datasets
from enhance_cb_whisper_tpu_torch.data.datamodule import KWSDataMod
from enhance_cb_whisper_tpu_torch.data.samplers import KWSSampler
from enhance_cb_whisper_tpu_torch.ops.resize import features_from_hidden_states, resize_matrix_dynamic

from fixtures import make_aishell_kws, make_mls

SIZE = (32, 48)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    aishell = tmp_path_factory.mktemp("aishell")
    make_aishell_kws(str(aishell), n_keywords=12, n_utts=5, ghost=(4,))
    mls = tmp_path_factory.mktemp("mls")
    make_mls(str(mls), languages=("English", "German"), n_keywords=8, n_utts=3, ghost=(3,))
    return {"aishell": str(aishell), "mls": str(mls)}


def _assert_equal(got, want, where=""):
    """Bit-equal items or batches: dicts, tuples, arrays, scalars."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _assert_equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want and type(got) is type(want), where


def _pair(name, root, kw_type, raw=False):
    kwargs = {"raw_features": True} if raw else {}
    if name == "aishell":
        return (datasets.AishellKWSDataset(root, kw_type=kw_type, **kwargs),
                jax_datasets.AishellKWSDataset(root, kw_type=kw_type, **kwargs))
    langs = ("German", "English")
    return (datasets.MLSKWSDataset(root, languages=langs, kw_type=kw_type, **kwargs),
            jax_datasets.MLSKWSDataset(root, languages=langs, kw_type=kw_type, **kwargs))


@pytest.mark.parametrize("name", ["aishell", "mls"])
@pytest.mark.parametrize("sampling, resample", [("random", True), ("utterance-examples", True),
                                                ("random", False)])
def test_sampler_streams_are_bit_equal(roots, name, sampling, resample):
    port_ds, jax_ds = _pair(name, roots[name], "tts")
    port = KWSSampler(port_ds, sampling=sampling, resample_every_epoch=resample, seed=7)
    ref = JaxSampler(jax_ds, sampling=sampling, resample_every_epoch=resample, seed=7)
    assert len(port) == len(ref)
    epochs = [list(port) for _ in range(3)]
    assert epochs == [list(ref) for _ in range(3)]
    assert (epochs[0] == epochs[1]) is (not resample)


@pytest.mark.parametrize("name, kw_type, raw", [
    ("aishell", "tts", False), ("aishell", "natural", False), ("aishell", "tts", True),
    ("mls", "natural", False), ("mls", "tts", True),
])
def test_dataset_items_are_bit_equal(roots, name, kw_type, raw):
    port, ref = _pair(name, roots[name], kw_type, raw)
    assert len(port) == len(ref)
    assert port.ghost_keyword_indices == ref.ghost_keyword_indices
    step = max(1, len(ref) // 17)
    for idx in range(0, len(ref), step):
        _assert_equal(port[idx], ref[idx], f"{name}/{kw_type}[{idx}]")


def test_all_pairs_are_bit_equal(roots):
    port = datasets.ConcatDataset([_pair("aishell", roots["aishell"], t)[0] for t in ("tts", "natural")])
    ref = jax_datasets.ConcatDataset([_pair("aishell", roots["aishell"], t)[1] for t in ("tts", "natural")])
    assert len(port) == len(ref)
    for idx in (0, 5, len(ref) - 1):
        _assert_equal(port[idx], ref[idx], f"all[{idx}]")


def _items(roots, raw=False, n=6):
    port, ref = _pair("aishell", roots["aishell"], "tts", raw)
    return [port[i] for i in range(n)], [ref[i] for i in range(n)]


@pytest.mark.parametrize("size", [SIZE, None])
def test_kws_collator_is_bit_equal(roots, size):
    port_items, ref_items = _items(roots)
    _assert_equal(collators.KWSDataCollator(size)(port_items),
                  jax_collators.KWSDataCollator(size)(ref_items))
    # multi-keyword items: the ghost (mask 0) labels become -100
    multi = [{"features": [it["features"] for it in port_items[:3]], "label": [1, 0, 1],
              "mask": [1, 0, 1], "domain": 0}]
    got = collators.KWSDataCollator(size)(multi)
    _assert_equal(got, jax_collators.KWSDataCollator(size)(multi))
    assert got["labels"].tolist() == [1, -100, 1]


def test_raw_and_hotword_collators_are_bit_equal(roots):
    port_items, ref_items = _items(roots, raw=True)
    _assert_equal(collators.RawKWSDataCollator()(port_items),
                  jax_collators.RawKWSDataCollator()(ref_items))
    pairs = list(zip(port_items[::2], port_items[1::2]))
    _assert_equal(collators.RawKWSDataCollator(bucket_kwd=4, bucket_utt=16)(pairs),
                  jax_collators.RawKWSDataCollator(bucket_kwd=4, bucket_utt=16)(pairs))
    assert collators.HotwordDataCollator()(port_items) is port_items[0]


@pytest.mark.parametrize("kw_type, sampling, device_features", [
    ("tts", "random", False), ("all", "random", False),
    ("natural", "utterance-examples", False), ("tts", "random", True),
])
def test_train_loader_batches_are_bit_equal(roots, kw_type, sampling, device_features):
    args = dict(batch_size=8, sampling=sampling, features_size=SIZE,
                train_info=[{"name": "aishell", "root": roots["aishell"], "kw_type": kw_type}],
                device_features=device_features)
    port, ref = KWSDataMod(**args), JaxDataMod(**args)
    assert port.batch_size == ref.batch_size
    batches = []
    for dm in (port, ref):
        dm.setup("fit")
        batches.append([b for _, b in zip(range(4), dm.train_dataloader())])
    assert len(port.train_dataloader()) == len(ref.train_dataloader())
    assert len(batches[0]) == len(batches[1]) > 0
    for i, (got, want) in enumerate(zip(*batches)):
        _assert_equal(got, want, f"batch {i}")
    assert ("kwd_hs" in batches[0][0]) is device_features


def test_shuffled_loader_follows_the_global_numpy_seed(roots):
    from enhance_cb_whisper_tpu.data.datamodule import DataLoader as JaxLoader
    from enhance_cb_whisper_tpu_torch.data.datamodule import DataLoader

    port_ds, ref_ds = _pair("aishell", roots["aishell"], "tts")
    np.random.seed(3)
    got = [b["labels"] for b in DataLoader(port_ds, 7, collators.KWSDataCollator(SIZE), shuffle=True)]
    np.random.seed(3)
    want = [b["labels"] for b in JaxLoader(ref_ds, 7, jax_collators.KWSDataCollator(SIZE), shuffle=True)]
    _assert_equal(got, want)


@pytest.mark.parametrize("antialias", [False, True])
def test_resize_matrix_dynamic_matches_jax(antialias):
    rng = np.random.default_rng(0)
    t_ins, max_in, t_out = rng.integers(1, 200, 24), 240, 75
    got = resize_matrix_dynamic(torch.from_numpy(t_ins), max_in, t_out, antialias).numpy()
    for row, t_in in zip(got, t_ins):
        want = np.asarray(jax_dynamic(jnp.float32(t_in), max_in, t_out, antialias))
        np.testing.assert_allclose(row, want, rtol=1e-4, atol=1e-5)
        assert row[:, t_in:].max(initial=0.0) == 0.0  # padded frames never leak


def test_features_from_hidden_states_match_jax_and_the_host_collator(roots):
    port_items, ref_items = _items(roots, raw=True)
    raw = jax_collators.RawKWSDataCollator(bucket_kwd=4, bucket_utt=16)(ref_items)
    got = features_from_hidden_states(*(torch.from_numpy(raw[k]) for k in
                                        ("kwd_hs", "utt_hs", "kwd_len", "utt_len")), SIZE).numpy()
    want = np.stack([np.asarray(jax_features(k, u, kl, ul, SIZE)) for k, u, kl, ul in
                     zip(raw["kwd_hs"], raw["utt_hs"], raw["kwd_len"], raw["utt_len"])])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    host = [{**it, "features": np.einsum("lkd,lud->lku", it["kwd_hs"], it["utt_hs"])}
            for it in port_items]
    np.testing.assert_allclose(got, collators.KWSDataCollator(SIZE)(host)["features"],
                               rtol=1e-4, atol=1e-5)
