"""The port's eval datasets and data module against the JAX package's, on
the synthetic AISHELL-hotword and ACL-6060 layouts of ``tests/fixtures.py``
(dev and test splits, ``.npy`` and the reference's torch-pickled ``.bin``
stacks, one ghost keyword each).

Catalogs must be equal (keywords, ``hs``, ``frames``, ``mask``,
``group_size``), and so must every item: transcript, code, audio path,
labels, speaker, mentions, ``utt_hs`` and ``hotword_mask``.  The data
module's ``setup("validate")`` and ``setup("test")`` build the same
datasets (the test one once), its constructor checks the same, and
``setup("fit")`` builds the validation datasets too (the training datasets
are held in ``tests/test_torch_train_data.py``)."""

import os
import shutil

import numpy as np
import pytest

from enhance_cb_whisper_tpu.data.datamodule import KWSDataMod as JaxDataMod
from enhance_cb_whisper_tpu.data.datasets import ACL6060KeywordDataset as JaxACL
from enhance_cb_whisper_tpu.data.datasets import AishellHotwordDataset as JaxAishell
from enhance_cb_whisper_tpu_torch.data.datamodule import KWSDataMod
from enhance_cb_whisper_tpu_torch.data.datasets import ACL6060KeywordDataset, AishellHotwordDataset

from fixtures import make_acl, make_aishell_hotword


@pytest.fixture(scope="module", params=["npy", "bin"])
def roots(request, tmp_path_factory):
    fmt = request.param
    root = str(tmp_path_factory.mktemp(f"eval_{fmt}"))
    make_acl(root, split="eval", fmt=fmt, n_keywords=5, ghost=(2,))
    make_acl(root, split="dev", fmt=fmt, n_keywords=5, ghost=(3,), seed=4)
    # the reference's tag quirks: a capitalized tag that is no keyword is
    # lower-cased, two tags on a line shift the offsets, and a hyphenated
    # tag does not match \w+
    tagged = os.path.join(root, "2", "acl_6060", "eval", "text", "tagged_terminology",
                          "ACL.6060.eval.tagged.en-xx.en.txt")
    with open(tagged) as f:
        lines = f.read().splitlines()
    lines[0] = "the [Term0] and [term1] is [non-term] here"
    with open(tagged, "w") as f:
        f.write("\n".join(lines) + "\n")
    make_aishell_hotword(root, fmt=fmt)
    hw = os.path.join(root, "hotword")
    shutil.copytree(os.path.join(hw, "dev"), os.path.join(hw, "test"))
    return root


def _assert_catalogs_equal(got, want):
    assert got.keywords == want.keywords
    assert got.group_size == want.group_size
    for name in ("hs", "frames", "mask"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _assert_datasets_equal(got, want):
    _assert_catalogs_equal(got.catalog, want.catalog)
    assert got.keywords == want.keywords
    assert len(got) == len(want)
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert sorted(g) == sorted(w), i
        for key, value in w.items():
            if isinstance(value, np.ndarray):
                assert g[key].dtype == value.dtype, key
                np.testing.assert_array_equal(g[key], value, err_msg=key)
            else:
                assert g[key] == value, key


def _make(kind, cls_pair, root, split):
    port_cls, jax_cls = cls_pair
    if kind == "acl":
        kwargs = dict(root=root, split=split, keywords_per_group=2, kw_type="tts", load_audio=True)
    else:
        kwargs = dict(root=os.path.join(root, "hotword"), split=split, hotwords_per_group=2,
                      kw_type="natural", load_audio=True, wav_folder=os.path.join(root, "wav"))
    return port_cls(**kwargs), jax_cls(**kwargs)


@pytest.mark.parametrize("split", ["dev", "test"])
@pytest.mark.parametrize("kind", ["acl", "aishell"])
def test_dataset_matches_jax(roots, kind, split):
    pair = (ACL6060KeywordDataset, JaxACL) if kind == "acl" else (AishellHotwordDataset, JaxAishell)
    got, want = _make(kind, pair, roots, split)
    _assert_datasets_equal(got, want)
    assert want.catalog.mask[: len(want.keywords)].min() == 0  # a ghost keyword is in the catalog
    if kind == "acl":
        labels = np.stack([want[i]["hotword_labels"] for i in range(len(want))])
        assert labels.sum() > 0 and all(want[i]["keywords"] for i in range(len(want)))


def _datamodules(roots, **kwargs):
    infos = dict(
        val_info=[{"name": "aishell", "root": roots, "kw_type": "natural"},
                  {"name": "acl", "root": roots, "kw_type": "tts"}],
        test_info={"name": "acl", "root": roots, "kw_type": "tts"},
    )
    args = dict(batch_size=4, sampling="random", hotwords_per_group=2, features_size=(32, 48))
    args.update(infos)
    args.update(kwargs)
    return KWSDataMod(**args), JaxDataMod(**args)


def test_datamodule_matches_jax(roots):
    port, jax_dm = _datamodules(roots)
    for dm in (port, jax_dm):
        dm.setup("validate")
        dm.setup("test")
    assert list(port.val_dataset) == list(jax_dm.val_dataset) == ["aishell/natural", "acl/tts"]
    for name in jax_dm.val_dataset:
        _assert_datasets_equal(port.val_dataset[name], jax_dm.val_dataset[name])
    _assert_datasets_equal(port.test_dataset, jax_dm.test_dataset)
    first = port.test_dataset
    port.setup("test")
    assert port.test_dataset is first  # built once
    for dm in (port, jax_dm):
        dm.setup("fit")
    assert list(port.val_dataset) == list(jax_dm.val_dataset)
    for name in jax_dm.val_dataset:
        _assert_datasets_equal(port.val_dataset[name], jax_dm.val_dataset[name])


@pytest.mark.parametrize("kwargs, error", [
    (dict(sampling="utterance-examples", batch_size=6), AssertionError),
    (dict(sampling="lexicographic"), NotImplementedError),
    (dict(val_info=[{"name": "mls", "root": ".", "kw_type": "tts"}]), AssertionError),
    (dict(test_info={"name": "mls", "root": ".", "kw_type": "tts"}), AssertionError),
])
def test_datamodule_constructor_checks_match_jax(roots, kwargs, error):
    with pytest.raises(error):
        KWSDataMod(**{**dict(batch_size=4, sampling="random"), **kwargs})
    with pytest.raises(error):
        JaxDataMod(**{**dict(batch_size=4, sampling="random"), **kwargs})


def test_utterance_examples_batch_rewrite_matches_jax(roots, tmp_path):
    os.makedirs(tmp_path / "kws")
    args = dict(batch_size=8, sampling="utterance-examples",
                train_info=[{"name": "aishell", "root": str(tmp_path), "kw_type": "tts"}])
    assert KWSDataMod(**args).batch_size == JaxDataMod(**args).batch_size == 2
