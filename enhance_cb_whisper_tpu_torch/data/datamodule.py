"""The KWS data module and loader (port of
enhance_cb_whisper_tpu/data/datamodule.py).

:class:`KWSDataMod` keeps the reference constructor's checks —
``train_info`` / ``val_info`` / ``test_info`` dataset descriptors,
``features_size``, ``hotwords_per_group``, the utterance-examples batch-size
/4 rewrite — and builds the training pairs, their sampler and collator in
``setup("fit")`` (with the validation datasets), the validation datasets
in ``setup("validate")`` and the test dataset in ``setup("test")``.
``device_features`` makes the training batches raw hidden-state stacks
(:class:`.collators.RawKWSDataCollator`) whose features the train step
computes on the device.  The options the JAX module accepts and never
reads (``num_workers``, ``whisper_ckpt``, ``max_duration``) are not taken:
the CLI's ``filter_kwargs`` drops them from a config.

:class:`DataLoader` is the JAX package's single-process loader: sampler
(or a shuffle by the global numpy RNG, which the CLI seeds) + collate.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from .collators import HotwordDataCollator, KWSDataCollator, RawKWSDataCollator
from .datasets import (
    ACL6060KeywordDataset,
    AishellHotwordDataset,
    AishellKWSDataset,
    ConcatDataset,
    MLSKWSDataset,
)
from .samplers import KWSSampler

MLS_LANGUAGES = ["English", "German", "French", "Spanish", "Polish", "Portuguese"]


@dataclasses.dataclass
class DatasetInfo:
    name: str
    root: str
    kw_type: str


class DataLoader:
    """Minimal map-style loader: iterate the sampler (or range), batch,
    collate."""

    def __init__(self, dataset, batch_size=1, collate_fn=None, sampler=None, shuffle=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or (lambda x: x)
        self.sampler = sampler
        self.shuffle = shuffle

    def __iter__(self):
        if self.sampler is not None:
            indices = iter(self.sampler)
        elif self.shuffle:
            # the global numpy RNG, so the CLI's seed governs the order
            indices = iter(np.random.permutation(len(self.dataset)).tolist())
        else:
            indices = iter(range(len(self.dataset)))
        batch = []
        for idx in indices:
            batch.append(self.dataset[idx])
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch:
            yield self.collate_fn(batch)

    def __len__(self):
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        return (n + self.batch_size - 1) // self.batch_size


def _as_info(info) -> DatasetInfo:
    if isinstance(info, DatasetInfo):
        return info
    if isinstance(info, dict):
        return DatasetInfo(**info)
    raise TypeError(f"cannot build DatasetInfo from {info!r}")


class KWSDataMod:
    def __init__(
        self,
        batch_size: int,
        sampling: str,
        train_info: Optional[Sequence] = None,
        val_info: Optional[Sequence] = None,
        test_info=None,
        hotwords_per_group: int = 100,
        features_size: Optional[Tuple[int, int]] = None,
        test_split: str = "test",
        resample_every_epoch: bool = True,
        device_features: bool = False,
    ):
        self.features_size = features_size
        self.batch_size = batch_size
        self.sampling = sampling
        self.hotwords_per_group = hotwords_per_group
        self.train_info = [_as_info(i) for i in (train_info or [])]
        self.val_info = [_as_info(i) for i in (val_info or [])]
        self.test_info = _as_info(test_info) if test_info is not None else None
        self.test_split = test_split

        if self.sampling == "utterance-examples":
            assert self.batch_size % 4 == 0, (
                "when loading all positive and negative examples in the same "
                f"batch, the batch size must be a multiple of 4, got {self.batch_size}"
            )
            if self.train_info and self.train_info[0].name == "aishell":
                self.batch_size = self.batch_size // 4
        elif self.sampling != "random":
            raise NotImplementedError(f"sampling method not implemented: {self.sampling}")

        if self.train_info:
            assert not set(ds.name for ds in self.train_info) - {"aishell", "mls"}
            assert all(os.path.isdir(ds.root) for ds in self.train_info)
            if len(self.train_info) > 1:
                raise NotImplementedError("training with more than one dataset is not supported")
        assert not set(ds.name for ds in self.val_info) - {"aishell", "acl"}
        if self.test_info is not None:
            assert self.test_info.name in ("aishell", "acl")

        self.resample_every_epoch = resample_every_epoch
        self.device_features = device_features
        self.collate_fn1 = RawKWSDataCollator() if device_features else KWSDataCollator(size=features_size)
        self.collate_fn2 = HotwordDataCollator()

    def _make_val_dataset(self, ds: DatasetInfo):
        if ds.name == "aishell":
            return AishellHotwordDataset(
                root=os.path.join(ds.root, "hotword"),
                split="dev",
                size=self.features_size,
                r1_only=False,
                hotwords_per_group=self.hotwords_per_group,
                kw_type=ds.kw_type,
            )
        return ACL6060KeywordDataset(
            root=ds.root,
            split="dev",
            size=self.features_size,
            keywords_per_group=self.hotwords_per_group,
            kw_type=ds.kw_type,
        )

    def setup(self, stage=None):
        if stage in ("fit", "validate", None):
            self.val_dataset = {
                f"{ds.name}/{ds.kw_type}": self._make_val_dataset(ds) for ds in self.val_info
            }
        if stage in ("fit", None) and self.train_info:
            info = self.train_info[0]
            dataset_cls = AishellKWSDataset if info.name == "aishell" else MLSKWSDataset

            def make(kw_type):
                raw = {"raw_features": True} if self.device_features else {}
                if info.name == "aishell":
                    return dataset_cls(root=info.root, kw_type=kw_type, **raw)
                return dataset_cls(root=info.root, languages=MLS_LANGUAGES, kw_type=kw_type, **raw)

            if info.kw_type != "all":
                self.fit_dataset = make(info.kw_type)
                sampler_source = self.fit_dataset
            else:
                self.fit_dataset = ConcatDataset([make("tts"), make("natural")])
                sampler_source = self.fit_dataset.datasets[0]
            self.sampler = KWSSampler(
                data_source=sampler_source,
                sampling=self.sampling,
                negative_examples={"random": 1, "lexicographic": 2},
                resample_every_epoch=self.resample_every_epoch,
            )
        if (
            stage in ("test", None)
            and self.test_info is not None
            and getattr(self, "test_dataset", None) is None
        ):
            # idempotent: the int8-calibration path calls setup("test")
            # before the engine's test() does, and a rebuild would reload
            # the whole keyword catalog and miss the engine's device cache
            info = self.test_info
            if info.name == "aishell":
                self.test_dataset = AishellHotwordDataset(
                    root=os.path.join(info.root, "hotword"),
                    split=self.test_split,
                    size=self.features_size,
                    r1_only=False,
                    hotwords_per_group=self.hotwords_per_group,
                    kw_type=info.kw_type,
                    load_audio=True,
                    wav_folder=os.path.join(info.root, "wav"),
                )
            else:
                self.test_dataset = ACL6060KeywordDataset(
                    root=info.root,
                    split=self.test_split,
                    size=self.features_size,
                    keywords_per_group=self.hotwords_per_group,
                    kw_type=info.kw_type,
                    load_audio=True,
                )

    def train_dataloader(self):
        return DataLoader(self.fit_dataset, batch_size=self.batch_size,
                          collate_fn=self.collate_fn1, sampler=self.sampler)

    def val_dataloader(self):
        return [DataLoader(dataset, batch_size=1, collate_fn=self.collate_fn2)
                for dataset in self.val_dataset.values()]

    def test_dataloader(self):
        return DataLoader(self.test_dataset, batch_size=1, collate_fn=self.collate_fn2)
