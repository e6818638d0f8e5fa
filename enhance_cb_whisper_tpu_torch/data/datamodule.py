"""The eval half of the KWS data module (port of
enhance_cb_whisper_tpu/data/datamodule.py).

:class:`KWSDataMod` keeps the reference constructor's checks —
``train_info`` / ``val_info`` / ``test_info`` dataset descriptors,
``features_size``, ``hotwords_per_group``, the utterance-examples batch-size
/4 rewrite — and builds the validation and test datasets in
``setup("validate" | "test")``.  The training datasets, sampler and
collators, and the constructor options that only they read, wait for the
training slice (the CLI's ``filter_kwargs`` drops such options from a
config): ``setup("fit")`` raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

from .datasets import ACL6060KeywordDataset, AishellHotwordDataset


@dataclasses.dataclass
class DatasetInfo:
    name: str
    root: str
    kw_type: str


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
        if stage in ("fit", None):
            raise NotImplementedError(
                "KWS training data (setup('fit')) is not ported yet: ROADMAP.md §1 item 5"
            )
        if stage == "validate":
            self.val_dataset = {
                f"{ds.name}/{ds.kw_type}": self._make_val_dataset(ds) for ds in self.val_info
            }
        if (
            stage == "test"
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
