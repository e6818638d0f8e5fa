"""Paper-2 data layer (port of enhance_cb_whisper_tpu/efficient_kws/data.py).

Items carry padded hidden-state stacks and 0/1 frame masks, not
similarity maps, so the (learned) projections run inside the model:

* keyword side padded or truncated to ``features_size[0]`` frames,
  utterance side to ``features_size[1]``;
* the layer slice ``[-n_layers:]``;
* ``pad_long_before_resize=True`` zero-pads with masks; False truncates
  with all-ones masks.

Training reads the MLS pairs (:class:`EfficientMLSKWSDataset`: a keyword's
stack against an utterance's, labelled by the utterance's positives and
its language) through the paper-1 sampler; with ``load_embeddings=False``
an item carries the utterance as a 30 s zero-padded waveform and its valid
encoder frame count instead, for the engine to embed inside the step.  The
eval datasets (:class:`MLSEvaluationDataset`, and the ACL-6060 and AISHELL
forks of the paper-1 eval datasets) hold the keyword DB as pre-padded
groups with ghost keywords zero-filled and masked.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence, Tuple

import numpy as np

from ..catalog.store import hidden_states_exist, load_hidden_states
from ..data.datasets import (
    ACL6060KeywordDataset,
    AishellHotwordDataset,
    ConcatDataset,
    MLSKWSDataset,
    _read_lines,
)
from ..data.samplers import KWSSampler

LONG_MAX_LENGTH = 1500  # dataset.py:29


def pad_or_truncate(hs: np.ndarray, target: int, pad: bool, n_layers: int):
    """Returns (features [n_layers, target_or_less, D], mask) with the
    reference's pad/truncate + layer-slice semantics."""
    if target - hs.shape[1] >= 0 and pad:
        t = hs.shape[1]
        mask = np.concatenate(
            [np.ones((hs.shape[0], t), np.float32),
             np.zeros((hs.shape[0], target - t), np.float32)],
            axis=1,
        )
        hs = np.concatenate(
            [hs, np.zeros((hs.shape[0], target - t, hs.shape[2]), hs.dtype)], axis=1
        )
    else:
        hs = hs[:, :target, :]
        mask = np.ones((hs.shape[0], hs.shape[1]), np.float32)
    return hs[-n_layers:], mask[-n_layers:]


class EfficientMLSKWSDataset(MLSKWSDataset):
    """The MLS training pairs as raw embeddings and masks
    (dataset.py:210-606)."""

    def __init__(
        self,
        root: str,
        languages: Sequence[str] = (
            "English", "French", "German", "Polish", "Portuguese", "Spanish",
        ),
        kw_type: str = "natural",
        features_size: Tuple[int, int] = (150, 1500),
        n_layers: int = 3,
        pad_long_before_resize: bool = True,
        n_channels: int = 12,
        hidden_dim: int = 1024,
        load_embeddings: bool = True,
    ):
        super().__init__(root, languages, kw_type)
        self.features_size = tuple(features_size)
        self.n_layers = n_layers
        self.pad_long_before_resize = pad_long_before_resize
        self.n_channels = n_channels
        self.hidden_dim = hidden_dim
        self.load_embeddings = load_embeddings
        # the ghost stand-in takes the shape of a real cache (the reference
        # hard-codes (12, 1024))
        for lang in self.languages:
            real = [i for i in range(len(self.keywords[lang]))
                    if i not in self.ghost_keyword_indices[lang]]
            if real:
                s = load_hidden_states(self._kw_path(lang, real[0]))
                self.n_channels, self.hidden_dim = s.shape[0], s.shape[2]
                break

    def __getitem__(self, idx):
        submeta, data, keyword_idx, kw_lang = self._locate(idx)
        mask = 0 if keyword_idx in self.ghost_keyword_indices[kw_lang] else 1
        if mask:
            kwd = load_hidden_states(self._kw_path(kw_lang, keyword_idx))
        else:
            kwd = np.zeros((self.n_channels, 1, self.hidden_dim), np.float32)
        kwd_f, kwd_m = pad_or_truncate(kwd, self.features_size[0], self.pad_long_before_resize,
                                       self.n_layers)
        label = int(any(keyword_idx == p for _, p, _ in data["positives"])
                    and submeta["language"] == kw_lang)
        item = {
            "label": label,
            "mask": mask,
            "domain": (0 if self.kw_type == "tts" else len(self.languages))
            + self.languages.index(submeta["language"]),
            "idx": idx,  # carried for parity (dataset.py:575); the collator skips it
            "kwd_features": kwd_f,
            "kwd_mask": kwd_m,
        }
        root = self.roots[submeta["language"]]
        if self.load_embeddings:
            utt = load_hidden_states(os.path.join(root, "hs", data["code"] + ".bin"))
            item["utt_features"], item["utt_mask"] = pad_or_truncate(
                utt, self.features_size[1], self.pad_long_before_resize, self.n_layers)
        else:
            item["utt_audio"], item["utt_frames"] = self._load_utterance_audio(root, data["code"])
        return item

    @staticmethod
    def _load_utterance_audio(root: str, code: str):
        """The 30 s zero-padded waveform and its valid encoder frame count,
        ``ceil((unpadded samples // 160) / 2)`` (reference utils.py:187),
        from ``audio/{spk}/{book}/{code}.{opus,wav,mp3,flac}``.  Only WAV
        decodes (:func:`..audio.io.load_audio_16k`); another format raises."""
        import re

        from ..audio.io import load_audio_16k
        from ..ops.mel import HOP_LENGTH, N_SAMPLES

        m = re.match(r"(?P<f1>\d+)_(?P<f2>\d+)_\d+", code)
        base = os.path.join(root, "audio", m.group("f1"), m.group("f2"), code)
        for ext in (".opus", ".wav", ".mp3", ".flac"):
            if os.path.exists(base + ext):
                wav = load_audio_16k(base + ext)
                break
        else:
            raise FileNotFoundError(f"no audio for {code} under {root}/audio")
        wav = wav[:N_SAMPLES]
        frames = int(np.ceil((wav.shape[0] // HOP_LENGTH) / 2.0))
        padded = np.zeros((N_SAMPLES,), np.float32)
        padded[: wav.shape[0]] = wav
        return padded, frames


class _EfficientGroupedEval:
    """Shared grouped-keyword eval structure: pre-padded kwd groups + masks."""

    def _build_groups(self, keywords, kw_dir, group_size, size0, pad, n_layers):
        zfill = len(str(len(keywords) - 1))
        stacks, ghosts = [], []
        for idx in range(len(keywords)):
            path = os.path.join(kw_dir, str(idx).zfill(zfill) + ".bin")
            if hidden_states_exist(path):
                stacks.append(load_hidden_states(path))
            else:
                stacks.append(None)
                ghosts.append(idx)
        smallest = min((s for s in stacks if s is not None), key=lambda s: s.shape[1])
        for idx in ghosts:
            stacks[idx] = np.zeros_like(smallest)

        group = len(keywords) if group_size == -1 else group_size
        self.keywords_per_group = group
        self.groups = []
        for i in range(0, len(keywords), group):
            kwds, masks = [], []
            for s in stacks[i : i + group]:
                f, m = pad_or_truncate(s, size0, pad, n_layers)
                kwds.append(f)
                masks.append(m)
            if len({f.shape for f in kwds}) > 1:
                # pad_long_before_resize=False keeps PER-KEYWORD truncated
                # lengths (dataset.py:811-813); the reference's own eval then
                # crashes at `torch.stack(batch['kwd'][i])`
                # (efficient_kws/model.py:314-317), so ragged groups are not
                # a supported configuration in either implementation — fail
                # with a diagnosis instead of an opaque stack error
                raise ValueError(
                    "pad_long_before_resize=False produced ragged keyword "
                    f"lengths {sorted({f.shape[1] for f in kwds})} in group "
                    f"{i // group}; grouped evaluation requires uniform "
                    "lengths (use pad_long_before_resize=True, or ensure "
                    "every keyword has >= features_size[0] frames)"
                )
            self.groups.append(
                {
                    "keywords": keywords[i : i + group],
                    "kwd": np.stack(kwds),
                    "kwd_mask": np.stack(masks),
                    "mask": np.asarray(
                        [0 if idx in ghosts else 1 for idx in range(i, min(i + group, len(keywords)))],
                        np.float32,
                    ),
                }
            )


class MLSEvaluationDataset(_EfficientGroupedEval):
    """Grouped keyword DB over an MLS dev split (dataset.py:609-1156)."""

    def __init__(
        self,
        root: str,
        language: str,
        split: str = "dev",
        kw_type: str = "natural",
        size: Tuple[int, int] = (150, 1500),
        keywords_per_group: int = -1,
        n_layers: int = 3,
        pad_long_before_resize: bool = True,
        root_audios_transcripts: str = "",
        **_,
    ):
        assert split == "dev", f"the split is not supported, got: {split}"
        assert kw_type in ("tts", "natural")
        self.split_folder = os.path.join(root, "mls_" + language.lower() + "_opus", split)
        self.language = language
        self.size = tuple(size)
        self.n_layers = n_layers
        self.root_audios_transcripts = root_audios_transcripts

        self.keywords = [
            line.strip() for line in _read_lines(os.path.join(self.split_folder, "keywords.txt"))
        ]
        self._build_groups(
            self.keywords,
            os.path.join(self.split_folder, "keywords-hs", kw_type),
            keywords_per_group,
            self.size[0],
            pad_long_before_resize,
            n_layers,
        )
        self.pad_long_before_resize = pad_long_before_resize

        path = (
            os.path.join(root_audios_transcripts, "mls_" + language.lower() + "_opus", split)
            if self.is_expanded()
            else self.split_folder
        )
        uttid = set(line.strip() for line in _read_lines(os.path.join(path, "uttid")))
        transcripts = {}
        for line in _read_lines(os.path.join(path, "transcripts.txt")):
            code = line.split("\t")[0].strip()
            if code in uttid:
                transcripts[code] = line.split("\t")[1].strip()
        mentions = {}
        for line in _read_lines(os.path.join(path, "positives.tsv")):
            parts = line.split("\t")
            code = parts[0].strip()
            mentions[code] = [
                {
                    "mention": parts[i].strip(),
                    "total_offset": int(parts[i + 1].strip()),
                    "end_offset": int(parts[i + 2].strip()),
                }
                for i in range(1, len(parts), 3)
            ]

        group = self.keywords_per_group
        self.dataset = [
            {
                "code": code,
                "transcript": transcript,
                "hs_path": os.path.join(path, "hs", code + ".bin"),
                "hotword_labels": np.asarray(
                    [
                        1 if kw in [m["mention"] for m in mentions[code]] else 0
                        for kw in self.keywords
                    ],
                    np.int64,
                ),
                "keywords": mentions[code],
            }
            for code, transcript in transcripts.items()
        ]

    def is_expanded(self) -> bool:
        return self.root_audios_transcripts != ""

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        item = dict(self.dataset[idx])
        hs = load_hidden_states(item.pop("hs_path"))
        utt, utt_mask = pad_or_truncate(
            hs, self.size[1], self.pad_long_before_resize, self.n_layers
        )
        item["utt"] = utt
        item["utt_mask"] = utt_mask
        item["hotword_mask"] = np.concatenate([g["mask"] for g in self.groups])[
            : len(self.keywords)
        ]
        item["groups"] = self.groups
        return item


class _EvalForkMixin(_EfficientGroupedEval):
    """Adapts the paper-1 eval datasets to the raw-embeddings interface
    (dataset.py:1159-2114 — the eval forks)."""

    def _efficient_init(self, kw_dir, size, keywords_per_group, n_layers, pad):
        self.size = tuple(size)
        self.n_layers = n_layers
        self.pad_long_before_resize = pad
        self._build_groups(self.keywords, kw_dir, keywords_per_group, size[0], pad, n_layers)

    def __getitem__(self, idx):
        item = dict(self.dataset[idx])
        hs = load_hidden_states(item.pop("hs_path"))
        utt, utt_mask = pad_or_truncate(
            hs, self.size[1], self.pad_long_before_resize, self.n_layers
        )
        item["utt"] = utt
        item["utt_mask"] = utt_mask
        item["hotword_mask"] = np.concatenate([g["mask"] for g in self.groups])[
            : len(self.keywords)
        ]
        item["groups"] = self.groups
        return item

    def is_expanded(self) -> bool:
        return False


class EfficientAishellHotwordDataset(_EvalForkMixin, AishellHotwordDataset):
    def __init__(self, root, split="dev", size=(150, 1500), hotwords_per_group=-1,
                 kw_type="natural", n_layers=3, pad_long_before_resize=True,
                 load_audio=False, wav_folder=None, r1_only=False):
        AishellHotwordDataset.__init__(
            self, root, split=split, r1_only=r1_only, size=None,
            hotwords_per_group=hotwords_per_group, kw_type=kw_type,
            load_audio=load_audio, wav_folder=wav_folder,
        )
        self._efficient_init(
            os.path.join(self.split_folder, "keywords-hs", kw_type),
            size, hotwords_per_group, n_layers, pad_long_before_resize,
        )


class EfficientACL6060KeywordDataset(_EvalForkMixin, ACL6060KeywordDataset):
    def __init__(self, root, split="dev", size=(150, 1500), keywords_per_group=-1,
                 kw_type="natural", n_layers=3, pad_long_before_resize=True,
                 load_audio=False):
        ACL6060KeywordDataset.__init__(
            self, root, split=split, size=None, keywords_per_group=keywords_per_group,
            kw_type=kw_type, load_audio=load_audio,
        )
        self._efficient_init(
            os.path.join(self.split_folder, "keywords-hs", kw_type),
            size, keywords_per_group, n_layers, pad_long_before_resize,
        )


class EfficientKWSDataCollator:
    """Stack every tensor key (data_collator.py:5-54)."""

    def __call__(self, features):
        if isinstance(features[0], tuple):
            features = [item for pair in features for item in pair]
        batch = {}
        keys = ("kwd_features", "kwd_mask") + (
            ("utt_features", "utt_mask")
            if "utt_features" in features[0]
            else ("utt_audio", "utt_frames")  # audio mode
        )
        for key in keys:
            batch[key] = np.stack([f[key] for f in features])
        # labels verbatim — the reference collator excludes 'mask' from the
        # batch and never applies it (efficient_kws/data_collator.py:35-43);
        # the sampler rejects ghost keywords, so none reach training batches
        batch["labels"] = np.asarray([f["label"] for f in features], np.int64)
        if features[0].get("domain") is not None:
            batch["domain"] = np.asarray([f["domain"] for f in features], np.int64)
        return batch


MLS_LANGUAGES = ["English", "German", "French", "Spanish", "Polish", "Portuguese"]


class EfficientKWSDataMod:
    """Paper-2 data module (data_module.py:31-387): the MLS training pairs
    (tts, natural, or both for ``kw_type: all``), 12 per-language MLS
    validation datasets (tts + natural × languages) and the AISHELL or
    ACL-6060 test set.  ``batch_size % 4 == 0`` under utterance-examples
    sampling is checked at ``setup("fit")``, where the JAX package checks
    it in the constructor and so refuses the eval configs (they leave the
    batch size at the model's default of 1)."""

    def __init__(
        self,
        batch_size: int,
        sampling: str = "utterance-examples",
        train_info=None,
        val_info=None,
        test_info=None,
        features_size: Tuple[int, int] = (150, 1500),
        n_layers: int = 3,
        pad_long_before_resize: bool = True,
        keywords_per_group: int = 50,
        resample_every_epoch: bool = True,
        languages: Sequence[str] = tuple(MLS_LANGUAGES),
        test_split: str = "test",
        learn_features: bool = False,
        load_embeddings: bool = True,
        kws_whisper_ckpt=None,
        **kwargs,
    ):
        # reference data_module.py:72-77 contract
        assert load_embeddings or learn_features, (
            "when not loading pre-computed utterance embeddings, "
            "`learn_features` must be set to `True`"
        )
        assert load_embeddings or kws_whisper_ckpt is not None, (
            "when not loading pre-computed utterance embeddings, "
            "`kws_whisper_ckpt` must be assigned"
        )
        self.load_embeddings = load_embeddings
        self.kws_whisper_ckpt = kws_whisper_ckpt
        self.batch_size = batch_size
        self.sampling = sampling
        self.train_info = train_info or []
        self.val_info = val_info or []
        self.test_info = test_info
        self.features_size = tuple(features_size)
        self.n_layers = n_layers
        self.pad_long_before_resize = pad_long_before_resize
        self.keywords_per_group = keywords_per_group
        self.resample_every_epoch = resample_every_epoch
        self.languages = list(languages)
        self.test_split = test_split
        self.collate_fn = EfficientKWSDataCollator()

    def _train_dataset(self, root, kw_type):
        return EfficientMLSKWSDataset(
            root=root,
            languages=self.languages,
            kw_type=kw_type,
            features_size=self.features_size,
            n_layers=self.n_layers,
            pad_long_before_resize=self.pad_long_before_resize,
            load_embeddings=self.load_embeddings,
        )

    def setup(self, stage=None):
        from ..data.datamodule import DataLoader, _as_info

        self._loader_cls = DataLoader
        if stage in ("fit", None) and self.train_info:
            if self.sampling == "utterance-examples":
                assert self.batch_size % 4 == 0, (
                    f"utterance-examples sampling takes batches of a multiple of 4, got {self.batch_size}")
            info = _as_info(self.train_info[0])
            if info.kw_type != "all":
                self.fit_dataset = self._train_dataset(info.root, info.kw_type)
                sampler_source = self.fit_dataset
            else:
                self.fit_dataset = ConcatDataset(
                    [self._train_dataset(info.root, t) for t in ("tts", "natural")])
                sampler_source = self.fit_dataset.datasets[0]
            self.sampler = KWSSampler(sampler_source, sampling=self.sampling,
                                      resample_every_epoch=self.resample_every_epoch)

        if stage in ("fit", "validate", None) and self.val_info:
            self.val_dataset = {}
            for raw in self.val_info:
                info = raw if isinstance(raw, dict) else dataclasses.asdict(_as_info(raw))
                key = f"{info.get('language', info.get('name'))}/{info['kw_type']}"
                # the expanded (100k-catalog) configs list a plain AND an
                # expanded entry per (language, kw_type) — disambiguate so
                # neither silently overwrites the other (the engine consumes
                # .values() in config order, like Lightning's loader list)
                if key in self.val_dataset:
                    key = f"{key}#{sum(k.split('#')[0] == key for k in self.val_dataset)}"
                self.val_dataset[key] = MLSEvaluationDataset(
                    root=info["root"],
                    language=info["language"],
                    kw_type=info["kw_type"],
                    size=self.features_size,
                    keywords_per_group=self.keywords_per_group,
                    n_layers=self.n_layers,
                    pad_long_before_resize=self.pad_long_before_resize,
                    root_audios_transcripts=info.get("root_audios_transcripts", ""),
                )

        if (
            stage in ("test", None)
            and self.test_info is not None
            and getattr(self, "test_dataset", None) is None
        ):
            # idempotent (see data/datamodule.py): the int8-calibration CLI
            # path calls setup("test") before engine.test() does
            info = self.test_info if isinstance(self.test_info, dict) else dataclasses.asdict(
                _as_info(self.test_info)
            )
            common = dict(
                size=self.features_size,
                kw_type=info["kw_type"],
                n_layers=self.n_layers,
                pad_long_before_resize=self.pad_long_before_resize,
            )
            if info["name"] == "aishell":
                self.test_dataset = EfficientAishellHotwordDataset(
                    root=os.path.join(info["root"], "hotword"),
                    split=self.test_split,
                    hotwords_per_group=self.keywords_per_group,
                    **common,
                )
            else:
                self.test_dataset = EfficientACL6060KeywordDataset(
                    root=info["root"],
                    split=self.test_split,
                    keywords_per_group=self.keywords_per_group,
                    **common,
                )

    def train_dataloader(self):
        return self._loader_cls(self.fit_dataset, batch_size=self.batch_size,
                                collate_fn=self.collate_fn, sampler=self.sampler)

    def val_dataloader(self):
        return [
            self._loader_cls(ds, batch_size=1, collate_fn=lambda x: x[0])
            for ds in self.val_dataset.values()
        ]

    def test_dataloader(self):
        return self._loader_cls(self.test_dataset, batch_size=1, collate_fn=lambda x: x[0])


def chunk_stride(
    features: np.ndarray,  # [n_layers, T, D]
    mask: np.ndarray,  # [n_layers, T]
    ctx_window: int,
    chunk_size: int,
    condensed_dimension: str = "time",
):
    """Chunk-striding infrastructure for sequence condensers
    (``process_keyword``/``process_utterance``, reference dataset.py:43-207):
    pad/truncate to ``ctx_window``, then unfold either the time or the
    embedding dimension into non-overlapping chunks with positional indices.

    Returns ``{strided, mask_strided, position_strided}`` with layouts
    matching the reference's ``sru_*`` tensors:
      * ``condensed_dimension='time'``       → [L, n_chunks, chunk, D]
      * ``condensed_dimension='embeddings'`` → [L, n_chunks, chunk, ctx_window]

    The shipped models never consume these (the ``sru_*`` config names are
    vestigial, SURVEY.md §2.5); kept so condenser research on top of this
    framework has the same entry point.
    """
    n_layers, t, d = features.shape
    if ctx_window - t >= 0:
        pad = ctx_window - t
        mask = np.concatenate([mask[:, :t], np.zeros((n_layers, pad), mask.dtype)], axis=1)
        features = np.concatenate(
            [features, np.zeros((n_layers, pad, d), features.dtype)], axis=1
        )
    else:
        features = features[:, :ctx_window, :]
        mask = np.ones((n_layers, ctx_window), mask.dtype)

    if condensed_dimension == "time":
        n_chunks = ctx_window // chunk_size
        strided = features[:, : n_chunks * chunk_size].reshape(
            n_layers, n_chunks, chunk_size, d
        )
        mask_strided = mask[:, : n_chunks * chunk_size].reshape(
            n_layers, n_chunks, chunk_size
        )
        condensed = chunk_size
    else:  # embeddings/frames: unfold the embedding dim
        n_chunks = d // chunk_size
        strided = (
            features[:, :, : n_chunks * chunk_size]
            .reshape(n_layers, ctx_window, n_chunks, chunk_size)
            .transpose(0, 2, 3, 1)
        )
        mask_strided = mask[:, None, :]
        condensed = chunk_size

    position = np.broadcast_to(
        np.arange(condensed)[None, None, :], (n_layers, n_chunks, condensed)
    ).copy()
    return {"strided": strided, "mask_strided": mask_strided, "position_strided": position}
