"""Datasets over the reference's on-disk layout (port of
enhance_cb_whisper_tpu/data/datasets.py).

Training pairs (``keywords.txt``, ``positives.tsv`` with ``utt (\\t kw \\t
idx \\t rev_idx)*`` lines, ``hs/{code}.bin|.npy``,
``keywords-hs/{tts,natural}/{idx}.bin|.npy``):

* :class:`AishellKWSDataset` / :class:`MLSKWSDataset` — index space
  ``n_utterances x n_keywords``; an item carries the cosine-similarity
  stack (inner products of the pre-normalized caches) or, with
  ``raw_features``, both hidden-state stacks, plus its label, ghost mask
  and domain id;
* :class:`ConcatDataset` — the tts/natural zip of ``kw_type='all'``.

Grouped-keyword evaluation:

* :class:`AishellHotwordDataset` — AISHELL hotword dev/test:
  ``hotword/{split}/{hotword.txt, text, hs/, keywords-hs/{tts,natural}/}``;
* :class:`ACL6060KeywordDataset` — ACL-6060 terminology dev/eval:
  ``2/acl_6060/{dev,eval}/{text/..., hs/, keywords-hs/..., segmented_wavs/gold/}``.

An item carries the utterance's hidden-state stack (``utt_hs``), its
transcript, code, audio path, per-keyword labels and speaker; the keyword
stacks live in one :class:`..catalog.database.KeywordCatalog`, which the
scorers read.  The reference's quirks are kept on purpose: the ``\\[(\\w+)\\]``
tag regex with its offset arithmetic, AISHELL's first-token transcript, the
``&``-stripped XML for speakers, and ``dev`` labels from the transcript
against ``test`` labels from the tagged mentions.
"""

from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from itertools import accumulate
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..catalog.database import KeywordCatalog
from ..catalog.store import hidden_states_exist, load_hidden_states


def _read_lines(path: str) -> List[str]:
    with open(path, "r") as f:
        return f.readlines()


def _parse_positives(path: str) -> List[dict]:
    out = []
    for line in _read_lines(path):
        item = [p.strip() for p in line.split("\t")]
        out.append(
            {
                "code": item[0],
                "positives": [
                    (item[i], int(item[i + 1]), int(item[i + 2]))
                    for i in range(1, len(item), 3)
                ],
            }
        )
    return out


class ConcatDataset:
    """Zip of datasets (tts+natural pairing for kw_type='all',
    dataset.py:15-23)."""

    def __init__(self, datasets):
        self.datasets = datasets

    def __getitem__(self, i):
        return tuple(d[i] for d in self.datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)


class AishellKWSDataset:
    """Training pairs over the aishell KWS layout (dataset.py:26-102)."""

    def __init__(self, root: str, kw_type: str = "natural", raw_features: bool = False):
        # raw_features: emit the keyword and utterance hidden-state stacks
        # instead of the host-computed similarity map, so the sims einsum +
        # antialiased resize run inside the train step on the device
        # (ops/resize.py:features_from_hidden_states)
        self.raw_features = raw_features
        assert os.path.isdir(os.path.join(root, "kws")), (
            "the directory you indicated with the dataset could not be found"
        )
        self.root = os.path.join(root, "kws")
        assert os.path.exists(os.path.join(self.root, "keywords.txt"))
        assert kw_type in ("tts", "natural"), f"invalid keyword type {kw_type}"
        self.kw_type = kw_type

        self.keywords = {
            line.split()[0].strip(): idx
            for idx, line in enumerate(_read_lines(os.path.join(self.root, "keywords.txt")))
        }
        self.n_keywords = len(self.keywords)
        self.kw_zfill = len(str(self.n_keywords - 1))
        self.ghost_keyword_indices = [
            idx
            for idx in range(self.n_keywords)
            if not hidden_states_exist(self._kw_path(idx))
        ]
        self.keywords_reverse = sorted(self.keywords.keys(), key=lambda x: x[::-1])
        self.metadata = _parse_positives(os.path.join(self.root, "positives.tsv"))
        self.size = len(self.metadata) * self.n_keywords

    def _kw_path(self, idx: int) -> str:
        return os.path.join(
            self.root, "keywords-hs", self.kw_type, str(idx).zfill(self.kw_zfill) + ".bin"
        )

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        data = self.metadata[idx // self.n_keywords]
        keyword_idx = idx % self.n_keywords
        mask = 0 if keyword_idx in self.ghost_keyword_indices else 1
        utt = load_hidden_states(os.path.join(self.root, "hs", data["code"] + ".bin"))
        if mask:
            kwd = load_hidden_states(self._kw_path(keyword_idx))
        else:
            kwd = np.zeros((utt.shape[0], 1, utt.shape[2]), dtype=utt.dtype)
        item = {
            "label": int(any(keyword_idx == p for _, p, _ in data["positives"])),
            "mask": mask,
            "domain": 0 if self.kw_type == "tts" else 1,
            "code": data["code"],
        }
        if self.raw_features:
            item["kwd_hs"], item["utt_hs"] = kwd, utt
        else:
            # pre-normalized caches: inner product == cosine similarity
            item["features"] = np.einsum("lkd,lud->lku", kwd, utt)
        return item


class MLSKWSDataset:
    """Multilingual training pairs (dataset.py:105-200): languages
    concatenated with offset arithmetic, cross-language pairs negative,
    domain id = (0 if tts else n_languages) + language index."""

    def __init__(
        self,
        root: str,
        languages: Sequence[str] = (
            "English", "French", "German", "Polish", "Portuguese", "Spanish",
        ),
        kw_type: str = "natural",
        raw_features: bool = False,
    ):
        self.raw_features = raw_features  # see AishellKWSDataset
        assert os.path.isdir(root)
        # The roots dict (and hence keywords/n_keywords below) iterates in
        # caller order while self.languages is sorted, as in the reference:
        # with an unsorted `languages` argument and unequal per-language
        # keyword counts the reference's keyword buckets map to the "wrong"
        # languages; shipped data has equal counts per language.
        self.languages = sorted(languages)
        self.roots = {
            lang: os.path.join(root, "mls_" + lang.lower() + "_opus", "train")
            for lang in languages
        }
        assert all(os.path.isdir(r) for r in self.roots.values())
        assert kw_type in ("tts", "natural")
        self.kw_type = kw_type

        self.keywords, self.kw_zfill, self.ghost_keyword_indices = {}, {}, {}
        for lang, r in self.roots.items():
            self.keywords[lang] = {
                line.split()[0].strip(): idx
                for idx, line in enumerate(_read_lines(os.path.join(r, "keywords.txt")))
            }
            self.kw_zfill[lang] = len(str(len(self.keywords[lang]) - 1))
            self.ghost_keyword_indices[lang] = [
                idx
                for idx in range(len(self.keywords[lang]))
                if not hidden_states_exist(self._kw_path(lang, idx))
            ]
        self.keywords_reverse = {
            lang: sorted(kws.keys(), key=lambda x: x[::-1])
            for lang, kws in self.keywords.items()
        }
        self.n_keywords = list(accumulate(len(k) for k in self.keywords.values()))

        self.metadata = []
        offset_idx = 0
        for lang in self.languages:
            data = _parse_positives(os.path.join(self.roots[lang], "positives.tsv"))
            self.metadata.append({"language": lang, "offset_idx": offset_idx, "data": data})
            offset_idx += len(data) * self.n_keywords[-1]
        self.size = offset_idx

    def _kw_path(self, lang: str, idx: int) -> str:
        return os.path.join(
            self.roots[lang], "keywords-hs", self.kw_type,
            str(idx).zfill(self.kw_zfill[lang]) + ".bin",
        )

    def __len__(self):
        return self.size

    def _locate(self, idx):
        """(utterance language's metadata, utterance, keyword index within
        its language, keyword language) of pair ``idx``."""
        flags = [idx >= d["offset_idx"] for d in self.metadata]
        submeta = self.metadata[flags.index(False) - 1 if not all(flags) else -1]
        data = submeta["data"][(idx - submeta["offset_idx"]) // self.n_keywords[-1]]
        keyword_idx = (idx - submeta["offset_idx"]) % self.n_keywords[-1]
        lang_idx = [keyword_idx < n for n in self.n_keywords].index(True)
        if lang_idx != 0:
            keyword_idx -= self.n_keywords[lang_idx - 1]
        return submeta, data, keyword_idx, self.languages[lang_idx]

    def __getitem__(self, idx):
        submeta, data, keyword_idx, kw_lang = self._locate(idx)
        mask = 0 if keyword_idx in self.ghost_keyword_indices[kw_lang] else 1
        utt = load_hidden_states(
            os.path.join(self.roots[submeta["language"]], "hs", data["code"] + ".bin")
        )
        if mask:
            kwd = load_hidden_states(self._kw_path(kw_lang, keyword_idx))
        else:
            kwd = np.zeros((utt.shape[0], 1, utt.shape[2]), dtype=utt.dtype)
        label = int(
            any(keyword_idx == p for _, p, _ in data["positives"])
            and submeta["language"] == kw_lang
        )
        item = {
            "label": label,
            "mask": mask,
            "domain": (0 if self.kw_type == "tts" else len(self.languages))
            + self.languages.index(submeta["language"]),
        }
        if self.raw_features:
            item["kwd_hs"], item["utt_hs"] = kwd, utt
        else:
            item["features"] = np.einsum("lkd,lud->lku", kwd, utt)
        return item


class _GroupedKeywordEvalDataset:
    """Shared machinery of the grouped-keyword eval datasets: a
    :class:`KeywordCatalog` + per-utterance transcript/labels/speaker."""

    keywords: List[str]
    catalog: KeywordCatalog
    dataset: List[dict]

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        item = dict(self.dataset[idx])
        item["utt_hs"] = load_hidden_states(item.pop("hs_path"))
        item["hotword_mask"] = self.catalog.mask[: len(self.keywords)].copy()
        return item


class AishellHotwordDataset(_GroupedKeywordEvalDataset):
    """AISHELL hotword dev/test set."""

    def __init__(
        self,
        root: str,
        split: str = "dev",
        r1_only: bool = False,
        size: Optional[Tuple[int, int]] = None,
        hotwords_per_group: int = -1,
        kw_type: str = "natural",
        load_audio: bool = False,
        wav_folder: Optional[str] = None,
    ):
        assert size is None or (len(size) == 2 and all(i >= 32 for i in size))
        assert os.path.isdir(root)
        assert split in ("dev", "test"), f"invalid split {split}"
        self.split_folder = os.path.join(root, split)
        assert os.path.isdir(self.split_folder)
        assert kw_type in ("tts", "natural")
        self.kw_type = kw_type

        hotword_file = "r1-hotword.txt" if r1_only else "hotword.txt"
        self.hotwords = [
            line.strip() for line in _read_lines(os.path.join(self.split_folder, hotword_file))
        ]
        self.keywords = self.hotwords
        group = len(self.hotwords) if hotwords_per_group == -1 else hotwords_per_group
        self.catalog = KeywordCatalog.from_bin_dir(
            self.hotwords,
            os.path.join(self.split_folder, "keywords-hs", self.kw_type),
            group_size=group,
        )

        metadata = [
            [p.strip() for p in line.split()]
            for line in _read_lines(os.path.join(self.split_folder, "text"))
        ]
        subfolder_re = re.compile(r"BAC\d+(?P<subfolder>.+)W\d+")
        speaker_re = re.compile(r"BAC\d{3}S(?P<speaker>\d{4}).+")
        self.dataset = [
            {
                # item[1], not ' '.join(item[1:]): the reference keeps only the
                # first whitespace token (its AISHELL transcripts are unsegmented)
                "transcript": item[1],
                "code": item[0],
                "audio": (
                    os.path.join(
                        wav_folder, split, subfolder_re.match(item[0]).group("subfolder"),
                        item[0] + ".wav",
                    )
                    if load_audio
                    else None
                ),
                "hs_path": os.path.join(self.split_folder, "hs", item[0] + ".bin"),
                "hotword_labels": self.hotword_labels(item[1]),
                "speaker": speaker_re.match(item[0]).group("speaker"),
            }
            for item in metadata
        ]

    def hotword_labels(self, transcript: str) -> np.ndarray:
        return np.asarray([1 if hw in transcript else 0 for hw in self.hotwords], np.int64)


class ACL6060KeywordDataset(_GroupedKeywordEvalDataset):
    """ACL-6060 terminology dev/eval set: keywords from text/keywords.txt,
    gold mentions parsed from [keyword]-tagged transcripts with offset
    arithmetic, speakers from the XML."""

    def __init__(
        self,
        root: str,
        split: str = "dev",
        size: Optional[Tuple[int, int]] = None,
        keywords_per_group: int = -1,
        kw_type: str = "natural",
        load_audio: bool = False,
    ):
        assert size is None or (len(size) == 2 and all(i >= 32 for i in size))
        assert os.path.isdir(root)
        assert split in ("dev", "test")
        hf_split = "dev" if split == "dev" else "eval"
        self.split_folder = os.path.join(root, "2", "acl_6060", hf_split)
        assert os.path.isdir(self.split_folder)
        assert kw_type in ("tts", "natural")
        self.kw_type = kw_type

        text_dir = os.path.join(self.split_folder, "text")
        self.keywords = [
            line.strip() for line in _read_lines(os.path.join(text_dir, "keywords.txt"))
        ]
        group = len(self.keywords) if keywords_per_group == -1 else keywords_per_group
        self.catalog = KeywordCatalog.from_bin_dir(
            self.keywords,
            os.path.join(self.split_folder, "keywords-hs", self.kw_type),
            group_size=group,
        )

        transcripts = [
            line.strip()
            for line in _read_lines(
                os.path.join(text_dir, "txt", f"ACL.6060.{hf_split}.en-xx.en.txt")
            )
        ]
        # the reference's tag regex: \w+ cannot match multi-word or
        # hyphenated mentions, and the offsets discount the brackets of the
        # tags before each one
        tag_re = re.compile(r"\[(\w+)\]")
        mentions = [
            [
                {
                    "mention": (
                        m.group(1)
                        if m.group(1) in self.keywords
                        else m.group(1)[0].lower() + m.group(1)[1:]
                    ),
                    "total_offset": m.start() - m_idx * 2,
                    "end_offset": m.end() - m_idx * 2 - 2,
                }
                for m_idx, m in enumerate(tag_re.finditer(line))
            ]
            for line in _read_lines(
                os.path.join(
                    text_dir, "tagged_terminology", f"ACL.6060.{hf_split}.tagged.en-xx.en.txt"
                )
            )
        ]

        with open(os.path.join(text_dir, "xml", f"ACL.6060.{hf_split}.en-xx.en.xml")) as f:
            xml_root = ET.fromstring(re.sub("&", "", f.read()))
        idx2speaker = {
            int(child.attrib["id"]): speaker_id
            for speaker_id, doc in enumerate(xml_root[0])
            for child in doc
            if child.tag == "seg"
        }

        self.dataset = [
            {
                "transcript": transcript,
                "code": f"sent_{i + 1}",
                "audio": (
                    os.path.join(self.split_folder, "segmented_wavs/gold", f"sent_{i + 1}.wav")
                    if load_audio
                    else None
                ),
                "hs_path": os.path.join(self.split_folder, "hs", f"sent_{i + 1}.bin"),
                "hotword_labels": (
                    self.hotword_labels(transcript)
                    if split == "dev"
                    else self._label_from_mentions(kw)
                ),
                "keywords": kw,
                "speaker": idx2speaker[i + 1],
            }
            for i, (transcript, kw) in enumerate(zip(transcripts, mentions))
        ]

    def hotword_labels(self, transcript: str) -> np.ndarray:
        return np.asarray([1 if k in transcript else 0 for k in self.keywords], np.int64)

    def _label_from_mentions(self, mentions: List[dict]) -> np.ndarray:
        mentioned = [m["mention"] for m in mentions]
        return np.asarray([1 if k in mentioned else 0 for k in self.keywords], np.int64)
