"""Grouped-keyword evaluation datasets over the reference's on-disk layout
(port of the eval half of enhance_cb_whisper_tpu/data/datasets.py).

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
against ``test`` labels from the tagged mentions.  The training pair
datasets are not ported yet.
"""

from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from typing import List, Optional, Tuple

import numpy as np

from ..catalog.database import KeywordCatalog
from ..catalog.store import load_hidden_states


def _read_lines(path: str) -> List[str]:
    with open(path, "r") as f:
        return f.readlines()


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
