"""Entity recall: alignment-based mention-level recall of keyword mentions.

Behavioral re-implementation of the reference scorer (src/scorer.py:6-148):

1. tokenize prediction and reference with the Priberam tokenizer and keep
   only the FIRST sentence (the reference indexes ``tokenize(text)[0]``);
2. with ``char_split=True`` explode every token into single characters
   (used for Chinese);
3. globally align the two token-text sequences with Needleman-Wunsch
   (gap sentinel '[SKIP]');
4. map each gold mention's character span onto reference tokens: token
   ``tk`` belongs to mention ``m`` iff
   ``(m.end_offset - tk.start) * (m.total_offset - tk.end) < 0``
   (strict-overlap test, src/scorer.py:111) — later mentions overwrite
   earlier ones on shared tokens, exactly as in the reference loop;
5. extend the mention map across alignment gap positions when the gap is
   inside a mention (src/scorer.py:113-117);
6. a mention counts as recalled (TP) iff EVERY aligned prediction token
   equals the corresponding reference token (src/scorer.py:139-144);
7. empty predictions count every mention as FN (src/scorer.py:33-44).

Per-tag and 'ALL' recall are returned; mentions carry ``ner_tag`` (the
CB-Whisper eval uses only 'UNK' tags under ner_tags='ALL').
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

from .nw_align import GAP, needleman_wunsch
from .tokenizer import PriberamTokenizer, Token


def _first_sentence_tokens(tokenizer: PriberamTokenizer, text: str, char_split: bool) -> List[Token]:
    sentences = tokenizer.tokenize(text)
    tokens = [t for t in (sentences[0] if sentences else []) if t.type != "newline"]
    if char_split:
        tokens = [
            Token(-1, t.start + ci, t.start + ci + 1, ch, "text")
            for t in tokens
            for ci, ch in enumerate(t.text)
        ]
    return tokens


def entity_recall(
    preds: Sequence[str],
    refs: Sequence[str],
    mentions: Sequence[List[dict]],
    ner_tags: Union[str, List[str]] = "ALL",
    char_split: bool = False,
) -> Dict[str, float]:
    assert not isinstance(ner_tags, str) or ner_tags == "ALL", "invalid NER tags"
    if ner_tags == "ALL":
        ner_tags = ["ALL"]

    tokenizer = PriberamTokenizer()
    counts = {tag: {"TP": 0, "FN": 0, "N": 0} for tag in set(ner_tags + ["ALL"])}

    def _ensure_tag(tag: str):
        if ner_tags == ["ALL"] and tag not in counts:
            counts[tag] = {"TP": 0, "FN": 0, "N": 0}

    for pred, ref, ref_mentions in zip(preds, refs, mentions):
        if pred.strip() == "":
            for m in ref_mentions:
                _ensure_tag(m["ner_tag"])
                if m["ner_tag"] in counts:
                    counts[m["ner_tag"]]["N"] += 1
                    counts["ALL"]["N"] += 1
                    counts[m["ner_tag"]]["FN"] += 1
                    counts["ALL"]["FN"] += 1
            continue

        pred_tokens = _first_sentence_tokens(tokenizer, pred, char_split)
        ref_tokens = _first_sentence_tokens(tokenizer, ref, char_split)

        # Align the RAW token texts and strip only afterwards — exactly the
        # reference's order (scorer.py:67 aligns tk.text verbatim, :79/:95
        # strips the re-split alignment elements).  Stripping BEFORE the
        # alignment is not equivalent: e.g. a predicted ' ' (space) token vs
        # a reference '\n' token is a mismatch raw but a match stripped,
        # which can flip the optimal NW path and hence a TP/FN decision
        # (found by tests/test_scorer_differential.py).
        aligned_pred, aligned_ref = needleman_wunsch(
            [t.text for t in pred_tokens],
            [t.text for t in ref_tokens],
        )
        aligned_pred = [s.strip() for s in aligned_pred]
        aligned_ref = [s.strip() for s in aligned_ref]

        # map reference tokens to mention indices (last overlapping mention wins)
        mention_of_token = [-1] * len(ref_tokens)
        for ti, tk in enumerate(ref_tokens):
            for mi, m in enumerate(ref_mentions):
                if (m["end_offset"] - tk.start) * (m["total_offset"] - tk.end) < 0:
                    mention_of_token[ti] = mi

        # expand across gap positions in the aligned reference: a gap between
        # two tokens of the same mention inherits that mention
        mention_at_pos = list(mention_of_token)
        for pos in [i for i, tok in enumerate(aligned_ref) if tok == GAP]:
            if 0 < pos < len(mention_at_pos) and mention_at_pos[pos - 1] == mention_at_pos[pos]:
                mention_at_pos.insert(pos, mention_at_pos[pos - 1])
            else:
                mention_at_pos.insert(pos, -1)

        # group contiguous equal mention indices into (mention, positions)
        groups = []
        i = 0
        while i < len(mention_at_pos):
            if mention_at_pos[i] != -1:
                mi = mention_at_pos[i]
                positions = []
                while i < len(mention_at_pos) and mention_at_pos[i] == mi:
                    positions.append(i)
                    i += 1
                groups.append((mi, positions))
            else:
                i += 1

        for mi, positions in groups:
            m = ref_mentions[mi]
            _ensure_tag(m["ner_tag"])
            if m["ner_tag"] in counts:
                counts[m["ner_tag"]]["N"] += 1
                counts["ALL"]["N"] += 1
                if all(aligned_pred[p] == aligned_ref[p] for p in positions):
                    counts[m["ner_tag"]]["TP"] += 1
                    counts["ALL"]["TP"] += 1
                else:
                    counts[m["ner_tag"]]["FN"] += 1
                    counts["ALL"]["FN"] += 1

    return {
        tag: (float(c["TP"]) / float(c["N"]) if c["N"] != 0 else 0)
        for tag, c in counts.items()
    }
