"""Training example samplers: 1 positive + 1 random + 2 lexicographic
negatives per utterance (a copy of enhance_cb_whisper_tpu/data/samplers.py,
which needs only numpy, so the two packages draw the same batches).

The reference's ``src/data/sampler.py`` with numpy RNG:

* one positive drawn uniformly from the utterance's positive keywords;
* ``random`` negatives uniform over the utterance's keyword index range,
  rejection-sampled to avoid positives/duplicates;
* ``lexicographic`` negatives in two halves — gaussian offsets
  (sigma=``negative_diversity``) around the positive keyword in FORWARD
  lexicographic order, and around its REVERSE-lexicographic position mapped
  back through the reverse-sorted keyword list (sampler.py:55-77);
* emission: ``random`` shuffles everything; ``utterance-examples`` shuffles
  utterance blocks, keeping each utterance's examples adjacent so a batch
  is whole utterances (sampler.py:81-85);
* ``resample_every_epoch=False`` reseeds per epoch so every epoch sees the
  same pairs (sampler.py:46-50).

The RNG statistics match the reference's torch.Generator scheme
distribution-wise, not bitwise (SURVEY.md §7 hard parts).
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

# Rejection-sampling guard: the reference's loops spin forever when the
# corpus cannot satisfy the request (e.g. fewer distinct non-positive
# keywords than negatives asked for); the retries are bounded and raise
# with a diagnosis instead (unreachable for any feasible corpus and config).
_MAX_REJECTION_TRIES = 10_000


def _bounded(tries: int, what: str, detail: str):
    if tries >= _MAX_REJECTION_TRIES:
        raise ValueError(
            f"KWSSampler: could not draw {what} after {_MAX_REJECTION_TRIES} "
            f"rejection-sampling attempts ({detail}); the corpus is too small "
            "for the configured negative_examples/negative_diversity"
        )


class KWSSampler:
    def __init__(
        self,
        data_source,
        sampling: str = "random",
        negative_examples: Dict[str, int] = None,
        negative_diversity: float = 5.0,
        resample_every_epoch: bool = True,
        seed: int = 123,
    ):
        self.data_source = data_source
        assert sampling in ("random", "utterance-examples"), (
            "the provided sampling method does not exist"
        )
        self.sampling = sampling
        negative_examples = (
            {"random": 1, "lexicographic": 2} if negative_examples is None else negative_examples
        )
        assert all(k in ("random", "lexicographic") for k in negative_examples)
        assert negative_examples.get("lexicographic", 0) % 2 == 0, (
            "lexicographic negatives must be a multiple of 2"
        )
        self.negative_examples = negative_examples
        self.negative_diversity = negative_diversity
        self.resample_every_epoch = resample_every_epoch
        self.seed = seed
        self._epoch = 0

        self.is_multilingual = (
            bool(data_source.metadata)
            and isinstance(data_source.metadata[0], dict)
            and "data" in data_source.metadata[0]
        )
        if self.is_multilingual:
            self.num_utterances = sum(len(m["data"]) for m in data_source.metadata)
            self.n_keywords = sum(len(k) for k in data_source.keywords.values())
        else:
            self.num_utterances = len(data_source.metadata)
            self.n_keywords = len(data_source.keywords)
        self.examples_per_utt = 1 + sum(self.negative_examples.values())
        self.num_samples = self.num_utterances * self.examples_per_utt

    def __len__(self):
        return self.num_samples

    def _utterances(self):
        """Yields (base_index, lang_lo, lang_hi, positives, reverse_list,
        keyword_dict) per utterance, unifying flat and multilingual layouts."""
        ds = self.data_source
        if not self.is_multilingual:
            for utt_idx, utterance in enumerate(ds.metadata):
                base = utt_idx * self.n_keywords
                yield (
                    base, base, base + self.n_keywords, utterance["positives"],
                    ds.keywords_reverse, ds.keywords,
                )
        else:
            for submeta in ds.metadata:
                lang = submeta["language"]
                lang_idx = ds.languages.index(lang)
                lang_off = ds.n_keywords[lang_idx - 1] if lang_idx != 0 else 0
                n_lang = len(ds.keywords[lang])
                for utt_idx, utterance in enumerate(submeta["data"]):
                    base = submeta["offset_idx"] + utt_idx * self.n_keywords
                    yield (
                        base, base + lang_off, base + lang_off + n_lang,
                        utterance["positives"], ds.keywords_reverse[lang], ds.keywords[lang],
                    )

    def __iter__(self) -> Iterator[int]:
        if not self.resample_every_epoch:
            rng = np.random.default_rng(self.seed)
        else:
            rng = np.random.default_rng((self.seed, self._epoch))
            self._epoch += 1

        indices: List[int] = []
        n_rand = self.negative_examples.get("random", 0)
        n_lex = self.negative_examples.get("lexicographic", 0)

        for base, lo, hi, positives, kw_reverse, kw_dict in self._utterances():
            positive = positives[int(rng.integers(len(positives)))]
            positive_idx = lo + positive[1]
            indices.append(positive_idx)
            avoid = {lo + p[1] for p in positives}

            if n_rand > 0:
                for tries in range(_MAX_REJECTION_TRIES + 1):
                    _bounded(tries, "random negatives",
                             f"{n_rand} needed, {self.n_keywords} keywords, "
                             f"{len(avoid)} excluded")
                    cand = (base + rng.integers(0, self.n_keywords, size=n_rand)).tolist()
                    if len(set(cand) - avoid) == n_rand:
                        break
                indices += cand
                # NOTE: the reference's `indices_to_avoid.union(set(...))`
                # (union returns a new set, discarded) never grows the avoid
                # set, so later draw types only avoid the positives and may
                # duplicate earlier negatives.  Reproduced exactly.

            if n_lex > 0:
                half = n_lex // 2
                # forward lexicographic neighbourhood
                for tries in range(_MAX_REJECTION_TRIES + 1):
                    _bounded(tries, "forward lexicographic negatives",
                             f"{half} needed in [{lo},{hi}), {len(avoid)} excluded")
                    cand = (
                        positive_idx
                        + np.round(rng.standard_normal(half) * self.negative_diversity).astype(int)
                    ).tolist()
                    if len(set(cand) - avoid) == half and all(lo <= c < hi for c in cand):
                        break
                indices += cand
                # reverse lexicographic neighbourhood
                n_lang = hi - lo
                for tries in range(_MAX_REJECTION_TRIES + 1):
                    _bounded(tries, "reverse lexicographic negatives",
                             f"{half} needed, {n_lang} keywords, {len(avoid)} excluded")
                    offs = np.round(
                        positive[2] + rng.standard_normal(half) * self.negative_diversity
                    ).astype(int)
                    cand = [
                        lo + kw_dict[kw_reverse[o]]
                        for o in offs.tolist()
                        if 0 <= o < n_lang
                    ]
                    if len(set(cand) - avoid) == half:
                        break
                indices += cand

        indices = np.asarray(indices, dtype=np.int64)
        if self.sampling == "random":
            order = rng.permutation(self.num_samples)
            yield from indices[order].tolist()
        else:  # utterance-examples: shuffle blocks, keep examples adjacent
            k = self.examples_per_utt
            blocks = rng.permutation(self.num_samples // k) * k
            order = (blocks[:, None] + np.arange(k)[None, :]).reshape(-1)
            yield from indices[order].tolist()


# reference-compatible aliases (src/data/sampler.py:6, :91)
AishellKWSSampler = KWSSampler
MLSKWSSampler = KWSSampler
