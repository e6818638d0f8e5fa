"""Batch collators (a copy of enhance_cb_whisper_tpu/data/collators.py,
which needs only numpy: the reference's ``src/data/data_collator.py``).

:class:`KWSDataCollator` reproduces the reference semantics exactly:

* tts/natural tuples from :class:`ConcatDataset` are flattened in order;
* multi-keyword items (list-valued ``features``) are flattened per keyword
  with ghost entries (mask 0) relabeled -100 (data_collator.py:23-27) —
  the FLAT path takes labels verbatim, exactly as the reference (:53);
  ghosts never reach the flat path in shipped flows (the samplers reject
  them), so the two paths agree end-to-end;
* the SHORT edge of every similarity stack is resized (antialias=True,
  PIL semantics) to max(batch max, 32) — or ``size[0]`` when fixed;
* the LONG edge is zero-padded to the batch max when ``size`` is None,
  else resized (antialias=True) to ``size[1]``.

Host-side numpy matmuls via the same weight matrices as the device resize
(:mod:`..ops.resize`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..ops.resize import resize_matrix


def _resize_h(x: np.ndarray, out_h: int) -> np.ndarray:
    if x.shape[1] == out_h:
        return x
    w = resize_matrix(x.shape[1], out_h, antialias=True)
    return np.einsum("ok,lku->lou", w, x)


def _resize_w(x: np.ndarray, out_w: int) -> np.ndarray:
    if x.shape[2] == out_w:
        return x
    w = resize_matrix(x.shape[2], out_w, antialias=True)
    return np.einsum("pu,lku->lkp", w, x)


class KWSDataCollator:
    def __init__(self, size: Optional[Tuple[int, int]] = None):
        assert size is None or (len(size) == 2 and all(i >= 32 for i in size)), (
            "provide a valid size for the input features of the KWS model"
        )
        self.size = tuple(size) if size is not None else None

    def __call__(self, features: List) -> dict:
        if isinstance(features[0], tuple):  # tts/natural pairs → flatten
            features = [item for pair in features for item in pair]

        if isinstance(features[0]["features"], list):
            # multi-keyword items: flatten per keyword; the mask→-100 ghost
            # rewrite happens HERE and only here (data_collator.py:23-27)
            features = [
                {"features": np.asarray(t), "label": l if m == 1 else -100}
                for f in features
                for t, l, m in zip(f["features"], f["label"], f["mask"])
            ]

        if self.size is None:
            short = max(max(f["features"].shape[1] for f in features), 32)
            long = max(max(f["features"].shape[2] for f in features), 32)
        else:
            short, long = self.size

        resized = [_resize_h(f["features"].astype(np.float32), short) for f in features]
        if self.size is None:
            padded = []
            for t in resized:
                pad = long - t.shape[2]
                padded.append(np.pad(t, ((0, 0), (0, 0), (0, pad))))
            batch_features = np.stack(padded)
        else:
            batch_features = np.stack([_resize_w(t, long) for t in resized])

        batch = {
            "features": batch_features,
            # labels verbatim — the reference's flat path does NOT consult
            # the mask (data_collator.py:53); ghosts are rewritten to -100
            # only through the list-flatten branch above
            "labels": np.asarray([f["label"] for f in features], dtype=np.int64),
        }
        if features[0].get("domain", None) is not None:
            batch["domain"] = np.asarray([f["domain"] for f in features], dtype=np.int64)
        return batch


def _bucket(n: int, step: int, lo: int) -> int:
    return max(lo, ((n + step - 1) // step) * step)


class RawKWSDataCollator:
    """Batch the raw hidden-state stacks (datasets built with
    ``raw_features=True``) instead of host-computed similarity maps.

    The similarity einsum + antialiased resize then run inside the train
    step (``ops/resize.py:features_from_hidden_states`` via
    ``KWSTrainConfig.device_features``).  Lengths are zero-padded to
    bucketed maxima (the JAX step compiles once per bucket pair; the port
    keeps the same batches).
    """

    def __init__(self, bucket_kwd: int = 8, bucket_utt: int = 128):
        self.bucket_kwd = bucket_kwd
        self.bucket_utt = bucket_utt

    @staticmethod
    def _pad_stack(stacks: List[np.ndarray], target: int) -> np.ndarray:
        out = np.zeros(
            (len(stacks), stacks[0].shape[0], target, stacks[0].shape[2]),
            np.float32,
        )
        for i, s in enumerate(stacks):
            out[i, :, : s.shape[1]] = s
        return out

    def __call__(self, features: List) -> dict:
        if isinstance(features[0], tuple):  # tts/natural pairs → flatten
            features = [item for pair in features for item in pair]
        kwd = [np.asarray(f["kwd_hs"], np.float32) for f in features]
        utt = [np.asarray(f["utt_hs"], np.float32) for f in features]
        t_k = _bucket(max(s.shape[1] for s in kwd), self.bucket_kwd, self.bucket_kwd)
        t_u = _bucket(max(s.shape[1] for s in utt), self.bucket_utt, self.bucket_utt)
        batch = {
            "kwd_hs": self._pad_stack(kwd, t_k),
            "utt_hs": self._pad_stack(utt, t_u),
            "kwd_len": np.asarray([s.shape[1] for s in kwd], np.int32),
            "utt_len": np.asarray([s.shape[1] for s in utt], np.int32),
            "labels": np.asarray([f["label"] for f in features], dtype=np.int64),
        }
        if features[0].get("domain", None) is not None:
            batch["domain"] = np.asarray([f["domain"] for f in features], dtype=np.int64)
        return batch


class HotwordDataCollator:
    """Eval batch size is one utterance (data_collator.py:62-65)."""

    def __call__(self, features: List) -> dict:
        return features[0]
