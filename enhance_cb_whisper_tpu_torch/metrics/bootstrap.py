"""Bootstrap confidence intervals with condition (speaker) grouping.

Reimplements the behavior the reference gets from the
``confidence_intervals`` package's ``evaluate_with_conf_int``
(reference call sites: src/model/model.py:410-412,
src/efficient_kws/model.py:861-874, src/model/cb_whisper.py:285 —
always ``num_bootstraps=1000, alpha=5`` with per-speaker conditions):

* the center value is the metric on the full data;
* each bootstrap set is drawn hierarchically: conditions are sampled with
  replacement, then samples are sampled with replacement from within the
  selected conditions — so the interval reflects speaker-level variance;
* the interval is the (alpha/2, 100 - alpha/2) percentile of the bootstrap
  distribution.
"""

from __future__ import annotations

import numpy as np


def _bootstrap_indices(rng, num_samples, conditions=None):
    if conditions is None:
        return rng.integers(0, num_samples, size=num_samples)
    conditions = np.asarray(conditions)
    unique = np.unique(conditions)
    chosen = rng.choice(unique, size=unique.size, replace=True)
    idx = np.concatenate([np.nonzero(conditions == c)[0] for c in chosen])
    # second level: resample items within the selected conditions
    return idx[rng.integers(0, idx.size, size=idx.size)]


def evaluate_with_conf_int(
    samples,
    metric,
    labels=None,
    conditions=None,
    num_bootstraps: int = 1000,
    alpha: float = 5.0,
    seed: int = 0,
):
    """Returns ``(center, (low, high))``.

    ``metric`` has the reference signature ``metric(labels, samples)``.
    ``samples``/``labels`` may be numpy arrays or any sequence supporting
    fancy indexing via a list of ints (the reference wraps python lists in a
    ``Flexlist`` for this; we handle plain sequences transparently).
    """
    rng = np.random.default_rng(seed)
    n = len(samples)

    def _take(seq, idx):
        if seq is None:
            return None
        if isinstance(seq, np.ndarray):
            return seq[idx]
        return [seq[int(i)] for i in idx]

    center = metric(labels, samples)

    values = np.empty(num_bootstraps, dtype=np.float64)
    for b in range(num_bootstraps):
        idx = _bootstrap_indices(rng, n, conditions)
        values[b] = metric(_take(labels, idx), _take(samples, idx))

    low = float(np.percentile(values, alpha / 2.0))
    high = float(np.percentile(values, 100.0 - alpha / 2.0))
    return float(center), (low, high)
