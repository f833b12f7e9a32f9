"""Edit distance and word/character error rate, in numpy.

The port's own copy of the scoring half of
``attention_lvcsr_tpu/ops/error_rate.py``: that module cannot be imported
without JAX, because ``attention_lvcsr_tpu/ops/__init__.py`` imports
``expressions``.  Same values; the DP row uses the same prefix-min
transform over deletions.
"""
from __future__ import annotations

import numpy as np


def edit_distance(y, y_hat):
    """Minimum number of insertions, deletions and substitutions that
    turn ``y_hat`` into ``y`` (strings or lists of ints)."""
    y, y_hat = list(y), list(y_hat)
    m = len(y_hat)
    row = np.arange(m + 1, dtype=np.int64)
    if not y or not m:
        return max(len(y), m)
    hat = np.empty(m, dtype=object)
    hat[:] = y_hat
    cols = np.arange(1, m + 1)
    for i, sym in enumerate(y, start=1):
        mismatch = (hat != sym).astype(np.int64)
        base = np.minimum(row[1:] + 1, row[:-1] + mismatch)
        # deletions chain along the row: prefix-min of base[k] - k
        run = np.minimum.accumulate(np.concatenate(([i], base - cols)))[1:]
        row = np.concatenate(([i], np.minimum(base, run + cols)))
    return int(row[-1])


def wer(y, y_hat):
    """Length-normalized edit distance (CER when units are characters)."""
    return edit_distance(y, y_hat) / float(len(y))
