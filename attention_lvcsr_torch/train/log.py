"""Columnar training log.

The port's copy of ``attention_lvcsr_tpu/train/log.py`` (which imports no
JAX), without the pandas and sqlite exports: rows keyed by iteration
number, per-channel storage (two aligned lists: times and values), and a
``status`` dict for the loop's state.
"""
from __future__ import annotations

import bisect
from typing import Any, Dict, List


class _Column:
    __slots__ = ("times", "values")

    def __init__(self):
        self.times: List[int] = []
        self.values: List[Any] = []

    def append(self, t: int, value):
        if self.times and self.times[-1] == t:
            self.values[-1] = value
            return
        self.times.append(t)
        self.values.append(value)

    def get(self, t: int, default=None):
        i = bisect.bisect_left(self.times, t)
        if i < len(self.times) and self.times[i] == t:
            return self.values[i]
        return default

    def last(self, default=None):
        return self.values[-1] if self.values else default


class _RowView(dict):
    """Write-through view of one log row."""

    def __init__(self, log, time):
        super().__init__()
        self._log = log
        self._time = time
        for name, col in log.columns.items():
            value = col.get(time, _MISSING)
            if value is not _MISSING:
                super().__setitem__(name, value)

    def __setitem__(self, key, value):
        self._log.record(self._time, key, value)
        super().__setitem__(key, value)


_MISSING = object()


class TrainingLog:
    """Columnar iteration-indexed log."""

    def __init__(self):
        self.columns: Dict[str, _Column] = {}
        self.status: Dict[str, Any] = {
            "iterations_done": 0,
            "epochs_done": 0,
            "_epoch_ends": [],
            "training_started": False,
            "epoch_started": False,
        }

    def record(self, time: int, name: str, value):
        self.columns.setdefault(name, _Column()).append(time, value)

    @property
    def current_row(self) -> _RowView:
        return _RowView(self, self.status["iterations_done"])

    def last_value(self, name, default=None):
        col = self.columns.get(name)
        return col.last(default) if col else default

    def channel(self, name):
        col = self.columns.get(name, _Column())
        return list(col.times), list(col.values)

    def state_dict(self):
        return {
            "status": dict(self.status),
            "columns": {name: (col.times, col.values)
                        for name, col in self.columns.items()},
        }
