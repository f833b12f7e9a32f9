"""Columnar training log.

The port's copy of ``attention_lvcsr_tpu/train/log.py`` (which imports no
JAX): rows keyed by iteration number, per-channel storage (two aligned
lists: times and values), a ``status`` dict for the loop's state, and the
row iterator and the pandas (imported inside ``to_dataframe``) and sqlite
exports.  The ``state_dict`` is the JAX package's, so each package reads
the other's ``_log.pkl``.
"""
from __future__ import annotations

import bisect
from typing import Any, Dict, Iterator, List


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
            "resumed_from": None,
            "training_started": False,
            "epoch_started": False,
        }

    def record(self, time: int, name: str, value):
        self.columns.setdefault(name, _Column()).append(time, value)

    @property
    def current_row(self) -> _RowView:
        return _RowView(self, self.status["iterations_done"])

    def __getitem__(self, time: int) -> _RowView:
        return _RowView(self, time)

    @property
    def previous_row(self) -> _RowView:
        return _RowView(self, self.status["iterations_done"] - 1)

    def last_value(self, name, default=None):
        col = self.columns.get(name)
        return col.last(default) if col else default

    def channel(self, name):
        col = self.columns.get(name, _Column())
        return list(col.times), list(col.values)

    def _times(self):
        return sorted({t for col in self.columns.values() for t in col.times})

    def iter_rows(self) -> Iterator[tuple]:
        """(iteration, {name: value}) of every row, in time order."""
        for t in self._times():
            yield t, {name: v for name in self.columns
                      if (v := self.columns[name].get(t, _MISSING))
                      is not _MISSING}

    def to_dataframe(self):
        """A pandas DataFrame: one row an iteration, one column a channel
        (None where a channel has no value)."""
        import pandas
        times = self._times()
        data = {}
        for name, col in self.columns.items():
            lookup = dict(zip(col.times, col.values))
            data[name] = [lookup.get(t) for t in times]
        return pandas.DataFrame(data, index=times)

    def to_sqlite(self, path, table="log"):
        """The log as a sqlite table of (time, name, JSON value) rows; a
        value JSON cannot encode is stored as its JSON-encoded repr."""
        import json
        import sqlite3
        conn = sqlite3.connect(path)
        try:
            conn.execute(f"DROP TABLE IF EXISTS {table}")
            conn.execute(f"CREATE TABLE {table} "
                         "(time INTEGER, name TEXT, value TEXT)")
            rows = []
            for name, col in self.columns.items():
                for t, v in zip(col.times, col.values):
                    try:
                        payload = json.dumps(v)
                    except TypeError:
                        payload = json.dumps(repr(v))
                    rows.append((t, name, payload))
            conn.executemany(f"INSERT INTO {table} VALUES (?,?,?)", rows)
            conn.commit()
        finally:
            conn.close()

    def state_dict(self):
        return {
            "status": dict(self.status),
            "columns": {name: (col.times, col.values)
                        for name, col in self.columns.items()},
        }

    @classmethod
    def from_state_dict(cls, state):
        """The log of a ``state_dict`` written by either package."""
        log = cls()
        log.status.update(state["status"])
        for name, (times, values) in state["columns"].items():
            col = _Column()
            col.times = list(times)
            col.values = list(values)
            log.columns[name] = col
        return log
