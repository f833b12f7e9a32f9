"""Streaming pipeline: shuffle -> label edits -> bucket -> pad -> prefetch.

TPU-first re-design of the reference's Fuel transformer chain
(``lvsr/datasets/__init__.py:253-310``; Fuel ``transformers/__init__.py``):

* same stages — shuffled example stream, EOS/BOS insertion, length filter,
  sort-k-batches bucketing, normalization, batching, padding + masks;
* but batches are **batch-major** ``(B, T, ...)`` and padded up to a small
  set of static shapes (``pad_multiple``) so XLA compiles a handful of
  bucket shapes instead of one program per batch (SURVEY.md §5
  long-context notes: bucketed padding discipline);
* a background thread prefetches batches (the Fuel ``MultiProcessing`` /
  zmq ``ServerDataStream`` role on a single host).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np


def round_up(n: int, multiple: int) -> int:
    if multiple <= 1:
        return n
    return -(-n // multiple) * multiple


class ExampleStream:
    """Iterates examples (dicts source->array) of a dataset split."""

    def __init__(self, dataset, sources, shuffle=True, rng=None,
                 num_examples=None):
        self.dataset = dataset
        self.sources = tuple(sources)
        self.shuffle = shuffle
        self.rng = rng or np.random.RandomState(1234)
        self.num_examples = num_examples or dataset.num_examples

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(self.num_examples)
        if self.shuffle:
            order = self.rng.permutation(self.dataset.num_examples)
            order = order[:self.num_examples]
        for i in order:
            values = self.dataset.get_example(int(i))
            yield dict(zip(self.dataset.sources, values))


def add_label(example: Dict, source: str, label: int, append=True, times=1):
    arr = np.asarray(example[source])
    extra = np.full((times,), label, dtype=arr.dtype if arr.size else "int64")
    example = dict(example)
    example[source] = (np.concatenate([arr, extra]) if append
                       else np.concatenate([extra, arr]))
    return example


class LengthFilter:
    """Mutable max-length predicate (switch-off-able mid-training, like the
    reference's ``SwitchOffLengthFilter``, lvsr/main.py:128-136)."""

    def __init__(self, source: str, max_length: Optional[int]):
        self.source = source
        self.max_length = max_length

    def __call__(self, example) -> bool:
        if not self.max_length:
            return True
        return len(example[self.source]) <= self.max_length


def sorted_buckets(examples: Iterable[Dict], key_source: str,
                   batch_size: int, k_batches: int,
                   drop_incomplete: bool = False) -> Iterator[List[Dict]]:
    """sort-k-batches bucketing: read k*B examples, sort by length, emit
    B-sized batches (lvsr/datasets/__init__.py:281-293)."""
    chunk = []
    chunk_size = batch_size * max(1, k_batches)

    def flush(chunk):
        chunk.sort(key=lambda ex: len(ex[key_source]))
        for i in range(0, len(chunk), batch_size):
            batch = chunk[i:i + batch_size]
            if drop_incomplete and len(batch) < batch_size:
                continue
            yield batch

    for ex in examples:
        chunk.append(ex)
        if len(chunk) >= chunk_size:
            yield from flush(chunk)
            chunk = []
    if chunk:
        yield from flush(chunk)


def pad_batch(batch: List[Dict], sources, pad_multiple=1,
              pad_batch_to: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Zero-pad a list of examples into batch-major arrays + masks.

    Produces ``<source>`` and ``<source>_mask`` entries; time is padded to
    a multiple of ``pad_multiple`` (an int, or a per-source dict — label
    sequences are much shorter than frame sequences) and the batch dim
    optionally padded to ``pad_batch_to`` (mask rows zero) for
    static-shape discipline.
    """
    out = {}
    B = len(batch)
    BP = pad_batch_to or B
    for source in sources:
        multiple = (pad_multiple.get(source, 1)
                    if isinstance(pad_multiple, dict) else pad_multiple)
        arrays = [np.asarray(ex[source]) for ex in batch]
        if arrays[0].ndim == 0:
            out[source] = np.asarray(arrays + [arrays[0]] * (BP - B))
            continue
        max_len = round_up(max(a.shape[0] for a in arrays), multiple)
        tail = arrays[0].shape[1:]
        dtype = arrays[0].dtype
        padded = np.zeros((BP, max_len) + tail, dtype=dtype)
        mask = np.zeros((BP, max_len), dtype="float32")
        for i, a in enumerate(arrays):
            padded[i, :a.shape[0]] = a
            mask[i, :a.shape[0]] = 1.0
        out[source] = padded
        out[source + "_mask"] = mask
    return out


class Prefetcher:
    """Background-thread prefetch of an iterator (Fuel MultiProcessing
    role, fuel/transformers/__init__.py:822)."""

    _DONE = object()

    def __init__(self, iterator_factory: Callable[[], Iterator], depth=4):
        self.factory = iterator_factory
        self.depth = depth

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        error: List[BaseException] = []

        def worker():
            try:
                for item in self.factory():
                    q.put(item)
            except BaseException as e:  # propagate to the consumer
                error.append(e)
            finally:
                q.put(self._DONE)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is self._DONE:
                if error:
                    raise error[0]
                return
            yield item
