"""Data manager: datasets + preprocessing pipelines.

Counterpart of the reference ``Data`` class
(``lvsr/datasets/__init__.py:122-310``): maps conceptual sources
(``recordings``, ``labels``, ``uttids``) to dataset entries and builds the
stream pipeline — shuffle, EOS/BOS, length filter, sort-k-batches
bucketing, normalization, batch, pad (+ masks), prefetch.  Batches are
batch-major dicts of numpy arrays keyed by conceptual source name.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator

import numpy as np

from attention_lvcsr_torch.data.h5 import DATASET_REGISTRY, H5AudioDataset
from attention_lvcsr_torch.data.pipeline import (ExampleStream, LengthFilter,
                                               Prefetcher, add_label,
                                               pad_batch, sorted_buckets)
from attention_lvcsr_torch.data.preprocessing import Normalization


def _resolve_dataset_class(spec):
    if spec is None:
        return H5AudioDataset
    if isinstance(spec, type):
        return spec
    return DATASET_REGISTRY[str(spec).rsplit(".", 1)[-1]]


class Data:
    """Dataset manager (constructor mirrors the reference's config keys)."""

    def __init__(self, dataset_filename, name_mapping=None, sources_map=None,
                 batch_size=None, validation_batch_size=None,
                 sort_k_batches=None, max_length=None, normalization=None,
                 add_eos=True, eos_label=None, add_bos=0, prepend_eos=False,
                 default_sources=None, dataset_class=None,
                 pad_multiple=1, pad_batches=False, prefetch=True,
                 data_dir=None, uttid_source=None):
        if prepend_eos:
            raise ValueError("prepend_eos is not supported (reference "
                             "asserts the same, lvsr/datasets/__init__.py:166)")
        self.dataset_filename = dataset_filename
        self.data_dir = data_dir or os.environ.get("LVSR_DATA_PATH", ".")
        self.dataset_class = _resolve_dataset_class(dataset_class)
        self.name_mapping = dict(name_mapping or {})
        self.sources_map = dict(sources_map or
                                {"recordings": "recordings",
                                 "labels": "labels"})
        if uttid_source:
            # archival key (wsj_jan_* configs): alias for the uttids
            # source name
            self.sources_map.setdefault("uttids", uttid_source)
        self.default_sources = list(default_sources or self.sources_map)
        self.batch_size = batch_size
        self.validation_batch_size = validation_batch_size or batch_size
        self.sort_k_batches = sort_k_batches
        self.max_length = max_length
        self.add_eos = add_eos
        self.prepend_eos = prepend_eos
        self._eos_label = eos_label
        self.add_bos = add_bos
        # int, or a per-conceptual-source dict ({recordings: 100,
        # labels: 10}): time-padding bucket sizes for static shapes
        self.pad_multiple = pad_multiple
        # pad the final partial batch up to the full batch size (masked
        # rows) so the train step compiles for one batch dimension
        self.pad_batches = pad_batches
        self.prefetch = prefetch
        self.dataset_cache = {}
        if isinstance(normalization, str):
            # "" means "no normalization" (wsj_good_fbank.yaml sets it
            # to clear the inherited wsj_norm.pkl)
            normalization = (Normalization.load(normalization)
                             if normalization else None)
        self.normalization = normalization
        # length filter on the first conceptual source (input lengths)
        self.length_filter = LengthFilter(
            source=self.default_sources[0], max_length=max_length)

    # -- info --------------------------------------------------------------
    @property
    def info_dataset(self):
        return self.get_dataset("train")

    @property
    def num_labels(self):
        return self.info_dataset.num_characters

    @property
    def eos_label(self):
        if self._eos_label is not None:
            return self._eos_label
        return self.info_dataset.eos_label

    @property
    def bos_label(self):
        return self.info_dataset.bos_label

    def character_map(self, source):
        return self.info_dataset.character_map(self.sources_map[source])

    def num_features(self, source):
        return self.info_dataset.dim(self.sources_map[source])

    def decode(self, labels):
        return self.info_dataset.decode(labels)

    def pretty_print(self, labels, example=None):
        return self.info_dataset.pretty_print(labels, example)

    # -- datasets & streams ------------------------------------------------
    def get_dataset(self, part, add_sources=()):
        sources = tuple(self.sources_map[s]
                        for s in self.default_sources + list(add_sources))
        key = (part, sources)
        if key not in self.dataset_cache:
            path = self.dataset_filename
            if not os.path.isabs(path):
                path = os.path.join(self.data_dir, path)
            self.dataset_cache[key] = self.dataset_class(
                file_or_path=path,
                which_sets=(self.name_mapping.get(part, part),),
                sources=sources,
                target_source=self.sources_map["labels"])
        return self.dataset_cache[key]

    def _examples(self, part, add_sources, shuffle, rng, num_examples):
        dataset = self.get_dataset(part, add_sources)
        conceptual = self.default_sources + list(add_sources)
        labels_src = self.sources_map["labels"]
        stream = ExampleStream(dataset, dataset.sources, shuffle=shuffle,
                               rng=rng, num_examples=num_examples)
        for raw in stream:
            ex = {c: raw[self.sources_map[c]] for c in conceptual}
            if self.add_eos:
                ex = add_label(ex, "labels", self.eos_label)
            if self.add_bos:
                if self.bos_label is None:
                    raise ValueError("add_bos requires a <bol> label")
                ex = add_label(ex, "labels", self.bos_label, append=False,
                               times=self.add_bos)
            if not self.length_filter(ex):
                continue
            if self.normalization is not None:
                norm = self.normalization
                if norm.source in ex:
                    ex = norm(ex)
            for c in conceptual:
                if np.asarray(ex[c]).dtype == np.float64:
                    ex[c] = np.asarray(ex[c], np.float32)
            yield ex

    def get_stream(self, part, batches=True, shuffle=True, add_sources=(),
                   num_examples=None, rng=None, seed=None
                   ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield example dicts (batches=False) or padded batch dicts."""
        if rng is None and seed is not None:
            rng = np.random.RandomState(seed)

        def factory():
            examples = self._examples(part, add_sources, shuffle, rng,
                                      num_examples)
            if not batches:
                yield from examples
                return
            batch_size = (self.batch_size if part == "train"
                          else self.validation_batch_size)
            pad_sources = self.default_sources + list(add_sources)
            pad_sources = [s for s in pad_sources if s != "uttids"]
            if self.sort_k_batches:
                groups = sorted_buckets(
                    examples, self.default_sources[0], batch_size,
                    self.sort_k_batches)
            else:
                groups = _chunks(examples, batch_size)
            for group in groups:
                batch = pad_batch(
                    group, pad_sources, pad_multiple=self.pad_multiple,
                    pad_batch_to=(batch_size if self.pad_batches else None))
                if "uttids" in (self.default_sources + list(add_sources)):
                    batch["uttids"] = [ex.get("uttids") for ex in group]
                yield batch

        if self.prefetch and batches:
            return iter(Prefetcher(factory))
        return factory()


def _chunks(iterable, size):
    chunk = []
    for item in iterable:
        chunk.append(item)
        if len(chunk) == size:
            yield chunk
            chunk = []
    if chunk:
        yield chunk
