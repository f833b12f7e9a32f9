"""Direct h5py access to Fuel-layout speech datasets (reader only).

The port's copy of ``attention_lvcsr_tpu/data/h5.py`` without the
dataset writer; ``h5py`` is imported when a file is opened.

Reads the file layout produced by the reference's ``bin/kaldi2fuel.py``
and consumed by Fuel's ``H5PYDataset`` (``fuel/datasets/hdf5.py:94-160``):
root-group sources (vlen arrays with ``<source>_shapes`` side tables), a
``split`` root attribute (compound rows: split/source/start/stop/indices/
available/comment), and a ``value_map`` attribute on symbol sources.
No Fuel dependency — h5py is already a C-backed reader, and batching/
padding happens in :mod:`attention_lvcsr_torch.data.pipeline`.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np


class H5AudioDataset:
    """One split of a Fuel-layout HDF5 file (lvsr/datasets/h5py.py:5-46)."""

    def __init__(self, file_or_path, which_sets: Sequence[str],
                 sources: Sequence[str], target_source: str = "labels"):
        self.path = file_or_path
        self.which_sets = tuple(which_sets)
        self.sources = tuple(sources)
        self.target_source = target_source
        import h5py      # only the CLI reads datasets: no h5py on the card
        self._file = h5py.File(file_or_path, "r")
        self._index = self._resolve_split_indices()

        tgt = self._file[target_source]
        self.char2num = self.character_map(target_source)
        self.num2char = {num: char for char, num in self.char2num.items()}
        self.num_characters = len(self.num2char)
        self.eos_label = self.char2num.get("<eol>")
        self.bos_label = self.char2num.get("<bol>")

    # -- layout ------------------------------------------------------------
    def _resolve_split_indices(self) -> np.ndarray:
        split_table = self._file.attrs["split"]
        per_source = {}
        for row in split_table:
            name = row["split"].decode()
            source = row["source"].decode()
            if name not in self.which_sets or source not in self.sources:
                continue
            if not row["available"]:
                raise ValueError(f"source {source} unavailable in {name}")
            if row["indices"]:
                idx = np.sort(np.asarray(self._file[row["indices"]]))
            else:
                idx = np.arange(int(row["start"]), int(row["stop"]))
            per_source.setdefault(source, []).append(idx)
        if not per_source:
            raise ValueError(
                f"splits {self.which_sets} not found for {self.sources}")
        merged = {s: np.concatenate(v) for s, v in per_source.items()}
        lengths = {len(v) for v in merged.values()}
        if len(lengths) != 1:
            raise ValueError("sources disagree on split size")
        first = merged[self.sources[0]]
        for s, v in merged.items():
            if not np.array_equal(v, first):
                raise ValueError("per-source split indices differ")
        return first

    @property
    def num_examples(self) -> int:
        return len(self._index)

    def character_map(self, source) -> Dict[str, int]:
        attrs = self._file[source].attrs
        if "value_map" not in attrs:
            return {}
        vm = attrs["value_map"]
        return {(k.decode() if isinstance(k, bytes) else str(k)): int(v)
                for k, v in vm}

    def dim(self, source) -> int:
        shapes = self._file.get(source + "_shapes")
        if shapes is None:
            return 0
        return int(shapes[0][1])

    def get_example(self, i: int) -> Tuple:
        """Example ``i`` of the split as a tuple ordered like sources."""
        j = int(self._index[i])
        out = []
        for source in self.sources:
            data = self._file[source][j]
            shapes = self._file.get(source + "_shapes")
            if shapes is not None and np.ndim(data) == 1:
                shape = tuple(int(x) for x in shapes[j])
                if len(shape) > 1:
                    data = np.asarray(data).reshape(shape)
            out.append(np.asarray(data))
        return tuple(out)

    def example_lengths(self, source) -> np.ndarray:
        """Sequence lengths without reading payloads (via _shapes)."""
        shapes = self._file.get(source + "_shapes")
        if shapes is not None:
            return np.asarray(shapes)[self._index, 0]
        return np.asarray([len(self._file[source][int(j)])
                           for j in self._index])

    # -- symbol handling ---------------------------------------------------
    def decode(self, labels, keep_eos=False) -> List[str]:
        return [self.num2char[int(l)] for l in labels
                if (int(l) != self.eos_label or keep_eos)
                and int(l) != self.bos_label]

    def pretty_print(self, labels, example=None) -> str:
        chars = self.decode(labels)
        return "".join(" " if c == "<spc>" else c for c in chars)

    def monospace_print(self, labels) -> str:
        subst = {"<spc>": "_", "<noise>": "~", "<eol>": "$", "<bol>": "^"}
        chars = self.decode(labels, keep_eos=True)
        return "".join(subst.get(c, c) for c in chars)


# TIMIT 60->39 phone folding (standard Lee & Hon mapping, as used by the
# reference's H5PYAudioDatasetTimit, lvsr/datasets/h5py.py:49-136).
TIMIT_61_TO_39 = {
    "aa": "aa", "ae": "ae", "ah": "ah", "ao": "aa", "aw": "aw", "ax": "ah",
    "ax-h": "ah", "axr": "er", "ay": "ay", "b": "b", "bcl": "sil",
    "ch": "ch", "d": "d", "dcl": "sil", "dh": "dh", "dx": "dx", "eh": "eh",
    "el": "l", "em": "m", "en": "n", "eng": "ng", "epi": "sil", "er": "er",
    "ey": "ey", "f": "f", "g": "g", "gcl": "sil", "h#": "sil", "hh": "hh",
    "hv": "hh", "ih": "ih", "ix": "ih", "iy": "iy", "jh": "jh", "k": "k",
    "kcl": "sil", "l": "l", "m": "m", "n": "n", "ng": "ng", "nx": "n",
    "ow": "ow", "oy": "oy", "p": "p", "pau": "sil", "pcl": "sil", "q": "",
    "r": "r", "s": "s", "sh": "sh", "t": "t", "tcl": "sil", "th": "th",
    "uh": "uh", "uw": "uw", "ux": "uw", "v": "v", "w": "w", "y": "y",
    "z": "z", "zh": "sh",
}


class H5AudioDatasetTimit(H5AudioDataset):
    """TIMIT variant: decode folds 60 phones to the 39-phone eval set."""

    def decode(self, labels, keep_eos=False, map_to_39=True):
        out = []
        for l in labels:
            l = int(l)
            if l in (self.eos_label, self.bos_label):
                continue
            ph = self.num2char[l]
            if map_to_39:
                ph = TIMIT_61_TO_39.get(ph, ph)
            if ph:
                out.append(ph)
        return out

    def pretty_print(self, labels, example=None):
        return " ".join(self.decode(labels))


DATASET_REGISTRY = {
    "H5PYAudioDataset": H5AudioDataset,
    "H5AudioDataset": H5AudioDataset,
    "H5PYAudioDatasetTimit": H5AudioDatasetTimit,
    "H5AudioDatasetTimit": H5AudioDatasetTimit,
}
