"""Feature normalization and spectrogram utilities.

Counterpart of ``lvsr/preprocessing.py:7-54``: dataset-wide mean/std
computed by streaming over a split, persisted to disk, applied per example
in the pipeline.  Persisted as ``.npz`` (arrays, no pickled code objects).
"""
from __future__ import annotations

import numpy as np


class Normalization:
    """Streaming mean/std over feature frames of a source."""

    def __init__(self, mean=None, std=None, source="recordings"):
        self.mean = mean
        self.std = std
        self.source = source

    @classmethod
    def compute(cls, examples, source="recordings"):
        """``examples``: iterable of dicts with (T, F) arrays at `source`."""
        total = None
        total_sq = None
        count = 0
        for ex in examples:
            feats = np.asarray(ex[source], dtype=np.float64)
            if total is None:
                total = feats.sum(axis=0)
                total_sq = (feats ** 2).sum(axis=0)
            else:
                total += feats.sum(axis=0)
                total_sq += (feats ** 2).sum(axis=0)
            count += feats.shape[0]
        mean = total / count
        var = total_sq / count - mean ** 2
        std = np.sqrt(np.maximum(var, 1e-10))
        return cls(mean.astype("float32"), std.astype("float32"), source)

    def __call__(self, example):
        example = dict(example)
        feats = np.asarray(example[self.source], dtype=np.float32)
        example[self.source] = (feats - self.mean) / self.std
        return example

    def save(self, path):
        np.savez(path, mean=self.mean, std=self.std,
                 source=np.asarray(self.source))

    @classmethod
    def load(cls, path):
        data = np.load(path, allow_pickle=False)
        return cls(data["mean"], data["std"], str(data["source"]))


def log_spectrogram(wav: np.ndarray, frame_length=256, hop=128,
                    eps=1e-10) -> np.ndarray:
    """Log-magnitude STFT of a waveform (lvsr/preprocessing.py:47-54 role)."""
    wav = np.asarray(wav, dtype=np.float64)
    n_frames = max(0, 1 + (len(wav) - frame_length) // hop)
    window = np.hanning(frame_length)
    frames = np.stack([wav[i * hop:i * hop + frame_length] * window
                       for i in range(n_frames)])
    spec = np.abs(np.fft.rfft(frames, axis=-1))
    return np.log(spec + eps).astype("float32")
