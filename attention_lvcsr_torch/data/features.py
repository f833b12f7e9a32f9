"""Speech features: log-mel filterbanks + deltas.

The port's own copy of the numpy half of
``attention_lvcsr_tpu/data/features.py`` (:26-118), the offline pipeline
the reference ran through Kaldi (``compute-fbank-feats`` with 40 mel bins
+ energy, ``add-deltas``), and :func:`device_frontend`, its counterpart of
the JAX module's on-device frontend (:149-208) on torch tensors.  The
defaults follow Kaldi's fbank: 25 ms window, 10 ms hop, preemphasis 0.97,
a Hamming window, log-energy, delta window 2 with order 2.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np


def mel_filterbank(num_bins: int, fft_size: int, sample_rate: int,
                   low_freq: float = 20.0,
                   high_freq: Optional[float] = None) -> np.ndarray:
    """Triangular mel filterbank matrix (num_bins, fft_size//2 + 1)."""
    if high_freq is None:
        high_freq = sample_rate / 2.0
    mel = lambda f: 1127.0 * math.log(1.0 + f / 700.0)
    imel = lambda m: 700.0 * (math.exp(m / 1127.0) - 1.0)
    points = np.linspace(mel(low_freq), mel(high_freq), num_bins + 2)
    freqs = np.asarray([imel(m) for m in points])
    bins = freqs * fft_size / sample_rate
    n_freqs = fft_size // 2 + 1
    fb = np.zeros((num_bins, n_freqs), np.float32)
    idx = np.arange(n_freqs)
    for b in range(num_bins):
        left, center, right = bins[b], bins[b + 1], bins[b + 2]
        up = (idx - left) / max(center - left, 1e-10)
        down = (right - idx) / max(right - center, 1e-10)
        fb[b] = np.maximum(0.0, np.minimum(up, down))
    return fb


def frame_signal(wav: np.ndarray, frame_length: int, hop: int) -> np.ndarray:
    n = max(0, 1 + (len(wav) - frame_length) // hop)
    if n == 0:
        return np.zeros((0, frame_length), np.float32)
    idx = np.arange(frame_length)[None, :] + hop * np.arange(n)[:, None]
    return wav[idx].astype(np.float32)


def fbank(wav: np.ndarray, sample_rate: int = 16000, num_bins: int = 40,
          frame_ms: float = 25.0, hop_ms: float = 10.0,
          preemphasis: float = 0.97, use_energy: bool = True,
          dither: float = 0.0, rng=None) -> np.ndarray:
    """Log-mel filterbank features (T, num_bins [+1 energy])."""
    wav = np.asarray(wav, np.float64)
    if dither and rng is not None:
        wav = wav + dither * rng.randn(len(wav))
    frame_length = int(sample_rate * frame_ms / 1000)
    hop = int(sample_rate * hop_ms / 1000)
    fft_size = 1 << (frame_length - 1).bit_length()

    frames = frame_signal(wav, frame_length, hop)
    if not len(frames):
        return np.zeros((0, num_bins + (1 if use_energy else 0)),
                        np.float32)
    log_energy = np.log(np.maximum((frames ** 2).sum(axis=1), 1e-10))
    # per-frame preemphasis + window
    pre = frames - preemphasis * np.concatenate(
        [frames[:, :1], frames[:, :-1]], axis=1)
    window = np.hamming(frame_length)
    spec = np.abs(np.fft.rfft(pre * window, n=fft_size, axis=1)) ** 2
    fb = mel_filterbank(num_bins, fft_size, sample_rate)
    mels = np.log(np.maximum(spec @ fb.T, 1e-10))
    if use_energy:
        mels = np.concatenate([log_energy[:, None], mels], axis=1)
    return mels.astype(np.float32)


def delta_coeffs(window: int = 2) -> np.ndarray:
    """Kaldi-style delta regression filter of half-width ``window``."""
    norm = 2 * sum(i * i for i in range(1, window + 1))
    return np.asarray([i / norm for i in range(-window, window + 1)],
                      np.float32)


def add_deltas(feats: np.ndarray, order: int = 2,
               window: int = 2) -> np.ndarray:
    """Append delta (and delta-delta, ...) features (Kaldi add-deltas).

    Edge frames are edge-replicated before the regression filter.
    """
    coeffs = delta_coeffs(window)[::-1]  # correlation via convolve
    outs = [feats]
    current = feats
    for _ in range(order):
        padded = np.pad(current, ((window, window), (0, 0)), mode="edge")
        nxt = np.stack([
            np.convolve(padded[:, d], coeffs, mode="valid")
            for d in range(padded.shape[1])], axis=1)
        outs.append(nxt.astype(np.float32))
        current = nxt
    return np.concatenate(outs, axis=1)


def extract_features(wav, sample_rate=16000, num_bins=40, use_energy=True,
                     deltas_order: int = 2) -> np.ndarray:
    """compute-fbank-feats + add-deltas pipeline (one utterance)."""
    feats = fbank(wav, sample_rate=sample_rate, num_bins=num_bins,
                  use_energy=use_energy)
    if deltas_order:
        feats = add_deltas(feats, order=deltas_order)
    return feats


def device_frontend(wav_batch, num_frames=None, sample_rate: int = 16000,
                    num_bins: int = 40, use_energy: bool = True,
                    deltas_order: int = 2):
    """fbank + deltas for a (B, N) float32 waveform tensor on its device:
    the CUDA frontend kernel on a CUDA tensor, its plain version on the
    CPU (``ops/frontend.py``).  Returns (B, T, D) float32 with T = 1 + (N
    - frame_length) // hop; rows past ``num_frames[b]`` (a (B,) integer
    tensor, default T) replicate row ``num_frames[b] - 1`` before every
    delta pass, so the edge replication is exact at each utterance's true
    end; mask them downstream."""
    from attention_lvcsr_torch.ops.frontend import fbank_deltas
    return fbank_deltas(wav_batch, num_frames, sample_rate=sample_rate,
                        num_bins=num_bins, use_energy=use_energy,
                        deltas_order=deltas_order)
