"""Log-mel fbank + delta frontend: the CUDA kernel's wrapper and its plain
version.

Counterpart of ``attention_lvcsr_tpu/ops/pallas/frontend.py::
fbank_deltas_pallas`` (:180).  The rFFT of each 25 ms frame is two DFT
products whose tables have preemphasis and the Hamming window folded in
(host float64, then float32; :44-80), followed by the power spectrum, the
mel product, the log with a 1e-10 floor, the log-energy of the raw frame,
and the delta passes with Kaldi's edge replication at each row's true
frame count: rows at or past ``num_frames[b]`` become copies of row
``num_frames[b] - 1`` before and after every delta pass.  The TPU kernel's
128-lane padding of the frequency axis is TPU layout; the port keeps the
real ``fft_size // 2 + 1`` bins.

``fbank_deltas`` takes the plain PyTorch version, :func:`fbank_deltas_plain`,
for tensors on the CPU and launches ``csrc/frontend.cu`` (one launch) for
tensors on a CUDA device; any other device raises.  There is no fallback
from one to the other.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from attention_lvcsr_torch import _build
from attention_lvcsr_torch.data.features import delta_coeffs, mel_filterbank

launches = _build.LaunchCounter()

# Kaldi's fbank and add-deltas settings, those of ``data/features.py``;
# csrc/frontend.cu fixes the delta filter to DELTA_WINDOW's 5 taps
FRAME_MS, HOP_MS, PREEMPHASIS, DELTA_WINDOW = 25.0, 10.0, 0.97, 2
TILE_FRAMES = 64      # frames whose base features one block computes


def frame_geometry(sample_rate, frame_ms=FRAME_MS, hop_ms=HOP_MS):
    """(frame_length, hop, fft_size) in samples at ``sample_rate``."""
    frame_length = int(sample_rate * frame_ms / 1000)
    hop = int(sample_rate * hop_ms / 1000)
    return frame_length, hop, 1 << (frame_length - 1).bit_length()


@functools.lru_cache(maxsize=None)
def _host_matrices(sample_rate, num_bins, frame_ms, hop_ms, preemphasis):
    frame_length, _, fft_size = frame_geometry(sample_rate, frame_ms, hop_ms)
    n_freqs = fft_size // 2 + 1
    # preemphasis as a matrix (pre[0] uses x[0], as numpy fbank does)
    P = np.eye(frame_length)
    P[0, 0] -= preemphasis
    for j in range(1, frame_length):
        P[j, j - 1] = -preemphasis
    w = np.hamming(frame_length)
    ang = -2.0 * math.pi * np.outer(np.arange(n_freqs),
                                    np.arange(frame_length)) / fft_size
    a_cos = (np.cos(ang) * w) @ P                # (n_freqs, frame_length)
    a_sin = (np.sin(ang) * w) @ P
    fb = mel_filterbank(num_bins, fft_size, sample_rate)   # (bins, n_freqs)
    return tuple(np.ascontiguousarray(m.T, np.float32)
                 for m in (a_cos, a_sin, fb))


@functools.lru_cache(maxsize=None)
def _matrices(sample_rate, num_bins, frame_ms, hop_ms, preemphasis, device):
    """(a_cos, a_sin) (frame_length, n_freqs) and the transposed mel matrix
    (n_freqs, num_bins), float32 on ``device``; cached per arguments and
    device."""
    return tuple(torch.tensor(m, device=device) for m in _host_matrices(
        sample_rate, num_bins, float(frame_ms), float(hop_ms),
        float(preemphasis)))


def _num_frames(N, frame_length, hop):
    T = 1 + (N - frame_length) // hop
    if T < 1:
        raise ValueError(f"waveform too short: {N} samples < one "
                         f"{frame_length}-sample frame")
    return T


def _frame_counts(num_frames, B, T, device):
    """Each row's true frame count, (B,) int64 in [1, T] (default T)."""
    if num_frames is None:
        return torch.full((B,), T, dtype=torch.int64, device=device)
    counts = torch.as_tensor(num_frames, device=device).to(torch.int64)
    if tuple(counts.shape) != (B,):
        raise ValueError(f"num_frames has shape {tuple(counts.shape)}, "
                         f"expected ({B},)")
    return counts.clamp(1, T)


def fbank_deltas_plain(wav, num_frames=None, sample_rate=16000, num_bins=40,
                       use_energy=True, deltas_order=2):
    """Plain version of :func:`fbank_deltas`, same arguments: the frame
    matrix, the folded-table products, power, mel, log, log-energy and the
    edge-clamped delta FIRs in PyTorch operations."""
    a_cos, a_sin, fb_t = _matrices(sample_rate, num_bins, FRAME_MS, HOP_MS,
                                   PREEMPHASIS, wav.device)
    frame_length, hop, _ = frame_geometry(sample_rate)
    B, N = wav.shape
    T = _num_frames(N, frame_length, hop)
    frames = wav.unfold(1, frame_length, hop)            # (B, T, frame)
    xc, xs = frames @ a_cos, frames @ a_sin
    feats = [torch.log(torch.clamp_min((xc * xc + xs * xs) @ fb_t, 1e-10))]
    if use_energy:
        feats.insert(0, torch.log(torch.clamp_min(
            (frames * frames).sum(-1, keepdim=True), 1e-10)))
    f = torch.cat(feats, dim=-1)
    n = _frame_counts(num_frames, B, T, wav.device)
    rows = torch.minimum(torch.arange(T, device=wav.device)[None],
                         (n - 1)[:, None])                # the row each copies
    clamp_tail = lambda x: torch.gather(
        x, 1, rows[..., None].expand(B, T, x.shape[-1]))
    coeffs = delta_coeffs(DELTA_WINDOW)
    cur = clamp_tail(f)
    outs = [cur]
    for _ in range(deltas_order):
        padded = torch.cat([cur[:, :1]] * DELTA_WINDOW + [cur]
                           + [cur[:, -1:]] * DELTA_WINDOW, dim=1)
        acc = None
        for m, c in enumerate(coeffs):
            if c:
                term = float(c) * padded[:, m:m + T]
                acc = term if acc is None else acc + term
        cur = clamp_tail(acc)
        outs.append(cur)
    return torch.cat(outs, dim=-1)


class _Args(ctypes.Structure):
    """Mirror of ``struct FrontendArgs`` in csrc/frontend.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "wav", "num_frames", "a_cos", "a_sin", "fb", "out")]
        + [(n, ctypes.c_int) for n in (
            "B", "N", "T", "frame_length", "hop", "n_freqs", "num_bins",
            "use_energy", "order", "rows")])


def _kernel_fits(lib, args, sample_rate, deltas_order, device):
    """Raise NotImplementedError naming what csrc/frontend.cu does not
    cover: a delta halo as wide as half a tile, or a sample rate whose
    tile (63 hops and a frame of samples, the DFT tables' slices, the
    power and feature tiles) overflows a block's shared memory."""
    if 2 * deltas_order * DELTA_WINDOW >= TILE_FRAMES:
        raise NotImplementedError(
            f"fbank_deltas: deltas order {deltas_order} is not ported yet "
            f"(the kernel's halo of order * {DELTA_WINDOW} frames must stay "
            f"under {TILE_FRAMES // 2})")
    lib.frontend_smem_bytes.argtypes = [ctypes.POINTER(_Args)]
    lib.frontend_smem_bytes.restype = ctypes.c_int
    smem = lib.frontend_smem_bytes(ctypes.byref(args))
    props = torch.cuda.get_device_properties(device)
    limit = getattr(props, "shared_memory_per_block_optin", 232448)
    if smem > limit:
        raise NotImplementedError(
            f"fbank_deltas: sample rate {sample_rate} Hz is not ported yet "
            f"(a {TILE_FRAMES}-frame tile needs {smem} bytes of shared "
            f"memory, the card's limit is {limit})")


def fbank_deltas(wav, num_frames=None, sample_rate=16000, num_bins=40,
                 use_energy=True, deltas_order=2):
    """Fused frontend: (B, N) float32 waveforms -> (B, T, D) features, D =
    (num_bins + use_energy) * (1 + deltas_order), T = 1 + (N -
    frame_length) // hop.  ``num_frames`` (B,) gives each row's true frame
    count (default T); rows past it replicate its last real frame through
    the delta passes, then carry no information: mask them downstream."""
    device = wav.device
    if device.type == "cpu":
        return fbank_deltas_plain(wav, num_frames, sample_rate, num_bins,
                                  use_energy, deltas_order)
    if device.type != "cuda":
        raise ValueError(f"fbank_deltas: no kernel for device {device}")
    if wav.dtype != torch.float32 or wav.dim() != 2 \
            or not wav.is_contiguous():
        raise ValueError(f"fbank_deltas: wav must be a contiguous (B, N) "
                         f"float32 tensor, got {wav.dtype} "
                         f"{tuple(wav.shape)}")
    a_cos, a_sin, fb_t = _matrices(sample_rate, num_bins, FRAME_MS, HOP_MS,
                                   PREEMPHASIS, device)
    frame_length, hop, _ = frame_geometry(sample_rate)
    B, N = wav.shape
    T = _num_frames(N, frame_length, hop)
    counts = _frame_counts(num_frames, B, T, device).to(torch.int32)
    d0 = num_bins + (1 if use_energy else 0)
    out = torch.empty(B, T, d0 * (1 + deltas_order), dtype=torch.float32,
                      device=device)
    if not B:
        return out
    args = _Args(wav.data_ptr(), counts.data_ptr(), a_cos.data_ptr(),
                 a_sin.data_ptr(), fb_t.data_ptr(), out.data_ptr(),
                 B, N, T, frame_length, hop, a_cos.shape[1], num_bins,
                 int(use_energy), deltas_order,
                 TILE_FRAMES - 2 * deltas_order * DELTA_WINDOW)
    lib = _build.load().lib
    _kernel_fits(lib, args, sample_rate, deltas_order, device)
    lib.frontend_f32.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    lib.frontend_f32.restype = ctypes.c_int
    with torch.cuda.device(device):
        status = lib.frontend_f32(ctypes.byref(args), _build.stream_of(wav))
    _build.check(status, "frontend_f32")
    launches.count += 1
    return out
