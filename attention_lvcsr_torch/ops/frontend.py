"""Log-mel fbank + delta frontend: the CUDA kernel's wrapper and its plain
version.

Counterpart of ``attention_lvcsr_tpu/ops/pallas/frontend.py::
fbank_deltas_pallas`` (:180): per 25 ms frame, preemphasis (``x[j] - 0.97
x[j-1]``, ``x[-1] := x[0]``), the Hamming window, zero padding to the FFT
size, the power spectrum of the real FFT, the mel sums, the log with a
1e-10 floor, the log-energy of the raw frame, then the delta passes with
Kaldi's edge replication at each row's true frame count: rows at or past
``num_frames[b]`` become copies of row ``num_frames[b] - 1`` before and
after every delta pass.  The TPU kernel's 128-lane padding of the
frequency axis is TPU layout; the port keeps the real ``fft_size // 2 + 1``
bins.

:func:`fbank_deltas_plain` computes the rFFT as two DFT products whose
tables fold in preemphasis and the window (host float64, then float32), as
the TPU kernel does.  ``csrc/frontend.cu`` computes it as a real FFT in
shared memory and registers, one warp a frame, on the tables of
:func:`host_tables` (window, twiddles, the mel schedule), in tiles of
frames chosen by :func:`plan` so that one request fills the card.

``fbank_deltas`` takes the plain version for tensors on the CPU and
launches the kernel (one launch) for tensors on a CUDA device; any other
device raises.  There is no fallback from one to the other.
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


# ---- the kernel's host side ------------------------------------------------

# frames whose base features one block computes, at most: at B=64 x 8 s,
# 40-row tiles (three blocks an SM at 16 kHz) ran faster than 56- and
# 32-row ones (tools/torch_bench_decode_kernels.py --frontend-rows)
MAX_FRAMES = 48
WARPS = 8             # warps a block; a warp computes one frame at a time
MAX_SMEM = 232448     # an H100's opt-in shared memory a block, in bytes
# log2 of the FFT sizes the kernel takes: 256 points (8 kHz) to 2048 (48 kHz)
LOG2N_RANGE = (8, 11)


def _bitrev(x, bits):
    return int(format(x, f"0{bits}b")[::-1], 2)


def fft_geometry(sample_rate):
    """(n, log2 n, P, N) of the kernel's FFT at ``sample_rate``: the real
    FFT of n = fft_size points is an N = n / 2 point complex FFT, N = 32 P
    (a lane of the frame's warp holds P points)."""
    n = frame_geometry(sample_rate)[2]
    return n, n.bit_length() - 1, n // 64, n // 2


def mel_schedule(sample_rate, num_bins):
    """How the kernel's warp takes the mel sums of a frame without a
    power row: lane l holds the power of the P bins [q P, q P + P), q =
    br_5(l) (and lane 31 the Nyquist bin as its bin P), in registers.
    Each bin lies in at most two filters, f(k) and f(k) + 1, with f never
    decreasing in k; so a lane walks its bins in order with two running
    sums, A (filter f) and B (f + 1).  Where f steps up by d at a bin, the
    lane d times emits A to its next slot, takes A = B and B = 0, then
    adds the bin into both.  At its last bin it emits A and B.  Filter m
    is then the sum of its slots, in chunk order.

    Returns ``adv`` ((P + 1, 32) int: the step d at bin r of lane l),
    ``w`` ((P + 1, 32, 2): the bin's weights in filters f and f + 1),
    ``slot`` ((E, 32) int: where emit e of lane l goes; ``slots`` is the
    slot of emits outside [0, num_bins), written and never read) and
    ``segoff`` (num_bins + 1: filter m's slots are [segoff[m],
    segoff[m + 1]))."""
    n, _, P, N = fft_geometry(sample_rate)
    fb = mel_filterbank(num_bins, n, sample_rate)
    f, lower = -1, []
    for k in range(N + 1):
        nz = np.flatnonzero(fb[:, k])
        if len(nz):
            f = max(f, int(nz[-1]) - 1)
            if nz[0] < f:
                raise ValueError(f"bin {k} lies in filters {list(nz)}: "
                                 f"not a chain of two")
        lower.append(f)
    weight = lambda m, k: float(fb[m, k]) if 0 <= m < num_bins else 0.0
    adv = np.zeros((P + 1, 32), np.int32)
    w = np.zeros((P + 1, 32, 2), np.float32)
    emits = []                     # per lane: the filters it emits, in order
    for lane in range(32):
        q = _bitrev(lane, 5)
        bins = list(range(q * P, q * P + P)) + ([N] if q == 31 else [])
        cur, out = lower[bins[0]], []
        for r, k in enumerate(bins):
            adv[r, lane] = lower[k] - cur
            out += range(cur, lower[k])
            cur = lower[k]
            w[r, lane] = weight(cur, k), weight(cur + 1, k)
        emits.append(out + [cur, cur + 1])
    order = sorted((m, _bitrev(lane, 5), lane, e)
                   for lane, out in enumerate(emits)
                   for e, m in enumerate(out) if 0 <= m < num_bins)
    slots = len(order)
    slot = np.full((max(map(len, emits)), 32), slots, np.int32)
    segoff = np.zeros(num_bins + 1, np.int32)
    for i, (m, _, lane, e) in enumerate(order):
        slot[e, lane] = i
        segoff[m + 1] = i + 1
    segoff = np.maximum.accumulate(segoff)
    return {"adv": adv, "w": w, "slot": slot, "slots": slots,
            "segoff": segoff}


@functools.lru_cache(maxsize=None)
def host_tables(sample_rate, num_bins):
    """The kernel's tables at ``sample_rate``, in float64 rounded to
    float32, as ``csrc/frontend.cu::frontend_kernel`` reads them:

    ``tables`` (float32), in order: ``win`` (n: the Hamming window, zero
    past the frame), ``twp`` (P/2 complex, W_P^k: the lane's P-point
    DFT), ``twl`` (P x 32 complex, [i][lane] = W_N^(lane * br_P(i))),
    ``tws`` (4 x 32 complex, [stage][lane]: the cross-lane stages' twiddle,
    W_2h^(lane % h) where ``lane & h``, else 1, h = 16, 8, 4, 2), ``twk``
    (P x 32 complex, [i][lane] = W_n^k of the bin k = br_P(i) + P
    br_5(lane) that register i of the lane holds), then ``melw`` ((P + 1)
    x 32 pairs: :func:`mel_schedule`'s weights).  W_m = exp(-2 pi i / m);
    complex values are (re, im) pairs.

    ``ints`` (int32): :func:`mel_schedule`'s ``adv`` ((P + 1) x 32),
    ``slot`` (``emits`` x 32) and ``segoff`` (num_bins + 1); ``slots``
    partial sums a frame.
    """
    frame_length, _, _ = frame_geometry(sample_rate)
    n, _, P, N = fft_geometry(sample_rate)
    logp = P.bit_length() - 1
    lanes = np.arange(32)
    w = lambda k, m: np.exp(-2j * np.pi * np.asarray(k, np.float64) / m)
    win = np.zeros(n)
    win[:frame_length] = np.hamming(frame_length)
    twp = w(np.arange(P // 2), P)
    brp = np.array([_bitrev(i, logp) for i in range(P)])
    br5 = np.array([_bitrev(lane, 5) for lane in lanes])
    twl = w(brp[:, None] * lanes[None], N)
    tws = np.stack([np.where(lanes & h, w(lanes % h, 2 * h), 1.0)
                    for h in (16, 8, 4, 2)])
    twk = w(brp[:, None] + P * br5[None], n)
    mel = mel_schedule(sample_rate, num_bins)
    pairs = lambda z: np.stack([z.real, z.imag], -1).ravel()
    tables = np.concatenate([win, pairs(twp), pairs(twl), pairs(tws),
                             pairs(twk), mel["w"].ravel()])
    return {"tables": tables.astype(np.float32),
            "ints": np.concatenate([mel["adv"].ravel(), mel["slot"].ravel(),
                                    mel["segoff"]]).astype(np.int32),
            "emits": mel["slot"].shape[0], "slots": mel["slots"]}


def _round4(x):
    return (x + 3) // 4 * 4


def layout(sample_rate, num_bins, use_energy, order, rows):
    """The kernel's shared memory (``csrc/frontend.cu::front_layout``) for
    tiles of ``rows`` output frames: offsets in floats of the tables, the
    mel schedule's integers, the tile's waveform span, the warps' partial
    mel sums and the feature levels, and ``bytes``."""
    frame_length, hop, _ = frame_geometry(sample_rate)
    host = host_tables(sample_rate, num_bins)
    frames = rows + 2 * order * DELTA_WINDOW
    d0 = num_bins + bool(use_energy)
    out = {"tables": 0}
    out["ints"] = _round4(len(host["tables"]))
    out["wav"] = out["ints"] + _round4(len(host["ints"]))
    out["part"] = out["wav"] + _round4((frames - 1) * hop + frame_length)
    out["lev"] = out["part"] + _round4(WARPS * (host["slots"] + 1))
    out["bytes"] = 4 * (out["lev"] + (1 + order) * frames * d0)
    return out


@functools.lru_cache(maxsize=None)
def max_rows(sample_rate, num_bins, use_energy, order, limit):
    """The most output frames a block's tile can take within ``limit``
    bytes of shared memory; raise NotImplementedError naming what the
    kernel does not cover (an FFT past 2048 points, a delta halo of half
    a tile, a tile past the limit)."""
    n, log2n, _, _ = fft_geometry(sample_rate)
    if not LOG2N_RANGE[0] <= log2n <= LOG2N_RANGE[1]:
        raise NotImplementedError(
            f"fbank_deltas: sample rate {sample_rate} Hz is not ported yet "
            f"(its {n}-point FFT is outside the kernel's "
            f"{1 << LOG2N_RANGE[0]}-{1 << LOG2N_RANGE[1]})")
    halo = 2 * order * DELTA_WINDOW       # both sides of the tile
    if halo >= MAX_FRAMES:
        raise NotImplementedError(
            f"fbank_deltas: deltas order {order} is not ported yet (the "
            f"kernel's halo of order * {DELTA_WINDOW} frames must stay "
            f"under {MAX_FRAMES // 2})")
    for rows in range(MAX_FRAMES - halo, 0, -1):
        if layout(sample_rate, num_bins, use_energy, order,
                  rows)["bytes"] <= limit:
            return rows
    need = layout(sample_rate, num_bins, use_energy, order, 1)["bytes"]
    raise NotImplementedError(
        f"fbank_deltas: sample rate {sample_rate} Hz is not ported yet (a "
        f"one-frame tile needs {need} bytes of shared memory, the card's "
        f"limit is {limit})")


def plan(B, T, sample_rate, num_bins=40, use_energy=True, order=2, sms=132,
         limit=MAX_SMEM):
    """The launch over B rows of T frames: the largest tile of output
    frames (``rows``) that still gives at least ``sms`` blocks, so that a
    single request fills the card, within what a block's shared memory
    holds; ``frames`` (the tile and its delta halo), ``blocks`` and the
    layout's ``smem_bytes``."""
    rows = max_rows(sample_rate, num_bins, use_energy, order, limit)
    while rows > 1 and B * -(-T // rows) < sms:
        rows -= 1
    return {"rows": rows, "frames": rows + 2 * order * DELTA_WINDOW,
            "blocks": B * -(-T // rows),
            "smem_bytes": layout(sample_rate, num_bins, use_energy, order,
                                 rows)["bytes"]}


@functools.lru_cache(maxsize=None)
def _tables(sample_rate, num_bins, device):
    """:func:`host_tables` on ``device``, cached per arguments and device."""
    host = host_tables(sample_rate, num_bins)
    return (torch.tensor(host["tables"], device=device),
            torch.tensor(host["ints"], device=device))


_device_limits = {}


def _limits(device):
    """(SMs, opt-in shared memory a block) of the device, queried once."""
    if device.index not in _device_limits:
        props = torch.cuda.get_device_properties(device)
        _device_limits[device.index] = (
            props.multi_processor_count,
            getattr(props, "shared_memory_per_block_optin", MAX_SMEM))
    return _device_limits[device.index]


class _Args(ctypes.Structure):
    """Mirror of ``struct FrontendArgs`` in csrc/frontend.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "wav", "num_frames", "tables", "ints", "out")]
        + [(n, ctypes.c_int) for n in (
            "B", "N", "T", "frame_length", "hop", "log2n", "num_bins",
            "mel_emits", "mel_slots", "use_energy", "order", "rows")]
        + [("preemphasis", ctypes.c_float)])


_entry = None


def _entry_point():
    """The C launcher, its ctypes signature set once."""
    global _entry
    if _entry is None:
        fn = _build.load().lib.frontend_f32
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


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
    frame_length, hop, _ = frame_geometry(sample_rate)
    B, N = wav.shape
    T = _num_frames(N, frame_length, hop)
    sms, limit = _limits(device)
    launch = plan(B, T, sample_rate, num_bins, use_energy, deltas_order, sms,
                  limit)
    counts = _frame_counts(num_frames, B, T, device).to(torch.int32)
    d0 = num_bins + (1 if use_energy else 0)
    out = torch.empty(B, T, d0 * (1 + deltas_order), dtype=torch.float32,
                      device=device)
    if not B:
        return out
    tables, ints = _tables(sample_rate, num_bins, device)
    host = host_tables(sample_rate, num_bins)
    args = _Args(wav.data_ptr(), counts.data_ptr(), tables.data_ptr(),
                 ints.data_ptr(), out.data_ptr(), B, N, T, frame_length, hop,
                 fft_geometry(sample_rate)[1], num_bins, host["emits"],
                 host["slots"], int(use_energy), deltas_order,
                 launch["rows"], PREEMPHASIS)
    fn = _entry_point()
    with torch.cuda.device(device):
        status = fn(ctypes.byref(args), _build.stream_of(wav))
    _build.check(status, "frontend_f32")
    launches.count += 1
    return out
