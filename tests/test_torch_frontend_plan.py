"""The frontend kernel's algorithm, tables and launch plan, on the CPU.

``csrc/frontend.cu`` computes each frame's power spectrum as a real FFT in
one warp: the n-point real frame is an N = n / 2 point complex sequence
z[m] = x[2m] + i x[2m+1], N = 32 P, lane l holds z[l + 32 j] for j < P;
a P-point DIF FFT in the lane's registers, a twiddle W_N^(l p), five
cross-lane DIF stages (shuffles), then the real split with the partner
bin N - k fetched from another lane.  :func:`warp_model` replays those
steps in float32 numpy on the very tables the wrapper passes
(``ops/frontend.py::host_tables``), lanes on one axis and registers on
the other, and is held to ``np.fft.rfft`` in float64.  :func:`mel_model`
replays the mel schedule (``ops/frontend.py::mel_schedule``): a lane's
running sums over its own bins, emitted to slots that each filter sums.
With the log and the delta passes added the model is held to
``fbank_deltas_plain`` at the 1e-3 log-domain gate of the card.
``plan`` and ``layout`` mirror the kernel's tiles and shared memory.
"""
import numpy as np
import pytest
import torch

from attention_lvcsr_torch.data.features import delta_coeffs, mel_filterbank
from attention_lvcsr_torch.ops import frontend as fe

RATES = [8000, 16000, 22050, 44100, 48000]
f32 = np.float32


def _unpack(sample_rate, num_bins=40):
    """The named parts of ``host_tables``, complex ones as (re, im)
    float32 arrays, at the offsets the kernel reads."""
    host = fe.host_tables(sample_rate, num_bins)
    tab, ints = host["tables"], host["ints"]
    n, _, P, _ = fe.fft_geometry(sample_rate)
    parts, at = {}, 0
    for name, floats in (("win", n), ("twp", P), ("twl", 64 * P),
                         ("tws", 256), ("twk", 64 * P),
                         ("melw", 64 * (P + 1))):
        parts[name] = tab[at:at + floats]
        at += floats
    assert at == len(tab)
    cplx = lambda a, *shape: (a[0::2].reshape(shape), a[1::2].reshape(shape))
    parts["twp"] = cplx(parts["twp"], P // 2)
    parts["twl"] = cplx(parts["twl"], P, 32)
    parts["tws"] = cplx(parts["tws"], 4, 32)
    parts["twk"] = cplx(parts["twk"], P, 32)
    parts["melw"] = parts["melw"].reshape(P + 1, 32, 2)
    E = host["emits"]
    parts["adv"] = ints[:32 * (P + 1)].reshape(P + 1, 32)
    parts["slot"] = ints[32 * (P + 1):32 * (P + 1 + E)].reshape(E, 32)
    parts["segoff"] = ints[32 * (P + 1 + E):]
    assert len(parts["segoff"]) == num_bins + 1
    parts["slots"] = host["slots"]
    return parts


def _cmul(ar, ai, br, bi):
    return f32(ar * br - ai * bi), f32(ar * bi + ai * br)


def _bitrev(x, bits):
    return int(format(x, f"0{bits}b")[::-1], 2)


def warp_model(frame, sample_rate, t):
    """The kernel's power spectrum of one raw frame (frame_length float32
    samples), step by step in float32.  Returns (pwr: (32, P), lane l's
    register i holding bin br_P(i) + P br_5(l); the Nyquist bin's power;
    the spectrum X[0..N] in bin order)."""
    frame_length = fe.frame_geometry(sample_rate)[0]
    n, _, P, N = fe.fft_geometry(sample_rate)
    logp = P.bit_length() - 1
    lane = np.arange(32)
    pre, win = f32(fe.PREEMPHASIS), t["win"]
    x = lambda s: np.where(s < frame_length,
                           frame[np.minimum(s, frame_length - 1)], f32(0))
    # z[l + 32 j] = x'[2m] + i x'[2m+1]: registers j of lane l
    vr = np.zeros((32, P), f32)
    vi = np.zeros((32, P), f32)
    for j in range(P):
        s = 2 * (lane + 32 * j)
        x0, x1 = x(s), x(s + 1)
        xm = np.where(s == 0, x0, x(np.maximum(s - 1, 0)))
        vr[:, j] = win[s] * f32(x0 - f32(pre * xm))
        vi[:, j] = win[s + 1] * f32(x1 - f32(pre * x0))
    # the lane's P-point DIF FFT: register i then holds Y[br_P(i)]
    twr, twi = t["twp"]
    for st in range(logp):
        length = P >> st
        half = length // 2
        for base in range(0, P, length):
            for k in range(half):
                a, b = base + k, base + k + half
                ar, ai, br, bi = vr[:, a], vi[:, a], vr[:, b], vi[:, b]
                dr, di = f32(ar - br), f32(ai - bi)
                vr[:, a], vi[:, a] = f32(ar + br), f32(ai + bi)
                if k:
                    dr, di = _cmul(dr, di, twr[k * (P // length)],
                                   twi[k * (P // length)])
                vr[:, b], vi[:, b] = dr, di
    # W_N^(l br_P(i))
    for i in range(1, P):
        vr[:, i], vi[:, i] = _cmul(vr[:, i], vi[:, i], t["twl"][0][i],
                                   t["twl"][1][i])
    # cross-lane DIF stages, h = 16 .. 1: lane l then holds bin q = br_5(l)
    for st, h in enumerate((16, 8, 4, 2, 1)):
        partner = lane ^ h
        sg = np.where(lane & h, f32(-1), f32(1))
        ur, ui = vr[partner], vi[partner]
        nr, ni = f32(ur + f32(sg[:, None] * vr)), f32(ui + f32(sg[:, None]
                                                             * vi))
        if h > 1:
            nr, ni = _cmul(nr, ni, t["tws"][0][st][:, None],
                           t["tws"][1][st][:, None])
        vr, vi = nr, ni
    # real split: bin k = br_P(i) + P br_5(l); Z[N - k] from another lane
    br5 = np.array([_bitrev(l, 5) for l in lane])
    src0 = np.where(lane == 0, 0, [_bitrev((32 - q) % 32, 5) for q in br5])
    pwr = np.zeros((32, P), f32)
    spec = np.zeros(N + 1, np.complex128)
    for i in range(P):
        if i == 0:
            ip, src = 0, src0
        else:
            ip, src = _bitrev(P - _bitrev(i, logp), logp), 31 - lane
        bx, by = vr[src, ip], vi[src, ip]
        sr, si = f32(vr[:, i] + bx), f32(vi[:, i] - by)
        dr, di = f32(vr[:, i] - bx), f32(vi[:, i] + by)
        wr, wi = t["twk"][0][i], t["twk"][1][i]
        xr = f32(0.5) * f32(sr + f32(f32(wr * di) + f32(wi * dr)))
        xi = f32(0.5) * f32(si - f32(f32(wr * dr) - f32(wi * di)))
        pwr[:, i] = f32(xr * xr) + f32(xi * xi)
        spec[_bitrev(i, logp) + P * br5] = xr + 1j * xi
    nyq = f32(vr[0, 0] - vi[0, 0])
    spec[N] = nyq
    return pwr, f32(nyq * nyq), spec


def mel_model(pwr, nyq, t):
    """The kernel's mel sums from the lanes' registers
    (``frontend.cu::mel_partials`` and the slots' sums): lane l walks its
    bins in order with the running sums A and B, emitting to its slots
    where the schedule steps; filter m sums its slots in order.  ``pwr``
    (..., 32, P) and ``nyq`` (...) may hold a batch of spectra."""
    P = pwr.shape[-1]
    logp = P.bit_length() - 1
    nyq = np.asarray(nyq, f32)
    part = np.zeros(nyq.shape + (t["slots"] + 1,), f32)
    for lane in range(32):
        A = B = np.zeros(nyq.shape, f32)
        e = 0
        for r in range(P + 1):
            p = pwr[..., lane, _bitrev(r, logp)] if r < P else nyq
            for _ in range(t["adv"][r, lane]):
                part[..., t["slot"][e, lane]] = A
                e += 1
                A, B = B, np.zeros(nyq.shape, f32)
            A = f32(A + f32(p * t["melw"][r, lane, 0]))
            B = f32(B + f32(p * t["melw"][r, lane, 1]))
        part[..., t["slot"][e, lane]] = A
        part[..., t["slot"][e + 1, lane]] = B
    seg = t["segoff"]
    mel = np.zeros(nyq.shape + (len(seg) - 1,), f32)
    for m in range(len(seg) - 1):
        for g in range(seg[m], seg[m + 1]):
            mel[..., m] = f32(mel[..., m] + part[..., g])
    return mel


def model_features(wav, count, sample_rate, order=2, num_bins=40):
    """One row of ``fbank_deltas`` the kernel's way: the warp model, the
    mel schedule's sums, the log, the energy, the delta passes with edge
    replication at the row's true frame count."""
    t = _unpack(sample_rate, num_bins)
    frame_length, hop, _ = fe.frame_geometry(sample_rate)
    T = 1 + (len(wav) - frame_length) // hop
    base = np.zeros((T, 1 + num_bins), f32)
    for f in range(T):
        frame = wav[f * hop:f * hop + frame_length]
        pwr, nyq, _ = warp_model(frame, sample_rate, t)
        base[f, 1:] = np.log(np.maximum(mel_model(pwr, nyq, t), f32(1e-10)))
        base[f, 0] = np.log(max(f32(np.sum(frame.astype(np.float64) ** 2)),
                                1e-10))
    rows = np.minimum(np.arange(T), count - 1)
    levels = [base[rows]]
    for _ in range(order):
        cur = levels[-1]
        idx = np.clip(np.arange(T)[:, None] + np.arange(-2, 3)[None], 0,
                      count - 1)
        levels.append(sum(f32(c) * cur[idx[:, m]]
                          for m, c in enumerate(delta_coeffs(2)) if c)
                      [rows])
    return np.concatenate(levels, axis=-1)


def _speech(rng, n, sample_rate):
    tt = np.arange(n) / sample_rate
    f0 = rng.uniform(90, 250)
    wav = sum(rng.uniform(0.05, 0.3) / k * np.sin(2 * np.pi * k * f0 * tt
                                                    + rng.uniform(0, 6.3))
              for k in range(1, 12))
    return (wav + rng.uniform(0.01, 0.05) * rng.randn(n)).astype(f32)


@pytest.mark.parametrize("sample_rate", RATES)
def test_warp_model_is_the_real_fft(sample_rate):
    """The kernel's FFT on its float32 tables equals the float64 rFFT of
    the preemphasised, windowed, zero-padded frame within float32
    rounding (1e-5 of the spectrum's peak), at every bin, the Nyquist
    one included; the registers hold |X[k]|^2 of their bins."""
    t = _unpack(sample_rate)
    frame_length = fe.frame_geometry(sample_rate)[0]
    n, _, P, N = fe.fft_geometry(sample_rate)
    rng = np.random.RandomState(sample_rate % 1000)
    for frame in (_speech(rng, frame_length, sample_rate),
                  rng.randn(frame_length).astype(f32)):
        x = frame.astype(np.float64)
        pre = x - fe.PREEMPHASIS * np.concatenate([x[:1], x[:-1]])
        ref = np.fft.rfft(pre * np.hamming(frame_length), n)
        pwr, nyq, spec = warp_model(frame, sample_rate, t)
        scale = np.abs(ref).max()
        assert np.abs(spec - ref).max() <= 1e-5 * scale
        logp = P.bit_length() - 1
        power = np.zeros(N + 1)
        for lane in range(32):
            for i in range(P):
                power[_bitrev(i, logp) + P * _bitrev(lane, 5)] = pwr[lane, i]
        power[N] = nyq
        np.testing.assert_allclose(power, np.abs(ref) ** 2, rtol=0,
                                   atol=2e-5 * scale ** 2)


@pytest.mark.parametrize("sample_rate", RATES)
def test_twiddles_are_float64_rounded_once(sample_rate):
    """Every twiddle is exp(-2 pi i k / m) rounded to float32 from
    float64, and the window is numpy's Hamming window, zero past the
    frame."""
    t = _unpack(sample_rate)
    frame_length = fe.frame_geometry(sample_rate)[0]
    n, _, P, N = fe.fft_geometry(sample_rate)
    w = lambda k, m: np.exp(-2j * np.pi * np.asarray(k, np.float64) / m)
    as32 = lambda z: (z.real.astype(f32), z.imag.astype(f32))
    np.testing.assert_array_equal(
        t["win"], np.concatenate([np.hamming(frame_length),
                                  np.zeros(n - frame_length)]).astype(f32))
    for got, want in ((t["twp"], w(np.arange(P // 2), P)),
                      (t["twk"][0][:, 0] + 1j * t["twk"][1][:, 0],
                       w([_bitrev(i, P.bit_length() - 1) for i in range(P)],
                         n))):
        got = got if isinstance(got, tuple) else as32(got)
        np.testing.assert_array_equal(got[0], as32(want)[0])
        np.testing.assert_array_equal(got[1], as32(want)[1])


@pytest.mark.parametrize("sample_rate", RATES)
@pytest.mark.parametrize("num_bins", [40, 23, 80])
def test_mel_schedule_sums_exactly_the_filterbank(sample_rate, num_bins):
    """The mel schedule on a one-hot power spectrum (bin k at 1, every
    other 0) gives column k of ``mel_filterbank`` exactly, at every bin:
    each filter sums its nonzero weights and nothing else."""
    t = _unpack(sample_rate, num_bins)
    n, _, P, N = fe.fft_geometry(sample_rate)
    logp = P.bit_length() - 1
    fb = mel_filterbank(num_bins, n, sample_rate)
    pwr = np.zeros((N + 1, 32, P), f32)
    for k in range(N):
        pwr[k, _bitrev(k // P, 5), _bitrev(k % P, logp)] = 1
    got = mel_model(pwr, (np.arange(N + 1) == N).astype(f32), t)
    np.testing.assert_array_equal(got.T, fb)


@pytest.mark.parametrize("sample_rate", RATES)
def test_mel_schedule_shape(sample_rate):
    """Every bin's weights sit in two consecutive filters; the slots of
    each filter are consecutive and in chunk order; emits outside the
    filters go to the one slot that is never read."""
    t = _unpack(sample_rate)
    sched = fe.mel_schedule(sample_rate, 40)
    assert (sched["adv"] >= 0).all()
    seg = t["segoff"]
    assert seg[0] == 0 and seg[-1] == t["slots"]
    assert (np.diff(seg) >= 1).all()          # every filter has a slot
    used = t["slot"][t["slot"] < t["slots"]]
    assert sorted(used) == list(range(t["slots"]))      # each once


@pytest.mark.parametrize("sample_rate,order", [(16000, 2), (8000, 2),
                                               (48000, 2), (22050, 1)])
def test_kernel_model_matches_the_plain_version(sample_rate, order):
    """The warp model with the sparse mel sums, log, energy and delta
    passes vs ``fbank_deltas_plain``: within 1e-3 in the log domain (the
    gate the kernel meets on the card), a row cut short by its count."""
    rng = np.random.RandomState(sample_rate // 100 + order)
    frame_length, hop, _ = fe.frame_geometry(sample_rate)
    N = frame_length + 11 * hop
    wav = np.stack([_speech(rng, N, sample_rate) for _ in range(2)])
    counts = np.array([12, 7])
    ref = fe.fbank_deltas_plain(torch.from_numpy(wav),
                                torch.from_numpy(counts),
                                sample_rate=sample_rate,
                                deltas_order=order).numpy()
    for b in range(2):
        got = model_features(wav[b], counts[b], sample_rate, order)
        np.testing.assert_allclose(got, ref[b], rtol=0, atol=1e-3)


@pytest.mark.parametrize("sample_rate", RATES)
@pytest.mark.parametrize("B", [1, 64])
def test_plan_fits_a_block(sample_rate, B):
    """At 8-48 kHz the tile and its layout fit 232,448 bytes; the layout's
    regions follow one another on 16-byte boundaries."""
    p = fe.plan(B, 798, sample_rate)
    assert p["smem_bytes"] <= fe.MAX_SMEM == 232448
    assert p["frames"] == p["rows"] + 8 <= fe.MAX_FRAMES
    lay = fe.layout(sample_rate, 40, True, 2, p["rows"])
    assert lay["bytes"] == p["smem_bytes"]
    order = ["tables", "ints", "wav", "part", "lev"]
    assert all(lay[a] < lay[b] for a, b in zip(order, order[1:]))
    assert all(lay[k] % 4 == 0 for k in order)
    if B == 64:
        assert p["rows"] == fe.MAX_FRAMES - 8       # the widest tile


@pytest.mark.parametrize("sample_rate,match", [
    (96000, "96000 Hz.*4096-point FFT"), (192000, "192000 Hz")])
def test_rates_past_the_kernel_are_refused(sample_rate, match):
    with pytest.raises(NotImplementedError, match=match):
        fe.plan(1, 100, sample_rate)


def test_a_tile_past_the_limit_names_it():
    """With less shared memory than one frame's tile needs, the refusal
    names the rate, the bytes and the limit."""
    need = fe.layout(48000, 40, True, 2, 1)["bytes"]
    with pytest.raises(NotImplementedError,
                       match=f"48000 Hz.*{need} bytes.*limit is 60000"):
        fe.plan(1, 100, 48000, limit=60000)
    assert fe.plan(1, 100, 16000, limit=60000)["smem_bytes"] <= 60000


def test_a_deep_delta_order_is_refused():
    with pytest.raises(NotImplementedError, match="order 16"):
        fe.plan(1, 100, 16000, order=16)


@pytest.mark.parametrize("sample_rate", RATES)
def test_one_request_fills_the_card(sample_rate):
    """A single 8 s request gets at least a block per SM (132 on an H100
    SXM), each tile as wide as that allows."""
    frame_length, hop, _ = fe.frame_geometry(sample_rate)
    T = 1 + (8 * sample_rate - frame_length) // hop
    p = fe.plan(1, T, sample_rate, sms=132)
    assert p["blocks"] == -(-T // p["rows"]) >= 132
    assert -(-T // (p["rows"] + 1)) < 132       # one frame more is fewer


@pytest.mark.parametrize("B,T,sms", [(1, 798, 132), (8, 300, 132),
                                     (64, 798, 132), (3, 5, 132),
                                     (1, 1, 114), (2, 2000, 114)])
def test_plan_takes_the_widest_tile_that_fills_the_card(B, T, sms):
    p = fe.plan(B, T, 16000, sms=sms)
    wider = [r for r in range(p["rows"] + 1, fe.MAX_FRAMES - 7)
             if B * -(-T // r) >= sms]
    assert not wider
    assert p["blocks"] == B * -(-T // p["rows"])
    assert p["blocks"] >= min(sms, B * T)
