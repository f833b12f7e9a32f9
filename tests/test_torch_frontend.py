"""The port's fbank+delta frontend vs the JAX package's (CPU).

* The port's numpy copy of the feature pipeline equals the JAX package's
  ``data/features.py`` exactly (the same numpy code on the same input).
* ``fbank_deltas_plain`` (the CUDA kernel's plain version, which the
  wrapper takes for a CPU tensor) vs ``fbank_deltas_pallas`` in interpret
  mode on a ragged batch: atol 1e-3 after the log, f32 both sides but the
  DFT sums taken in another order (the Pallas kernel sums over hop-sized
  views).
* ``fbank_deltas_plain`` vs the float64 numpy pipeline at the JAX
  package's own tolerance (``tests/test_frontend_pallas.py``: 2e-3, an
  f32 DFT-as-matmul against float64 ``np.fft``, compared after the log).
* ``device_frontend``: rows past a row's true frame count replicate its
  last row, and the rows before it equal the numpy pipeline on the
  utterance alone, its last frames included.
"""
import numpy as np
import pytest
import torch

from attention_lvcsr_torch.data import features as port_features
from attention_lvcsr_torch.ops.frontend import (fbank_deltas,
                                                fbank_deltas_plain,
                                                frame_geometry)
from attention_lvcsr_tpu.data import features as jax_features
from attention_lvcsr_tpu.ops.pallas.frontend import fbank_deltas_pallas

KERNEL_TOL = dict(rtol=0, atol=1e-3)
NUMPY_TOL = dict(rtol=2e-3, atol=2e-3)


def _speech_like(rng, seconds, sample_rate):
    """Tones plus noise: every mel bin has energy well above the floor."""
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    return (0.3 * np.sin(2 * np.pi * 440 * t)
            + 0.2 * np.sin(2 * np.pi * 1330 * t)
            + 0.05 * rng.randn(len(t))).astype(np.float32)


def _ragged_batch(sample_rate, seed=0):
    """Two utterances, the second shorter, zero-padded to the first."""
    rng = np.random.RandomState(seed)
    w1 = _speech_like(rng, 0.6, sample_rate)
    w2 = _speech_like(rng, 0.37, sample_rate)
    batch = np.zeros((2, len(w1)), np.float32)
    batch[0], batch[1, :len(w2)] = w1, w2
    frame_length, hop, _ = frame_geometry(sample_rate)
    counts = [1 + (len(w) - frame_length) // hop for w in (w1, w2)]
    return (w1, w2), batch, np.asarray(counts, np.int32)


@pytest.mark.parametrize("sample_rate,use_energy,order", [
    (16000, True, 2), (8000, True, 2), (16000, False, 2), (16000, True, 0),
    (8000, False, 1)])
def test_numpy_copy_equals_the_jax_package(sample_rate, use_energy, order):
    wav = _speech_like(np.random.RandomState(1), 0.5, sample_rate)
    got = port_features.extract_features(wav, sample_rate=sample_rate,
                                         use_energy=use_energy,
                                         deltas_order=order)
    ref = jax_features.extract_features(wav, sample_rate=sample_rate,
                                        use_energy=use_energy,
                                        deltas_order=order)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        port_features.mel_filterbank(40, 512, sample_rate),
        jax_features.mel_filterbank(40, 512, sample_rate))


@pytest.mark.parametrize("sample_rate", [16000, 8000])
@pytest.mark.parametrize("use_energy", [True, False])
def test_plain_matches_pallas_interpret(sample_rate, use_energy):
    _, batch, counts = _ragged_batch(sample_rate)
    ref = np.asarray(fbank_deltas_pallas(
        batch, num_frames=counts, sample_rate=sample_rate,
        use_energy=use_energy, interpret=True))
    got = fbank_deltas(torch.from_numpy(batch), torch.from_numpy(counts),
                       sample_rate=sample_rate, use_energy=use_energy)
    assert got.shape == ref.shape == (2, counts[0], 3 * (40 + use_energy))
    for b, n in enumerate(counts):
        np.testing.assert_allclose(got[b, :n].numpy(), ref[b, :n],
                                   err_msg=f"row {b}", **KERNEL_TOL)


@pytest.mark.parametrize("sample_rate", [16000, 8000])
def test_plain_matches_float64_numpy(sample_rate):
    (w1, w2), batch, counts = _ragged_batch(sample_rate, seed=2)
    got = fbank_deltas_plain(torch.from_numpy(batch),
                             torch.from_numpy(counts),
                             sample_rate=sample_rate).numpy()
    for b, (w, n) in enumerate(zip((w1, w2), counts)):
        ref = jax_features.extract_features(w, sample_rate=sample_rate)
        assert ref.shape[0] == n
        np.testing.assert_allclose(got[b, :n], ref, err_msg=f"row {b}",
                                   **NUMPY_TOL)


def test_device_frontend_replicates_the_true_end():
    (_, w2), batch, counts = _ragged_batch(16000, seed=3)
    out = port_features.device_frontend(torch.from_numpy(batch),
                                        torch.from_numpy(counts)).numpy()
    n = counts[1]
    assert n < out.shape[1]
    # rows at and past the true end are copies of its last row
    np.testing.assert_array_equal(out[1, n:],
                                  np.broadcast_to(out[1, n - 1],
                                                  out[1, n:].shape))
    # and the rows before it are the utterance's own features, its last
    # frames' deltas included
    np.testing.assert_allclose(out[1, :n],
                               port_features.extract_features(w2),
                               **NUMPY_TOL)
    # without counts every row is real
    full = port_features.device_frontend(torch.from_numpy(batch)).numpy()
    np.testing.assert_array_equal(full[0], out[0])


def test_short_waveform_raises():
    with pytest.raises(ValueError, match="too short"):
        fbank_deltas(torch.zeros(1, 399))
