"""GRU scan and encoder of the port vs the JAX package (CPU, f32 both
sides).  The JAX side runs its Pallas ``gru_scan`` in interpret mode, as
the JAX package's own tests run it; the port's wrapper takes its plain
version because the tensors lie on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_net_config
from attention_lvcsr_tpu.models.recognizer import \
    SpeechRecognizer as JaxRecognizer
from attention_lvcsr_tpu.ops.pallas.gru_scan import gru_scan as jax_gru_scan
from attention_lvcsr_torch.models.cells import GatedRecurrent
from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
from attention_lvcsr_torch.ops.gru_scan import gru_scan, gru_scan_reference

TOL = dict(atol=1e-5, rtol=1e-5)   # f32 both sides, different sum order
INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.3],
                        "biases_init": ["isotropic_gaussian", 0.1],
                        "rec_weights_init": ["orthogonal"],
                        "initial_states_init": ["isotropic_gaussian", 0.2]}}


def _operands(T, B, D, masked, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (rng.randn(*s) * scale).astype(np.float32)
    mask = None
    if masked:
        lengths = rng.randint(1, T + 1, size=B)
        lengths[0] = T
        mask = (np.arange(T)[:, None] < lengths[None]).astype(np.float32)
    return (f(T, B, D), f(T, B, 2 * D), mask, f(B, D, scale=0.5),
            f(D, D, scale=0.4), f(D, 2 * D, scale=0.4))


@pytest.mark.parametrize("T,B,D,masked", [
    (13, 3, 8, True), (13, 3, 8, False), (21, 5, 16, True),
    (8, 2, 5, True)])
def test_gru_scan_matches_jax_interpret(T, B, D, masked):
    ops = _operands(T, B, D, masked)
    ref = jax_gru_scan(*(jnp.asarray(a) if a is not None else None
                         for a in ops), interpret=True)
    x, g, mask, h0, ws, wg = (torch.from_numpy(a) if a is not None else None
                              for a in ops)
    got = gru_scan(torch.cat([x, g], dim=-1), mask, (h0, ws, wg))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("masked", [True, False])
def test_bidir_matches_jax_flipped_scans(masked):
    """Both directions in one call: the backward one in reverse time equals
    the JAX package's flip -> scan -> flip."""
    T, B, D = 11, 3, 6
    fwd = _operands(T, B, D, masked, seed=5)
    bwd = _operands(T, B, D, masked, seed=6)
    mask = fwd[2]
    proj = np.concatenate([fwd[0], fwd[1], bwd[0], bwd[1]], axis=-1)
    j = lambda a: jnp.asarray(a) if a is not None else None
    ref_f = jax_gru_scan(*map(j, fwd[:2]), j(mask), *map(j, fwd[3:]),
                         interpret=True)
    flip = lambda a: jnp.flip(jnp.asarray(a), axis=0)
    ref_b = jnp.flip(jax_gru_scan(
        flip(bwd[0]), flip(bwd[1]), flip(mask) if masked else None,
        *map(j, bwd[3:]), interpret=True), axis=0)
    t = lambda a: torch.from_numpy(a) if a is not None else None
    got = gru_scan(t(proj), t(mask), tuple(map(t, fwd[3:])),
                   tuple(map(t, bwd[3:])))
    np.testing.assert_allclose(got[..., :D].numpy(), np.asarray(ref_f),
                               **TOL)
    np.testing.assert_allclose(got[..., D:].numpy(), np.asarray(ref_b),
                               **TOL)


def test_masked_steps_keep_state():
    ops = _operands(9, 4, 6, masked=True, seed=1)
    x, g, m, h0, ws, wg = (torch.from_numpy(a) for a in ops)
    out = gru_scan_reference(torch.cat([x, g], dim=-1), m,
                             (h0, ws, wg)).numpy()
    mask = ops[2]
    for b in range(4):
        n = int(mask[:, b].sum())
        if n < 9:
            np.testing.assert_array_equal(out[n:, b],
                                          np.broadcast_to(out[n - 1, b],
                                                          out[n:, b].shape))


def test_one_step_matches_scan():
    cell = GatedRecurrent(6)
    rng = np.random.RandomState(2)
    with torch.no_grad():
        for p in cell.parameters():
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)
                                     * 0.4))
    x = torch.from_numpy(rng.randn(5, 3, 6).astype(np.float32))
    g = torch.from_numpy(rng.randn(5, 3, 12).astype(np.float32))
    m = torch.tensor([[1, 1, 1]] * 3 + [[1, 0, 1], [1, 0, 0]],
                     dtype=torch.float32)
    with torch.no_grad():
        states = cell.scan({"inputs": x, "gate_inputs": g}, mask=m)
        h = cell.initial_states(3)
        for t in range(5):
            h = cell.one_step(h, {"inputs": x[t], "gate_inputs": g[t]},
                              mask=m[t])
            torch.testing.assert_close(states[t], h, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("mode", ["never", "interpret"])
def test_encode_matches_jax_on_padded_batch(mode):
    cfg = _tiny_net_config()
    jax_rec = JaxRecognizer(dict(cfg, use_pallas=mode), init_config=INIT,
                            seed=11)
    port = SpeechRecognizer(cfg, init_config=INIT, seed=11,
                            device="cpu")
    rng = np.random.RandomState(4)
    x = rng.randn(3, 29, 12).astype(np.float32)
    lengths = np.array([29, 17, 6])
    m = (np.arange(29)[None] < lengths[:, None]).astype(np.float32)
    enc, enc_mask, _ = jax_rec.net.apply(jax_rec.params, x, m, fast=True,
                                         method=jax_rec.net.encode)
    with torch.no_grad():
        got, got_mask = port.net.encode(torch.from_numpy(x),
                                        torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(enc), **TOL)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(enc_mask))
    assert got.shape == (3, 15, 16)
