"""The port's peephole-LSTM scans vs the JAX package's (CPU, f32 both
sides).

``lstm_scan`` (inference) and ``lstm_scan_train`` (values and all seven
gradients: x_proj, h0, c0, W_state and the three peepholes) are held to
the JAX functions run in interpret mode; the port's wrappers take their
plain versions because the tensors lie on the CPU.  The both-directions
call is held to two JAX calls, the second on time-flipped inputs and mask
(flip, scan, flip back).  Tolerance: 1e-5 of each output's largest value,
f32 both sides with the products summed in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_lvcsr_torch.ops.lstm_scan import lstm_scan
from attention_lvcsr_torch.ops.lstm_train import lstm_scan_train
from attention_lvcsr_tpu.ops.pallas.lstm_train import \
    lstm_scan as jax_lstm_scan
from attention_lvcsr_tpu.ops.pallas.lstm_train import \
    lstm_scan_train as jax_lstm_scan_train

T, B, D = 9, 3, 6
NAMES = ("dx", "dh0", "dc0", "dW_state", "dpci", "dpcf", "dpco")


def _close(got, ref, name):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=1e-5 * max(np.abs(ref).max(), 1e-30),
                               err_msg=name)


def _direction(rng):
    """x_proj (T, B, 4D) and (h0, c0, W_state, pci, pcf, pco)."""
    f = lambda *s, scale=1.0: (rng.randn(*s) * scale).astype(np.float32)
    return f(T, B, 4 * D), (f(B, D, scale=0.3), f(B, D, scale=0.3),
                            f(D, 4 * D, scale=0.4), f(D, scale=0.3),
                            f(D, scale=0.3), f(D, scale=0.3))


def _mask(rng):
    lengths = rng.randint(1, T + 1, size=B)
    lengths[0] = T
    return (np.arange(T)[:, None] < lengths[None]).astype(np.float32)


@pytest.mark.parametrize("masked", [True, False])
def test_scan_matches_jax_interpret(masked):
    rng = np.random.RandomState(0)
    x, weights = _direction(rng)
    mask = _mask(rng) if masked else None
    ref_h, ref_c = jax_lstm_scan(jnp.asarray(x), None if mask is None
                                 else jnp.asarray(mask),
                                 *map(jnp.asarray, weights), interpret=True)
    h, c = lstm_scan(torch.from_numpy(x),
                     None if mask is None else torch.from_numpy(mask),
                     tuple(map(torch.from_numpy, weights)))
    _close(h, ref_h, "states")
    _close(c, ref_c, "cells")


@pytest.mark.parametrize("cells_cotangent", [True, False])
def test_train_scan_and_gradients_match_jax_interpret(cells_cotangent):
    """Without a cells cotangent (the encoder's case) the JAX VJP takes
    zeros; the port's backward takes None as zeros."""
    rng = np.random.RandomState(1)
    x, weights = _direction(rng)
    mask = _mask(rng)
    cot_h = rng.randn(T, B, D).astype(np.float32)
    cot_c = rng.randn(T, B, D).astype(np.float32)

    def loss(*leaves):
        h, c = jax_lstm_scan_train(leaves[0], jnp.asarray(mask),
                                   *leaves[1:], interpret=True)
        value = (h * cot_h).sum()
        if cells_cotangent:
            value = value + (c * cot_c).sum()
        return value, (h, c)

    (_, (ref_h, ref_c)), ref_grads = jax.value_and_grad(
        loss, argnums=tuple(range(7)), has_aux=True)(
            jnp.asarray(x), *map(jnp.asarray, weights))
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, *weights)]
    h, c = lstm_scan_train(leaves[0], torch.from_numpy(mask),
                           tuple(leaves[1:]))
    _close(h.detach(), ref_h, "states")
    _close(c.detach(), ref_c, "cells")
    value = (h * torch.from_numpy(cot_h)).sum()
    if cells_cotangent:
        value = value + (c * torch.from_numpy(cot_c)).sum()
    value.backward()
    for name, t, r in zip(NAMES, leaves, ref_grads):
        _close(t.grad, r, name)


def test_both_directions_match_jax_flipped_scans():
    """The backward direction in reverse time equals the JAX package's
    flip -> scan -> flip back, in value and in every gradient."""
    rng = np.random.RandomState(2)
    (xf, wf), (xb, wb) = _direction(rng), _direction(rng)
    mask = _mask(rng)
    cot = rng.randn(T, B, 2 * D).astype(np.float32)
    flip = lambda a: jnp.flip(a, axis=0)

    def loss(xf, wf, xb, wb):
        m = jnp.asarray(mask)
        hf, cf = jax_lstm_scan_train(xf, m, *wf, interpret=True)
        hb, cb = jax_lstm_scan_train(flip(xb), flip(m), *wb,
                                     interpret=True)
        h = jnp.concatenate([hf, flip(hb)], axis=-1)
        c = jnp.concatenate([cf, flip(cb)], axis=-1)
        return (h * cot).sum(), (h, c)

    (_, (ref_h, ref_c)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True)(
            jnp.asarray(xf), tuple(map(jnp.asarray, wf)), jnp.asarray(xb),
            tuple(map(jnp.asarray, wb)))
    tf = [torch.tensor(a, requires_grad=True) for a in (xf, *wf)]
    tb = [torch.tensor(a, requires_grad=True) for a in (xb, *wb)]
    proj = torch.cat([tf[0], tb[0]], dim=-1)
    mask_t = torch.from_numpy(mask)
    h, c = lstm_scan_train(proj, mask_t, tuple(tf[1:]), tuple(tb[1:]))
    _close(h.detach(), ref_h, "states")
    _close(c.detach(), ref_c, "cells")
    # the inference scan gives the same values
    hi, ci = lstm_scan(proj.detach(), mask_t,
                       tuple(t.detach() for t in tf[1:]),
                       tuple(t.detach() for t in tb[1:]))
    _close(hi, ref_h, "inference states")
    _close(ci, ref_c, "inference cells")
    (h * torch.from_numpy(cot)).sum().backward()
    for side, leaves, (gx, gw) in (("fwd", tf, grads[:2]),
                                   ("bwd", tb, grads[2:])):
        for name, t, r in zip(NAMES, leaves, (gx, *gw)):
            _close(t.grad, r, f"{side} {name}")
