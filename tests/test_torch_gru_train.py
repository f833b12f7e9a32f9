"""Differentiable GRU scan of the port's training path vs the JAX package
(CPU, f32 both sides).

One direction is held to the JAX ``gru_scan_train`` in interpret mode, the
forward and its custom VJP under one numpy cotangent.  Both directions in
one call are held to ``jax.grad`` of the XLA scan run forward and on the
time-flipped inputs (the JAX package's interpret bidirectional kernel test
is slow-marked).  The port's wrapper takes its plain version, whose
gradient autograd takes, because the tensors lie on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_lvcsr_tpu.ops.pallas.gru_train import \
    gru_scan_train as jax_gru_scan_train
from attention_lvcsr_torch.ops.gru_train import gru_scan_train

T, B, D = 9, 3, 8
TOL = dict(atol=1e-5, rtol=1e-5)   # f32 both sides, different sum order


def _direction(rng):
    f = lambda *s, scale=1.0: (rng.randn(*s) * scale).astype(np.float32)
    return (f(T, B, D), f(T, B, 2 * D), f(B, D, scale=0.5),
            f(D, D, scale=0.4), f(D, 2 * D, scale=0.4))


def _mask(rng):
    lengths = rng.randint(1, T + 1, size=B)
    lengths[0] = T
    return (np.arange(T)[:, None] < lengths[None]).astype(np.float32)


def _xla_scan(x, g, mask, h0, wss, wsg):
    def step(h, inp):
        xt, gt, m = inp
        gates = jax.nn.sigmoid(h @ wsg + gt)
        u, r = gates[:, :D], gates[:, D:]
        cand = jnp.tanh((h * r) @ wss + xt)
        new_h = u * cand + (1.0 - u) * h
        new_h = m[:, None] * new_h + (1.0 - m[:, None]) * h
        return new_h, new_h
    return jax.lax.scan(step, h0, (x, g, mask))[1]


def _torch_leaves(arrays):
    return [torch.tensor(a, requires_grad=True) for a in arrays]


@pytest.mark.parametrize("masked", [True, False])
def test_one_direction_matches_jax_interpret(masked):
    rng = np.random.RandomState(0)
    x, g, h0, wss, wsg = _direction(rng)
    mask = _mask(rng) if masked else None
    cot = rng.randn(T, B, D).astype(np.float32)

    def loss(x, g, h0, wss, wsg):
        out = jax_gru_scan_train(x, g, None if mask is None
                                 else jnp.asarray(mask), h0, wss, wsg,
                                 interpret=True)
        return (out * cot).sum(), out

    (_, ref), grads_ref = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
            *map(jnp.asarray, (x, g, h0, wss, wsg)))
    tx, tg, th0, twss, twsg = _torch_leaves((x, g, h0, wss, wsg))
    proj = torch.cat([tx, tg], dim=-1)
    got = gru_scan_train(proj, None if mask is None
                         else torch.from_numpy(mask), (th0, twss, twsg))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    (got * torch.from_numpy(cot)).sum().backward()
    for name, t, r in zip(("dx_in", "dx_gate", "dh0", "dW_ss", "dW_sg"),
                          (tx, tg, th0, twss, twsg), grads_ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   err_msg=name, **TOL)


def test_both_directions_match_jax_flipped_scans():
    """The backward direction in reverse time equals the JAX package's
    flip -> scan -> flip back, in value and in every gradient."""
    rng = np.random.RandomState(1)
    fwd, bwd = _direction(rng), _direction(rng)
    mask = _mask(rng)
    cot = rng.randn(T, B, 2 * D).astype(np.float32)

    def loss(fwd, bwd):
        m = jnp.asarray(mask)
        sf = _xla_scan(fwd[0], fwd[1], m, *fwd[2:])
        flip = lambda a: jnp.flip(a, axis=0)
        sb = flip(_xla_scan(flip(bwd[0]), flip(bwd[1]), flip(m), *bwd[2:]))
        out = jnp.concatenate([sf, sb], axis=-1)
        return (out * cot).sum(), out

    (_, ref), (gf, gb) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(
        tuple(map(jnp.asarray, fwd)), tuple(map(jnp.asarray, bwd)))
    tf, tb = _torch_leaves(fwd), _torch_leaves(bwd)
    proj = torch.cat([tf[0], tf[1], tb[0], tb[1]], dim=-1)
    got = gru_scan_train(proj, torch.from_numpy(mask), tuple(tf[2:]),
                         tuple(tb[2:]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    (got * torch.from_numpy(cot)).sum().backward()
    names = ("dx_in", "dx_gate", "dh0", "dW_ss", "dW_sg")
    for side, leaves, grads in (("fwd", tf, gf), ("bwd", tb, gb)):
        for name, t, r in zip(names, leaves, grads):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                       err_msg=f"{side} {name}", **TOL)


def test_cuda_route_refuses_other_devices():
    proj = torch.zeros(2, 1, 3 * D, device="meta")
    h0, wss, wsg = (torch.zeros(1, D), torch.zeros(D, D),
                    torch.zeros(D, 2 * D))
    with pytest.raises(ValueError, match="no kernel"):
        gru_scan_train(proj, None, (h0, wss, wsg))
