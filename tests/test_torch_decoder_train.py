"""Teacher-forced attention-decoder scan of the port's training path vs
the JAX package (CPU, f32 both sides).

The port's plain ``decoder_scan_train`` (its wrapper takes the plain
version because the tensors lie on the CPU) is held to the JAX
``decoder_scan_train`` in interpret mode, its forward and its custom VJP
under one numpy cotangent, for the flagship variant (one conv filter,
softmax, both priors) and for the variants only the plain version covers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_lvcsr_tpu.ops.pallas.decode_score import \
    toeplitz_band as jax_toeplitz_band
from attention_lvcsr_tpu.ops.pallas.decoder_train import \
    decoder_scan_train as jax_decoder_scan_train
from attention_lvcsr_torch.ops.decoder_train import (decoder_scan_train,
                                                     toeplitz_band,
                                                     unported_variant)

T, B, L, M, S, D = 5, 3, 10, 7, 6, 8
TOL = dict(atol=1e-5, rtol=1e-5)   # f32 both sides, different sum order
EXPANDING = {"type": "expanding", "initial_begin": 0, "initial_end": 4,
             "min_speed": 1.0, "max_speed": 2.0}
MEDIAN = {"type": "window_around_median", "before": 2, "after": 3}
MEAN = {"type": "window_around_mean", "before": 2, "after": 3}
# differentiable operands, in the order of decoder_scan_train's arguments
NAMES = ("fx", "fg", "pre", "attended", "h0", "wa0", "toep", "st", "hand",
         "v", "wss", "wsg", "dxm", "dgm")


def _operands(n_filters, dec_stack, normalizer, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (rng.randn(*s) * scale).astype(np.float32)
    NS, Fh = S * dec_stack, max(n_filters, 1)
    taps = f(Fh, 5, scale=0.5)
    toep = np.concatenate([np.asarray(jax_toeplitz_band(
        jnp.asarray(taps[i]), L)) for i in range(Fh)], axis=1) \
        if n_filters else np.zeros((L, L), np.float32)
    ops = dict(
        fx=f(T, B, NS), fg=f(T, B, 2 * NS), pre=f(B, L, M, scale=0.5),
        attended=f(B, L, D), h0=f(B, NS, scale=0.5),
        wa0=np.zeros((B, D), np.float32), toep=toep,
        st=f(NS, M, scale=0.4), hand=f(Fh, M, scale=0.5),
        v=f(M, scale=0.5), wss=f(S, NS, scale=0.4),
        wsg=f(S, 2 * NS, scale=0.4), dxm=f(D, NS, scale=0.3),
        dgm=f(D, 2 * NS, scale=0.3))
    if not n_filters:
        ops["hand"] = np.zeros((1, M), np.float32)
    lengths = np.array([T, T - 2, 2])
    mask = (np.arange(T)[:, None] < lengths[None]).astype(np.float32)
    amask = (np.arange(L)[None] < np.array([[L], [L - 3], [L]])).astype(
        np.float32)
    w0 = np.zeros((B, L), np.float32)
    w0[:, 0] = 1.0
    extra = dict(e_bias=np.full((1, 1), 2.0 if normalizer != "softmax"
                                else 0.0, np.float32))
    if dec_stack > 1:
        extra.update(inter_in=f(S, (dec_stack - 1) * S, scale=0.4),
                     inter_gate=f(S, 2 * (dec_stack - 1) * S, scale=0.4))
    cots = [f(T, B, NS), f(T, B, L), f(T, B, D)]
    return ops, mask, amask, w0, extra, cots


def _call(fn, ops, mask, amask, w0, extra, lib, **kw):
    (fx, fg, pre, att, h0, wa0, toep, st, hand, v, wss, wsg, dxm,
     dgm) = (ops[n] for n in NAMES)
    return fn(fx, fg, mask, pre, att, amask, h0, w0, wa0, toep, st, hand, v,
              wss, wsg, dxm, dgm, **extra, **kw)


CASES = [
    ("expanding", EXPANDING, 1, 1, "softmax"),
    ("median", MEDIAN, 1, 1, "softmax"),
    ("mean-conv3-logistic", MEAN, 3, 1, "logistic"),
    ("expanding-relu-stack2", EXPANDING, 1, 2, "relu"),
    ("content", {"type": "expanding", "initial_begin": 0,
                 "initial_end": float(L), "min_speed": 0, "max_speed": 0},
     0, 1, "softmax"),
]


@pytest.mark.parametrize("name,prior,n_filters,dec_stack,normalizer", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_scan_matches_jax_interpret(name, prior, n_filters, dec_stack,
                                          normalizer):
    ops, mask, amask, w0, extra, cots = _operands(n_filters, dec_stack,
                                                  normalizer)
    if normalizer == "relu":
        ops["v"] = np.abs(ops["v"])     # energies above zero: no 0/0 rows
    kw = dict(prior=prior, normalizer=normalizer, n_filters=n_filters,
              dec_stack=dec_stack)
    diff = NAMES + ("e_bias",)

    def loss(d):
        full = dict(d)
        out = _call(jax_decoder_scan_train, full, jnp.asarray(mask),
                    jnp.asarray(amask), jnp.asarray(w0),
                    {k: full.get(k, v) for k, v in extra.items()}, jnp,
                    interpret=True, **kw)
        return sum((o * c).sum() for o, c in zip(out[:3], cots)), out

    jd = {k: jnp.asarray(v) for k, v in {**ops, **extra}.items()}
    (_, ref), grads = jax.value_and_grad(loss, has_aux=True)(jd)
    td = {k: torch.tensor(v, requires_grad=True)
          for k, v in {**ops, **extra}.items()}
    got = _call(decoder_scan_train, td, torch.from_numpy(mask),
                torch.from_numpy(amask), torch.from_numpy(w0),
                {k: td[k] for k in extra}, torch, **kw)
    for what, g, r in zip(("h", "weights", "wa", "energies"), got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   err_msg=what, **TOL)
    sum((o * torch.from_numpy(c)).sum()
        for o, c in zip(got[:3], cots)).backward()
    for k in diff:
        if k == "e_bias" and normalizer == "softmax":
            continue              # no gradient: softmax is shift-invariant
        if k in ("hand", "toep") and not n_filters:
            continue              # content-only: no convolution
        np.testing.assert_allclose(td[k].grad.numpy(), np.asarray(grads[k]),
                                   err_msg=f"d{k}", **TOL)
    for k in ("inter_in", "inter_gate"):
        if k in td:
            np.testing.assert_allclose(td[k].grad.numpy(),
                                       np.asarray(grads[k]),
                                       err_msg=f"d{k}", **TOL)


def test_toeplitz_band_matches_jax_and_reaches_the_taps():
    rng = np.random.RandomState(3)
    taps = rng.randn(1, 9).astype(np.float32)
    ref = np.asarray(jax_toeplitz_band(jnp.asarray(taps), 12))
    t = torch.tensor(taps, requires_grad=True)
    band = toeplitz_band(t, 12)
    np.testing.assert_array_equal(band.detach().numpy(), ref)
    cot = rng.randn(12, 12).astype(np.float32)
    jgrad = jax.grad(lambda a: (jax_toeplitz_band(a, 12) * cot).sum())(
        jnp.asarray(taps))
    (band * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), **TOL)


@pytest.mark.parametrize("kw,piece", [
    (dict(normalizer="softmax", n_filters=1, dec_stack=1,
          prior_type="window_around_median"), None),
    (dict(normalizer="softmax", n_filters=1, dec_stack=1,
          prior_type="expanding"), None),
    (dict(normalizer="softmax", n_filters=0, dec_stack=1,
          prior_type="expanding"), None),
    (dict(normalizer="relu", n_filters=0, dec_stack=1,
          prior_type="expanding"), "the 'relu' normalizer"),
    (dict(normalizer="softmax", n_filters=17, dec_stack=1,
          prior_type="expanding"), "17 conv filters"),
    (dict(normalizer="softmax", n_filters=1, dec_stack=2,
          prior_type="expanding"), "dec_stack=2"),
    (dict(normalizer="logistic", n_filters=10, dec_stack=1,
          prior_type="window_around_mean"), None),
])
def test_kernel_variant_gate(kw, piece):
    """The CUDA route covers conv attention with 1-16 filters (softmax,
    logistic or relu; any prior) and content-only attention (no filter,
    softmax) and names any other."""
    got = unported_variant(**kw)
    assert got == piece or (piece is not None and piece in got)
