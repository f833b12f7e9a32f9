"""The task loss's kernel branches against their plain PyTorch versions,
on the card: ``beam_loop.cu``'s ``mse_cost`` and logistic / relu branches
(a relu row whose weights are all zero included) and ``decoder_train.cu``'s
logistic and relu forward and backward with the energy bias and its
gradient.  Marked ``cuda``: they skip without a CUDA device, and run
there with ``python -m pytest -m cuda tests/test_torch_cuda_task_loss.py
--noconftest`` (no JAX needed)."""
import ctypes

import numpy as np
import pytest
import torch

from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
from attention_lvcsr_torch.ops import beam_loop as bl
from attention_lvcsr_torch.ops import decoder_train as dt

pytestmark = pytest.mark.cuda

NET = dict(
    input_dims={"recordings": 6}, input_num_chars={}, eos_label=8,
    num_phonemes=9, dim_dec=33, dims_bidir=[33, 33], enc_transition="gru",
    dec_transition="gru", attention_type="content_and_conv", conv_n=2,
    criterion={"name": "log_likelihood"},
    bottom={"bottom_class": "speech"}, subsample=[1, 2],
    post_merge_dims=[17], max_decoded_length_scale=1.0,
    data_prepend_eos=False,
    prior={"type": "window_around_median", "before": 3, "after": 3})
INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.5],
                        "biases_init": ["constant", 0.0],
                        "rec_weights_init": ["orthogonal"]}}
EXPANDING = {"type": "expanding", "initial_begin": 0, "initial_end": 1e4,
             "min_speed": 0, "max_speed": 0}
MEDIAN = {"type": "window_around_median", "before": 3, "after": 4}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _loop_case(device, config, U, frames, beam, energy_bias, seed=3):
    rec = SpeechRecognizer(config, init_config=INIT, seed=seed,
                           device=device)
    if energy_bias is not None:
        rec.net.generator.attention.energy_comp.bias.data.fill_(energy_bias)
    rec.net.generator.readout.post_merge_0.bias.data[rec.eos_label] += 1.5
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(U, frames, 6).astype(np.float32),
                     device=device)
    lengths = rng.randint(frames // 2, frames + 1, size=U)
    lengths[0] = frames
    m = torch.tensor((np.arange(frames)[None] < lengths[:, None])
                     .astype(np.float32), device=device)
    with torch.inference_mode():
        data = rec.net.decode_loop(x, m)
        tables = rec.net.decode_loop_tables()
    prior = rec.net.generator.attention.prior_config()
    kw = dict(beam=beam, max_len=frames // 4, eol=rec.eos_label,
              char_discount=0.1, prior=prior["type"],
              before=float(prior["before"]), after=float(prior["after"]),
              normalizer=config.get("energy_normalizer") or "softmax",
              mse_cost=rec.net.generator.mse)
    return (data["pre"], data["attended"], data["attended_mask"], tables), kw


@pytest.mark.parametrize("K", [1, 10])
@pytest.mark.parametrize("case", [
    ("logistic", "log_likelihood", 0.3), ("logistic", "mse_gain", 0.3),
    ("relu", "log_likelihood", 2.0), ("relu", "mse_reward", 2.0),
    ("softmax", "mse_gain", None),
    # every relu numerator zero: all rows lose the selection
    ("relu", "log_likelihood", -50.0)])
def test_beam_loop_branches_match_plain(device, K, case):
    normalizer, criterion, bias = case
    config = dict(NET, energy_normalizer=normalizer,
                  criterion={"name": criterion})
    args, kw = _loop_case(device, config, 4, 48, K, bias)
    pre, attended, _, tables = args
    U, L, M = pre.shape
    lib = bl._build.load().lib
    lib.beam_loop_smem_bytes.argtypes = [ctypes.POINTER(bl._Args)]
    c_args = bl._Args(U=U, L=L, M=M, D=attended.shape[-1], S=33, R=17, V=9,
                      F=33, K=K, Lout=kw["max_len"], n_taps=5,
                      normalizer=bl.NORMALIZERS.index(normalizer))
    assert lib.beam_loop_smem_bytes(ctypes.byref(c_args)) == bl.smem_plan(
        K, L, M, attended.shape[-1], 33, 17, 9, 33, kw["max_len"], 5,
        normalizer=normalizer)["smem_bytes"]
    before = bl.launches.count
    got = bl.beam_search_loop(*args, **kw)
    again = bl.beam_search_loop(*args, **kw)
    assert bl.launches.count == before + 2
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    ref = bl.beam_search_loop_reference(*args, **kw)
    out, meta, steps = got
    if bias != -50.0:
        assert (ref[1][:, :, 1] < bl.INF / 2).any()
    torch.testing.assert_close(out, ref[0], atol=0, rtol=0)
    torch.testing.assert_close(steps, ref[2], atol=0, rtol=0)
    torch.testing.assert_close(meta[:, :, 2], ref[1][:, :, 2])
    torch.testing.assert_close(meta[:, :, :2], ref[1][:, :, :2],
                               atol=1e-4, rtol=1e-5)


def _grads(fn, leaves, cots):
    xs = [x.detach().requires_grad_() for x in leaves]
    outs = fn(*xs)
    grads = torch.autograd.grad(outs[:len(cots)], xs, cots)
    return [o.detach() for o in outs], grads


# relu's bias keeps every row's window live: a row whose numerators are
# all zero divides 0 by 0 in both versions (NaN, as in the JAX package)
@pytest.mark.parametrize("normalizer,bias", [("logistic", -0.2),
                                             ("relu", 2.0)])
@pytest.mark.parametrize("prior", [EXPANDING, MEDIAN])
@pytest.mark.parametrize("T,B,L,M,D,S,taps", [
    (6, 3, 10, 7, 9, 5, 7), (8, 5, 199, 33, 17, 33, 7),
    (5, 16, 175, 250, 500, 250, 201)])
def test_decoder_scan_train_branches_match_plain(device, normalizer, bias,
                                                 prior, T, B, L, M, D, S,
                                                 taps):
    """Forward and backward kernels vs autograd through the plain scan,
    the energy bias's gradient included; a second call's gradients bit
    for bit."""
    rng = np.random.RandomState(T + B + L)
    f = lambda *s, scale=0.3: torch.tensor(
        rng.randn(*s).astype(np.float32) * scale, device=device)
    labels = rng.randint(1, T + 1, size=B)
    frames = rng.randint(L // 2, L + 1, size=B)
    labels[0], frames[0] = T, L
    mask = torch.tensor((np.arange(T)[:, None] < labels[None]).astype("f"),
                        device=device)
    amask = torch.tensor((np.arange(L)[None] < frames[:, None]).astype("f"),
                         device=device)
    w0 = torch.zeros(B, L, device=device)
    w0[:, 0] = 1.0
    leaves = [f(T, B, S), f(T, B, 2 * S), f(B, L, M), f(B, L, D), f(B, S),
              f(B, D), dt.toeplitz_band(f(1, taps), L), f(S, M, scale=0.1),
              f(1, M, scale=0.1), f(M, scale=0.1), f(S, S, scale=S ** -0.5),
              f(S, 2 * S, scale=S ** -0.5), f(D, S, scale=0.05),
              f(D, 2 * S, scale=0.05),
              torch.tensor([bias], device=device)]
    cots = [f(T, B, S), f(T, B, L), f(T, B, D)]

    def scan(fn):
        def call(fx, fg, pre, att, h0, wa0, toep, st, hand, v, wss, wsg,
                 dxm, dgm, e_bias):
            return fn(fx, fg, mask, pre, att, amask, h0, w0, wa0, toep, st,
                      hand, v, wss, wsg, dxm, dgm, prior=prior,
                      e_bias=e_bias, normalizer=normalizer)
        return call

    before = dt.launches.count
    got, ggot = _grads(scan(dt.decoder_scan_train), leaves, cots)
    assert dt.launches.count == before + 2
    _, again = _grads(scan(dt.decoder_scan_train), leaves, cots)
    assert all(torch.equal(g, h) for g, h in zip(ggot, again))
    ref, gref = _grads(scan(dt.decoder_scan_train_reference), leaves, cots)
    assert float(gref[-1].abs()) > 0          # the bias gets a gradient
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5 * max(
            float(r.abs().max()), 1e-6))
    for g, r in zip(ggot, gref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * max(
            float(r.abs().max()), 1e-6))
