"""Stacked GRU decoders (``dec_stack`` 2-4) in the kernels against their
plain PyTorch versions, on the card: ``beam_loop.cu``'s stacked instance
(the layers' advance, the interlayer products, the feedback rows read from
global memory) and ``decoder_train.cu``'s stacked forward and backward
(the interlayer tables' gradients included), at narrow and odd widths
(``wsj_jan_debug``'s 19-wide layers put every layer's lanes off a 16-byte
boundary), and the C layouts of both against their mirrors for one to
four layers.  Marked ``cuda``: they skip without a CUDA device, and run
there with ``python -m pytest -m cuda tests/test_torch_cuda_stacked.py
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
    post_merge_dims=[18], post_merge_activation="maxout:2",
    conv_num_filters=10, use_states_for_readout=True,
    max_decoded_length_scale=1.0, data_prepend_eos=False)
INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.5],
                        "biases_init": ["constant", 0.0],
                        "rec_weights_init": ["orthogonal"]}}
EXPANDING = {"type": "expanding", "initial_begin": 0, "initial_end": 6,
             "min_speed": 1.0, "max_speed": 2.0}
MEAN = {"type": "window_around_mean", "before": 3, "after": 4}
MEDIAN = {"type": "window_around_median", "before": 3, "after": 4}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


LOOP_CASES = {
    "stack2-mean": dict(dec_stack=2, prior=MEAN),
    "stack3-expanding": dict(dec_stack=3, prior=EXPANDING),
    "stack4-median-tanh": dict(dec_stack=4, prior=MEDIAN,
                               post_merge_activation="tanh",
                               conv_num_filters=1,
                               use_states_for_readout=False),
    "stack2-debug-widths": dict(dec_stack=2, prior=MEAN, dim_dec=19,
                                dims_bidir=[17, 17], conv_n=13),
}


@pytest.mark.parametrize("K", [1, 10])
@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_beam_loop_stack_matches_plain(device, K, case):
    """The stacked instance's decode vs the plain loop on the same card
    tensors: identical done sets, lengths and steps, costs within 1e-4 +
    1e-5 relative; a second launch repeats the bits; the C layout equals
    ``smem_plan``."""
    config = dict(NET, **LOOP_CASES[case])
    N, S = config["dec_stack"], config["dim_dec"]
    U, frames = 4, 48
    rec = SpeechRecognizer(config, init_config=INIT, seed=3, device=device)
    rec.net.generator.readout.post_merge_0.bias.data[rec.eos_label] += (
        3.0 if K > 1 else 6.0)
    rng = np.random.RandomState(3)
    x = torch.tensor(rng.randn(U, frames, 6).astype(np.float32),
                     device=device)
    lengths = rng.randint(frames // 2, frames + 1, size=U)
    lengths[0] = frames
    m = torch.tensor((np.arange(frames)[None] < lengths[:, None])
                     .astype(np.float32), device=device)
    with torch.inference_mode():
        data = rec.net.decode_loop(x, m)
        tables = rec.net.decode_loop_tables()
    assert tuple(tables["wss"].shape) == (S, N * S)
    prior = rec.net.generator.attention.prior_config()
    act = config["post_merge_activation"]
    nf = config["conv_num_filters"]
    kw = dict(beam=K, max_len=frames // 2, eol=rec.eos_label,
              char_discount=0.1, post_act=act, prior=prior["type"],
              **{k: float(v) for k, v in prior.items() if k != "type"})
    args = (data["pre"], data["attended"], data["attended_mask"], tables)
    L, M, D = data["pre"].shape[1], data["pre"].shape[2], \
        data["attended"].shape[2]
    lib = bl._build.load().lib
    lib.beam_loop_smem_bytes.argtypes = [ctypes.POINTER(bl._Args)]
    code, pieces = bl.post_act_code(act)
    taps = 2 * config["conv_n"] + 1
    c_args = bl._Args(U=U, L=L, M=M, D=D, S=S, R=18, V=9, F=S, K=K,
                      Lout=kw["max_len"], n_taps=taps, n_filters=nf,
                      post_act=code, maxout=pieces, dec_stack=N)
    assert lib.beam_loop_smem_bytes(ctypes.byref(c_args)) == bl.smem_plan(
        K, L, M, D, S, 18, 9, S, kw["max_len"], taps, n_filters=nf,
        maxout=pieces, dec_stack=N)["smem_bytes"]
    before = bl.launches.count
    got = bl.beam_search_loop(*args, **kw)
    again = bl.beam_search_loop(*args, **kw)
    assert bl.launches.count == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    ref = bl.beam_search_loop_reference(*args, **kw)
    out, meta, steps = got
    finished = int((ref[1][:, :, 1] < bl.INF / 2).any(dim=1).sum())
    assert finished >= U // 2, "vacuous: most utterances found nothing"
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


def _check_layouts(device, B, L, M, D, S, nf, N):
    """The C layout of both kinds' plans equals the mirror's."""
    lib = dt._build.load().lib
    lib.decoder_train_smem_bytes.argtypes = [ctypes.c_int,
                                             ctypes.POINTER(dt._Args)]
    for kind in dt.KINDS:
        p = dt.launch_plan(kind, B, L, M, D, S, device, n_filters=nf,
                           dec_stack=N)
        args = dt._Args(B=B, L=L, M=M, D=D, S=S, cluster=p["cluster"],
                        clusters=p["clusters"], res_pre=p["res_pre"],
                        res_att=p["res_att"], res_dpre=p.get("res_dpre", 0),
                        n_filters=nf, dec_stack=N)
        assert lib.decoder_train_smem_bytes(
            dt.KINDS.index(kind), ctypes.byref(args)) == p["smem_bytes"]


@pytest.mark.parametrize("N", [1, 2, 3, 4])
@pytest.mark.parametrize("B,L,M,D,S", [
    (3, 10, 7, 9, 5), (10, 400, 512, 512, 256), (10, 200, 512, 512, 512),
    (32, 100, 512, 34, 19)])
def test_decoder_layout_matches_mirror(device, N, B, L, M, D, S):
    _check_layouts(device, B, L, M, D, S, 10, N)


@pytest.mark.parametrize("N,prior", [(2, MEAN), (3, EXPANDING),
                                     (4, MEDIAN)])
@pytest.mark.parametrize("T,B,L,M,D,S,taps", [
    (6, 3, 10, 7, 9, 5, 7), (8, 5, 61, 33, 34, 19, 27),
    (5, 10, 200, 512, 512, 256, 201)])
def test_decoder_scan_train_stack_matches_plain(device, N, prior, T, B, L,
                                                M, D, S, taps):
    """The stacked forward and backward kernels vs autograd through the
    plain scan, ten filters, every gradient (the interlayer tables'
    included), rows padded from their label lengths on; a second call's
    gradients bit for bit; the C layouts equal the mirror's."""
    nf = 10
    rng = np.random.RandomState(T + B + L + N)
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
    filters = f(nf, taps)
    toep = torch.cat([dt.toeplitz_band(filters[i], L) for i in range(nf)],
                     dim=1)
    NS = N * S
    leaves = [f(T, B, NS), f(T, B, 2 * NS), f(B, L, M), f(B, L, D),
              f(B, NS), f(B, D), toep, f(NS, M, scale=0.1),
              f(nf, M, scale=0.1), f(M, scale=0.1),
              f(S, NS, scale=S ** -0.5), f(S, 2 * NS, scale=S ** -0.5),
              f(D, NS, scale=0.05), f(D, 2 * NS, scale=0.05),
              f(S, (N - 1) * S, scale=S ** -0.5),
              f(S, 2 * (N - 1) * S, scale=S ** -0.5)]
    cots = [f(T, B, NS), f(T, B, L), f(T, B, D)]

    def scan(fn):
        def call(fx, fg, pre, att, h0, wa0, toep, st, hand, v, wss, wsg,
                 dxm, dgm, inter_in, inter_gate):
            return fn(fx, fg, mask, pre, att, amask, h0, w0, wa0, toep, st,
                      hand, v, wss, wsg, dxm, dgm, prior=prior,
                      n_filters=nf, dec_stack=N, inter_in=inter_in,
                      inter_gate=inter_gate)
        return call

    _check_layouts(device, B, L, M, D, S, nf, N)
    before = dt.launches.count
    got, ggot = _grads(scan(dt.decoder_scan_train), leaves, cots)
    assert dt.launches.count == before + 2
    _, again = _grads(scan(dt.decoder_scan_train), leaves, cots)
    assert all(torch.equal(g, h) for g, h in zip(ggot, again))
    ref, gref = _grads(scan(dt.decoder_scan_train_reference), leaves, cots)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5 * max(
            float(r.abs().max()), 1e-6))
    for g, r in zip(ggot, gref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * max(
            float(r.abs().max()), 1e-6))
