"""The WSJ recipes' readout and attention branches of the kernels against
their plain PyTorch versions, on the card: ``beam_loop.cu``'s post-merge
activations (rectifier, sigmoid, identity, maxout), 1-16 conv filters and
the ``window_around_mean`` prior, ``decoder_train.cu``'s filters and mean
prior forward and backward (the taps' and the handler's gradients
included), and ``decode_score.cu``'s mean prior.  Marked ``cuda``: they
skip without a CUDA device, and run there with ``python -m pytest -m cuda
tests/test_torch_cuda_wsj_variants.py --noconftest`` (no JAX needed)."""
import ctypes

import numpy as np
import pytest
import torch

from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
from attention_lvcsr_torch.ops import beam_loop as bl
from attention_lvcsr_torch.ops import decode_score as ds
from attention_lvcsr_torch.ops import decoder_train as dt
from attention_lvcsr_torch.ops.expressions import maxout_pieces

pytestmark = pytest.mark.cuda

NET = dict(
    input_dims={"recordings": 6}, input_num_chars={}, eos_label=8,
    num_phonemes=9, dim_dec=33, dims_bidir=[33, 33], enc_transition="gru",
    dec_transition="gru", attention_type="content_and_conv", conv_n=2,
    criterion={"name": "log_likelihood"},
    bottom={"bottom_class": "speech"}, subsample=[1, 2],
    post_merge_dims=[18], max_decoded_length_scale=1.0,
    data_prepend_eos=False)
INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.5],
                        "biases_init": ["constant", 0.0],
                        "rec_weights_init": ["orthogonal"]}}
EXPANDING = {"type": "expanding", "initial_begin": 0, "initial_end": 6,
             "min_speed": 1.0, "max_speed": 2.0}
MEDIAN = {"type": "window_around_median", "before": 3, "after": 4}
MEAN = {"type": "window_around_mean", "before": 3, "after": 4}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


LOOP_CASES = {
    "maxout-10-mean": dict(post_merge_activation="maxout:2",
                           conv_num_filters=10, prior=MEAN,
                           use_states_for_readout=True),
    "maxout-10-expanding": dict(post_merge_activation="maxout:2",
                                conv_num_filters=10, prior=EXPANDING,
                                use_states_for_readout=True),
    "maxout-10-mean-logistic": dict(post_merge_activation="maxout:2",
                                    conv_num_filters=10, prior=MEAN,
                                    use_states_for_readout=True,
                                    energy_normalizer="logistic"),
    "maxout3-3-median": dict(post_merge_activation="maxout:3",
                             conv_num_filters=3, prior=MEDIAN),
    "rectifier": dict(post_merge_activation="rectifier", prior=MEDIAN,
                      use_states_for_readout=True),
    "sigmoid": dict(post_merge_activation="sigmoid", prior=EXPANDING),
    "identity": dict(post_merge_activation="identity", prior=MEAN),
}


@pytest.mark.parametrize("K", [1, 10])
@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_beam_loop_variant_branches_match_plain(device, K, case):
    """The kernel's decode vs the plain loop on the same card tensors:
    identical done sets, lengths and steps, costs within 1e-4 + 1e-5
    relative; a second launch repeats the bits; the C layout equals
    ``smem_plan``."""
    config = dict(NET, **LOOP_CASES[case])
    U, frames = 4, 48
    rec = SpeechRecognizer(config, init_config=INIT, seed=3, device=device)
    # one hypothesis a row (K=1) of these random weights tends to repeat a
    # symbol to the cap: a larger EOS bias makes most of its rows finish
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
    prior = rec.net.generator.attention.prior_config()
    act = config["post_merge_activation"]
    nf = config.get("conv_num_filters", 1)
    normalizer = config.get("energy_normalizer", "softmax")
    kw = dict(beam=K, max_len=frames // 2, eol=rec.eos_label,
              char_discount=0.1, normalizer=normalizer, post_act=act,
              prior=prior["type"],
              **{k: float(v) for k, v in prior.items() if k != "type"})
    args = (data["pre"], data["attended"], data["attended_mask"], tables)
    L, M, D = data["pre"].shape[1], data["pre"].shape[2], \
        data["attended"].shape[2]
    lib = bl._build.load().lib
    lib.beam_loop_smem_bytes.argtypes = [ctypes.POINTER(bl._Args)]
    code, pieces = bl.post_act_code(act)
    c_args = bl._Args(U=U, L=L, M=M, D=D, S=33, R=18, V=9, F=33, K=K,
                      Lout=kw["max_len"], n_taps=5, n_filters=nf,
                      post_act=code, maxout=pieces,
                      normalizer=bl.NORMALIZERS.index(normalizer))
    assert lib.beam_loop_smem_bytes(ctypes.byref(c_args)) == bl.smem_plan(
        K, L, M, D, 33, 18, 9, 33, kw["max_len"], 5, normalizer=normalizer,
        n_filters=nf, maxout=maxout_pieces(act))["smem_bytes"]
    before = bl.launches.count
    got = bl.beam_search_loop(*args, **kw)
    again = bl.beam_search_loop(*args, **kw)
    assert bl.launches.count == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    ref = bl.beam_search_loop_reference(*args, **kw)
    out, meta, steps = got
    finished = int((ref[1][:, :, 1] < bl.INF / 2).any(dim=1).sum())
    assert finished >= U // 2, \
        "vacuous: most utterances found nothing"
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


@pytest.mark.parametrize("nf,normalizer,prior", [
    (10, "softmax", MEAN), (10, "softmax", EXPANDING),
    (10, "logistic", MEAN), (3, "softmax", MEDIAN), (1, "softmax", MEAN)])
@pytest.mark.parametrize("T,B,L,M,D,S,taps", [
    (6, 3, 10, 7, 9, 5, 7), (8, 5, 199, 33, 17, 33, 7),
    (5, 10, 200, 512, 512, 256, 201)])
def test_decoder_scan_train_filters_match_plain(device, nf, normalizer,
                                                prior, T, B, L, M, D, S,
                                                taps):
    """Forward and backward kernels vs autograd through the plain scan,
    the (L, F*L) bands' and the (F, M) handler's gradients included;
    a second call's gradients bit for bit; the C layout equals the
    mirror's."""
    rng = np.random.RandomState(T + B + L + nf)
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
    leaves = [f(T, B, S), f(T, B, 2 * S), f(B, L, M), f(B, L, D), f(B, S),
              f(B, D), toep, f(S, M, scale=0.1), f(nf, M, scale=0.1),
              f(M, scale=0.1), f(S, S, scale=S ** -0.5),
              f(S, 2 * S, scale=S ** -0.5), f(D, S, scale=0.05),
              f(D, 2 * S, scale=0.05)]
    if normalizer != "softmax":      # the energy bias, with its gradient
        leaves.append(torch.tensor([-0.2], device=device))
    cots = [f(T, B, S), f(T, B, L), f(T, B, D)]

    def scan(fn):
        def call(fx, fg, pre, att, h0, wa0, toep, st, hand, v, wss, wsg,
                 dxm, dgm, e_bias=None):
            return fn(fx, fg, mask, pre, att, amask, h0, w0, wa0, toep, st,
                      hand, v, wss, wsg, dxm, dgm, prior=prior,
                      e_bias=e_bias, normalizer=normalizer, n_filters=nf)
        return call

    for kind in dt.KINDS:
        p = dt.launch_plan(kind, B, L, M, D, S, device, n_filters=nf)
        lib = dt._build.load().lib
        lib.decoder_train_smem_bytes.argtypes = [ctypes.c_int,
                                                 ctypes.POINTER(dt._Args)]
        args = dt._Args(B=B, L=L, M=M, D=D, S=S, cluster=p["cluster"],
                        clusters=p["clusters"], res_pre=p["res_pre"],
                        res_att=p["res_att"],
                        res_dpre=p.get("res_dpre", 0), n_filters=nf)
        assert lib.decoder_train_smem_bytes(
            dt.KINDS.index(kind), ctypes.byref(args)) == p["smem_bytes"]
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


@pytest.mark.parametrize("U,K,L", [(4, 3, 23), (64, 10, 200)])
def test_decode_score_mean_prior_matches_plain(device, U, K, L):
    """The score kernel under ``window_around_mean`` vs its plain version
    on the same card tensors (a padded utterance, a row of zero weights)
    within 1e-4; a second launch repeats the bits."""
    M, D, S, R, V, n = 250, 500, 250, 250, 32, 50
    rng = np.random.RandomState(U + L)
    f = lambda *s, scale=1.0: torch.tensor(
        rng.randn(*s).astype(np.float32) * scale, device=device)
    w = torch.tensor(np.abs(rng.randn(U * K, L)).astype(np.float32) ** 4,
                     device=device)
    w = w / w.sum(dim=1, keepdim=True)
    w[1] = 0.0
    frames = rng.randint(L // 2, L + 1, size=U)
    frames[-1] = 0
    mask = torch.tensor((np.arange(L)[None] < frames[:, None]).astype("f"),
                        device=device)
    tables = {"state_trans": f(S, M, scale=0.1), "handler": f(M),
              "v": f(M, scale=0.1), "merge_k": f(D, R, scale=0.05),
              "merge_b": f(R), "post_k": f(R, V, scale=0.1), "post_b": f(V),
              "conv_filters": f(1, 2 * n + 1, scale=0.3)}
    args = (f(U, L, M, scale=0.5), f(U, L, D), mask, w,
            torch.zeros(U * K, dtype=torch.int32, device=device),
            f(U * K, S))
    kw = dict(beam=K, prior="window_around_mean", before=20.0, after=30.0)
    before = ds.launches.count
    got = ds.fused_decode_score(*args, tables, **kw)
    again = ds.fused_decode_score(*args, tables, **kw)
    assert ds.launches.count == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = ds.fused_decode_score_reference(*args, tables, **kw)
    for name, g, r in zip(("costs", "weights", "energies", "wa"), got, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4, msg=name)
