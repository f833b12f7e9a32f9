"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: they skip without a CUDA device, and run there
with ``python -m pytest -m cuda tests/test_torch_cuda.py`` (no JAX
needed)."""
import numpy as np
import pytest
import torch

from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
from attention_lvcsr_torch.ops import attention_energy as ae
from attention_lvcsr_torch.ops import beam_loop as bl
from attention_lvcsr_torch.ops import decode_score as ds
from attention_lvcsr_torch.ops import fst
from attention_lvcsr_torch.ops import gru_scan as gs
from attention_lvcsr_torch.search.beam import DecodeConstraint

pytestmark = pytest.mark.cuda

NET_CONFIG = dict(
    input_dims={"recordings": 6}, input_num_chars={}, eos_label=4,
    num_phonemes=5, dim_dec=8, dims_bidir=[7, 7], enc_transition="gru",
    dec_transition="gru", attention_type="content_and_conv", conv_n=2,
    criterion={"name": "log_likelihood"},
    bottom={"bottom_class": "speech"}, subsample=[1, 2],
    post_merge_dims=[10], max_decoded_length_scale=1.0,
    data_prepend_eos=False,
    prior={"type": "window_around_median", "before": 3, "after": 3})
INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.5],
                        "biases_init": ["constant", 0.0],
                        "rec_weights_init": ["orthogonal"]}}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _gru_operands(rng, device, T, B, D, ndir, masked=True):
    f = lambda *s: torch.tensor(rng.randn(*s).astype(np.float32) * 0.5,
                                device=device)
    mask = None
    if masked:
        lengths = rng.randint(1, T + 1, size=B)
        mask = torch.tensor((np.arange(T)[:, None] < lengths[None])
                            .astype(np.float32), device=device)
    weights = [(f(B, D), f(D, D) / D ** 0.5, f(D, 2 * D) / D ** 0.5)
               for _ in range(ndir)]
    return f(T, B, 3 * D * ndir), mask, weights


@pytest.mark.parametrize("T,B,D,masked", [(13, 3, 8, True),
                                          (40, 9, 250, True),
                                          (7, 5, 33, False)])
def test_gru_scan_kernel_matches_plain(device, T, B, D, masked):
    """One direction, forward in time."""
    rng = np.random.RandomState(T + B + D)
    proj, mask, (fwd,) = _gru_operands(rng, device, T, B, D, 1, masked)
    before = gs.launches.count
    got = gs.gru_scan(proj, mask, fwd)
    assert gs.launches.count == before + 1
    ref = gs.gru_scan_reference(proj, mask, fwd)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("T,B,D", [(13, 3, 8), (40, 9, 250),
                                   (17, 6, 300), (21, 35, 250)])
def test_gru_scan_bidir_kernel_matches_plain(device, T, B, D):
    """Both directions in one launch, the backward one in reverse time."""
    rng = np.random.RandomState(T * B + D)
    proj, mask, weights = _gru_operands(rng, device, T, B, D, 2)
    before = gs.launches.count
    got = gs.gru_scan(proj, mask, *weights)
    assert gs.launches.count == before + 1
    ref = gs.gru_scan_reference(proj, mask, *weights)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


def test_gru_scan_too_wide_raises(device):
    """D=600 does not fit the cluster's shared memory: no launch."""
    rng = np.random.RandomState(0)
    proj, mask, weights = _gru_operands(rng, device, 3, 2, 600, 2)
    before = gs.launches.count
    with pytest.raises(NotImplementedError, match="D=600"):
        gs.gru_scan(proj, mask, *weights)
    assert gs.launches.count == before


@pytest.mark.parametrize("search", [
    dict(char_discount=0.1),
    dict(char_discount=0.5, stop_on="optimistic_future_cost"),
    dict(char_discount=0.1, round_to_inf=2.0),
    dict(char_discount=0.1, ignore_first_eol=True)])
@pytest.mark.parametrize("states_readout", [False, True])
def test_beam_loop_kernel_matches_plain(device, search, states_readout):
    rec = SpeechRecognizer(dict(NET_CONFIG,
                                use_states_for_readout=states_readout),
                           init_config=INIT, seed=7, device=device)
    rec.net.generator.readout.post_merge_0.bias.data[4] += 1.5
    rng = np.random.RandomState(3)
    x = torch.tensor(rng.randn(5, 30, 6).astype(np.float32), device=device)
    m = torch.tensor((np.arange(30)[None] < np.array(
        [[30], [25], [0], [11], [30]])).astype(np.float32), device=device)
    with torch.inference_mode():
        data = rec.net.decode_loop(x, m)
        tables = rec.net.decode_loop_tables()
    kw = dict(beam=4, max_len=15, eol=4, prior="window_around_median",
              before=3.0, after=3.0, **search)
    before = bl.launches.count
    out, meta, steps = bl.beam_search_loop(
        data["pre"], data["attended"], data["attended_mask"], tables, **kw)
    assert bl.launches.count == before + 1
    ref_out, ref_meta, ref_steps = bl.beam_search_loop_reference(
        data["pre"], data["attended"], data["attended_mask"], tables, **kw)
    valid = ref_meta[:, :, 1] < bl.INF / 2
    assert valid.any()
    torch.testing.assert_close(out, ref_out, atol=0, rtol=0)
    torch.testing.assert_close(steps, ref_steps, atol=0, rtol=0)
    torch.testing.assert_close(meta[:, :, 2], ref_meta[:, :, 2])
    torch.testing.assert_close(meta[:, :, :2], ref_meta[:, :, :2],
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("U,K,L,M", [(3, 4, 23, 9), (2, 1, 7, 300),
                                     (4, 10, 200, 250), (1, 12, 33, 64)])
def test_attention_energy_kernel_matches_plain(device, U, K, L, M):
    rng = np.random.RandomState(U + K + L + M)
    f = lambda *s: torch.tensor(rng.randn(*s).astype(np.float32),
                                device=device)
    args = (f(U, L, M), f(U * K, M), f(U * K, L), f(M) * 0.3, f(M) * 0.3)
    before = ae.launches.count
    got = ae.beam_attention_energies(*args, 0.5, beam=K)
    assert ae.launches.count == before + 1
    ref = ae.beam_attention_energies_reference(*args, 0.5, beam=K)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("prior", [
    dict(prior="window_around_median", before=4.0, after=5.0),
    dict(prior="expanding", initial_begin=1.0, initial_end=6.0,
         min_speed=1.5, max_speed=2.5)], ids=["median", "expanding"])
@pytest.mark.parametrize("K", [3, 10, 12])
def test_decode_score_kernel_matches_plain(device, prior, K):
    U, L, M, D, S, R, V = 4, 37, 40, 24, 20, 30, 12
    rng = np.random.RandomState(K)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    w = np.abs(f(U * K, L))
    w /= w.sum(axis=1, keepdims=True)
    w[1] = 0.0
    mask = (np.arange(L)[None] < np.array([[L], [30], [11], [2]])
            ).astype(np.float32)
    t = lambda a: torch.tensor(a, device=device)
    tables = {k: t(v) for k, v in dict(
        state_trans=f(S, M), handler=f(M), v=f(M), merge_k=f(D, R),
        merge_b=f(R), post_k=f(R, V), post_b=f(V),
        conv_filters=f(1, 7) * 0.3).items()}
    args = (t(f(U, L, M)), t(f(U, L, D)), t(mask), t(w),
            t(rng.randint(0, 5, U * K).astype(np.int32)), t(f(U * K, S)),
            tables)
    before = ds.launches.count
    got = ds.fused_decode_score(*args, beam=K, **prior)
    assert ds.launches.count == before + 1
    ref = ds.fused_decode_score_reference(*args, beam=K, **prior)
    for name, g, r in zip(("costs", "weights", "energies", "wa"), got, ref):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5, msg=name)


def _lm_npz(path):
    rng = np.random.RandomState(11)
    toks = [f"c{i}" for i in range(5)]
    uni = {("<s>",): (-99.0, -0.4), ("</s>",): (-1.5, 0.0)}
    uni.update({(tk,): (float(-1.2 - rng.rand()), -0.5) for tk in toks})
    bi = {(a, b): (float(-0.3 - rng.rand()), 0.0)
          for a in toks for b in toks if rng.rand() < 0.5}
    graph = fst.arpa_to_fst({1: uni, 2: bi},
                            {tk: i + 1 for i, tk in enumerate(toks)})
    fst.save_packed(path, fst.pack_fst(graph, {i: i + 1 for i in range(5)},
                                       5, no_transition_cost=20.0))
    return path


def _decode_on(device, config, kwargs, seed=7):
    rec = SpeechRecognizer(config, init_config=INIT, seed=seed,
                           device=device)
    rec.net.generator.readout.post_merge_0.bias.data[4] += 1.5
    rng = np.random.RandomState(3)
    x = rng.randn(5, 30, 6).astype(np.float32)
    m = (np.arange(30)[None] < np.array(
        [[30], [25], [0], [11], [30]])).astype(np.float32)
    rec.init_beam_search(4)
    return rec.beam_search(x, m, as_arrays=True, **kwargs)


def _assert_same_decode(got, ref):
    valid = ref["done_valid"]
    assert valid.any()
    assert int(got["steps"]) == int(ref["steps"])
    np.testing.assert_array_equal(got["done_valid"], valid)
    np.testing.assert_array_equal(got["done_out"], ref["done_out"])
    np.testing.assert_array_equal(got["done_len"], ref["done_len"])
    np.testing.assert_allclose(got["done_cost"][valid],
                               ref["done_cost"][valid], atol=1e-4, rtol=1e-5)


def test_lm_decode_on_the_card_matches_plain(device, tmp_path):
    """LM-fused decode: gru_scan and beam_attention_energies launch, the
    loop kernel does not; the result is the CPU plain versions'."""
    config = dict(NET_CONFIG, lm={"path": _lm_npz(str(tmp_path / "g.npz")),
                                  "weight": 0.5,
                                  "no_transition_cost": 20.0})
    kwargs = dict(char_discount=0.1)
    counts = (ae.launches.count, bl.launches.count, gs.launches.count)
    got = _decode_on(device, config, kwargs)
    assert ae.launches.count > counts[0]
    assert bl.launches.count == counts[1]
    assert gs.launches.count > counts[2]
    _assert_same_decode(got, _decode_on("cpu", config, kwargs))


def test_constrained_fused_decode_on_the_card_matches_plain(device):
    """``use_pallas: fused`` with a dictionary constraint: every step is
    one fused_decode_score launch."""
    config = dict(NET_CONFIG, use_pallas="fused")
    char_map = {"a": 0, "b": 1, "c": 2, "<spc>": 3, "<eol>": 4}
    constraint = DecodeConstraint.from_words(["ab", "c", "cab", "ba"],
                                             char_map, 5)
    kwargs = dict(char_discount=0.1, validate_solution_function=constraint)
    before = ds.launches.count
    got = _decode_on(device, config, kwargs)
    assert ds.launches.count > before
    _assert_same_decode(got, _decode_on("cpu", config, kwargs))


def _grads(fn, leaves, cots):
    xs = [x.detach().requires_grad_() for x in leaves]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return outs, torch.autograd.grad(outs[:len(cots)], xs, cots)


@pytest.mark.parametrize("T,B,D,ndir", [(13, 3, 8, 1), (40, 9, 250, 2),
                                        (17, 35, 300, 2), (9, 5, 33, 1)])
def test_gru_scan_train_kernels_match_plain(device, T, B, D, ndir):
    """Forward (gru_scan.cu with residuals) and backward (gru_train.cu,
    then outer_sum.cu) vs autograd through the plain scan."""
    from attention_lvcsr_torch.ops import gru_train as gt
    rng = np.random.RandomState(T + B + D + ndir)
    proj, mask, weights = _gru_operands(rng, device, T, B, D, ndir)
    cot = torch.tensor(rng.randn(T, B, D * ndir).astype(np.float32),
                       device=device)
    leaves = [proj] + [w for d in weights for w in d]

    def scan(fn):
        return lambda p, *w: fn(p, mask, tuple(w[:3]),
                                tuple(w[3:]) if ndir == 2 else None)

    counter = gt.launches if ndir == 1 else gt.launches_bidir
    before = counter.count
    got, ggot = _grads(scan(gt.gru_scan_train), leaves, [cot])
    assert counter.count == before + 3      # forward, backward, outer_sum
    _, again = _grads(scan(gt.gru_scan_train), leaves, [cot])
    assert all(torch.equal(g, h) for g, h in zip(ggot, again))  # bit for bit
    ref, gref = _grads(scan(gt.gru_scan_train_reference), leaves, [cot])
    torch.testing.assert_close(got[0], ref[0], atol=1e-5, rtol=1e-5)
    for g, r in zip(ggot, gref):
        torch.testing.assert_close(g, r, atol=1e-4 * float(r.abs().max()),
                                   rtol=1e-4)


@pytest.mark.parametrize("prior", [
    {"type": "expanding", "initial_begin": 0, "initial_end": 6,
     "min_speed": 1.0, "max_speed": 2.0},
    {"type": "window_around_median", "before": 3, "after": 4}])
@pytest.mark.parametrize("T,B,L,M,D,S", [(6, 3, 10, 7, 9, 5),
                                         (20, 8, 60, 250, 500, 250)])
def test_decoder_scan_train_kernels_match_plain(device, prior, T, B, L, M,
                                                D, S):
    """Forward and backward kernels (then outer_sum.cu) vs autograd
    through the plain scan, ragged label and frame masks."""
    from attention_lvcsr_torch.ops import decoder_train as dt
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
    # recurrent weights at 1/sqrt(S): larger ones make the 20-step
    # recurrence chaotic, and then any rounding difference grows
    leaves = [f(T, B, S), f(T, B, 2 * S), f(B, L, M), f(B, L, D), f(B, S),
              f(B, D), dt.toeplitz_band(f(1, 7), L), f(S, M, scale=0.1),
              f(1, M, scale=0.1), f(M, scale=0.1), f(S, S, scale=S ** -0.5),
              f(S, 2 * S, scale=S ** -0.5), f(D, S, scale=0.05),
              f(D, 2 * S, scale=0.05)]
    cots = [f(T, B, S), f(T, B, L), f(T, B, D)]

    def scan(fn):
        def call(fx, fg, pre, att, h0, wa0, toep, st, hand, v, wss, wsg, dxm,
                 dgm):
            return fn(fx, fg, mask, pre, att, amask, h0, w0, wa0, toep, st,
                      hand, v, wss, wsg, dxm, dgm, prior=prior)
        return call

    before = dt.launches.count
    got, ggot = _grads(scan(dt.decoder_scan_train), leaves, cots)
    assert dt.launches.count == before + 3   # forward, backward, outer_sum
    _, again = _grads(scan(dt.decoder_scan_train), leaves, cots)
    assert all(torch.equal(g, h) for g, h in zip(ggot, again))  # bit for bit
    ref, gref = _grads(scan(dt.decoder_scan_train_reference), leaves, cots)
    for g, r in zip(list(got) + list(ggot), list(ref) + list(gref)):
        torch.testing.assert_close(
            g, r, rtol=1e-4, atol=1e-4 * max(float(r.detach().abs().max()),
                                             1e-6))


def test_decoder_scan_train_kernel_refuses_other_variants(device):
    from attention_lvcsr_torch.ops import decoder_train as dt
    z = lambda *s: torch.zeros(*s, device=device)
    args = (z(2, 1, 4), z(2, 1, 8), None, z(1, 5, 3), z(1, 5, 6), z(1, 5),
            z(1, 4), z(1, 5), z(1, 6), z(5, 5), z(4, 3), z(1, 3), z(3),
            z(4, 4), z(4, 8), z(6, 4), z(6, 8))
    with pytest.raises(NotImplementedError, match="relu"):
        dt.decoder_scan_train(*args, prior={"type": "expanding"},
                              normalizer="relu")
    with pytest.raises(NotImplementedError, match="window_around_mean"):
        dt.decoder_scan_train(*args, prior={"type": "window_around_mean"})
