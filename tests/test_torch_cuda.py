"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: they skip without a CUDA device, and run there
with ``python -m pytest -m cuda tests/test_torch_cuda.py --noconftest``
(no JAX needed)."""
import numpy as np
import pytest
import torch

from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
from attention_lvcsr_torch.ops import attention_energy as ae
from attention_lvcsr_torch.ops import beam_loop as bl
from attention_lvcsr_torch.ops import decode_score as ds
from attention_lvcsr_torch.ops import fst
from attention_lvcsr_torch.ops import gru_scan as gs
from attention_lvcsr_torch.ops import outer_sum as osum
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
FLAGSHIP_INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.1],
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


@pytest.mark.parametrize("T,B,D,ndir,cluster", [
    (9, 35, 300, 2, 16), (9, 35, 250, 2, 8), (9, 35, 250, 2, 16),
    (1, 17, 33, 2, 8), (5, 16, 448, 1, 16)])
def test_gru_scan_layout_edges(device, monkeypatch, T, B, D, ndir, cluster):
    """The forward kernel's padding (D not a multiple of the cluster's
    columns), its partial row group (B=35), a row masked from the first
    step, both directions, with the cluster size forced; the C layout
    equals the Python mirror, and a second call repeats bit for bit."""
    import ctypes
    from attention_lvcsr_torch import _build
    lib = _build.load().lib
    lib.gru_scan_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    assert lib.gru_scan_smem_bytes(D, cluster) == \
        gs.fwd_layout(D, cluster)["smem_bytes"]
    monkeypatch.setattr(gs, "max_active_clusters", lambda D, device: {
        size: 16 if size == cluster else 0 for size in gs.CLUSTERS})
    rng = np.random.RandomState(T + B + D)
    proj, mask, weights = _gru_operands(rng, device, T, B, D, ndir)
    mask[:, -1] = 0.0
    got = gs.gru_scan(proj, mask, *weights)
    again = gs.gru_scan(proj, mask, *weights)
    ref = gs.gru_scan_reference(proj, mask, *weights)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    assert torch.equal(got, again)
    assert torch.equal(got[:, -1], weights[0][0][-1].expand(T, D)
                       if ndir == 1 else torch.cat(
                           [weights[0][0][-1], weights[1][0][-1]])
                       .expand(T, 2 * D))


def test_gru_scan_too_wide_raises(device):
    """D=1025 is past the wide instance's 1024: no launch of either
    instance, in the scan and in the training scan."""
    from attention_lvcsr_torch.ops import gru_train as gt
    rng = np.random.RandomState(0)
    proj, mask, weights = _gru_operands(rng, device, 3, 2, 1025, 2)
    counters = (gs.launches, gs.launches_wide, gt.launches_bidir,
                gt.launches_bidir_wide)
    before = [c.count for c in counters]
    with pytest.raises(NotImplementedError, match="D=1025"):
        gs.gru_scan(proj, mask, *weights)
    with pytest.raises(NotImplementedError, match="D=1025"):
        gt.gru_scan_train(proj, mask, *weights)
    assert [c.count for c in counters] == before


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


def _loop_case(device, config, U, frames, beam, eos_bias, seed, init=INIT):
    """Loop inputs, tables and keywords of ``config`` with random weights;
    the EOS logit raised by ``eos_bias``."""
    rec = SpeechRecognizer(config, init_config=init, seed=seed,
                           device=device)
    rng = np.random.RandomState(seed)
    dims = config["input_dims"]["recordings"]
    x = torch.tensor(rng.randn(U, frames, dims).astype(np.float32),
                     device=device)
    lengths = rng.randint(frames // 2, frames + 1, size=U)
    lengths[0] = frames
    m = torch.tensor((np.arange(frames)[None] < lengths[:, None])
                     .astype(np.float32), device=device)
    with torch.inference_mode():
        data = rec.net.decode_loop(x, m)
        tables = dict(rec.net.decode_loop_tables())
    tables["post_b"] = tables["post_b"].clone()
    tables["post_b"][rec.eos_label] += eos_bias
    prior = rec.net.generator.attention.prior_config()
    kw = dict(beam=beam, max_len=frames // 8, eol=rec.eos_label,
              char_discount=0.1, prior=prior["type"],
              **{k: float(prior[k]) for k in (
                  "before", "after", "initial_begin", "initial_end",
                  "min_speed", "max_speed") if k in prior})
    return (data["pre"], data["attended"], data["attended_mask"], tables), kw


def _check_loop(args, kw):
    """Kernel vs plain, the C layout vs its mirror, a second call's bits."""
    import ctypes
    from attention_lvcsr_torch import _build
    pre, attended, _, tables = args
    U, L, M = pre.shape
    S, R, V = (tables["wss"].shape[0], tables["merge_k"].shape[1],
               tables["post_k"].shape[1])
    content = kw.get("content_attention", False)
    taps = 0 if content else tables["conv_filters"].shape[-1]
    lib = _build.load().lib
    lib.beam_loop_smem_bytes.argtypes = [ctypes.POINTER(bl._Args)]
    c_args = bl._Args(U=U, L=L, M=M, D=attended.shape[-1], S=S, R=R, V=V,
                      F=tables["embed"].shape[1], K=kw["beam"],
                      Lout=kw["max_len"], n_taps=taps, content=int(content))
    assert lib.beam_loop_smem_bytes(ctypes.byref(c_args)) == bl.smem_plan(
        kw["beam"], L, M, attended.shape[-1], S, R, V,
        tables["embed"].shape[1], kw["max_len"], taps,
        content=content)["smem_bytes"]
    before = bl.launches.count
    got = bl.beam_search_loop(*args, **kw)
    again = bl.beam_search_loop(*args, **kw)
    assert bl.launches.count == before + 2
    ref = bl.beam_search_loop_reference(*args, **kw)
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    out, meta, steps = got
    assert (ref[1][:, :, 1] < bl.INF / 2).any()
    torch.testing.assert_close(out, ref[0], atol=0, rtol=0)
    torch.testing.assert_close(steps, ref[2], atol=0, rtol=0)
    torch.testing.assert_close(meta[:, :, 2], ref[1][:, :, 2])
    torch.testing.assert_close(meta[:, :, :2], ref[1][:, :, :2],
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("K", [1, 10, 16])
@pytest.mark.parametrize("states_readout,prior", [
    (False, {"type": "window_around_median", "before": 3, "after": 3}),
    (True, {"type": "expanding", "initial_begin": 0, "initial_end": 6,
            "min_speed": 0.5, "max_speed": 2.0})])
def test_beam_loop_kernel_odd_widths(device, K, states_readout, prior):
    """S=33, D=66: odd row pitches and odd table widths take the products'
    scalar paths; K=1, 10 and 16 take row groups of 1 to 8 rows."""
    config = dict(NET_CONFIG, dim_dec=33, dims_bidir=[33, 33],
                  post_merge_dims=[17], num_phonemes=9, eos_label=8,
                  use_states_for_readout=states_readout, prior=prior)
    args, kw = _loop_case(device, config, 3, 48, K, 3.0 if K == 1 else 1.5,
                          seed=K)
    _check_loop(args, kw)


def test_beam_loop_kernel_flagship_widths(device):
    """The flagship's widths (D=500, S=M=R=F=250, V=32, beam 10) at U=3:
    row groups of 5 and of 3, 2 rows, the L1 prefetch over long tables."""
    from __graft_entry__ import FLAGSHIP_NET
    config = dict(FLAGSHIP_NET, max_decoded_length_scale=8.0)
    args, kw = _loop_case(device, config, 3, 400, 10, 1.5, seed=5,
                          init=FLAGSHIP_INIT)
    _check_loop(args, kw)


CONTENT_CONFIG = {k: v for k, v in NET_CONFIG.items()
                  if k not in ("conv_n", "prior")}
CONTENT_CONFIG["attention_type"] = "content"


@pytest.mark.parametrize("K", [1, 10])
@pytest.mark.parametrize("states_readout", [False, True])
def test_beam_loop_content_branch_matches_plain(device, K, states_readout):
    """Content-only attention (no convolution, no handler term) over the
    window search/beam.py gives it, every frame: the kernel's content
    branch vs the plain version, odd widths and the tables without
    ``handler`` and ``conv_filters``."""
    config = dict(CONTENT_CONFIG, dim_dec=33, dims_bidir=[33, 33],
                  post_merge_dims=[17], num_phonemes=9, eos_label=8,
                  use_states_for_readout=states_readout)
    args, kw = _loop_case(device, config, 3, 48, K, 3.0 if K == 1 else 1.5,
                          seed=K)
    assert "conv_filters" not in args[3] and "handler" not in args[3]
    kw.update(initial_end=float(args[0].shape[1]) + 1.0,
              content_attention=True)
    _check_loop(args, kw)


def test_beam_loop_content_branch_recipe_widths(device):
    """The TIMIT recipe's widths (nips_baseline.yaml: D=500, S=M=R=250, 63
    phones with BOS and EOS, 3x250 BiGRU subsampled 1, 2, 2) at U=3."""
    config = dict(CONTENT_CONFIG, input_dims={"recordings": 123},
                  dim_dec=250, dims_bidir=[250, 250, 250],
                  subsample=[1, 2, 2], post_merge_dims=[250],
                  num_phonemes=63, eos_label=62,
                  bottom={"bottom_class": "speech", "dims": [100],
                          "activation": "relu"})
    args, kw = _loop_case(device, config, 3, 400, 10, 1.5, seed=5,
                          init=FLAGSHIP_INIT)
    kw.update(initial_end=float(args[0].shape[1]) + 1.0,
              content_attention=True)
    _check_loop(args, kw)


def test_beam_loop_too_large_raises(device):
    """Beam 32 at the flagship widths does not fit a block's shared memory:
    no launch."""
    from __graft_entry__ import FLAGSHIP_NET
    config = dict(FLAGSHIP_NET, max_decoded_length_scale=8.0)
    args, kw = _loop_case(device, config, 1, 64, 32, 0.0, seed=1,
                          init=FLAGSHIP_INIT)
    before = bl.launches.count
    with pytest.raises(NotImplementedError, match="beam 32"):
        bl.beam_search_loop(*args, **kw)
    assert bl.launches.count == before


@pytest.mark.parametrize("U,K,L,M", [
    (3, 4, 23, 9), (2, 1, 7, 300), (4, 10, 200, 250), (1, 12, 33, 64),
    # the LM decode's flagship shape at U=64 and 128
    (64, 10, 200, 250), (128, 10, 200, 250),
    # M not a multiple of 4 or 32, L under one frame tile, K = 1, 3, 12
    (5, 3, 5, 33), (2, 1, 200, 251), (7, 12, 13, 130), (1, 10, 1, 250),
    (3, 3, 41, 7),
    # beam 32: more than 48 KB of shared memory a block
    (3, 32, 40, 250)])
def test_attention_energy_kernel_matches_plain(device, U, K, L, M):
    """Within 1e-5 of the plain version (the sums run in another order),
    and a second call repeats the first bit for bit."""
    rng = np.random.RandomState(U + K + L + M)
    f = lambda *s: torch.tensor(rng.randn(*s).astype(np.float32),
                                device=device)
    args = (f(U, L, M), f(U * K, M), f(U * K, L), f(M) * 0.3, f(M) * 0.3)
    before = ae.launches.count
    got = ae.beam_attention_energies(*args, 0.5, beam=K)
    assert ae.launches.count == before + 1
    ref = ae.beam_attention_energies_reference(*args, 0.5, beam=K)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    assert torch.equal(got, ae.beam_attention_energies(*args, 0.5, beam=K))


# U, L, M, D, S, R, V, taps and the scale of the tables: a small shape
# (clusters of 8 blocks, some of whose blocks get no column of D), odd
# widths (M, D, S, R, V not multiples of 4 or 32, L = 5), and the flagship
# widths at U=64 and U=128 (clusters of 2 and of 1 block on an H100).  The
# new shapes take tables at the flagship's initial scale (0.1, the
# isotropic_gaussian of FLAGSHIP_INIT): unit tables at widths of 250-500
# give logits near 100, whose float32 rounding alone exceeds the
# tolerance.
SCORE_SHAPES = {"small": (4, 37, 40, 24, 20, 30, 12, 7, 1.0),
                "odd": (3, 5, 41, 27, 19, 33, 13, 5, 0.1),
                "flagship64": (64, 200, 250, 500, 250, 250, 32, 201, 0.1),
                "flagship128": (128, 200, 250, 500, 250, 250, 32, 201, 0.1)}


def _score_args(device, K, U, L, M, D, S, R, V, taps, scale, seed,
                exact_sums=False):
    """Operands of a score step: ragged masks (the first utterance whole),
    a row of zero weights, tables at ``scale``.  ``exact_sums`` rounds the
    weights to multiples of 2**-20, whose partial sums float32 holds
    exactly in any order."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    w = np.abs(f(U * K, L))
    w /= w.sum(axis=1, keepdims=True)
    if exact_sums:
        w = (np.round(w * 2.0 ** 20) / 2.0 ** 20).astype(np.float32)
    w[min(1, U * K - 1)] = 0.0
    lengths = rng.randint(1, L + 1, size=U)
    lengths[0] = L
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.float32)
    t = lambda a: torch.tensor(a, device=device)
    tables = {k: t(v) for k, v in dict(
        state_trans=f(S, M) * scale, handler=f(M) * scale, v=f(M) * scale,
        merge_k=f(D, R) * scale, merge_b=f(R) * scale,
        post_k=f(R, V) * scale, post_b=f(V) * scale,
        conv_filters=f(1, taps) * 0.3).items()}
    return (t(f(U, L, M)), t(f(U, L, D)), t(mask), t(w),
            t(rng.randint(0, 5, U * K).astype(np.int32)), t(f(U * K, S)),
            tables)


def _score_matches_plain(args, K, prior):
    before = ds.launches.count
    got = ds.fused_decode_score(*args, beam=K, **prior)
    assert ds.launches.count == before + 1
    ref = ds.fused_decode_score_reference(*args, beam=K, **prior)
    for name, g, r in zip(("costs", "weights", "energies", "wa"), got, ref):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5, msg=name)
    again = ds.fused_decode_score(*args, beam=K, **prior)
    for name, g, a in zip(("costs", "weights", "energies", "wa"), got, again):
        assert torch.equal(g, a), name


@pytest.mark.parametrize("shape", sorted(SCORE_SHAPES))
@pytest.mark.parametrize("prior", [
    dict(prior="window_around_median", before=4.0, after=5.0),
    dict(prior="expanding", initial_begin=1.0, initial_end=6.0,
         min_speed=1.5, max_speed=2.5)], ids=["median", "expanding"])
@pytest.mark.parametrize("K", [1, 3, 10, 12, 20])
def test_decode_score_kernel_matches_plain(device, prior, K, shape):
    """Within 1e-5 of the plain version, with a row of zero weights,
    ragged masks and windows clipped at both ends; a second call repeats
    the first bit for bit."""
    _score_matches_plain(_score_args(device, K, *SCORE_SHAPES[shape],
                                     seed=K), K, prior)


@pytest.mark.parametrize("U,L", [(67, 777), (67, 1437), (128, 1244),
                                 (64, 1606)])
@pytest.mark.parametrize("prior", [
    dict(prior="window_around_median", before=100.0, after=100.0),
    dict(prior="expanding", initial_begin=0.0, initial_end=1e4,
         min_speed=0.0, max_speed=0.0)], ids=["median", "whole"])
def test_decode_score_long_windows(device, prior, U, L):
    """Windows of up to 1606 frames at the flagship widths, beam 10, on
    whichever cluster size holds them (the zone shrunk to what a block
    has left; the expanding prior's window spans every frame).  The
    median compares a cumulative sum with 0.5, which the kernel and the
    plain version add in different orders: over hundreds of frames a row
    passing 0.5 within float32 rounding (seed 1244 at U=128 has one, 3.6e-8
    short of it) moves its median by a frame, so the weights here have
    exact partial sums."""
    _score_matches_plain(_score_args(device, 10, U, L, 250, 500, 250, 250,
                                     32, 201, 0.1, seed=L, exact_sums=True),
                         10, prior)


@pytest.mark.parametrize("size", ds.CLUSTERS)
def test_decode_score_every_cluster_size(device, monkeypatch, size):
    """The flagship widths at U=3 with each cluster size forced."""
    monkeypatch.setattr(ds, "active_clusters", lambda shape, device: {
        c: 16 if c == size else 0 for c in ds.CLUSTERS})
    args = _score_args(device, 10, 3, 200, 250, 500, 250, 250, 32, 201, 0.1,
                       seed=size)
    assert ds.launch_plan(3, {}, device)["cluster"] == size
    _score_matches_plain(args, 10, dict(prior="window_around_median",
                                        before=30.0, after=30.0))


def test_decode_kernels_launch_on_every_device(device):
    """Both module-path kernels launch on each device in turn, each with
    more than 48 KB of dynamic shared memory (an attribute of each
    device's context)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    for index in range(torch.cuda.device_count()):
        dev = torch.device("cuda", index)
        rng = np.random.RandomState(index)
        f = lambda *s: torch.tensor(rng.randn(*s).astype(np.float32),
                                    device=dev)
        eargs = (f(3, 40, 500), f(3 * 32, 500), f(3 * 32, 40), f(500) * 0.3,
                 f(500) * 0.3)
        assert ae.launch_plan(3, 32, 40, 500, dev)["smem_bytes"] > 49152
        torch.testing.assert_close(
            ae.beam_attention_energies(*eargs, 0.5, beam=32),
            ae.beam_attention_energies_reference(*eargs, 0.5, beam=32),
            atol=1e-5, rtol=1e-5)
        _score_matches_plain(_score_args(dev, 10, 4, 200, 250, 500, 250,
                                         250, 32, 201, 0.1, seed=index),
                             10, dict(prior="window_around_median",
                                      before=100.0, after=100.0))


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
    _check_gru_scan_train(device, T, B, D, ndir)


@pytest.mark.parametrize("T,B,D,ndir", [(1, 17, 33, 2), (6, 35, 250, 2),
                                        (1, 16, 300, 1), (11, 17, 250, 1),
                                        (4, 33, 33, 2), (3, 17, 300, 2)])
def test_gru_train_backward_edges(device, T, B, D, ndir):
    """gru_train.cu at its edges: B not a multiple of the cluster's 16
    rows, D not a multiple of its 8-block column split (33, 250, 300, the
    last blocks' columns partly padding), one step, and row 0 masked from
    the first step (its gradients pass straight through)."""
    _check_gru_scan_train(device, T, B, D, ndir, first_masked=True)


def _check_gru_scan_train(device, T, B, D, ndir, first_masked=False):
    from attention_lvcsr_torch.ops import gru_train as gt
    rng = np.random.RandomState(T + B + D + ndir)
    proj, mask, weights = _gru_operands(rng, device, T, B, D, ndir)
    if first_masked:
        mask[:, 0] = 0.0
    cot = torch.tensor(rng.randn(T, B, D * ndir).astype(np.float32),
                       device=device)
    leaves = [proj] + [w for d in weights for w in d]

    def scan(fn):
        return lambda p, *w: fn(p, mask, tuple(w[:3]),
                                tuple(w[3:]) if ndir == 2 else None)

    counter = gt.launches if ndir == 1 else gt.launches_bidir
    before, sums = counter.count, osum.launches.count
    got, ggot = _grads(scan(gt.gru_scan_train), leaves, [cot])
    assert counter.count == before + 2      # forward, backward
    assert osum.launches.count == sums + 2  # outer_sum's two kernels
    _, again = _grads(scan(gt.gru_scan_train), leaves, [cot])
    assert all(torch.equal(g, h) for g, h in zip(ggot, again))  # bit for bit
    ref, gref = _grads(scan(gt.gru_scan_train_reference), leaves, [cot])
    torch.testing.assert_close(got[0], ref[0], atol=1e-5, rtol=1e-5)
    for g, r in zip(ggot, gref):
        torch.testing.assert_close(g, r, atol=1e-4 * float(r.abs().max()),
                                   rtol=1e-4)


EXPANDING = {"type": "expanding", "initial_begin": 0, "initial_end": 6,
             "min_speed": 1.0, "max_speed": 2.0}
MEDIAN = {"type": "window_around_median", "before": 3, "after": 4}


def _check_decoder_scan_train(device, prior, T, B, L, M, D, S, taps=7,
                              content=False):
    """Forward and backward kernels (then outer_sum.cu) vs autograd through
    the plain scan, ragged label and frame masks; a second call's
    gradients bit for bit.  ``content``: the content branch (no filter,
    zero initial weights, the band and handler zeros that get no
    gradient)."""
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
    w0[:, 0] = 0.0 if content else 1.0
    # recurrent weights at 1/sqrt(S): larger ones make the 20-step
    # recurrence chaotic, and then any rounding difference grows
    leaves = [f(T, B, S), f(T, B, 2 * S), f(B, L, M), f(B, L, D), f(B, S),
              f(B, D), dt.toeplitz_band(f(1, taps), L), f(S, M, scale=0.1),
              f(1, M, scale=0.1), f(M, scale=0.1), f(S, S, scale=S ** -0.5),
              f(S, 2 * S, scale=S ** -0.5), f(D, S, scale=0.05),
              f(D, 2 * S, scale=0.05)]
    cots = [f(T, B, S), f(T, B, L), f(T, B, D)]
    band = (torch.zeros(L, L, device=device),
            torch.zeros(1, M, device=device))
    if content:
        del leaves[8], leaves[6]        # the band and the handler

    def scan(fn):
        def call(fx, fg, pre, att, h0, wa0, *rest):
            if content:
                (st, v, wss, wsg, dxm, dgm), (toep, hand) = rest, band
            else:
                toep, st, hand, v, wss, wsg, dxm, dgm = rest
            return fn(fx, fg, mask, pre, att, amask, h0, w0, wa0, toep, st,
                      hand, v, wss, wsg, dxm, dgm, prior=prior,
                      n_filters=0 if content else 1)
        return call

    before, sums = dt.launches.count, osum.launches.count
    got, ggot = _grads(scan(dt.decoder_scan_train), leaves, cots)
    assert dt.launches.count == before + 2   # forward, backward
    # outer_sum's two kernels: the weight gradients, then datt in calls of
    # up to MAX_JOBS batch rows
    assert osum.launches.count == sums + 2 * (1 + -(-B // osum.MAX_JOBS))
    _, again = _grads(scan(dt.decoder_scan_train), leaves, cots)
    assert all(torch.equal(g, h) for g, h in zip(ggot, again))  # bit for bit
    ref, gref = _grads(scan(dt.decoder_scan_train_reference), leaves, cots)
    for g, r in zip(list(got) + list(ggot), list(ref) + list(gref)):
        torch.testing.assert_close(
            g, r, rtol=1e-4, atol=1e-4 * max(float(r.detach().abs().max()),
                                             1e-6))


@pytest.mark.parametrize("prior", [EXPANDING, MEDIAN])
@pytest.mark.parametrize("T,B,L,M,D,S", [(6, 3, 10, 7, 9, 5),
                                         (20, 8, 60, 250, 500, 250)])
def test_decoder_scan_train_kernels_match_plain(device, prior, T, B, L, M,
                                                D, S):
    _check_decoder_scan_train(device, prior, T, B, L, M, D, S)


@pytest.mark.parametrize("B", [1, 32, 132])
def test_decoder_scan_train_flagship_widths(device, B):
    """The flagship decoder's widths (L=200, M=250, D=500, S=250, 201
    taps) from one row to 132: every batch size runs on the kernels."""
    _check_decoder_scan_train(device, MEDIAN, 6, B, 200, 250, 500, 250,
                              taps=201)


@pytest.mark.parametrize("prior", [EXPANDING, MEDIAN])
def test_decoder_scan_train_odd_shape(device, prior):
    """Odd widths and a frame count no cluster size divides."""
    _check_decoder_scan_train(device, prior, 8, 5, 199, 33, 17, 33)


CONTENT_PRIOR = {"type": "expanding", "initial_begin": 0, "initial_end": 1e4,
                 "min_speed": 0, "max_speed": 0}


@pytest.mark.parametrize("T,B,L,M,D,S", [(6, 3, 10, 7, 9, 5),
                                         (20, 8, 60, 250, 500, 250),
                                         (8, 5, 199, 33, 17, 33),
                                         (5, 16, 175, 250, 500, 250)])
def test_decoder_scan_train_content_branch_matches_plain(device, T, B, L, M,
                                                         D, S):
    """The content branch (``n_filters=0``, the full-window prior) at
    small, odd, flagship and TIMIT-recipe widths."""
    _check_decoder_scan_train(device, CONTENT_PRIOR, T, B, L, M, D, S,
                              content=True)


def test_decoder_scan_train_plan_fills_the_card(device):
    """At B=32 and the flagship widths both kernels' plans spread over at
    least 120 blocks, one a streaming multiprocessor."""
    from attention_lvcsr_torch.ops import decoder_train as dt
    for kind in dt.KINDS:
        plan = dt.launch_plan(kind, 32, 200, 250, 500, 250, device)
        assert plan["blocks"] >= 120, (kind, plan)


def test_decoder_scan_train_kernel_refuses_other_variants(device):
    from attention_lvcsr_torch.ops import decoder_train as dt
    z = lambda *s: torch.zeros(*s, device=device)
    args = (z(2, 1, 4), z(2, 1, 8), None, z(1, 5, 3), z(1, 5, 6), z(1, 5),
            z(1, 4), z(1, 5), z(1, 6), z(5, 5), z(4, 3), z(1, 3), z(3),
            z(4, 4), z(4, 8), z(6, 4), z(6, 8))
    with pytest.raises(NotImplementedError, match="relu"):
        dt.decoder_scan_train(*args, prior={"type": "expanding"},
                              normalizer="relu", n_filters=0)
    with pytest.raises(NotImplementedError, match="17 conv filters"):
        dt.decoder_scan_train(*args, prior={"type": "expanding"},
                              n_filters=17)


def _lstm_operands(rng, device, T, B, D, ndir, masked=True):
    f = lambda *s, scale=0.5: torch.tensor(
        rng.randn(*s).astype(np.float32) * scale, device=device)
    lengths = rng.randint(1, T + 1, size=B)
    lengths[0] = T
    mask = torch.tensor((np.arange(T)[:, None] < lengths[None])
                        .astype(np.float32), device=device) \
        if masked else None
    dirs = [(f(B, D, scale=0.3), f(B, D, scale=0.3),
             f(D, 4 * D, scale=D ** -0.5), f(D, scale=0.3), f(D, scale=0.3),
             f(D, scale=0.3)) for _ in range(ndir)]
    return f(T, B, 4 * D * ndir), mask, dirs


@pytest.mark.parametrize("T,B,D,ndir", [(13, 3, 8, 1), (40, 9, 250, 2),
                                        (17, 35, 280, 2), (9, 5, 33, 1)])
def test_lstm_scan_kernel_matches_plain(device, T, B, D, ndir):
    """One direction, or both in one launch (the backward in reverse
    time); states and cells within 1e-5."""
    from attention_lvcsr_torch.ops import lstm_scan as ls
    rng = np.random.RandomState(T + B + D + ndir)
    proj, mask, dirs = _lstm_operands(rng, device, T, B, D, ndir)
    before = ls.launches.count
    got = ls.lstm_scan(proj, mask, *dirs)
    assert ls.launches.count == before + 1
    ref = ls.lstm_scan_reference(proj, mask, *dirs)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("T,B,D,ndir,cells", [(13, 3, 8, 1, True),
                                              (40, 9, 250, 2, False),
                                              (17, 35, 250, 2, True),
                                              (9, 5, 33, 1, False)])
def test_lstm_scan_train_kernels_match_plain(device, T, B, D, ndir, cells):
    """Forward (lstm_scan.cu with residuals) and backward (lstm_train.cu,
    then outer_sum.cu) vs autograd through the plain scan, with a cells
    cotangent or without one (the encoder's case)."""
    _check_lstm_scan_train(device, T, B, D, ndir, cells)


@pytest.mark.parametrize("T,B,D,ndir,cluster,masked", [
    (9, 35, 250, 2, 16, True), (9, 35, 250, 2, 8, True),
    (5, 17, 384, 1, 16, True), (1, 17, 33, 2, 8, False),
    (4, 16, 256, 2, 8, True), (6, 33, 301, 1, 16, False)])
def test_lstm_scan_layout_edges(device, monkeypatch, T, B, D, ndir, cluster,
                                masked):
    """The forward kernel's padding (D not a multiple of the cluster's
    columns), its partial row group (B=17, 33, 35), the widest width of
    each cluster size (384 with 16 blocks, 256 with 8), with and without a
    mask, a row masked from the first step (it keeps h0 and c0), with the
    cluster size forced; the C layout equals the Python mirror, and a
    second call repeats bit for bit."""
    import ctypes
    from attention_lvcsr_torch import _build
    from attention_lvcsr_torch.ops import lstm_scan as ls
    lib = _build.load().lib
    lib.lstm_scan_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    assert lib.lstm_scan_smem_bytes(D, cluster) == \
        ls.fwd_layout(D, cluster)["smem_bytes"]
    monkeypatch.setattr(ls, "max_active_clusters", lambda D, device: {
        size: 16 if size == cluster else 0 for size in (16, 8)})
    rng = np.random.RandomState(T + B + D + cluster)
    proj, mask, dirs = _lstm_operands(rng, device, T, B, D, ndir, masked)
    if masked:
        mask[:, -1] = 0.0
    got = ls.lstm_scan(proj, mask, *dirs)
    again = ls.lstm_scan(proj, mask, *dirs)
    ref = ls.lstm_scan_reference(proj, mask, *dirs)
    for g, h, r in zip(got, again, ref):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)
        assert torch.equal(g, h)
    if masked:
        for out, k in zip(got, (0, 1)):       # states keep h0, cells c0
            assert torch.equal(out[:, -1], torch.cat(
                [d[k][-1] for d in dirs]).expand(T, D * ndir))


@pytest.mark.parametrize("T,B,D,ndir,cells,masked", [
    (1, 17, 33, 2, True, True), (6, 35, 250, 2, False, False),
    (3, 17, 352, 1, False, True), (5, 33, 275, 2, True, True),
    (11, 16, 301, 1, True, False)])
def test_lstm_train_backward_edges(device, T, B, D, ndir, cells, masked):
    """lstm_train.cu at its edges: B not a multiple of the cluster's 16
    rows, D not a multiple of its 16-block column split, the widest width
    (352), one step, one direction alone, no mask, no cells cotangent, and
    row 0 masked from the first step (its gradients pass straight
    through); the C layout equals the Python mirror."""
    import ctypes
    from attention_lvcsr_torch import _build
    from attention_lvcsr_torch.ops import lstm_train as lt
    lib = _build.load().lib
    lib.lstm_train_smem_bytes.argtypes = [ctypes.c_int]
    assert lib.lstm_train_smem_bytes(D) == lt.bwd_layout(D)["smem_bytes"]
    _check_lstm_scan_train(device, T, B, D, ndir, cells, masked,
                           first_masked=masked)


def _check_lstm_scan_train(device, T, B, D, ndir, cells, masked=True,
                           first_masked=False):
    from attention_lvcsr_torch.ops import lstm_train as lt
    rng = np.random.RandomState(T * B + D + ndir)
    proj, mask, dirs = _lstm_operands(rng, device, T, B, D, ndir, masked)
    if first_masked:
        mask[:, 0] = 0.0
    cots = [torch.tensor(rng.randn(T, B, D * ndir).astype(np.float32),
                         device=device) for _ in range(1 + cells)]
    leaves = [proj] + [w for d in dirs for w in d]

    def scan(fn):
        return lambda p, *w: fn(p, mask, tuple(w[:6]),
                                tuple(w[6:]) if ndir == 2 else None)

    before, sums = lt.launches.count, osum.launches.count
    got, ggot = _grads(scan(lt.lstm_scan_train), leaves, cots)
    assert lt.launches.count == before + 2      # forward, backward
    assert osum.launches.count == sums + 2      # outer_sum's two kernels
    _, again = _grads(scan(lt.lstm_scan_train), leaves, cots)
    assert all(torch.equal(g, h) for g, h in zip(ggot, again))  # bit for bit
    ref, gref = _grads(scan(lt.lstm_scan_train_reference), leaves, cots)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)
    for g, r in zip(ggot, gref):
        torch.testing.assert_close(g, r, atol=1e-4 * float(r.abs().max()),
                                   rtol=1e-4)


def test_lstm_scans_too_wide_raise(device):
    """D=385 does not fit the forward cluster's shared memory, D=353 the
    backward's: no launch, NotImplementedError naming the width and the
    widest one covered."""
    from attention_lvcsr_torch.ops import lstm_scan as ls
    from attention_lvcsr_torch.ops import lstm_train as lt
    rng = np.random.RandomState(0)
    proj, mask, dirs = _lstm_operands(rng, device, 3, 2, 385, 2)
    before = ls.launches.count
    with pytest.raises(NotImplementedError, match="D=385.*up to D=384"):
        ls.lstm_scan(proj, mask, *dirs)
    assert ls.launches.count == before
    proj, mask, dirs = _lstm_operands(rng, device, 3, 2, 353, 1)
    before = lt.launches.count
    with pytest.raises(NotImplementedError, match="D=353.*up to D=352"):
        lt.lstm_scan_train(proj, mask, *dirs)
    assert lt.launches.count == before


@pytest.mark.parametrize("sample_rate,B,use_energy,order", [
    (16000, 5, True, 2), (8000, 3, False, 2), (16000, 2, True, 1),
    (16000, 1, True, 0), (22050, 2, True, 2), (44100, 1, True, 2),
    (48000, 3, False, 1)])
def test_fbank_deltas_kernel_matches_plain(device, sample_rate, B,
                                           use_energy, order):
    """Ragged true frame counts (one of 3 frames); the log domain within
    1e-3 over every row (rows past a count are copies of its last); a
    second call repeats the first's bits."""
    from attention_lvcsr_torch.ops import frontend as fe
    rng = np.random.RandomState(sample_rate + B)
    N = int(sample_rate * 1.3) + 17
    t = np.arange(N) / sample_rate
    wav = torch.tensor((0.3 * np.sin(2 * np.pi * 440 * t)[None]
                        + 0.05 * rng.randn(B, N)).astype(np.float32),
                       device=device)
    T = 1 + (N - fe.frame_geometry(sample_rate)[0]) \
        // fe.frame_geometry(sample_rate)[1]
    counts = torch.tensor([T] + [3] * (B > 1) + list(
        rng.randint(1, T + 1, size=max(B - 2, 0))), device=device)
    kw = dict(sample_rate=sample_rate, use_energy=use_energy,
              deltas_order=order)
    before = fe.launches.count
    got = fe.fbank_deltas(wav, counts, **kw)
    assert fe.launches.count == before + 1
    ref = fe.fbank_deltas_plain(wav, counts, **kw)
    torch.testing.assert_close(got, ref, atol=1e-3, rtol=0)
    assert torch.equal(fe.fbank_deltas(wav, counts, **kw), got)


@pytest.mark.parametrize("sample_rate", [8000, 16000, 48000])
def test_fbank_deltas_of_silence_is_the_log_floor(device, sample_rate):
    """An all-zero waveform: every base feature is log(1e-10) exactly on
    both routes, and the two routes agree bit for bit."""
    from attention_lvcsr_torch.ops import frontend as fe
    wav = torch.zeros(2, sample_rate // 4, device=device)
    got = fe.fbank_deltas(wav, sample_rate=sample_rate)
    ref = fe.fbank_deltas_plain(wav, sample_rate=sample_rate)
    floor = torch.log(torch.tensor(1e-10, device=device))
    assert torch.equal(got[..., :41], floor.expand_as(got[..., :41]))
    assert torch.equal(ref[..., :41], floor.expand_as(ref[..., :41]))
    assert torch.equal(got, ref)


@pytest.mark.parametrize("sample_rate,order,match", [
    (96000, 2, "96000 Hz"), (16000, 16, "order 16")])
def test_fbank_deltas_beyond_the_kernel_raises(device, sample_rate, order,
                                               match):
    """A 96 kHz tile overflows a block's shared memory; order 16 makes the
    delta halo half a tile: NotImplementedError naming it, no launch."""
    from attention_lvcsr_torch.ops import frontend as fe
    wav = torch.zeros(1, sample_rate // 2, device=device)
    before = fe.launches.count
    with pytest.raises(NotImplementedError, match=match):
        fe.fbank_deltas(wav, sample_rate=sample_rate, deltas_order=order)
    assert fe.launches.count == before


@pytest.mark.parametrize("rows,shapes,gated", [
    (13, [(8, 24), (8, 16)], True), (25600 // 64, [(250, 1000)], False),
    (700, [(250, 250), (250, 500), (1, 750)], True)])
def test_outer_sum_kernel_matches_plain(device, rows, shapes, gated):
    """Both kernels of outer_sum.cu vs one matrix product per job, on
    column slices of wider tensors; a second call repeats bit for bit."""
    rng = np.random.RandomState(rows)
    f = lambda *s: torch.tensor(rng.randn(*s).astype(np.float32),
                                device=device)
    wide = f(rows, sum(J for _, J in shapes))
    jobs, col = [], 0
    for k, (I, J) in enumerate(shapes):
        a2 = f(rows, I) if gated and k == 0 else None
        jobs.append((f(rows, I), a2, wide[:, col:col + J], f(I, J)))
        col += J
    ref = [(a, a2, b, c.clone()) for a, a2, b, c in jobs]
    got = [(a, a2, b, c.clone()) for a, a2, b, c in jobs]
    again = [(a, a2, b, c.clone()) for a, a2, b, c in jobs]
    before = osum.launches.count
    osum.outer_sum(got, wide)
    assert osum.launches.count == before + 2
    osum.outer_sum(again, wide)
    osum.outer_sum_plain(ref)
    for (_, _, _, g), (_, _, _, h), (_, _, _, r) in zip(got, again, ref):
        assert torch.equal(g, h)
        torch.testing.assert_close(g, r, rtol=1e-5,
                                   atol=1e-5 * float(r.abs().max()))


@pytest.mark.parametrize("rows,shapes,offset,odd", [
    (1, [(17, 19)], 0, False),                          # one row
    (301, [(5, 7), (3, 130), (129, 9)], 1, True),        # 4-byte copies
    (700, [(250, 250), (250, 500)], 250, False),         # 8-byte copies
    (2000, [(252, 252), (252, 500)], 1000, False),       # 16-byte copies
    (97, [(3, 5), (130, 1), (1, 130), (64, 64), (9, 257), (256, 4), (2, 2),
          (31, 33)], 2, True)])                          # eight jobs
def test_outer_sum_kernel_edges(device, rows, shapes, offset, odd):
    """outer_sum.cu at its edges: b a column slice at ``offset`` floats
    into rows of an odd or even width (so its copies are 16, 8 or 4 bytes
    wide), a and a2 slices at odd offsets, I and J below the 128-wide tile
    and not multiples of 4, one row, rows not a multiple of the 16-row
    chunk, eight jobs in one call; a second call repeats bit for bit."""
    rng = np.random.RandomState(rows + len(shapes))
    f = lambda *s: torch.tensor(rng.randn(*s).astype(np.float32),
                                device=device)
    wide = f(rows, offset + sum(J for _, J in shapes) + odd)
    jobs, col = [], offset
    for k, (I, J) in enumerate(shapes):
        a = f(rows, I + 3)[:, 1:I + 1] if odd else f(rows, I)
        a2 = f(rows, I + 1)[:, :I] if k == 0 else None
        jobs.append((a, a2, wide[:, col:col + J], f(I, J)))
        col += J
    ref = [(a, a2, b, c.clone()) for a, a2, b, c in jobs]
    got = [(a, a2, b, c.clone()) for a, a2, b, c in jobs]
    again = [(a, a2, b, c.clone()) for a, a2, b, c in jobs]
    before = osum.launches.count
    osum.outer_sum(got, wide)
    assert osum.launches.count == before + 2
    osum.outer_sum(again, wide)
    osum.outer_sum_plain(ref)
    for (_, _, _, g), (_, _, _, h), (_, _, _, r) in zip(got, again, ref):
        assert torch.equal(g, h)
        torch.testing.assert_close(g, r, rtol=1e-5,
                                   atol=1e-5 * float(r.abs().max()))


def _plain_training_scans(monkeypatch):
    """The training forward's plain versions in place of the kernels."""
    from attention_lvcsr_torch.models import cells as cells_mod
    from attention_lvcsr_torch.models import generator as generator_mod
    from attention_lvcsr_torch.ops import decoder_train as dt
    from attention_lvcsr_torch.ops import gru_train as gt
    monkeypatch.setattr(cells_mod, "gru_scan_train",
                        gt.gru_scan_train_reference)
    monkeypatch.setattr(generator_mod, "decoder_scan_train",
                        dt.decoder_scan_train_reference)


@pytest.mark.parametrize("flagship,prior", [
    (False, "median"), (False, "expanding"), (True, "median")])
def test_analyze_one_utterance_matches_plain(device, monkeypatch, flagship,
                                             prior):
    """``analyze`` at B=1, as the search driver calls it: the training
    forward kernels (``gru_scan_train_bidir``, ``decoder_scan_train``)
    under ``torch.no_grad()`` against the plain route; costs within 1e-4
    relative, weights within 1e-5."""
    from attention_lvcsr_torch.ops import decoder_train as dt
    from attention_lvcsr_torch.ops import gru_train as gt
    if flagship:
        from __graft_entry__ import FLAGSHIP_NET
        config, init, T, TL = FLAGSHIP_NET, FLAGSHIP_INIT, 640, 61
    else:
        config, init, T, TL = NET_CONFIG, INIT, 29, 9
    if prior == "expanding":
        config = dict(config, prior={"type": "expanding", "initial_begin": 0,
                                     "initial_end": 6, "min_speed": 0.5,
                                     "max_speed": 2.0})
    rec = SpeechRecognizer(config, init_config=init, seed=11, device=device)
    rng = np.random.RandomState(T)
    F = config["input_dims"]["recordings"]
    x = rng.randn(1, T, F).astype(np.float32)
    y = rng.randint(0, config["num_phonemes"], size=(1, TL))
    ones = (np.ones((1, T)), np.ones((1, TL)))
    before = (gt.launches_bidir.count, dt.launches.count)
    got = rec.analyze(x, ones[0], y, ones[1])
    assert gt.launches_bidir.count - before[0] == len(config["dims_bidir"])
    assert dt.launches.count - before[1] == 1
    _plain_training_scans(monkeypatch)
    ref = rec.analyze(x, ones[0], y, ones[1])
    assert got["costs"].shape == (TL, 1) and np.isfinite(got["costs"]).all()
    np.testing.assert_allclose(got["costs"], ref["costs"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["weights"], ref["weights"], atol=1e-5)


class _Chars:
    """decode / pretty_print over NET_CONFIG's four characters and EOS."""

    def decode(self, labels):
        return ["abcd"[int(x)] for x in labels if int(x) != 4]

    def pretty_print(self, labels, example=None):
        return "".join(self.decode(labels))


def _report(text):
    """Per line: (label, value) with the value a float where it is one."""
    lines = []
    for line in text.splitlines():
        label, _, value = line.partition(":")
        try:
            value = float(value)
        except ValueError:
            value = value.strip()
        lines.append((label, value))
    return lines


def test_run_search_matches_plain(device, monkeypatch):
    """``run_search`` at ``decode_batch`` 4 over 10 utterances (the last
    chunk of 2): the encoder, loop and training forward kernels launch,
    and the report equals the plain route's line for line (costs within
    1e-4 relative, ``Decoding took`` apart), the totals too."""
    import io

    from attention_lvcsr_torch.models import cells as cells_mod
    from attention_lvcsr_torch.ops import decoder_train as dt
    from attention_lvcsr_torch.ops import gru_train as gt
    from attention_lvcsr_torch.search import beam as beam_mod
    from attention_lvcsr_torch.train.driver import run_search
    rec = SpeechRecognizer(NET_CONFIG, init_config=INIT, seed=7,
                           device=device)
    rec.net.generator.readout.post_merge_0.bias.data[4] += 1.5
    rng = np.random.RandomState(4)
    examples = [{"recordings": rng.randn(n, 6).astype(np.float32),
                 "labels": np.append(rng.randint(0, 4, size=n // 4), 4)}
                for n in rng.randint(16, 41, size=10)]
    conf = {"beam_size": 4, "decode_batch": 4, "char_discount": 2.0}

    def search():
        out = io.StringIO()
        stats = run_search(rec, [dict(ex) for ex in examples], _Chars(),
                           conf, print_to=out)
        return _report(out.getvalue()), stats

    before = (gs.launches.count, bl.launches.count,
              gt.launches_bidir.count, dt.launches.count)
    got, stats = search()
    moved = [c.count - b for c, b in zip(
        (gs.launches, bl.launches, gt.launches_bidir, dt.launches), before)]
    assert moved[1] == 3 and min(moved) >= 1, moved
    _plain_training_scans(monkeypatch)
    monkeypatch.setattr(cells_mod, "gru_scan", gs.gru_scan_reference)
    monkeypatch.setattr(beam_mod, "beam_search_loop",
                        bl.beam_search_loop_reference)
    ref, ref_stats = search()
    assert len(got) == len(ref)
    assert sum(1 for label, v in got if label == "Recognized" and v) >= 3
    for (label, a), (label_ref, b) in zip(got, ref):
        assert label == label_ref
        if isinstance(b, float) and label != "Decoding took":
            assert a == pytest.approx(b, rel=1e-4, abs=1e-5), label
        elif label != "Decoding took":
            assert a == b, label
    assert stats["num_examples"] == ref_stats["num_examples"] == 10
    assert stats["total_errors"] == ref_stats["total_errors"]
    assert stats["total_nll"] == pytest.approx(ref_stats["total_nll"],
                                               rel=1e-4)
