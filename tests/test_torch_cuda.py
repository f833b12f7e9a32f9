"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: they skip without a CUDA device, and run there
with ``python -m pytest -m cuda tests/test_torch_cuda.py`` (no JAX
needed)."""
import numpy as np
import pytest
import torch

from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
from attention_lvcsr_torch.ops import beam_loop as bl
from attention_lvcsr_torch.ops import gru_scan as gs

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
