"""The whole serving slice: the port's ``SpeechRecognizer.beam_search``
decodes the same hypotheses as the JAX package's, through both of its
routes (the XLA decode, ``use_pallas="never"``, and the Pallas kernels in
interpret mode), on a padded batch; plus the port's numpy error rate."""
import numpy as np
import pytest

from __graft_entry__ import _tiny_net_config
from attention_lvcsr_tpu.models.recognizer import \
    SpeechRecognizer as JaxRecognizer
from attention_lvcsr_tpu.ops import error_rate as jax_error_rate
from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
from attention_lvcsr_torch.ops import error_rate
from attention_lvcsr_torch.search.beam import CandidateNotFoundError

INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.5],
                        "biases_init": ["constant", 0.0],
                        "rec_weights_init": ["orthogonal"]}}
_CACHE = {}


def _recognizers(mode, bidir=True):
    if (mode, bidir) not in _CACHE:
        cfg = dict(_tiny_net_config(), bidir=bidir)
        eos = cfg["eos_label"]
        jax_rec = JaxRecognizer(dict(cfg, use_pallas=mode), init_config=INIT,
                                seed=7)
        p = jax_rec.params["params"]["generator"]["readout"]["post_merge_0"]
        p["bias"] = p["bias"].at[eos].add(3.0)
        port = SpeechRecognizer(cfg, init_config=INIT, seed=7)
        port.net.generator.readout.post_merge_0.bias.data[eos] += 3.0
        _CACHE[mode, bidir] = (jax_rec, port)
    return _CACHE[mode, bidir]


def _batch():
    rng = np.random.RandomState(3)
    x = rng.randn(3, 37, 12).astype(np.float32)
    m = (np.arange(37)[None] < np.array([[37], [30], [21]])).astype("f")
    return x, m


def _finished(out):
    """{(utterance, slot): (tokens, cost)} over the valid done entries."""
    return {(u, k): (tuple(out["done_out"][u, k, :out["done_len"][u, k]]),
                     float(out["done_cost"][u, k]))
            for u, k in zip(*np.nonzero(out["done_valid"]))}


@pytest.mark.parametrize("mode", ["never", "interpret"])
@pytest.mark.parametrize("search", [
    dict(char_discount=0.1),
    dict(char_discount=0.5, stop_on="optimistic_future_cost"),
    dict(char_discount=0.1, round_to_inf=2.0),
], ids=["patience", "optimistic", "round-to-inf"])
def test_beam_search_matches_jax(mode, search):
    jax_rec, port = _recognizers(mode)
    jax_rec.init_beam_search(4)
    port.init_beam_search(4)
    x, m = _batch()
    ref = _finished(jax_rec.beam_search(x, m, as_arrays=True, **search))
    got = _finished(port.beam_search(x, m, as_arrays=True, **search))
    assert ref, "vacuous: nothing finished"
    assert sorted(got) == sorted(ref)
    for key, (tokens, cost) in ref.items():
        assert got[key][0] == tokens, key
        np.testing.assert_allclose(got[key][1], cost, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["never", "interpret"])
def test_unidirectional_beam_search_matches_jax(mode):
    """``bidir: false``: the encoder's layers run one direction."""
    jax_rec, port = _recognizers(mode, bidir=False)
    jax_rec.init_beam_search(4)
    port.init_beam_search(4)
    x, m = _batch()
    ref = _finished(jax_rec.beam_search(x, m, as_arrays=True,
                                        char_discount=0.1))
    got = _finished(port.beam_search(x, m, as_arrays=True,
                                     char_discount=0.1))
    assert ref, "vacuous: nothing finished"
    assert sorted(got) == sorted(ref)
    for key, (tokens, cost) in ref.items():
        assert got[key][0] == tokens, key
        np.testing.assert_allclose(got[key][1], cost, rtol=1e-5, atol=1e-5)


def test_single_utterance_api_matches_jax():
    jax_rec, port = _recognizers("interpret")
    jax_rec.init_beam_search(4)
    port.init_beam_search(4)
    x, _ = _batch()
    outputs, costs = port.beam_search(x[0], char_discount=0.1)
    ref_outputs, ref_costs = jax_rec.beam_search(x[0], char_discount=0.1)
    assert [list(map(int, o)) for o in outputs] == \
        [list(map(int, o)) for o in ref_outputs]
    np.testing.assert_allclose(costs, ref_costs, rtol=1e-5, atol=1e-5)


def test_no_candidate_raises():
    _, port = _recognizers("interpret")
    port.init_beam_search(2)
    x, _ = _batch()
    with pytest.raises(CandidateNotFoundError):
        # one decode step, never the EOS at the first position it may take
        port.beam_search(x[0, :1], char_discount=0.0)


@pytest.mark.parametrize("y,y_hat", [
    ("abcde", "abXde"), ("kitten", "sitting"), ("", "abc"), ("abc", ""),
    ([1, 2, 3, 4], [2, 3, 4, 5, 6]), ("aaaa", "aa")])
def test_error_rate_matches_jax(y, y_hat):
    assert error_rate.edit_distance(y, y_hat) == \
        jax_error_rate.edit_distance(y, y_hat)
    if len(y):
        assert error_rate.wer(y, y_hat) == jax_error_rate.wer(y, y_hat)
