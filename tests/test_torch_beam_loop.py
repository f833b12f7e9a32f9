"""Whole-loop decode of the port vs the JAX package's TPU kernel.

The same weights give the same decode tables, and on the same
encoder outputs and tables the port's plain ``beam_search_loop`` matches
the JAX ``beam_search_loop`` run in interpret mode: identical done-set
tokens, lengths and step counts, costs to float tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_lvcsr_tpu.models.recognizer import \
    SpeechRecognizer as JaxRecognizer
from attention_lvcsr_tpu.models.recognizer import param_path_dict
from attention_lvcsr_tpu.ops.pallas.beam_loop import \
    beam_search_loop as jax_beam_search_loop
from attention_lvcsr_torch.models.params import load_path_dict
from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
from attention_lvcsr_torch.ops.beam_loop import beam_search_loop
from attention_lvcsr_torch.ops.expressions import conv1d_full

EOS = 4
NET_CONFIG = dict(
    input_dims={"recordings": 6}, input_num_chars={}, eos_label=EOS,
    num_phonemes=5, dim_dec=8, dims_bidir=[7], enc_transition="gru",
    dec_transition="gru", attention_type="content_and_conv", conv_n=2,
    use_states_for_readout=False, criterion={"name": "log_likelihood"},
    bottom={"bottom_class": "speech"}, subsample=[1],
    post_merge_dims=[10], max_decoded_length_scale=1.0,
    data_prepend_eos=False)
INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.5],
                        "biases_init": ["constant", 0.0],
                        "rec_weights_init": ["orthogonal"]}}
EXPANDING = {"type": "expanding", "initial_begin": 0, "initial_end": 6,
             "min_speed": 1.0, "max_speed": 2.0}
MEDIAN = {"type": "window_around_median", "before": 3, "after": 3}
_CACHE = {}


def _pair(prior=None, states_readout=False):
    """(JAX recognizer, port recognizer) with identical weights; the EOS
    logit is raised so hypotheses finish."""
    key = (repr(prior), states_readout)
    if key not in _CACHE:
        cfg = dict(NET_CONFIG, prior=prior,
                   use_states_for_readout=states_readout)
        jax_rec = JaxRecognizer(dict(cfg, use_pallas="interpret"),
                                init_config=INIT, seed=7)
        p = jax_rec.params["params"]["generator"]["readout"]["post_merge_0"]
        p["bias"] = p["bias"].at[EOS].add(1.5)
        port = SpeechRecognizer(cfg, init_config=INIT, seed=7,
                                device="cpu")
        load_path_dict(port.net, param_path_dict(jax_rec.params))
        _CACHE[key] = (jax_rec, port)
    return _CACHE[key]


def _batch():
    rng = np.random.RandomState(3)
    x = rng.randn(3, 16, 6).astype(np.float32)
    m = (np.arange(16)[None] < np.array([[16], [12], [0]])).astype("f")
    return x, m


@pytest.mark.parametrize("states_readout", [False, True])
def test_decode_tables_match_jax(states_readout):
    jax_rec, port = _pair(MEDIAN, states_readout)
    L = 16
    jt = jax_rec.net.apply(jax_rec.params, L, jnp.float32,
                           method=jax_rec.net.decode_loop_tables)
    pt = port.net.decode_loop_tables()
    assert set(pt) - set(jt) == {"conv_filters"}
    for key, value in pt.items():
        if key != "conv_filters":
            np.testing.assert_allclose(value.numpy(), np.asarray(jt[key]),
                                       atol=1e-6, rtol=0, err_msg=key)
    # the taps convolve exactly as the TPU kernel's Toeplitz band does:
    # a true convolution, not PyTorch's cross-correlation
    w = np.random.RandomState(0).rand(5, L).astype(np.float32)
    n = (pt["conv_filters"].shape[-1] - 1) // 2
    conv = conv1d_full(torch.from_numpy(w), pt["conv_filters"])[:, 0, n:n + L]
    np.testing.assert_allclose(conv.numpy(), w @ np.asarray(jt["toeplitz"]),
                               atol=1e-6)


CASES = {
    "patience-median": dict(prior=MEDIAN, kw=dict(char_discount=0.1)),
    "patience-expanding": dict(prior=EXPANDING,
                               kw=dict(char_discount=0.1)),
    "default-prior": dict(prior=None, kw=dict(char_discount=0.1)),
    "optimistic": dict(prior=MEDIAN, kw=dict(
        char_discount=0.5, stop_on="optimistic_future_cost")),
    "round-to-inf": dict(prior=MEDIAN, kw=dict(char_discount=0.1,
                                               round_to_inf=2.0)),
    "ignore-first-eol": dict(prior=MEDIAN, kw=dict(
        char_discount=0.1, ignore_first_eol=True)),
    "states-readout": dict(prior=MEDIAN, states_readout=True,
                           kw=dict(char_discount=0.1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_beam_loop_matches_jax_interpret(case):
    spec = CASES[case]
    jax_rec, port = _pair(spec["prior"], spec.get("states_readout", False))
    x, m = _batch()
    data = jax_rec.net.apply(jax_rec.params, x, m,
                             method=jax_rec.net.decode_loop)
    L = data["attended"].shape[1]
    tables = jax_rec.net.apply(jax_rec.params, L, jnp.float32,
                               method=jax_rec.net.decode_loop_tables)
    prior = dict(spec["prior"] or {})
    kw = dict(beam=3, max_len=12, eol=EOS,
              prior=prior.get("type", "expanding"),
              before=float(prior.get("before", 0.0)),
              after=float(prior.get("after", 0.0)),
              initial_begin=float(prior.get("initial_begin", 0.0)),
              initial_end=float(prior.get("initial_end", 1e4)),
              min_speed=float(prior.get("min_speed", 0.0)),
              max_speed=float(prior.get("max_speed", 0.0)), **spec["kw"])
    ref_out, ref_meta, ref_steps = (np.asarray(a) for a in
                                    jax_beam_search_loop(
        data["pre"], data["attended"], data["attended_mask"], tables,
        states_readout=spec.get("states_readout", False),
        interpret=True, **kw))
    t = lambda a: torch.from_numpy(np.array(a))
    with torch.no_grad():
        out, meta, steps = beam_search_loop(
            t(data["pre"]), t(data["attended"]), t(data["attended_mask"]),
            port.net.decode_loop_tables(), **kw)
    valid = ref_meta[:, :, 1] < 1e9 / 2
    assert valid.any(), "vacuous: nothing finished"
    assert not valid[2].any(), "the fully padded utterance must not decode"
    np.testing.assert_array_equal(out.numpy(), ref_out)
    np.testing.assert_array_equal(meta.numpy()[:, :, 2], ref_meta[:, :, 2])
    np.testing.assert_array_equal(steps.numpy(), ref_steps)
    np.testing.assert_allclose(meta.numpy()[:, :, :2], ref_meta[:, :, :2],
                               rtol=1e-5, atol=1e-5)
