"""The decode and the training cost of the WSJ recipes' readout and
attention variants in the port vs the JAX package (CPU, f32 both sides).

* the plain whole-loop decode ``beam_search_loop`` against JAX's
  ``beam_search_loop`` in interpret mode, on the same weights and tables,
  for the variants of ``tests/test_beam_loop.py::test_variant_kernel_
  parity`` this port covers (states readout, maxout, the combined one,
  rectifier and sigmoid post-merge, three filters, the mean-maxout shape)
  and the identity post-merge and mean prior: identical done-set tokens,
  lengths and steps, costs within 1e-5;
* ``RecognizerNet.cost`` and every parameter's gradient of a 10-filter,
  maxout, mean-prior net with the states readout against JAX's, on the
  port's ``decoder_scan_train`` route (its plain version; the plain scan
  against JAX's kernel in interpret mode is ``tests/test_torch_decoder_
  train.py``'s) and on its module route (``use_pallas: never``);
* ``beam_search`` of a readout without post-merge layers (``wsj_good``'s
  shape), which takes the module route in both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_lvcsr_tpu.models.recognizer import RecognizerNet as JaxNet
from attention_lvcsr_tpu.models.recognizer import \
    SpeechRecognizer as JaxRecognizer
from attention_lvcsr_tpu.models.recognizer import param_path_dict
from attention_lvcsr_tpu.ops.pallas.beam_loop import \
    beam_search_loop as jax_beam_search_loop
from attention_lvcsr_torch.models import generator as generator_mod
from attention_lvcsr_torch.models.params import load_path_dict
from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
from attention_lvcsr_torch.ops.beam_loop import (
    beam_search_loop, beam_search_loop_reference)
from attention_lvcsr_torch.ops.expressions import maxout_pieces
from attention_lvcsr_torch.search import beam as beam_mod

EOS = 4
NET = dict(
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
MEDIAN = {"type": "window_around_median", "before": 3, "after": 3}
MEAN = {"type": "window_around_mean", "before": 3, "after": 3}
# the cost graph and its gradients (tests/test_torch_cost.py's tolerances)
COST_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-5, atol=2e-6)

VARIANTS = {
    "states-readout": {"use_states_for_readout": True},
    "maxout": {"post_merge_activation": "maxout:2"},
    "combined": {"use_states_for_readout": True,
                 "post_merge_activation": "maxout:2",
                 "energy_normalizer": "logistic"},
    "post-rectifier": {"post_merge_activation": "rectifier"},
    "post-sigmoid": {"post_merge_activation": "sigmoid"},
    "post-identity": {"post_merge_activation": "identity"},
    "conv3": {"conv_num_filters": 3},
    "mean-maxout-shape": {"conv_num_filters": 10,
                          "post_merge_activation": "maxout:2",
                          "use_states_for_readout": True, "prior": MEAN},
    "mean-prior": {"prior": MEAN},
}


def _pair(overrides, use_pallas="interpret", seed=7):
    """(JAX recognizer, port recognizer) with identical weights; the EOS
    logit is raised so hypotheses finish."""
    cfg = dict(dict(NET, prior=MEDIAN, use_pallas=use_pallas), **overrides)
    jrec = JaxRecognizer(cfg, init_config=INIT, seed=seed)
    readout = jrec.params["params"]["generator"]["readout"]
    last = readout.get("post_merge_0", readout)
    key = "bias" if "bias" in last else "merge_bias"
    last[key] = last[key].at[EOS].add(1.5)
    rec = SpeechRecognizer(cfg, init_config=INIT, seed=seed, device="cpu")
    load_path_dict(rec.net, param_path_dict(jrec.params))
    return jrec, rec


def _batch(U=3, T=16):
    rng = np.random.RandomState(3)
    x = rng.randn(U, T, 6).astype(np.float32)
    m = (np.arange(T)[None] < np.array([[T], [T - 4], [0]])).astype("f")
    return x[:U], m[:U]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_beam_loop_variant_matches_jax_interpret(variant):
    overrides = VARIANTS[variant]
    jrec, rec = _pair(overrides)
    net = rec.net_config
    x, m = _batch()
    data = jrec.net.apply(jrec.params, x, m, method=jrec.net.decode_loop)
    L = data["attended"].shape[1]
    tables = jrec.net.apply(jrec.params, L, jnp.float32,
                            method=jrec.net.decode_loop_tables)
    prior = dict(net["prior"])
    act = net.get("post_merge_activation", "tanh")
    normalizer = net.get("energy_normalizer", "softmax")
    kw = dict(beam=3, max_len=12, eol=EOS, prior=prior["type"],
              before=float(prior["before"]), after=float(prior["after"]),
              char_discount=0.1, normalizer=normalizer)
    ref_out, ref_meta, ref_steps = (np.asarray(a) for a in
                                    jax_beam_search_loop(
        data["pre"], data["attended"], data["attended_mask"], tables,
        states_readout=bool(net["use_states_for_readout"]),
        maxout=maxout_pieces(act), post_act=act, interpret=True, **kw))
    assert beam_mod.loop_route(net, 3, x.shape[1])
    t = lambda a: torch.from_numpy(np.array(a))
    with torch.no_grad():
        out, meta, steps = beam_search_loop(
            t(data["pre"]), t(data["attended"]), t(data["attended_mask"]),
            rec.net.decode_loop_tables(), post_act=act, **kw)
    valid = ref_meta[:, :, 1] < 1e9 / 2
    assert valid[:2].sum() >= 3, "vacuous: most hypotheses empty"
    assert not valid[2].any(), "the fully padded utterance must not decode"
    np.testing.assert_array_equal(out.numpy(), ref_out)
    np.testing.assert_array_equal(meta.numpy()[:, :, 2], ref_meta[:, :, 2])
    np.testing.assert_array_equal(steps.numpy(), ref_steps)
    np.testing.assert_allclose(meta.numpy()[:, :, :2], ref_meta[:, :, :2],
                               rtol=1e-5, atol=1e-5)


EXPANDING = {"type": "expanding", "initial_begin": 1, "initial_end": 4,
             "min_speed": 0.5, "max_speed": 1.5}


@pytest.mark.parametrize("prior", [EXPANDING, MEDIAN, MEAN],
                         ids=["expanding", "median", "mean"])
def test_plain_loop_reports_its_windows(prior):
    """``window_widths`` collects each step's (U,) window widths (what a
    decode's bound counts) and changes nothing of the decode: the
    expanding window's widths follow from the step alone, the median's
    and the mean's lie in [1, L] and narrow the decode's first steps."""
    _, rec = _pair({"prior": prior, "conv_num_filters": 3})
    x, m = _batch()
    with torch.no_grad():
        data = rec.net.decode_loop(torch.from_numpy(x), torch.from_numpy(m))
        tables = rec.net.decode_loop_tables()
    args = (data["pre"], data["attended"], data["attended_mask"], tables)
    config = rec.net.generator.attention.prior_config()
    kw = dict(beam=3, max_len=12, eol=EOS, char_discount=0.1,
              prior=config["type"],
              **{k: float(v) for k, v in config.items() if k != "type"})
    widths = []
    with torch.no_grad():
        got = beam_search_loop_reference(*args, **kw, window_widths=widths)
        plain = beam_search_loop_reference(*args, **kw)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    L = data["pre"].shape[1]
    W = torch.stack(widths).numpy()                       # (steps, U)
    assert W.shape == (int(got[2].max()), 3)
    if prior is EXPANDING:
        want = [min(L, int(np.ceil(4 + 1.5 * i))) - int(np.floor(0.5 * i) + 1)
                for i in range(len(W))]
        np.testing.assert_array_equal(W, np.repeat(
            np.array(want, dtype=np.float32)[:, None], 3, axis=1))
    else:
        live = W[:, :2]              # the fully padded utterance aside
        assert (live >= 1).all() and (live <= L).all()
        assert (live[0] < L).all(), "the first window spans every frame"


def _data(seed=1, U=3, T=12, TL=5):
    rng = np.random.RandomState(seed)
    inputs = rng.randn(U, T, 6).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([[T], [T - 3], [T]])).astype("f")
    labels = rng.randint(0, 5, size=(U, TL)).astype(np.int32)
    lmask = (np.arange(TL)[None] < np.array([[TL], [TL - 2], [3]])).astype(
        "f")
    return inputs, mask, labels, lmask


_REFERENCE = {}


def _reference(cfg, jdata):
    """JAX's parameters, cost dict and gradients of the cost graph (its
    XLA scan), computed once for both of the port's routes."""
    if not _REFERENCE:
        net = JaxNet(**dict(cfg, use_pallas="never"))
        params = net.init(jax.random.PRNGKey(0), *jdata, method=net.cost)

        def cost(p):
            out = net.apply(p, *jdata, method=net.cost)
            return out["costs"].sum(), out

        (_, ref), grads = jax.value_and_grad(cost, has_aux=True)(params)
        _REFERENCE.update(params=params, ref=ref,
                          grads=param_path_dict(grads))
    return _REFERENCE["params"], _REFERENCE["ref"], _REFERENCE["grads"]


@pytest.mark.parametrize("use_pallas", ["interpret", "never"])
def test_cost_and_gradients_of_the_mean_maxout_net_match_jax(use_pallas,
                                                            monkeypatch):
    """``net.cost`` (costs, weights, energies) and every parameter's
    gradient, the taps (10, 5) and the handler (10, M) included, against
    JAX's cost graph; the port's ``interpret`` route takes
    ``decoder_scan_train`` with ``n_filters=10`` and the (L, 10 L) bands,
    its ``never`` route the module scan."""
    data = _data()
    jdata = [jnp.asarray(a) for a in data]
    cfg = dict(NET, **VARIANTS["mean-maxout-shape"])
    params, ref, ref_grads = _reference(cfg, jdata)
    calls = []
    real = generator_mod.decoder_scan_train
    monkeypatch.setattr(generator_mod, "decoder_scan_train",
                        lambda *a, **k: calls.append((a, k)) or real(*a, **k))
    rec = SpeechRecognizer(dict(cfg, use_pallas=use_pallas), device="cpu")
    load_path_dict(rec.net, param_path_dict(params))
    rec.net.requires_grad_(True)
    inputs, mask, labels, lmask = (torch.from_numpy(a) for a in data)
    out = rec.cost_fn()(inputs, mask, labels.long(), lmask)
    if use_pallas == "never":
        assert not calls
    else:
        ((args, kw),) = calls
        L = out["weights"].shape[2]
        assert kw["n_filters"] == 10
        assert tuple(args[9].shape) == (L, 10 * L)
    for key in ("costs", "weights", "energies"):
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(ref[key]), err_msg=key,
                                   **COST_TOL)
    out["costs"].sum().backward()
    grads = {k: p.grad for k, p in rec.parameters().items()}
    assert set(grads) == set(ref_grads)
    assert tuple(grads["/recognizer/generator/attention/conv_filters"]
                 .shape) == (10, 5)
    for key, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref_grads[key], err_msg=key,
                                   **GRAD_TOL)


@pytest.mark.parametrize("dims", [None, [10, 6]], ids=["none", "two"])
def test_beam_search_without_one_post_merge_layer_matches_jax(dims,
                                                              monkeypatch):
    """A readout with no post-merge layer (``wsj_good``) or two decodes on
    the module route in both packages (never the loop kernel) and finds
    JAX's hypotheses and costs."""
    jrec, rec = _pair({"post_merge_dims": dims,
                       "post_merge_activation": "rectifier",
                       "use_states_for_readout": True}, use_pallas="auto")
    monkeypatch.setattr(beam_mod.BeamSearch, "_search_loop", None)
    x, _ = _batch(U=1, T=14)
    jrec.init_beam_search(3)
    rec.init_beam_search(3)
    assert jrec._beam_search._loop_kernel_mode() is None
    ref = jrec.beam_search(x[0], as_arrays=True, char_discount=0.1)
    out = rec.beam_search(x[0], as_arrays=True, char_discount=0.1)
    valid = ref["done_valid"][0]
    assert valid.sum() >= 2, "vacuous: nothing finished"
    np.testing.assert_array_equal(out["done_valid"][0], valid)
    for k in np.nonzero(valid)[0]:
        n = ref["done_len"][0, k]
        assert out["done_len"][0, k] == n
        np.testing.assert_array_equal(out["done_out"][0, k, :n],
                                      ref["done_out"][0, k, :n])
    np.testing.assert_allclose(out["done_cost"][0][valid],
                               ref["done_cost"][0][valid], rtol=1e-5)
