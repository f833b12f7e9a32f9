"""The model variants no recipe uses, in the port against the JAX package
(CPU, f32 both sides): the top MLP (``dims_top``), one-hot feedback
(``embed_outputs: false``), both together, the lookup bottom over integer
tokens, the LSTM decoder (one layer and a stack of two), the simple-RNN
decoder and the simple-RNN encoder.

The weights come from JAX's ``param_path_dict`` into the port's
``load_path_dict``, the inputs from a numpy seed.  Per variant:

* init from the same seed and ``init_config`` is bit-identical, parameter
  names included (the one-hot feedback has none), and a JAX-written
  checkpoint loads bit for bit;
* the inference encoder (after the top MLP) within 2e-5 / 2e-6 (rtol /
  atol, as ``test_torch_lstm_model.py``: two scans);
* the cost, weights, energies and every parameter gradient on both
  routes, ``use_pallas: interpret`` (JAX's Pallas kernels in interpret
  mode where its routes take them; the port's kernels' plain versions)
  and ``never``, within 2e-5 / 2e-6 (``test_torch_cost.py``'s);
* beam search on both routes: the same finished hypotheses (every one of
  every utterance, tokens identical) and steps, costs within 1e-5, as
  ``test_torch_lstm_model.py``.  Under ``interpret`` a one-hot or top-MLP
  model decodes on the loop kernel's plain version against JAX's
  ``beam_search_loop`` in interpret mode, and trains on
  ``decoder_scan_train``'s plain version against JAX's in interpret
  mode; the LSTM and simple-RNN decoders take both packages' module
  paths;
* the routes (``loop_route``, ``fused_score_supported``,
  ``train_kernel_route``) are JAX's and those of ``ROADMAP.md``'s table
  of the variants' routes.

Beside these: the LSTM decoder's samples against JAX's ``generate_step``
unrolled (argmax under the task loss, outputs identical, costs, weights
and readouts within 1e-5; categorical under the log-likelihood, each
sample's costs JAX's teacher-forced costs within 1e-5), its
dictionary-constrained decode through ``fused_decode_score``'s plain
version against JAX's score kernel in interpret mode, and three training
steps of each decoder cell against JAX's ``make_train_step`` (monitors and
parameters within 1e-5 / 1e-6, as ``test_torch_train_step.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_net_config
from attention_lvcsr_torch.models.params import load_path_dict
from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
from attention_lvcsr_torch.search.beam import DecodeConstraint, loop_route
from attention_lvcsr_torch.train.driver import make_train_step
from attention_lvcsr_torch.train.rules import build_optimizer
from attention_lvcsr_tpu.models.recognizer import \
    SpeechRecognizer as JaxRecognizer
from attention_lvcsr_tpu.models.recognizer import (param_path_dict,
                                                   params_from_path_dict)
from attention_lvcsr_tpu.search.beam import \
    DecodeConstraint as JaxDecodeConstraint
from attention_lvcsr_tpu.train import checkpoint as jax_checkpoint
from attention_lvcsr_tpu.train.driver import \
    make_train_step as jax_make_train_step
from attention_lvcsr_tpu.train.rules import \
    build_optimizer as jax_build_optimizer
from test_torch_readout_variants import _assert_routes_match
from test_torch_sample import jax_generate

INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.3],
                        "biases_init": ["isotropic_gaussian", 0.1],
                        "rec_weights_init": ["orthogonal"]},
        "/recognizer/generator": {"initial_states_init":
                                  ["isotropic_gaussian", 0.1]}}
COST_TOL = dict(rtol=2e-5, atol=2e-6)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
TOKENS = 9                  # the lookup bottom's alphabet
LOOKUP = dict(bottom={"bottom_class": "lookup", "dim": 10}, input_dims={},
              input_num_chars={"inputs": TOKENS})
VARIANTS = {
    "top": dict(dims_top=[20]),
    "onehot": dict(embed_outputs=False),
    "top_onehot": dict(dims_top=[20, 12], embed_outputs=False),
    "lookup": LOOKUP,
    "lstm_decoder": dict(dec_transition="LSTM"),
    "lstm_stack": dict(dec_transition="LSTM", dec_stack=2),
    "simple_decoder": dict(dec_transition="SimpleRecurrent"),
    "simple_encoder": dict(enc_transition="SimpleRecurrent"),
}
# (loop kernel, fused score step supported, training decoder kernel) of
# each variant on the card, as ROADMAP.md's table of the variants' routes
# gives them
ROUTES = {
    "top": (True, True, True), "onehot": (True, True, True),
    "top_onehot": (True, True, True), "lookup": (True, True, True),
    "lstm_decoder": (False, True, False), "lstm_stack": (False, False, False),
    "simple_decoder": (False, True, False),
    "simple_encoder": (True, True, True),
}


def _config(variant, **changes):
    return dict(_tiny_net_config(), max_decoded_length_scale=1.0,
                **VARIANTS[variant], **changes)


def _eos_raised(params, eos, by=3.0):
    """The readout's EOS logit raised, so that hypotheses finish."""
    params = dict(params)
    key = "/recognizer/generator/readout/post_merge_0/bias"
    if key not in params:
        key = "/recognizer/generator/readout/merge_bias"
    params[key] = params[key].copy()
    params[key][eos] += by
    return params


def _pair(variant, mode="interpret", seed=7, eos_raise=0.0, **changes):
    """The JAX recognizer and the port's with the JAX one's parameters,
    an LSTM's peepholes moved off their zero init so that they count."""
    cfg = _config(variant, use_pallas=mode, **changes)
    jax_rec = JaxRecognizer(cfg, init_config=INIT, seed=seed)
    params = param_path_dict(jax_rec.params)
    rng = np.random.RandomState(seed)
    for k in sorted(params):
        if "W_cell_to" in k:
            params[k] = (rng.randn(*params[k].shape) * 0.3).astype(np.float32)
    if eos_raise:
        params = _eos_raised(params, cfg["eos_label"], eos_raise)
    jax_rec.params = params_from_path_dict(params)
    port = SpeechRecognizer(cfg, device="cpu")
    load_path_dict(port.net, params)
    return jax_rec, port, params


def _batch(variant, seed=3, B=3, T=13, TL=5):
    rng = np.random.RandomState(seed)
    if variant == "lookup":
        x = rng.randint(0, TOKENS, size=(B, T)).astype(np.int32)
    else:
        x = rng.randn(B, T, 12).astype(np.float32)
    return (x,
            (np.arange(T)[None] < np.array([[T], [T - 4], [T - 1]])).astype(
                "f"),
            rng.randint(0, 31, size=(B, TL)).astype(np.int32),
            (np.arange(TL)[None] < np.array([[TL], [TL - 2], [3]])).astype(
                "f"))


def _torch(data):
    x, m, labels, lmask = (torch.from_numpy(a) for a in data)
    return x, m, labels.long(), lmask


@pytest.mark.parametrize("variant", VARIANTS)
def test_init_bit_identical_to_jax(variant):
    cfg = _config(variant)
    ref = param_path_dict(JaxRecognizer(cfg, init_config=INIT,
                                        seed=1234).params)
    got = SpeechRecognizer(cfg, init_config=INIT, seed=1234,
                           device="cpu").param_path_dict()
    assert sorted(got) == sorted(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    feedback = [k for k in got if "/feedback/" in k]
    assert feedback == ([] if "onehot" in variant
                        else ["/recognizer/generator/feedback/lookup/"
                              "embedding"])
    if "top" in variant:
        assert "/recognizer/top/top_out/kernel" in got
    if variant == "lookup":
        assert got["/recognizer/bottom/lookup/embedding"].shape == (
            TOKENS, 10)
    if variant.startswith("lstm"):
        assert "/recognizer/generator/transition_0/initial_cells" in got


@pytest.mark.parametrize("variant", VARIANTS)
def test_jax_checkpoint_loads(variant, tmp_path):
    cfg = _config(variant)
    jax_rec = JaxRecognizer(cfg, init_config=INIT, seed=3)
    params = param_path_dict(jax.tree.map(lambda a: a + 0.25,
                                          jax_rec.params))
    path = str(tmp_path / f"{variant}.zip")
    jax_checkpoint.save_checkpoint(path, params)
    port = SpeechRecognizer(cfg, init_config=INIT, seed=3, device="cpu")
    port.load_params(path)
    loaded = port.param_path_dict()
    assert sorted(loaded) == sorted(params)
    for key, value in params.items():
        np.testing.assert_array_equal(loaded[key], value, err_msg=key)


@pytest.mark.parametrize("variant", VARIANTS)
def test_encode_matches_jax(variant):
    jax_rec, port, _ = _pair(variant)
    x, m, _, _ = _batch(variant)
    net = jax_rec.net
    ref, ref_mask, _ = net.apply(jax_rec.params, jnp.asarray(x),
                                 jnp.asarray(m), method=net.encode,
                                 fast=True)
    with torch.no_grad():
        got, got_mask = port.net.encode(torch.from_numpy(x),
                                        torch.from_numpy(m))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **COST_TOL)


@pytest.mark.parametrize("mode", ["interpret", "never"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_cost_and_gradients_match_jax(variant, mode):
    jax_rec, port, _ = _pair(variant, mode)
    data = _batch(variant)
    net = jax_rec.net

    def cost(p):
        out = net.apply(p, *map(jnp.asarray, data), method=net.cost)
        return out["costs"].sum(), out

    (_, ref), grads = jax.value_and_grad(cost, has_aux=True)(jax_rec.params)
    ref_grads = param_path_dict(grads)
    port.net.requires_grad_(True)
    out = port.cost_fn()(*_torch(data))
    for key in ("costs", "weights", "energies", "encoded"):
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(ref[key]), err_msg=key,
                                   **COST_TOL)
    out["costs"].sum().backward()
    got = {k: p.grad for k, p in port.parameters().items()}
    assert set(got) == set(ref_grads)
    for key, g in got.items():
        np.testing.assert_allclose(g.numpy(), ref_grads[key], err_msg=key,
                                   **COST_TOL)
    # the training decoder takes the kernel exactly where JAX's does
    gen = jax_rec.net.bind(jax_rec.params).generator
    assert port.net.generator.train_kernel_route(mode) == (
        gen._fused_train_mode() is not None)


def _finished(out):
    return {(u, k): (tuple(int(t) for t in
                           out["done_out"][u, k, :out["done_len"][u, k]]),
                     float(out["done_cost"][u, k]))
            for u, k in zip(*np.nonzero(out["done_valid"]))}


def _assert_same_hypotheses(got, ref):
    assert int(got["steps"]) == int(ref["steps"])
    ref_f, got_f = _finished(ref), _finished(got)
    assert len(ref_f) >= 3, "vacuous: too few hypotheses finished"
    assert sorted(got_f) == sorted(ref_f)
    for key, (tokens, cost) in ref_f.items():
        assert got_f[key][0] == tokens, key
        np.testing.assert_allclose(got_f[key][1], cost, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["interpret", "never"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_beam_search_matches_jax(variant, mode):
    jax_rec, port, _ = _pair(variant, mode, eos_raise=3.0)
    jax_rec.init_beam_search(4)
    port.init_beam_search(4)
    x, m, _, _ = _batch(variant, seed=5, T=29)
    ref = jax_rec.beam_search(x, m, as_arrays=True, char_discount=0.1)
    got = port.beam_search(x, m, as_arrays=True, char_discount=0.1)
    _assert_same_hypotheses(got, ref)
    # the route taken is JAX's: the loop kernel (interpret mode) or not
    jax_loop = jax_rec._beam_search._loop_kernel_mode(x.shape[1]) \
        is not None
    assert loop_route(port.net_config, 4, x.shape[1]) == jax_loop
    assert jax_loop == (ROUTES[variant][0] and mode == "interpret")


@pytest.mark.parametrize("variant", VARIANTS)
def test_routes_match_jax(variant):
    """The port's loop route, fused score step and training route are
    JAX's choices and those of ``ROUTES``."""
    net = _config(variant, use_pallas="interpret")
    _assert_routes_match(net, dict(net))
    port = SpeechRecognizer(net, device="cpu")
    assert (loop_route(net, 10, 100),
            bool(port.net.generator.fused_score_supported()),
            port.net.generator.train_kernel_route("auto")) == ROUTES[variant]


def _words_constraint(cls, seed=0, n=12):
    from test_torch_constraint import CHAR_MAP
    rng = np.random.RandomState(seed)
    words = sorted({"".join(rng.choice(list("abcdefgh"),
                                       size=rng.randint(1, 4)))
                    for _ in range(n)})
    return cls.from_words(words, CHAR_MAP, 32)


@pytest.mark.parametrize("variant", ["lstm_decoder", "simple_decoder"])
def test_constrained_fused_decode_matches_jax(variant):
    """A dictionary-constrained decode with the fused score step (JAX's
    ``use_pallas: interpret``, the port's ``fused``): JAX's score kernel in
    interpret mode against ``fused_decode_score``'s plain version, the
    transition on the module step."""
    jax_rec, _, params = _pair(variant, "interpret", eos_raise=3.0)
    port = SpeechRecognizer(_config(variant, use_pallas="fused"),
                            device="cpu")
    load_path_dict(port.net, params)
    x, m, _, _ = _batch(variant, seed=4, T=41)
    with torch.inference_mode():
        ctx = port.net.decode_contexts(torch.from_numpy(x),
                                       torch.from_numpy(m))
    assert "fused_tables" in ctx
    jax_rec.init_beam_search(4)
    port.init_beam_search(4)
    ref = jax_rec.beam_search(
        x, m, as_arrays=True, char_discount=0.1,
        validate_solution_function=_words_constraint(JaxDecodeConstraint))
    got = port.beam_search(
        x, m, as_arrays=True, char_discount=0.1,
        validate_solution_function=_words_constraint(DecodeConstraint))
    _assert_same_hypotheses(got, ref)


@pytest.mark.parametrize("variant", ["lstm_decoder", "lstm_stack"])
def test_lstm_decoder_argmax_samples_match_jax(variant):
    """Under the task loss the emitter is argmax: the outputs are JAX's
    ``generate_step``'s, unrolled, and the costs, weights and readouts
    within 1e-5."""
    jax_rec, port, _ = _pair(variant, "never",
                             criterion={"name": "mse_gain"})
    x = _batch(variant, seed=6, T=19)[0]
    out = port.sample(x, n_steps=12)
    ref = jax_generate(jax_rec, x, 12, jax.random.PRNGKey(3))
    np.testing.assert_array_equal(out["outputs"], ref["outputs"])
    for key in ("costs", "weights", "readouts"):
        np.testing.assert_allclose(out[key], ref[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    assert len(np.unique(out["outputs"])) > 1, "vacuous: one symbol"


def test_lstm_decoder_samples_cost_as_jax_teacher_forced():
    """A categorical sample's per-step costs and weights are JAX's
    teacher-forced ``cost`` of the sampled outputs (1e-5)."""
    jax_rec, port, _ = _pair("lstm_decoder", "never")
    x, m, _, _ = _batch("lstm_decoder", seed=8, T=19)
    m = np.ones_like(m)
    out = port.sample(x, m, n_steps=10)
    labels = out["outputs"].T.astype(np.int32)
    ref = jax_rec.net.apply(jax_rec.params, jnp.asarray(x), jnp.asarray(m),
                            jnp.asarray(labels), jnp.ones(labels.shape),
                            method=jax_rec.net.cost)
    np.testing.assert_allclose(out["costs"], np.asarray(ref["costs"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out["weights"], np.asarray(ref["weights"]),
                               rtol=1e-5, atol=1e-5)
    assert len(np.unique(out["outputs"])) > 3, "vacuous: one symbol drawn"


@pytest.mark.parametrize("variant", ["top_onehot", "lookup", "lstm_decoder",
                                     "simple_encoder"])
def test_three_train_steps_match_jax(variant):
    config = {"training": {"rules": ["adadelta"], "decay_rate": 0.95,
                           "epsilon": 1e-6, "gradient_threshold": 1.0},
              "regularization": {"max_norm": 0.8}}
    jax_rec, port, _ = _pair(variant)
    config["net"] = jax_rec.net_config
    key = "inputs" if variant == "lookup" else "recordings"
    jparams = jax_rec.params
    jopt = jax_build_optimizer(config["training"], config["regularization"])
    jstep = jax.jit(jax_make_train_step(jax_rec, jopt, config,
                                        jax_rec.eos_label, key))
    jstate = jopt.init(jparams)
    opt = build_optimizer(config["training"], config["regularization"])
    step = make_train_step(port, opt, config)
    state = opt.init({k: p.detach() for k, p in port.parameters().items()})
    batch = _batch(variant, seed=4)
    for i in range(3):
        jparams, jstate, jmon = jstep(jparams, jstate, jax.random.PRNGKey(i),
                                      *map(jnp.asarray, batch))
        state, mon = step(state, *_torch(batch))
        for k, v in jmon.items():
            np.testing.assert_allclose(float(mon[k]), float(v),
                                       err_msg=f"step {i}: {k}", **STEP_TOL)
        ref = param_path_dict(jparams)
        for k, p in port.param_path_dict().items():
            np.testing.assert_allclose(p, ref[k], err_msg=f"step {i}: {k}",
                                       **STEP_TOL)
