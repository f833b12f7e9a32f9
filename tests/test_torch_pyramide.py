"""The pyramid-shaped encoder of ``exp/wsj/configs/wsj_pyramide.yaml`` in
the port vs the JAX package (CPU, f32 both sides), and the recipe's routes
at its own widths.

At small widths, a net of the recipe's shape (BiGRU widths growing over
three layers, ``subsample [1, 2, 2]``, a relu post-merge layer wider than
the decoder, either prior), with JAX's parameters loaded through the
path-keyed loader (``models/params.py::load_path_dict``):

* ``RecognizerNet.cost`` and every parameter's gradient against JAX's,
  under ``use_pallas`` "interpret" (the port's ``decoder_scan_train`` and
  ``gru_scan_train``, their plain versions on the CPU) and "never";
* each encoder layer's own width and frame count reach the GRU scans
  (the strides apply to a layer's output, as in JAX: 24, 24 and 12
  frames into the three layers, 6 out);
* beam-search hypotheses identical to JAX's, on the module route the
  recipe's decodes take and on the loop route.

At the recipe's widths, with no model built: every stage passes
``unported_piece`` and ``unported_training``; the GRU widths route to the
resident and wide instances; an 800-frame decode takes the module route
(``loop_route``: the loop kernel's block would need 282,880 bytes); the
training decoder's launch plans fit at B=10 and 32."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_lvcsr_tpu.models.recognizer import RecognizerNet as JaxNet
from attention_lvcsr_tpu.models.recognizer import \
    SpeechRecognizer as JaxRecognizer
from attention_lvcsr_tpu.models.recognizer import param_path_dict
from attention_lvcsr_torch.config import Configuration
from attention_lvcsr_torch.models import cells as cells_mod
from attention_lvcsr_torch.models import generator as generator_mod
from attention_lvcsr_torch.models.params import load_path_dict
from attention_lvcsr_torch.models.recognizer import (RecognizerNet,
                                                     SpeechRecognizer,
                                                     unported_piece)
from attention_lvcsr_torch.ops import decoder_train as dt
from attention_lvcsr_torch.ops import gru_scan as gs
from attention_lvcsr_torch.ops import gru_train as gt
from attention_lvcsr_torch.ops.beam_loop import smem_plan
from attention_lvcsr_torch.search.beam import loop_route
from attention_lvcsr_torch.train.driver import unported_training

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "exp", "wsj", "configs", "wsj_pyramide.yaml")
EOS = 4
PRIORS = {
    "expanding": {"type": "expanding", "initial_begin": 0, "initial_end": 4,
                  "min_speed": 1.2, "max_speed": 2.1},
    "median": {"type": "window_around_median", "before": 3, "after": 3},
}
NET = dict(
    input_dims={"recordings": 6}, input_num_chars={}, eos_label=EOS,
    num_phonemes=5, dim_dec=8, dim_matcher=8, dims_bidir=[6, 10, 14],
    subsample=[1, 2, 2], enc_transition="gru", dec_transition="gru",
    attention_type="content_and_conv", conv_n=2,
    use_states_for_readout=False, criterion={"name": "log_likelihood"},
    bottom={"bottom_class": "speech"}, post_merge_dims=[28],
    post_merge_activation="relu", max_decoded_length_scale=1.0,
    data_prepend_eos=False)
INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.5],
                        "biases_init": ["constant", 0.0],
                        "rec_weights_init": ["orthogonal"]}}
# f32 both sides through three scans and their gradients
TOL = dict(rtol=2e-5, atol=2e-6)
U, T, TL = 3, 24, 5


def _data(seed=1):
    rng = np.random.RandomState(seed)
    inputs = rng.randn(U, T, 6).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([[T], [T - 7], [T - 2]])).astype(
        "f")
    labels = rng.randint(0, 5, size=(U, TL)).astype(np.int32)
    lmask = (np.arange(TL)[None] < np.array([[TL], [TL - 2], [3]])).astype(
        "f")
    return inputs, mask, labels, lmask


_REFERENCE = {}


def _reference(prior, use_pallas):
    """JAX's parameters, cost dict and gradients, once per prior and
    route."""
    key = (prior, use_pallas)
    if key not in _REFERENCE:
        cfg = dict(NET, prior=PRIORS[prior])
        jdata = [jnp.asarray(a) for a in _data()]
        init = JaxNet(**dict(cfg, use_pallas="never"))
        params = init.init(jax.random.PRNGKey(0), *jdata, method=init.cost)
        net = JaxNet(**dict(cfg, use_pallas=use_pallas))

        def cost(p):
            out = net.apply(p, *jdata, method=net.cost)
            return out["costs"].sum(), out

        (_, ref), grads = jax.value_and_grad(cost, has_aux=True)(params)
        _REFERENCE[key] = (params, ref, param_path_dict(grads))
    return _REFERENCE[key]


@pytest.mark.parametrize("use_pallas", ["interpret", "never"])
@pytest.mark.parametrize("prior", sorted(PRIORS))
def test_cost_and_gradients_match_jax(prior, use_pallas, monkeypatch):
    params, ref, ref_grads = _reference(prior, use_pallas)
    calls = []
    real = generator_mod.decoder_scan_train
    monkeypatch.setattr(generator_mod, "decoder_scan_train",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = dict(NET, prior=PRIORS[prior], use_pallas=use_pallas)
    cfg.pop("input_num_chars")
    rec = SpeechRecognizer(cfg, device="cpu")
    load_path_dict(rec.net, param_path_dict(params))
    rec.net.requires_grad_(True)
    inputs, mask, labels, lmask = (torch.from_numpy(a) for a in _data())
    out = rec.cost_fn()(inputs, mask, labels.long(), lmask)
    assert bool(calls) == (use_pallas != "never")   # the route taken
    for key in ("costs", "weights", "energies"):
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(ref[key]), err_msg=key, **TOL)
    out["costs"].sum().backward()
    grads = {k: p.grad for k, p in rec.parameters().items()}
    assert set(grads) == set(ref_grads)
    assert any("post_merge_0" in k for k in grads)
    for key, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref_grads[key], err_msg=key,
                                   **TOL)


@pytest.mark.parametrize("train", [True, False])
def test_each_layer_reaches_the_scan_at_its_width(train, monkeypatch):
    """The encoder hands each layer's own width and frame count to the
    GRU scan (``models/cells.py``): 6, 10, 14 units over 24, 24, 12
    frames (``subsample`` strides a layer's output), both directions in
    one call; 6 frames are attended."""
    seen = []
    name = "gru_scan_train" if train else "gru_scan"
    real = getattr(cells_mod, name)

    def record(proj, mask, fwd, bwd=None):
        seen.append((proj.shape[0], fwd[1].shape[0], bwd is not None))
        return real(proj, mask, fwd, bwd)

    monkeypatch.setattr(cells_mod, name, record)
    rec = SpeechRecognizer(dict(NET, prior=PRIORS["median"]), init_config=
                           INIT, seed=3, device="cpu")
    inputs, mask, labels, lmask = (torch.from_numpy(a) for a in _data())
    with torch.set_grad_enabled(train):
        if train:
            rec.cost_fn()(inputs, mask, labels.long(), lmask)
        else:
            rec.net.decode_contexts(inputs, mask)
    assert seen == [(24, 6, True), (24, 10, True), (12, 14, True)]


def _pair(use_pallas, seed=8):
    """(JAX recognizer, port recognizer) of the pyramid net with JAX's
    weights; the EOS logit raised so hypotheses finish (random relu
    readouts of other seeds or biases finish at once or never)."""
    cfg = dict(NET, prior=PRIORS["median"], use_pallas=use_pallas)
    jrec = JaxRecognizer(cfg, init_config=INIT, seed=seed)
    last = jrec.params["params"]["generator"]["readout"]["post_merge_0"]
    last["bias"] = last["bias"].at[EOS].add(2.0)
    rec = SpeechRecognizer(cfg, init_config=INIT, seed=seed, device="cpu")
    load_path_dict(rec.net, param_path_dict(jrec.params))
    return jrec, rec


@pytest.mark.parametrize("use_pallas,loop", [("never", False),
                                             ("interpret", True)])
def test_beam_search_matches_jax(use_pallas, loop):
    """Beam 3 over one 14-frame utterance: the same finished hypotheses,
    lengths and costs as JAX's, on the module route (the route of the
    recipe's 800-frame decodes) and on the whole-loop route (the plain
    loop against JAX's kernel in interpret mode)."""
    jrec, rec = _pair(use_pallas)
    x = np.random.RandomState(5).randn(14, 6).astype(np.float32)
    jrec.init_beam_search(3)
    rec.init_beam_search(3)
    assert (jrec._beam_search._loop_kernel_mode() is not None) == loop
    assert loop_route(rec.net_config, 3, 100, 100) == loop
    ref = jrec.beam_search(x, as_arrays=True, char_discount=0.1)
    out = rec.beam_search(x, as_arrays=True, char_discount=0.1)
    valid = ref["done_valid"][0]
    assert valid.sum() >= 2, "vacuous: most hypotheses empty"
    np.testing.assert_array_equal(out["done_valid"], ref["done_valid"])
    np.testing.assert_array_equal(out["done_len"], ref["done_len"])
    np.testing.assert_array_equal(out["done_out"], ref["done_out"])
    np.testing.assert_allclose(out["done_cost"][0][valid],
                               ref["done_cost"][0][valid], rtol=1e-4,
                               atol=1e-4)


def _recipe_stages():
    conf = Configuration(RECIPE)
    return conf.ordered_stages


def test_recipe_passes_the_port_at_its_widths():
    """Every stage of wsj_pyramide.yaml, at its own widths, with no model
    built: no unported model or training piece; 250, 500 and 1000 units
    over 800, 800 and 400 frames of an 800-frame utterance (a layer's
    stride applies to its output), 200 frames attended."""
    stages = _recipe_stages()
    assert list(stages) == ["pretraining", "main", "annealing"]
    for name, stage in stages.items():
        net = stage["net"]
        assert unported_piece(net) is None, name
        assert unported_training(stage) is None, name
        assert net["dims_bidir"] == [250, 500, 1000]
        assert net["subsample"] == [1, 2, 2]
        assert net["post_merge_dims"] == [1000]
        assert net["post_merge_activation"] == "relu"
    frames, seen = 800, []
    for width, step in zip(net["dims_bidir"], net["subsample"]):
        seen.append((width, frames))
        frames = -(-frames // step)
    assert (seen, frames) == ([(250, 800), (500, 800), (1000, 400)], 200)


def test_recipe_gru_routes():
    """The first layer on the resident instances, the wider two on the
    wide ones, forward and backward."""
    assert [gs.route(D) for D in (250, 500, 1000)] == [
        "resident", "wide", "wide"]
    assert [gt.backward_route(D) for D in (250, 500, 1000)] == [
        "resident", "wide", "wide"]


def test_recipe_decode_takes_the_module_route():
    """At 800 frames (200 encoded, a 266-step cap) the loop kernel's
    block would need 282,880 bytes, over a block's 232,448, so the
    decode takes ``_search_core``, as the stacked recipes' do.  The two K
    x D glimpse buffers (20,000 floats each at D=2000) fill it: 50 frames
    of a 200-frame utterance miss as well."""
    net = dict(_recipe_stages()["main"]["net"], num_phonemes=32)
    assert not loop_route(net, 10, 800, 266)
    widths = dict(K=10, M=250, D=2000, S=250, R=1000, V=32, F=250,
                  n_taps=201)
    plan = smem_plan(L=200, Lout=266, **widths)
    assert (plan["fits"], plan["smem_bytes"]) == (False, 282880)
    offsets = plan["offsets"]
    assert offsets["conv"] - offsets["wa"] == 10 * 2000
    assert offsets["aout2"] - offsets["was"] == 10 * 2000
    short = smem_plan(L=50, Lout=66, **widths)
    assert not short["fits"] and short["smem_bytes"] > gs.MAX_SMEM
    assert not loop_route(net, 10, 200, 66)
    # the readout's relu: no fused score step, as in JAX
    small = dict(net, dims_bidir=[6] * 3, dim_dec=6, dim_matcher=6,
                 post_merge_dims=[6], conv_n=2, num_phonemes=5,
                 input_dims={"recordings": 5}, eos_label=4)
    assert not RecognizerNet(**small).generator.fused_score_supported()


def test_recipe_trains_on_the_kernel_route():
    """The training cost takes ``decoder_scan_train`` (one filter,
    softmax, one decoder layer), whose launch plans fit the recipe's
    attention (L=200, M=250, D=2000, S=250) at B=10 and 32 on 8-block
    clusters, the attended tiles streamed from L2."""
    net = _recipe_stages()["main"]["net"]
    small = dict(net, dims_bidir=[6] * 3, dim_dec=6, dim_matcher=6,
                 post_merge_dims=[6], conv_n=2, num_phonemes=5,
                 input_dims={"recordings": 5}, eos_label=4)
    assert RecognizerNet(**small).generator.train_kernel_route("auto")
    assert dt.unported_variant("softmax", 1, 1, "expanding") is None
    active = {16: 7, 8: 16}
    bytes_ = {}
    for kind in ("forward", "backward"):
        for B in (10, 32):
            plan = dt.plan(kind, B, 200, 250, 2000, 250, active)
            assert plan["cluster"] == 8 and plan["res_att"] == 0
            bytes_[kind, B] = plan["smem_bytes"]
    assert bytes_ == {("forward", 10): 58480, ("forward", 32): 114816,
                      ("backward", 10): 87056, ("backward", 32): 171968}
