"""Stacked GRU decoders (``dec_stack`` 2-4) in the port vs the JAX package
(CPU, f32 both sides).

* ``SequenceGenerator``'s module step (``decode_init``, ``decode_score``,
  ``decode_advance``) for N = 2, 3, 4: the costs and every layer's new
  state (1e-5);
* ``RecognizerNet.cost`` and every parameter's gradient of a JAX-initialised
  stacked net loaded through ``models/params.py`` (the ``interlayer_*``,
  ``state_trans_states_*`` and ``merge_states_*`` keys), with ragged label
  masks, on the port's module scan (``use_pallas: never``) and on its
  ``decoder_scan_train`` route (the plain version), against JAX's scan
  (the tolerances of ``tests/test_torch_cost.py``);
* the plain ``decoder_scan_train`` against JAX's kernel in interpret mode
  for N = 2, 3, 4 with several filters: outputs and gradients, the
  interlayer tables' included (1e-5);
* the plain whole-loop decode against JAX's ``beam_search_loop`` in
  interpret mode for N = 2 and 3: identical done sets, lengths and steps,
  costs within 1e-4 (the rows of a stack pass through more sums);
* ``_search_core`` of a stacked net against JAX's module search;
* ``exp/wsj/configs/wsj_jan_debug.yaml``'s two stages at its own widths
  through ``run.py train`` of both packages.

The module scan feeds layer l the unmasked new state of layer l-1, as
JAX's ``_compute_states`` (no mask reaches it) and both packages' kernels
do; on a padded step the layer above is masked back, so the masked and
unmasked readings give the same outputs, and the ragged masks here hold
the gradients to that.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_lvcsr_tpu.config import Configuration as JaxConfiguration
from attention_lvcsr_tpu.data import Data as JaxData
from attention_lvcsr_tpu.models.recognizer import RecognizerNet as JaxNet
from attention_lvcsr_tpu.models.recognizer import \
    SpeechRecognizer as JaxRecognizer
from attention_lvcsr_tpu.models.recognizer import param_path_dict
from attention_lvcsr_tpu.ops.pallas.beam_loop import \
    beam_search_loop as jax_beam_search_loop
from attention_lvcsr_tpu.ops.pallas.decoder_train import \
    decoder_scan_train as jax_decoder_scan_train
from attention_lvcsr_tpu.train import checkpoint as jax_checkpoint
from attention_lvcsr_tpu.train import driver as jax_driver
from attention_lvcsr_torch.models import generator as generator_mod
from attention_lvcsr_torch.models.params import load_path_dict
from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
from attention_lvcsr_torch.ops.beam_loop import (beam_search_loop,
                                                 smem_plan, unported_loop)
from attention_lvcsr_torch.ops.decoder_train import (decoder_scan_train,
                                                     unported_variant)
from attention_lvcsr_torch.search import beam as beam_mod
from test_torch_decoder_train import (EXPANDING, NAMES, TOL, _call,
                                      _operands)
from test_torch_multistage import _same_files, _same_records, _train_both

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EOS = 4
MEAN = {"type": "window_around_mean", "before": 3, "after": 3}
MEDIAN = {"type": "window_around_median", "before": 3, "after": 3}
NET = dict(
    input_dims={"recordings": 6}, input_num_chars={}, eos_label=EOS,
    num_phonemes=5, dim_dec=6, dims_bidir=[7], enc_transition="gru",
    dec_transition="gru", attention_type="content_and_conv", conv_n=2,
    conv_num_filters=3, use_states_for_readout=True, dim_matcher=9,
    criterion={"name": "log_likelihood"}, bottom={"bottom_class": "speech"},
    subsample=[1], post_merge_dims=[10], post_merge_activation="maxout:2",
    prior=MEAN, max_decoded_length_scale=1.0, data_prepend_eos=False)
INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.5],
                        "biases_init": ["constant", 0.0],
                        "rec_weights_init": ["orthogonal"]}}
COST_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-5, atol=2e-6)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(dec_stack, use_pallas="interpret", seed=7, **overrides):
    """(JAX recognizer, port recognizer) of one stacked net with JAX's
    weights; the EOS logit raised so hypotheses finish."""
    cfg = dict(NET, dec_stack=dec_stack, use_pallas=use_pallas, **overrides)
    jrec = JaxRecognizer(cfg, init_config=INIT, seed=seed)
    last = jrec.params["params"]["generator"]["readout"]["post_merge_0"]
    last["bias"] = last["bias"].at[EOS].add(1.5)
    rec = SpeechRecognizer(cfg, init_config=INIT, seed=seed, device="cpu")
    load_path_dict(rec.net, param_path_dict(jrec.params))
    return jrec, rec


def _batch(U=3, T=16):
    rng = np.random.RandomState(3)
    x = rng.randn(U, T, 6).astype(np.float32)
    m = (np.arange(T)[None] < np.array([[T], [T - 4], [0]])).astype("f")
    return x[:U], m[:U]


@pytest.mark.parametrize("dec_stack", [2, 3, 4])
def test_parameter_keys_are_jax_keys(dec_stack):
    """The stack's parameters carry JAX's names, so the weight bridge maps
    them by name alone: every layer's transition, fork and distribute,
    the interlayer projections of layers 1.., a state transform and a
    readout merge per state name."""
    jrec, rec = _pair(dec_stack)
    keys = set(rec.parameters())
    assert keys == set(param_path_dict(jrec.params))
    g = "/recognizer/generator"
    for layer in range(dec_stack):
        assert f"{g}/transition_{layer}/state_to_gates" in keys
        assert f"{g}/fork_{layer}_gate_inputs/kernel" in keys
        assert f"{g}/attention/state_trans_states_{layer}/kernel" in keys
        assert f"{g}/readout/merge_states_{layer}/kernel" in keys
        assert (f"{g}/interlayer_{layer}_inputs/kernel" in keys) == (
            layer > 0)


@pytest.mark.parametrize("dec_stack", [2, 3, 4])
def test_module_step_matches_jax(dec_stack):
    """Two steps of the module-driven decode at beam 3: the score step's
    costs and the advance's states of every layer."""
    jrec, rec = _pair(dec_stack)
    x, m = _batch(U=2)
    K, V = 3, 5
    jnet, params = jrec.net, jrec.params
    jctx = jnet.apply(params, x, m, method=jnet.decode_contexts)
    jcarry = jnet.apply(params, 2 * K, jctx, method=jnet.decode_init)
    with torch.no_grad():
        ctx = rec.net.decode_contexts(torch.from_numpy(x),
                                      torch.from_numpy(m))
        carry = rec.net.decode_init(2 * K, ctx)
        for step in range(2):
            jg, jcosts, _ = jnet.apply(params, jcarry, jctx, beam=K,
                                       method=jnet.decode_score)
            g, costs = rec.net.decode_score(carry, ctx, beam=K)
            np.testing.assert_allclose(costs.numpy(), np.asarray(jcosts),
                                       err_msg=f"costs {step}", **STEP_TOL)
            chosen = np.argsort(np.asarray(jcosts), axis=1,
                                kind="stable")[:, step].astype(np.int32)
            jcarry = jnet.apply(params, jcarry, jg, jnp.asarray(chosen),
                                jctx, method=jnet.decode_advance)
            carry = rec.net.decode_advance(carry, g,
                                           torch.from_numpy(chosen).long())
            want = np.concatenate([np.asarray(s["states"])
                                   for s in jcarry["states"]], axis=1)
            assert carry["states"].shape == (2 * K, 6 * dec_stack)
            np.testing.assert_allclose(carry["states"].numpy(), want,
                                       err_msg=f"states {step}", **STEP_TOL)


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
    XLA scan), once per net config."""
    key = repr(sorted(cfg.items()))
    if key not in _REFERENCE:
        net = JaxNet(**dict(cfg, use_pallas="never"))
        params = net.init(jax.random.PRNGKey(0), *jdata, method=net.cost)

        def cost(p):
            out = net.apply(p, *jdata, method=net.cost)
            return out["costs"].sum(), out

        (_, ref), grads = jax.value_and_grad(cost, has_aux=True)(params)
        _REFERENCE[key] = (params, ref, param_path_dict(grads))
    return _REFERENCE[key]


@pytest.mark.parametrize("use_pallas", ["interpret", "never"])
@pytest.mark.parametrize("dec_stack", [2, 3, 4])
def test_cost_and_gradients_match_jax(dec_stack, use_pallas, monkeypatch):
    """``net.cost`` (costs, weights, energies) and every parameter's
    gradient, the interlayer projections included, against JAX's cost
    graph, from JAX's initial parameters; ``interpret`` takes the port's
    ``decoder_scan_train`` (lane-stacked tables, the interlayer tables
    beside them), ``never`` its module scan."""
    data = _data()
    jdata = [jnp.asarray(a) for a in data]
    cfg = dict(NET, dec_stack=dec_stack)
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
        assert kw["dec_stack"] == dec_stack
        assert tuple(kw["inter_gate"].shape) == (6, 12 * (dec_stack - 1))
        assert tuple(args[10].shape) == (6 * dec_stack, 9)      # st
    for key in ("costs", "weights", "energies"):
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(ref[key]), err_msg=key,
                                   **COST_TOL)
    out["costs"].sum().backward()
    grads = {k: p.grad for k, p in rec.parameters().items()}
    assert set(grads) == set(ref_grads)
    assert any("interlayer_1" in k for k in grads)
    for key, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref_grads[key], err_msg=key,
                                   **GRAD_TOL)


PLAIN_CASES = [(2, 3, MEAN), (3, 10, MEDIAN), (4, 2, EXPANDING)]


@pytest.mark.parametrize("dec_stack,n_filters,prior", PLAIN_CASES,
                         ids=[f"stack{c[0]}-conv{c[1]}" for c in PLAIN_CASES])
def test_plain_scan_matches_jax_interpret(dec_stack, n_filters, prior):
    """The plain ``decoder_scan_train`` of a stack against JAX's kernel in
    interpret mode (rows padded from the third and the fifth step on):
    h, weights, averages, energies and the gradients of every operand,
    ``inter_in`` and ``inter_gate`` included."""
    ops, mask, amask, w0, extra, cots = _operands(n_filters, dec_stack,
                                                  "softmax")
    extra.pop("e_bias")
    kw = dict(prior=prior, normalizer="softmax", n_filters=n_filters,
              dec_stack=dec_stack)

    def loss(d):
        out = _call(jax_decoder_scan_train, d, jnp.asarray(mask),
                    jnp.asarray(amask), jnp.asarray(w0),
                    {k: d[k] for k in extra}, jnp, interpret=True, **kw)
        return sum((o * c).sum() for o, c in zip(out[:3], cots)), out

    jd = {k: jnp.asarray(v) for k, v in {**ops, **extra}.items()}
    (_, ref), grads = jax.value_and_grad(loss, has_aux=True)(jd)
    td = {k: torch.tensor(v, requires_grad=True)
          for k, v in {**ops, **extra}.items()}
    got = _call(decoder_scan_train, td, torch.from_numpy(mask),
                torch.from_numpy(amask), torch.from_numpy(w0),
                {k: td[k] for k in extra}, torch, **kw)
    for what, g, r in zip(("h", "weights", "wa", "energies"), got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   err_msg=what, **TOL)
    sum((o * torch.from_numpy(c)).sum()
        for o, c in zip(got[:3], cots)).backward()
    for k in NAMES + ("inter_in", "inter_gate"):
        np.testing.assert_allclose(td[k].grad.numpy(), np.asarray(grads[k]),
                                   err_msg=f"d{k}", **TOL)


@pytest.mark.parametrize("dec_stack,overrides", [
    (2, {}), (3, {"conv_num_filters": 10, "prior": MEDIAN}),
    (2, {"post_merge_activation": "rectifier",
         "use_states_for_readout": False})],
    ids=["stack2", "stack3-conv10-median", "stack2-rectifier"])
def test_plain_loop_matches_jax_interpret(dec_stack, overrides):
    jrec, rec = _pair(dec_stack, **overrides)
    net = rec.net_config
    x, m = _batch()
    data = jrec.net.apply(jrec.params, x, m, method=jrec.net.decode_loop)
    L = data["attended"].shape[1]
    tables = jrec.net.apply(jrec.params, L, jnp.float32,
                            method=jrec.net.decode_loop_tables)
    prior = dict(net["prior"])
    act = net["post_merge_activation"]
    kw = dict(beam=3, max_len=12, eol=EOS, prior=prior["type"],
              before=float(prior["before"]), after=float(prior["after"]),
              char_discount=0.1)
    ref_out, ref_meta, ref_steps = (np.asarray(a) for a in
                                    jax_beam_search_loop(
        data["pre"], data["attended"], data["attended_mask"], tables,
        states_readout=bool(net["use_states_for_readout"]),
        maxout=2 if act.startswith("maxout") else 0, post_act=act,
        dec_stack=dec_stack, interpret=True, **kw))
    assert beam_mod.loop_route(net, 3, x.shape[1], 12)
    ours = rec.net.decode_loop_tables()
    assert tuple(ours["inter_gate_w"].shape) == (6, 12 * (dec_stack - 1))
    for name in ("fork_in_w", "fork_gate_w", "wsg", "wss", "h0",
                 "state_trans", "inter_in_w", "inter_gate_w") + (
            ("merge_states_k",) if net["use_states_for_readout"] else ()):
        np.testing.assert_array_equal(ours[name].numpy(),
                                      np.asarray(tables[name]), name)
    t = lambda a: torch.from_numpy(np.array(a))
    with torch.no_grad():
        out, meta, steps = beam_search_loop(
            t(data["pre"]), t(data["attended"]), t(data["attended_mask"]),
            ours, post_act=act, **kw)
    valid = ref_meta[:, :, 1] < 1e9 / 2
    assert valid[:2].sum() >= 3, "vacuous: most hypotheses empty"
    assert not valid[2].any(), "the fully padded utterance must not decode"
    np.testing.assert_array_equal(out.numpy(), ref_out)
    np.testing.assert_array_equal(meta.numpy()[:, :, 2], ref_meta[:, :, 2])
    np.testing.assert_array_equal(steps.numpy(), ref_steps)
    np.testing.assert_allclose(meta.numpy()[:, :, :2], ref_meta[:, :, :2],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dec_stack", [2, 3])
def test_module_search_matches_jax(dec_stack, monkeypatch):
    """Under ``use_pallas: never`` both packages decode a stacked net on
    their module search, which reorders every layer's states by the
    chosen source rows: the same hypotheses and costs."""
    jrec, rec = _pair(dec_stack, use_pallas="never")
    monkeypatch.setattr(beam_mod.BeamSearch, "_search_loop", None)
    x, _ = _batch(U=1, T=14)
    jrec.init_beam_search(3)
    rec.init_beam_search(3)
    assert jrec._beam_search._loop_kernel_mode() is None
    ref = jrec.beam_search(x[0], as_arrays=True, char_discount=0.1)
    out = rec.beam_search(x[0], as_arrays=True, char_discount=0.1)
    valid = ref["done_valid"][0]
    assert valid.sum() >= 2, "vacuous: most hypotheses empty"
    np.testing.assert_array_equal(out["done_valid"], ref["done_valid"])
    np.testing.assert_array_equal(out["done_len"], ref["done_len"])
    np.testing.assert_array_equal(out["done_out"], ref["done_out"])
    np.testing.assert_allclose(out["done_cost"][0][valid],
                               ref["done_cost"][0][valid], rtol=1e-4,
                               atol=1e-4)


def test_kernel_routes_of_a_stack():
    """The loop kernel takes one to four layers under the log-likelihood
    and softmax; the training decoder's kernel two to four with several
    filters and softmax.  The loop's layout keeps the layers' states and
    no staged feedback rows: two 512-wide layers fit at the recipes'
    widths up to about 250 encoded frames."""
    assert unported_loop("window_around_mean", 10, "softmax", False,
                         "maxout:2", False, 2) is None
    assert unported_loop("expanding", 1, "softmax", False, "tanh", False,
                         4) is None
    assert "5 decoder layers" in unported_loop("expanding", 1, "softmax",
                                               False, "tanh", False, 5)
    assert unported_loop("expanding", 1, "logistic", False, "tanh", False,
                         2) is not None
    assert unported_loop("expanding", 1, "softmax", False, "tanh", True,
                         2) is not None
    assert unported_variant("softmax", 10, 2, "window_around_mean") is None
    assert unported_variant("softmax", 10, 4, "expanding") is None
    assert "dec_stack=5" in unported_variant("softmax", 10, 5, "expanding")
    assert "dec_stack=2" in unported_variant("softmax", 1, 2, "expanding")
    assert "dec_stack=2" in unported_variant("logistic", 10, 2, "expanding")
    wide = dict(K=10, M=512, D=512, R=256, V=32, F=512, Lout=100,
                n_taps=201, n_filters=10, maxout=2)
    one = smem_plan(L=200, S=512, **wide)
    two = smem_plan(L=200, S=512, dec_stack=2, **wide)
    assert two["fits"]
    assert two["offsets"]["ends"] - two["offsets"]["h"] \
        == one["offsets"]["ends"] - one["offsets"]["h"] + 10 * 512
    assert not smem_plan(L=300, S=512, dec_stack=2, **wide)["fits"]


CONFIG = """
parent: {root}/exp/wsj/configs/wsj_jan_debug.yaml
data:
    dataset_filename: {dataset}
    name_mapping: {{train: train, valid: train, test: test}}
    sources_map: {{recordings: recordings, labels: labels, uttids: uttids}}
    batch_size: 2
    validation_batch_size: 4
    sort_k_batches: 2
    add_bos: 0
    pad_multiple: {{recordings: 12, labels: 5}}
    prefetch: false
training:
    rules: [adadelta]
stages:
    pretraining:
        training: {{num_epochs: 1}}
    main:
        training: {{num_epochs: 1}}
"""


@pytest.fixture
def staged(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_toy_dataset import make_toy_dataset
    make_toy_dataset(str(tmp_path / "toy.h5"), num_examples=24, num_chars=4,
                     feat_dim=5, max_len=4, seed=5)
    path = tmp_path / "staged.yaml"
    path.write_text(CONFIG.format(root=ROOT, dataset=tmp_path / "toy.h5"))
    config = JaxConfiguration(str(path))
    start = str(tmp_path / "start.zip")
    jrec = jax_driver.create_model(config.ordered_stages["pretraining"],
                                   JaxData(**config["data"]))
    jax_checkpoint.save_checkpoint(start, param_path_dict(jrec.params))
    return path, start


def test_wsj_jan_debug_stages_match_jax(staged, tmp_path):
    """``wsj_jan_debug.yaml`` at its own widths (3 x 17 encoder, two
    19-wide decoder layers, ten 27-tap filters, maxout:2 with the decoder
    states): ``pretraining`` then ``main`` from its ``_best_ll``, the same
    files, parameters and records as JAX's.  The run takes
    ``wsj_paper.yaml``'s ``[adadelta]``: under the recipe's ``[momentum,
    adadelta]`` the toy set's cost rises over an epoch in both packages,
    and no ``_best_ll`` is written."""
    config, start = staged
    jloops, ploops = _train_both(tmp_path, config, start,
                                 flags=("--final-stage", "main"))
    stages = ("pretraining", "main")
    assert len(ploops) == len(jloops) == 2
    _same_files(tmp_path, stages)
    for stage, ploop, jloop in zip(stages, ploops, jloops):
        compared = _same_records(stage, ploop, jloop)
        assert {"valid_sequence_total_cost", "valid_per",
                "average_train_cost"} <= set(compared), stage
    nets = [loop.algorithm.recognizer.net_config for loop in ploops]
    assert [n["dec_stack"] for n in nets] == [2, 2]
    assert [n["prior"]["type"] for n in nets] == ["expanding",
                                                 "window_around_mean"]
    params = ploops[1].algorithm.recognizer.parameters()
    g = "/recognizer/generator"
    assert tuple(params[f"{g}/interlayer_1_gate_inputs/kernel"].shape) \
        == (19, 38)
    assert tuple(params[f"{g}/attention/conv_filters"].shape) == (10, 27)


# the clusters of each size an H100 SXM holds at once
# (tests/test_torch_decoder_plan.py)
H100 = {16: 7, 8: 15, 4: 30}


@pytest.mark.parametrize("B,L,S", [(10, 400, 256), (32, 400, 256),
                                   (10, 200, 512), (10, 400, 512)],
                         ids=["wsj13v2-B10", "wsj13v2-B32", "wsj15v2",
                              "wsj14v2"])
def test_decoder_plans_cover_the_stacked_recipes(B, L, S):
    """Both training kernels have a launch plan for two layers at the
    recipes' training shapes (800 frames: L=400 under wsj13v2's and
    wsj14v2's subsampling by 2, 200 under wsj15v2's by 4; ten filters,
    M=D=512); a stack's rows keep every layer's states and gradients,
    so its block takes more shared memory than one layer's."""
    import attention_lvcsr_torch.ops.decoder_train as dt
    for kind in dt.KINDS:
        one = dt.plan(kind, B, L, 512, 512, S, H100, n_filters=10)
        two = dt.plan(kind, B, L, 512, 512, S, H100, n_filters=10,
                      dec_stack=2)
        assert two["smem_bytes"] <= dt.MAX_SMEM
        res = {k: 0 for k in dt.TILES[kind]}
        bare = [dt.layout(kind, two["cluster"], two["rows"], L, 512, 512, S,
                          res, n_filters=10, dec_stack=n)["smem_bytes"]
                for n in (1, 2, 3, 4)]
        assert bare == sorted(bare) and len(set(bare)) == 4
        assert one["cluster"] in dt.CLUSTERS
