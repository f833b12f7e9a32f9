"""The readout and attention variants of the WSJ recipes in the port vs the
JAX package (CPU, f32 both sides).

* the readout (``models/generator.py::Readout``): every post-merge
  activation (tanh, relu / rectifier, sigmoid / logistic, identity,
  maxout:2 and maxout:3) through one and two post-merge layers, and no
  post-merge layer (``post_merge_dims`` None or ``[]``), against JAX
  ``Readout`` on the same weights (1e-6);
* the conv attention with 3 and 10 filters and the ``window_around_mean``
  prior (``models/attention.py``), one hypothesis a row and K a row,
  against JAX ``SequenceContentAndConvAttention`` (1e-5);
* the plain score step ``fused_decode_score`` with the mean prior against
  JAX's Pallas kernel in interpret mode (1e-5);
* the routing of every config under ``exp/``: the port's
  ``loop_route``, ``fused_score_supported`` and ``train_kernel_route``
  give JAX's ``_loop_kernel_mode``, ``fused_score_supported`` and
  ``_fused_train_mode`` (widths cut to a few units, which keeps each
  config's shapes of lists and its choices), ``unported_piece`` passes
  them all, and five decoder layers take both packages' module paths."""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_lvcsr_tpu.config import Configuration as JaxConfiguration
from attention_lvcsr_tpu.models.attention import \
    SequenceContentAndConvAttention as JaxConvAttention
from attention_lvcsr_tpu.models.generator import Readout as JaxReadout
from attention_lvcsr_tpu.models.recognizer import RecognizerNet as JaxNet
from attention_lvcsr_tpu.models.recognizer import param_path_dict
from attention_lvcsr_tpu.ops.pallas.decode_score import (fused_decode_score
                                                         as jax_score,
                                                         toeplitz_band)
from attention_lvcsr_tpu.search.beam import BeamSearch as JaxBeamSearch
from attention_lvcsr_torch.config import Configuration
from attention_lvcsr_torch.models.attention import \
    SequenceContentAndConvAttention
from attention_lvcsr_torch.models.generator import Readout
from attention_lvcsr_torch.models.params import load_path_dict
from attention_lvcsr_torch.models.recognizer import (RecognizerNet,
                                                     unported_piece)
from attention_lvcsr_torch.ops.decode_score import fused_decode_score
from attention_lvcsr_torch.search.beam import loop_route
from attention_lvcsr_torch.train.driver import unported_training
from test_torch_decode_score import TABLES, _inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)


def _load(module, variables):
    """JAX variables of a module into the port module of the same
    parameters (the recognizer's path keys, one level down)."""
    load_path_dict(module, param_path_dict(variables))


# -- the readout ------------------------------------------------------------

ACTIVATIONS = ["tanh", "relu", "rectifier", "sigmoid", "logistic",
               "identity", "maxout:2", "maxout:3"]


@pytest.mark.parametrize("dims", [[12], [12, 6]], ids=["one", "two"])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_readout_matches_jax(activation, dims):
    _compare_readout(activation, dims)


@pytest.mark.parametrize("dims", [None, []], ids=["none", "empty"])
@pytest.mark.parametrize("activation", ["tanh", "maxout:2"])
def test_readout_without_post_merge_layers_matches_jax(activation, dims):
    """No post-merge layer: the merged vector is the readout, whatever the
    activation, and its width the readout's."""
    readout = _compare_readout(activation, dims)
    assert readout.merged_dim == 5 and readout.num_post_merge == 0


def _compare_readout(activation, dims):
    V, rng = 5, np.random.RandomState(len(dims or ()))
    sources = {"weighted_averages": rng.randn(4, 7).astype(np.float32),
               "states": rng.randn(4, 3).astype(np.float32)}
    jr = JaxReadout(source_names=("states", "weighted_averages"),
                    readout_dim=V, post_merge_dims=dims,
                    post_merge_activation=activation)
    jsrc = {k: jnp.asarray(v) for k, v in sources.items()}
    variables = jr.init(jax.random.PRNGKey(1), jsrc)
    # a nonzero merge bias, so that the activations see both signs
    p = dict(variables["params"])
    p["merge_bias"] = jnp.asarray(rng.randn(*p["merge_bias"].shape)
                                  .astype(np.float32))
    variables = {"params": p}
    ref = np.asarray(jr.apply(variables, jsrc))
    readout = Readout({"states": 3, "weighted_averages": 7}, V, dims,
                      activation)
    _load(readout, variables)
    with torch.no_grad():
        out = readout({k: torch.from_numpy(v) for k, v in sources.items()})
    assert out.shape == (4, V)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    return readout


def test_maxout_shrinks_the_next_layer_and_refuses_a_width_it_cannot_split():
    """A maxout:k layer feeds ``width / k`` units to the next one (its
    kernel is (R/k, V), as flax infers it), and a width k does not divide
    raises."""
    readout = Readout({"weighted_averages": 7}, 5, [12, 6], "maxout:3")
    assert tuple(readout.post_merge_0.kernel.shape) == (4, 6)
    assert tuple(readout.post_merge_1.kernel.shape) == (2, 5)
    with pytest.raises(ValueError, match="divisible"):
        Readout({"weighted_averages": 7}, 5, [10], "maxout:3")
    with pytest.raises(ValueError):
        Readout({"weighted_averages": 7}, 5, [10], "softplus")


# -- the attention -----------------------------------------------------------

MEAN = {"type": "window_around_mean", "before": 2, "after": 3}
MEDIAN = {"type": "window_around_median", "before": 2, "after": 3}


@pytest.mark.parametrize("beam", [1, 3])
@pytest.mark.parametrize("filters,prior", [(3, MEDIAN), (10, MEAN),
                                           (1, MEAN)],
                         ids=["conv3-median", "conv10-mean", "conv1-mean"])
def test_conv_attention_matches_jax(filters, prior, beam):
    """One glimpse of U*beam rows over U utterances' keys from spread
    previous weights: weights, weighted averages, windowed energies and
    the step."""
    U, L, D, S, M, n = 3, 14, 6, 5, 4, 2
    rng = np.random.RandomState(filters + beam)
    attended = rng.randn(U, L, D).astype(np.float32)
    mask = (np.arange(L)[None] < np.array([[L], [9], [0]])).astype("f")
    states = rng.randn(U * beam, S).astype(np.float32)
    w = np.abs(rng.randn(U * beam, L)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    step = np.full(U * beam, 2, np.int32)
    jatt = JaxConvAttention(state_names=("states",), attended_dim=D,
                            match_dim=M, conv_n=n, conv_num_filters=filters,
                            prior=prior, use_pallas="never")
    glimpses = {"weights": jnp.asarray(w), "step": jnp.asarray(step)}
    args = (jnp.asarray(attended), None, jnp.asarray(mask), glimpses,
            {"states": jnp.asarray(states)}, beam)
    variables = jatt.init(jax.random.PRNGKey(0), *args,
                          method=jatt.take_glimpses)
    ref = jatt.apply(variables, *args, method=jatt.take_glimpses)
    att = SequenceContentAndConvAttention(("states",), S, D, M, n,
                                          conv_num_filters=filters,
                                          prior=prior)
    assert tuple(att.conv_filters.shape) == (filters, 2 * n + 1)
    assert tuple(att.handler.kernel.shape) == (filters, M)
    _load(att, variables)
    with torch.no_grad():
        a = torch.from_numpy(attended)
        ours = att.take_glimpses(
            a, att.preprocess(a), torch.from_numpy(mask),
            {"weights": torch.from_numpy(w), "step": torch.from_numpy(step)},
            {"states": torch.from_numpy(states)}, beam=beam)
    assert set(ours) == set(ref)
    for key in ours:
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]),
                                   err_msg=key, rtol=1e-5, atol=1e-5)


def test_train_tables_stack_the_filters_bands():
    """``train_tables``' Toeplitz bands are (L, F*L), filter-major: each
    filter's band times the weights is its true convolution."""
    att = SequenceContentAndConvAttention(("states",), 5, 6, 4, 2,
                                          conv_num_filters=3)
    with torch.no_grad():
        att.conv_filters.copy_(torch.randn(3, 5, generator=torch.Generator()
                                           .manual_seed(0)))
    L = 9
    t = att.train_tables(L)
    assert tuple(t["toep"].shape) == (L, 3 * L)
    assert tuple(t["hand"].shape) == (3, 4)
    w = torch.rand(2, L)
    for f in range(3):
        band = np.asarray(toeplitz_band(jnp.asarray(
            att.conv_filters[f].detach().numpy()), L))
        np.testing.assert_allclose(t["toep"][:, f * L:(f + 1) * L]
                                   .detach().numpy(), band, atol=1e-7)
        np.testing.assert_allclose(
            (w @ t["toep"][:, f * L:(f + 1) * L]).detach().numpy(),
            w.numpy() @ band, rtol=1e-5, atol=1e-6)
    lt = att.loop_tables()
    assert tuple(lt["handler"].shape) == (3, 4)
    assert tuple(lt["conv_filters"].shape) == (3, 5)


# -- the score step ----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_plain_score_step_with_the_mean_prior_matches_jax_kernel(seed):
    """``fused_decode_score_reference`` under ``window_around_mean`` (a
    padded batch, a row of zero weights, a one-hot row) against JAX's
    kernel in interpret mode."""
    data, tables, K = _inputs(seed)
    L = data["weights"].shape[1]
    prior = dict(prior="window_around_mean", before=4.0, after=5.0)
    ref = jax_score(
        *(jnp.asarray(data[k]) for k in ("pre", "attended", "mask",
                                         "weights", "step", "states")),
        toeplitz_band(jnp.asarray(tables["conv_filters"]), L),
        jnp.triu(jnp.ones((L, L), jnp.float32)),
        *(jnp.asarray(tables[k]) for k in TABLES), beam=K, interpret=True,
        **prior)
    got = fused_decode_score(
        *(torch.tensor(data[k]) for k in ("pre", "attended", "mask",
                                          "weights", "step", "states")),
        {k: torch.tensor(v) for k, v in tables.items()}, beam=K, **prior)
    for name, ours, theirs in zip(("costs", "weights", "energies", "wa"),
                                  got, ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


# -- routing over every config ----------------------------------------------

CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "exp", "*", "configs", "*.yaml")))
STACKED = {"exp/wsj/configs/wsj_jan_debug.yaml",
           "exp/wsj/configs/wsj_jan_wsj13v2.yaml",
           "exp/wsj/configs/wsj_jan_wsj14v2.yaml",
           "exp/wsj/configs/wsj_jan_wsj15v2.yaml"}
# the widths of a net config, cut to a few units; lists keep their length
_WIDTHS = ("dim_dec", "dim_matcher", "dim_output_embedding")


def _stages(path, cls):
    conf = cls(os.path.join(ROOT, path))
    if getattr(conf, "multi_stage", False):
        return list(conf.ordered_stages.values())
    return [conf]


def _small(net):
    net = dict(net)
    for key in _WIDTHS:
        if net.get(key):
            net[key] = 6
    for key in ("dims_bidir", "post_merge_dims"):
        if net.get(key):
            net[key] = [6] * len(net[key])
    if net.get("conv_n"):
        net["conv_n"] = 2
    bottom = dict(net.get("bottom") or {})
    if bottom.get("dims"):
        bottom["dims"] = [6] * len(bottom["dims"])
        net["bottom"] = bottom
    net.pop("lm", None)
    net.pop("compute_dtype", None)
    net.pop("input_sources", None)
    return dict(net, input_dims={"recordings": 5}, input_num_chars={},
                eos_label=4, num_phonemes=5, use_pallas="interpret")


def test_every_config_is_covered():
    assert len(CONFIGS) == 54


def _assert_routes_match(net, jnet_config):
    """The port's loop route (beam 10, 100 frames), fused score step and
    training route are JAX's choices for the same net config."""
    jnet = JaxNet(**jnet_config)

    class _Rec:
        pass

    jrec = _Rec()
    jrec.net, jrec.num_phonemes = jnet, 5
    jax_loop = JaxBeamSearch(jrec, 10)._loop_kernel_mode() is not None
    assert loop_route(net, 10, 100) == jax_loop, net
    bound = jnet.bind({}, rngs={"params": jax.random.PRNGKey(0)},
                      mutable=["params"])
    ours = RecognizerNet(**net).generator
    assert bool(ours.fused_score_supported()) \
        == bool(bound.generator.fused_score_supported())
    assert ours.train_kernel_route(net["use_pallas"]) \
        == (bound.generator._fused_train_mode() is not None)


@pytest.mark.parametrize("path", CONFIGS)
def test_routing_matches_jax(path):
    """Per stage: ``unported_piece`` and ``unported_training`` pass every
    config, the stacked decoders included; the port's loop route, fused
    score step and training route are JAX's choices."""
    stages = _stages(path, Configuration)
    jstages = _stages(path, JaxConfiguration)
    assert [unported_piece(s["net"]) for s in stages] == [None] * len(stages)
    for stage, jstage in zip(stages, jstages):
        assert unported_training(stage) is None
        _assert_routes_match(_small(stage["net"]), _small(jstage["net"]))
        if path in STACKED:
            assert stage["net"]["dec_stack"] == 2
            assert not RecognizerNet(**_small(stage["net"])) \
                .generator.fused_score_supported()


def test_routing_of_five_layers_matches_jax():
    """Five decoder layers, past the kernels' four: both packages take
    their module paths for the decode and for the training cost."""
    stage = _stages("exp/wsj/configs/wsj_jan_wsj13v2.yaml",
                    Configuration)[-1]
    net = dict(_small(stage["net"]), dec_stack=5)
    assert not loop_route(net, 10, 100)
    assert not RecognizerNet(**net).generator.train_kernel_route("auto")
    _assert_routes_match(net, dict(net))
