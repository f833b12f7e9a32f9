"""Bottom dropout and additive weight noise in the port vs the JAX package
(CPU, f32 both sides).

Two steps of the port's ``make_train_step`` against the JAX package's on
the flagship's structure (a two-layer BiGRU subsampled 1, 2, conv
attention with the median window) at narrow widths, with dropout alone,
the weight noise alone, both, and both under the task loss's greedy
exploration.  The draws are the JAX step's own: the noise reproduced with
``jax.random`` from the step's key split as the JAX step splits it, the
dropout mask read from the bottom output of JAX's cost under the step's
dropout key, both given to the port's step through ``weight_noise`` and
``dropout_mask``.  Costs, monitors and updated parameters agree within
1e-5 (the train step's tolerance, ``test_torch_train_step.py``).  The
noised leaves are the complement of JAX's ``_attention_leaf``; an
adaptive-noise step applies no dropout in either package; the port's own
draws follow ``regularization_draws``' order; a resumed run repeats the
bits of a straight one; ``run.py train`` with dropout, noise and
``monitoring.plot`` warns of nothing and writes the plot."""
import json
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_lvcsr_tpu.models.recognizer import \
    SpeechRecognizer as JaxRecognizer
from attention_lvcsr_tpu.models.recognizer import param_path_dict
from attention_lvcsr_tpu.train import driver as jax_driver
from attention_lvcsr_tpu.train.rules import \
    build_optimizer as jax_build_optimizer
from attention_lvcsr_torch.cli import run
from attention_lvcsr_torch.models.params import load_path_dict
from attention_lvcsr_torch.models.recognizer import (SpeechRecognizer,
                                                     bottom_dropout,
                                                     draw_dropout_mask)
from attention_lvcsr_torch.train import driver
from attention_lvcsr_torch.train.rules import build_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)
EOS = 4
NET = dict(
    input_dims={"recordings": 5}, eos_label=EOS, num_phonemes=5, dim_dec=8,
    dims_bidir=[6, 6], enc_transition="gru", dec_transition="gru",
    attention_type="content_and_conv", conv_n=2,
    use_states_for_readout=False, criterion={"name": "log_likelihood"},
    bottom={"bottom_class": "speech"}, subsample=[1, 2],
    prior={"type": "window_around_median", "before": 2, "after": 2},
    post_merge_dims=[10], max_decoded_length_scale=1.0, use_pallas="never")
INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.3],
                        "biases_init": ["isotropic_gaussian", 0.1],
                        "rec_weights_init": ["orthogonal"]}}
B, T, TL = 3, 10, 5
NOISE = 0.05


def _batch(seed=3):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, EOS, size=(B, TL)).astype(np.int32)
    labels[np.arange(B), [4, 2, 2]] = EOS      # rows end with EOS
    return (rng.randn(B, T, 5).astype(np.float32),
            (np.arange(T)[None] < np.array([[T], [T - 3], [T]])).astype("f"),
            labels,
            (np.arange(TL)[None] < np.array([[TL], [3], [3]])).astype("f"))


def _config(dropout, noise, exploration="imitative"):
    net = dict(NET, dropout=dropout)
    reg = {"max_norm": 0.8, "decay": 1e-3, "penalty_coof": 0.5,
           "dropout": dropout, "noise": noise}
    if exploration != "imitative":
        net.update(energy_normalizer="logistic",
                   criterion={"name": "mse_gain", "min_reward": -2})
    return {"net": net, "regularization": reg,
            "training": {"rules": ["adadelta"], "decay_rate": 0.95,
                         "epsilon": 1e-6, "gradient_threshold": 1.0,
                         "exploration": exploration}}


def _jax_noise(params, key):
    """The JAX step's standard normal draws of the non-attention leaves,
    by the port's parameter paths (``make_train_step``'s
    ``split(noise_rng, len(flat))``)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    keys = jax.random.split(key, len(flat))
    return {"/recognizer/" + "/".join(p.key for p in path[1:]):
            torch.from_numpy(np.asarray(
                jax.random.normal(k, leaf.shape, leaf.dtype)))
            for (path, leaf), k in zip(flat, keys)
            if not jax_driver._attention_leaf(path)}


def _jax_mask(jrec, params, batch, key):
    """The JAX step's dropout mask: where the bottom output of its cost
    under the step's dropout key is not zero (the features are nowhere
    zero)."""
    net = jrec.net
    out = net.apply(params, *map(jnp.asarray, batch), None, None, True,
                    method=net.cost, rngs={"dropout": key})
    return torch.from_numpy(np.asarray(out["bottom_output"]) != 0)


def _steps(config, n=2):
    batch = _batch()
    jrec = JaxRecognizer(dict(config["net"], input_num_chars={}),
                         init_config=INIT, seed=7)
    jopt = jax_build_optimizer(config["training"], config["regularization"])
    jstep = jax.jit(jax_driver.make_train_step(jrec, jopt, config, EOS,
                                               "recordings"))
    jparams, jstate = jrec.params, jopt.init(jrec.params)
    rec = SpeechRecognizer(config["net"], device="cpu")
    load_path_dict(rec.net, param_path_dict(jparams))
    opt = build_optimizer(config["training"], config["regularization"])
    step = driver.make_train_step(rec, opt, config)
    state = opt.init({k: p.detach() for k, p in rec.parameters().items()})
    tb = [torch.from_numpy(a) for a in batch]
    tb[2] = tb[2].long()
    reg = config["regularization"]
    for i in range(n):
        key = jax.random.PRNGKey(11 + i)
        drop_key, noise_key, _ = jax.random.split(key, 3)
        kwargs = {}
        if reg["noise"]:
            kwargs["weight_noise"] = _jax_noise(jparams, noise_key)
        if reg["dropout"]:
            kwargs["dropout_mask"] = _jax_mask(jrec, jparams, batch,
                                               drop_key)
        jparams, jstate, jmon = jstep(jparams, jstate, key,
                                      *map(jnp.asarray, batch))
        state, mon = step(state, *tb, **kwargs)
        yield i, jmon, mon, param_path_dict(jparams), rec, kwargs


@pytest.mark.parametrize("dropout,noise,exploration", [
    (True, 0.0, "imitative"), (False, NOISE, "imitative"),
    (True, NOISE, "imitative"), (True, NOISE, "greedy")],
    ids=["dropout", "noise", "both", "both-greedy"])
def test_steps_match_jax(dropout, noise, exploration):
    config = _config(dropout, noise, exploration)
    for i, jmon, mon, ref, rec, draws in _steps(config):
        assert set(jmon) <= set(mon)
        for k, v in jmon.items():
            np.testing.assert_allclose(float(mon[k]), float(v),
                                       err_msg=f"step {i}: {k}", **TOL)
        for k, p in rec.param_path_dict().items():
            np.testing.assert_allclose(p, ref[k], err_msg=f"step {i}: {k}",
                                       **TOL)
        if dropout:
            kept = float(draws["dropout_mask"].float().mean())
            assert 0.2 < kept < 0.8, "vacuous: the mask keeps all or none"
    if dropout:
        # mean_bottom_output reads the dropped-out values, in both
        np.testing.assert_allclose(float(mon["mean_bottom_output"]),
                                   float(jmon["mean_bottom_output"]), **TOL)


def test_regularizers_change_the_step():
    """Not vacuous: each regularizer moves the step's cost."""
    costs = {}
    for name, (dropout, noise) in {"plain": (False, 0.0),
                                   "dropout": (True, 0.0),
                                   "noise": (False, NOISE)}.items():
        (_, jmon, mon, _, _, _), = list(_steps(_config(dropout, noise), 1))
        costs[name] = float(mon["train_cost"])
    assert abs(costs["dropout"] - costs["plain"]) > 1e-3
    assert abs(costs["noise"] - costs["plain"]) > 1e-4


def test_noised_leaves_are_jax_attention_complement():
    jrec = JaxRecognizer(dict(NET, input_num_chars={}), init_config=INIT,
                         seed=7)
    flat, _ = jax.tree_util.tree_flatten_with_path(jrec.params)
    jax_noised = {"/recognizer/" + "/".join(p.key for p in path[1:])
                  for path, _ in flat
                  if not jax_driver._attention_leaf(path)}
    rec = SpeechRecognizer(NET, device="cpu")
    noise, mask = driver.regularization_draws(
        rec, {"regularization": {"noise": 0.1}}, (B, T),
        torch.Generator().manual_seed(0))
    assert mask is None
    assert set(noise) == jax_noised
    assert set(rec.parameters()) - jax_noised == {
        k for k in rec.parameters() if "/attention/" in k}
    assert any("/attention/" in k for k in rec.parameters())


def test_own_draws_follow_the_stated_order():
    """Without explicit draws the step takes ``regularization_draws``
    from its generator: the same generator's draws given explicitly give
    the same bits."""
    config = _config(True, NOISE)
    tb = [torch.from_numpy(a) for a in _batch()]
    tb[2] = tb[2].long()
    results = []
    for explicit in (False, True):
        rec = SpeechRecognizer(config["net"], init_config=INIT, seed=7,
                               device="cpu")
        opt = build_optimizer(config["training"], config["regularization"])
        step = driver.make_train_step(rec, opt, config)
        state = opt.init({k: p.detach() for k, p in
                          rec.parameters().items()})
        gen = driver.noise_generator("cpu", 1234, 0)
        kwargs = {"generator": gen}
        if explicit:
            noise, mask = driver.regularization_draws(
                rec, config, tb[0].shape, driver.noise_generator("cpu",
                                                                 1234, 0))
            kwargs.update(weight_noise=noise, dropout_mask=mask)
            assert abs(float(mask.float().mean()) - 0.5) < 0.2
        state, mon = step(state, *tb, **kwargs)
        results.append(({k: float(v) for k, v in mon.items()},
                        rec.param_path_dict()))
    assert results[0][0] == results[1][0]
    for k, v in results[0][1].items():
        np.testing.assert_array_equal(v, results[1][1][k], err_msg=k)


def test_dropout_matches_flax():
    """``bottom_dropout`` is flax's ``nn.Dropout(0.5)`` on a given mask:
    kept values doubled, bit for bit."""
    x = torch.from_numpy(np.random.RandomState(0).randn(3, 7, 5)
                         .astype(np.float32))
    mask = draw_dropout_mask(x.shape, torch.Generator().manual_seed(2))
    got = bottom_dropout(x, mask)
    ref = np.where(mask.numpy(), x.numpy() / np.float32(0.5), 0)
    np.testing.assert_array_equal(got.numpy(), ref)


def _adaptive(dropout):
    net = dict(NET, dropout=dropout)
    return {"net": net, "regularization": {
        "dropout": dropout, "adaptive_noise": {
            "init_sigma": 1e-2, "model_cost_coefficient": 0.1,
            "num_examples": 20}},
        "training": {"rules": ["adadelta"], "decay_rate": 0.95,
                     "epsilon": 1e-6, "gradient_threshold": 100.0}}


def test_adaptive_noise_applies_no_dropout():
    """An adaptive-noise config with ``dropout: true`` steps as the same
    config without it, in both packages, and the two agree."""
    batch = _batch()
    tb = [torch.from_numpy(a) for a in batch]
    tb[2] = tb[2].long()
    jmons, mons = {}, {}
    for dropout in (False, True):
        config = _adaptive(dropout)
        jrec = JaxRecognizer(dict(config["net"], input_num_chars={}),
                             init_config=INIT, seed=7)
        jax_driver.init_adaptive_noise_params(jrec, 1e-2)
        jopt = jax_build_optimizer(config["training"],
                                   config["regularization"])
        jstep = jax.jit(jax_driver.make_train_step(jrec, jopt, config, EOS,
                                                   "recordings"))
        key = jax.random.PRNGKey(5)
        flat, _ = jax.tree_util.tree_flatten_with_path(
            jrec.params["params"])
        keys = jax.random.split(key, len(flat))
        noise = {"/recognizer/" + "/".join(p.key for p in path):
                 torch.from_numpy(np.asarray(
                     jax.random.normal(k, leaf.shape, leaf.dtype)))
                 for (path, leaf), k in zip(flat, keys)}
        _, _, jmon = jstep(jrec.params, jopt.init(jrec.params), key,
                           *map(jnp.asarray, batch))
        rec = SpeechRecognizer(config["net"], device="cpu")
        load_path_dict(rec.net, {
            k: v for k, v in param_path_dict(jrec.params).items()
            if k.startswith("/recognizer/")})
        opt = build_optimizer(config["training"], config["regularization"])
        step = driver.make_train_step(rec, opt, config)
        _, mon = step(opt.init(rec.optimized()), *tb, noise=noise)
        jmons[dropout] = {k: float(v) for k, v in jmon.items()}
        mons[dropout] = {k: float(v) for k, v in mon.items()}
    assert jmons[True] == jmons[False]
    assert mons[True] == mons[False]
    for k, v in jmons[True].items():
        np.testing.assert_allclose(mons[True][k], v, err_msg=k, **TOL)


def _run(config, batches, save, num_epochs, load_path=None):
    rec = SpeechRecognizer(config["net"], init_config=INIT, seed=7,
                           device="cpu")
    opt = build_optimizer(config["training"], config["regularization"])
    loop = driver.run_training(rec, opt, lambda: batches, save, config,
                               num_epochs=num_epochs, printing=False,
                               load_path=load_path,
                               use_load_ext=load_path is not None)
    return rec, loop


def test_resumed_run_repeats_the_straight_run(tmp_path):
    config = _config(True, NOISE)
    batches = []
    for seed in (3, 4):
        x, xm, y, ym = _batch(seed)
        batches.append({"recordings": x, "recordings_mask": xm,
                        "labels": y, "labels_mask": ym})
    rec, straight = _run(config, batches, str(tmp_path / "s.zip"), 2)
    _run(config, batches, str(tmp_path / "r.zip"), 1)
    back, resumed = _run(config, batches, str(tmp_path / "r.zip"), 2,
                         load_path=str(tmp_path / "r.zip"))
    assert resumed.log.status["resumed_from"] == str(tmp_path / "r.zip")
    times, costs = straight.log.channel("train_cost")
    assert times == [1, 2, 3, 4]
    assert resumed.log.channel("train_cost") == (times, costs)
    for k, v in rec.param_path_dict().items():
        np.testing.assert_array_equal(back.param_path_dict()[k], v,
                                      err_msg=k)


@pytest.fixture
def toy(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_toy_dataset import make_toy_dataset
    make_toy_dataset(str(tmp_path / "toy.h5"), num_examples=20,
                     num_chars=4, feat_dim=5, max_len=4, seed=5)
    text = open(os.path.join(ROOT, "tests", "configs", "toy.yaml")).read()
    path = tmp_path / "toy.yaml"
    path.write_text(text.replace("/tmp/toy.h5", str(tmp_path / "toy.h5")))
    return path


def test_cli_trains_with_dropout_noise_and_plot(toy, tmp_path, caplog):
    caplog.set_level(logging.WARNING)
    plot = tmp_path / "curves"
    loop = run.main(["train", str(tmp_path / "m.zip"), str(toy),
                     "net.dim_dec", "8", "net.dims_bidir", "[6]",
                     "net.dim_matcher", "8", "net.post_merge_dims", "[8]",
                     "data.batch_size", "4", "training.num_batches", "3",
                     "regularization.dropout", "true",
                     "regularization.noise", "0.01",
                     "monitoring.plot",
                     f"{{path: {plot}, every_n_batches: 1}}",
                     "--fast-start", "--device", "cpu"])
    warned = [r.getMessage() for r in caplog.records
              if r.levelno == logging.WARNING]
    assert warned == []
    series = json.loads((tmp_path / "curves.json").read_text())
    times, costs = loop.log.channel("train_cost")
    assert times == [1, 2, 3]
    assert series["train_cost"] == [[t, c] for t, c in zip(times, costs)]
    assert np.isfinite(costs).all()
