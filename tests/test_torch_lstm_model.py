"""The LSTM-encoder recognizer (``enc_transition: LSTM``, GRU decoder) of
the port vs the JAX package's, on the CPU (f32 both sides).

Bit-identical init from the same seed and ``init_config``; a JAX-package
checkpoint loads; ``encode``, the cost and every parameter gradient
(tolerance as ``test_torch_cost.py``: rtol 2e-5, atol 2e-6 through two
scans and their gradients); identical beam-search hypotheses (costs within
1e-5); three training steps (monitors and parameters within rtol 1e-5,
atol 1e-6, as ``test_torch_train_step.py``); a checkpoint the port writes
reads back identical, in the port and in the JAX package.  The JAX side
runs its LSTM kernels in interpret mode (``use_pallas: interpret``); the
port's scans take their plain versions because the tensors lie on the
CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_net_config
from attention_lvcsr_torch.models.cells import LSTM
from attention_lvcsr_torch.models.params import load_path_dict
from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
from attention_lvcsr_torch.train.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
from attention_lvcsr_torch.train.driver import make_train_step
from attention_lvcsr_torch.train.rules import build_optimizer
from attention_lvcsr_tpu.models.recognizer import \
    SpeechRecognizer as JaxRecognizer
from attention_lvcsr_tpu.models.recognizer import (param_path_dict,
                                                   params_from_path_dict)
from attention_lvcsr_tpu.train import checkpoint as jax_checkpoint
from attention_lvcsr_tpu.train.driver import \
    make_train_step as jax_make_train_step
from attention_lvcsr_tpu.train.rules import \
    build_optimizer as jax_build_optimizer

INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.3],
                        "biases_init": ["isotropic_gaussian", 0.1],
                        "rec_weights_init": ["orthogonal"]},
        "/recognizer/encoder": {"initial_states_init":
                                ["isotropic_gaussian", 0.1]}}
COST_TOL = dict(rtol=2e-5, atol=2e-6)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)


def _config(**changes):
    cfg = dict(_tiny_net_config(), enc_transition="LSTM",
               max_decoded_length_scale=1.0)
    cfg.update(changes)
    return cfg


def _pair(cfg, mode="interpret", seed=7):
    """The JAX recognizer and the port's with the JAX one's parameters,
    the peepholes moved off their zero init so that they count."""
    jax_rec = JaxRecognizer(dict(cfg, use_pallas=mode), init_config=INIT,
                            seed=seed)
    params = param_path_dict(jax_rec.params)
    rng = np.random.RandomState(seed)
    for k in params:
        if "W_cell_to" in k:
            params[k] = (rng.randn(*params[k].shape) * 0.3).astype(np.float32)
    jax_rec.params = params_from_path_dict(params)
    port = SpeechRecognizer(dict(cfg, use_pallas=mode), device="cpu")
    load_path_dict(port.net, params)
    return jax_rec, port, params


def _batch(seed=3, B=3, T=13, TL=5, F=12):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, F).astype(np.float32),
            (np.arange(T)[None] < np.array([[T], [T - 4], [T - 1]])).astype(
                "f"),
            rng.randint(0, 31, size=(B, TL)).astype(np.int32),
            (np.arange(TL)[None] < np.array([[TL], [TL - 2], [3]])).astype(
                "f"))


def test_lstm_layers_and_parameter_names():
    port = SpeechRecognizer(_config(), device="cpu")
    cells = [m for m in port.net.encoder.modules() if isinstance(m, LSTM)]
    assert len(cells) == 4                  # 2 layers x 2 directions
    keys = set(port.parameters())
    assert "/recognizer/encoder/bidir0/forward/cell/W_cell_to_out" in keys
    assert "/recognizer/encoder/bidir1/backward/fork_inputs/kernel" in keys


@pytest.mark.parametrize("seed", [1234, 7])
def test_init_bit_identical_to_jax(seed):
    cfg = _config()
    ref = param_path_dict(JaxRecognizer(cfg, init_config=INIT,
                                        seed=seed).params)
    got = SpeechRecognizer(cfg, init_config=INIT, seed=seed,
                           device="cpu").param_path_dict()
    assert sorted(got) == sorted(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_jax_checkpoint_loads(tmp_path):
    cfg = _config()
    jax_rec = JaxRecognizer(cfg, init_config=INIT, seed=3)
    params = param_path_dict(jax.tree.map(lambda a: a + 0.25,
                                          jax_rec.params))
    path = str(tmp_path / "lstm.zip")
    jax_checkpoint.save_checkpoint(path, params)
    port = SpeechRecognizer(cfg, init_config=INIT, seed=3, device="cpu")
    port.load_params(path)
    loaded = port.param_path_dict()
    assert sorted(loaded) == sorted(params)
    for key, value in params.items():
        np.testing.assert_array_equal(loaded[key], value, err_msg=key)


def test_encode_matches_jax():
    jax_rec, port, params = _pair(_config())
    x, m, _, _ = _batch()
    net = jax_rec.net
    ref, ref_mask, _ = net.apply(jax_rec.params,
                                 jnp.asarray(x), jnp.asarray(m),
                                 method=net.encode, fast=True)
    with torch.no_grad():
        got, got_mask = port.net.encode(torch.from_numpy(x),
                                        torch.from_numpy(m))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **COST_TOL)


def test_cost_and_gradients_match_jax():
    jax_rec, port, params = _pair(_config())
    data = _batch()
    net = jax_rec.net

    def cost(p):
        out = net.apply(p, *map(jnp.asarray, data), method=net.cost)
        return out["costs"].sum(), out

    (_, ref), grads = jax.value_and_grad(cost, has_aux=True)(jax_rec.params)
    ref_grads = param_path_dict(grads)
    port.net.requires_grad_(True)
    x, m, labels, lmask = (torch.from_numpy(a) for a in data)
    out = port.cost_fn()(x, m, labels.long(), lmask)
    for key in ("costs", "weights", "energies"):
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(ref[key]), err_msg=key,
                                   **COST_TOL)
    out["costs"].sum().backward()
    got = {k: p.grad for k, p in port.parameters().items()}
    assert set(got) == set(ref_grads)
    assert any("W_cell_to" in k for k in got)
    for key, g in got.items():
        np.testing.assert_allclose(g.numpy(), ref_grads[key], err_msg=key,
                                   **COST_TOL)


def _finished(out):
    return {(u, k): (tuple(out["done_out"][u, k, :out["done_len"][u, k]]),
                     float(out["done_cost"][u, k]))
            for u, k in zip(*np.nonzero(out["done_valid"]))}


@pytest.mark.parametrize("mode", ["interpret", "never"])
def test_beam_search_matches_jax(mode):
    cfg = _config()
    jax_rec, port, params = _pair(cfg, mode)
    eos = cfg["eos_label"]
    p = jax_rec.params["params"]["generator"]["readout"]["post_merge_0"]
    p["bias"] = p["bias"].at[eos].add(3.0)
    port.net.generator.readout.post_merge_0.bias.data[eos] += 3.0
    jax_rec.init_beam_search(4)
    port.init_beam_search(4)
    x, m, _, _ = _batch(seed=5, T=29)
    ref = _finished(jax_rec.beam_search(x, m, as_arrays=True,
                                        char_discount=0.1))
    got = _finished(port.beam_search(x, m, as_arrays=True,
                                     char_discount=0.1))
    assert ref, "vacuous: nothing finished"
    assert sorted(got) == sorted(ref)
    for key, (tokens, cost) in ref.items():
        assert got[key][0] == tokens, key
        np.testing.assert_allclose(got[key][1], cost, rtol=1e-5, atol=1e-5)


def test_three_train_steps_match_jax():
    cfg = _config(prior={"type": "window_around_median", "before": 2,
                         "after": 2})
    config = {"training": {"rules": ["adadelta"], "decay_rate": 0.95,
                           "epsilon": 1e-6, "gradient_threshold": 1.0},
              "regularization": {"max_norm": 0.8}, "net": cfg}
    jax_rec, port, params = _pair(cfg)
    jparams = jax_rec.params
    jopt = jax_build_optimizer(config["training"], config["regularization"])
    jstep = jax.jit(jax_make_train_step(jax_rec, jopt, config,
                                        cfg["eos_label"], "recordings"))
    jstate = jopt.init(jparams)
    opt = build_optimizer(config["training"], config["regularization"])
    step = make_train_step(port, opt, config)
    state = opt.init({k: p.detach() for k, p in port.parameters().items()})
    batch = _batch(seed=4)
    tbatch = [torch.from_numpy(a) for a in batch]
    tbatch[2] = tbatch[2].long()
    for i in range(3):
        jparams, jstate, jmon = jstep(jparams, jstate, jax.random.PRNGKey(i),
                                      *map(jnp.asarray, batch))
        state, mon = step(state, *tbatch)
        for k, v in jmon.items():
            np.testing.assert_allclose(float(mon[k]), float(v),
                                       err_msg=f"step {i}: {k}", **STEP_TOL)
        ref = param_path_dict(jparams)
        for k, p in port.param_path_dict().items():
            np.testing.assert_allclose(p, ref[k], err_msg=f"step {i}: {k}",
                                       **STEP_TOL)


def test_checkpoint_round_trip(tmp_path):
    cfg = _config()
    port = SpeechRecognizer(cfg, init_config=INIT, seed=5, device="cpu")
    path = str(tmp_path / "port.zip")
    save_checkpoint(path, port.param_path_dict())
    state = load_checkpoint(path)
    for k, v in port.param_path_dict().items():
        np.testing.assert_array_equal(state["parameters"][k], v)
    fresh = SpeechRecognizer(cfg, seed=11, device="cpu")
    fresh.load_params(path)
    jax_rec = JaxRecognizer(cfg, seed=9)
    jax_rec.load_params(path)
    theirs = param_path_dict(jax_rec.params)
    for k, v in port.param_path_dict().items():
        np.testing.assert_array_equal(fresh.param_path_dict()[k], v)
        np.testing.assert_array_equal(np.asarray(theirs[k]), v)
