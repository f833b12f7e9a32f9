"""The ICLR'16 task loss and the logistic/relu energy normalizers in the
port vs the JAX package (CPU, f32 both sides, tiny widths).

* the ``mse_gain`` / ``mse_reward`` cost graph (costs, the two losses,
  the gain and reward matrices, every gradient), fed the labels or a
  prediction of another length, on content and conv attention;
* logistic and relu attention: the cost graph under ``use_pallas``
  "interpret" (the JAX training kernels in interpret mode; the port's
  plain ``decoder_scan_train``) and "never" (the module scans), the
  decode's glimpse, and a relu row whose weights are all zero;
* the loop decode's plain version with the ``mse_cost`` and logistic /
  relu branches vs the JAX kernel in interpret mode (a relu all-zero row
  included), and the beam search of an ``mse_gain`` logistic model vs
  JAX's ``BeamSearch``;
* greedy and mixed exploration steps vs JAX's ``make_train_step`` (the
  mixed coin fixed on both sides), and the port's own determinism;
* the search's routing predicate, and the configs this port now builds.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import FLAGSHIP_NET, _tiny_net_config
from attention_lvcsr_tpu.models.attention import \
    SequenceContentAndConvAttention as JaxConvAttention
from attention_lvcsr_tpu.models.recognizer import \
    SpeechRecognizer as JaxRecognizer
from attention_lvcsr_tpu.models.recognizer import (param_path_dict,
                                                   params_from_path_dict)
from attention_lvcsr_tpu.ops.pallas.beam_loop import \
    beam_search_loop as jax_beam_search_loop
from attention_lvcsr_tpu.search.beam import \
    DecodeConstraint as JaxDecodeConstraint
from attention_lvcsr_tpu.train.driver import \
    make_train_step as jax_make_train_step
from attention_lvcsr_tpu.train.rules import \
    build_optimizer as jax_build_optimizer
from attention_lvcsr_torch.config import Configuration
from attention_lvcsr_torch.models import generator as generator_mod
from attention_lvcsr_torch.models.attention import \
    SequenceContentAndConvAttention
from attention_lvcsr_torch.models.params import load_path_dict
from attention_lvcsr_torch.models.recognizer import (SpeechRecognizer,
                                                     unported_piece)
from attention_lvcsr_torch.ops.beam_loop import beam_search_loop
from attention_lvcsr_torch.search import beam as beam_mod
from attention_lvcsr_torch.search.beam import DecodeConstraint
from attention_lvcsr_torch.train.driver import (make_train_step,
                                                unported_training)
from attention_lvcsr_torch.train.rules import build_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
EOS = 4
MEDIAN = {"type": "window_around_median", "before": 2, "after": 2}
NET = dict(
    input_dims={"recordings": 5}, eos_label=EOS, num_phonemes=5, dim_dec=8,
    dims_bidir=[6], enc_transition="gru", dec_transition="gru",
    attention_type="content_and_conv", conv_n=2,
    use_states_for_readout=False, criterion={"name": "log_likelihood"},
    bottom={"bottom_class": "speech"}, subsample=[2], prior=MEDIAN,
    post_merge_dims=[10], max_decoded_length_scale=1.0)
INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.3],
                        "biases_init": ["isotropic_gaussian", 0.1],
                        "rec_weights_init": ["orthogonal"]}}
B, T, TL = 3, 10, 5
# relu keeps a positive energy bias so that its windows are not all zero
# (the all-zero rows have their own tests below)
ENERGY_BIAS = {"logistic": None, "relu": 3.0}


def _data(seed=1):
    rng = np.random.RandomState(seed)
    inputs = rng.randn(B, T, 5).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([[T], [T - 3], [T]])).astype("f")
    labels = rng.randint(0, EOS, size=(B, TL)).astype(np.int32)
    labels[np.arange(B), [4, 2, 2]] = EOS      # rows end with EOS
    lmask = (np.arange(TL)[None] < np.array([[TL], [3], [3]])).astype("f")
    return inputs, mask, labels, lmask


def _pair(cfg, use_pallas="never", energy_bias=None, seed=7):
    """(JAX recognizer, port recognizer) with the same weights."""
    jrec = JaxRecognizer(dict(cfg, input_num_chars={},
                              use_pallas=use_pallas),
                         init_config=INIT, seed=seed)
    params = param_path_dict(jrec.params)
    if energy_bias is not None:
        key = "/recognizer/generator/attention/energy_comp/bias"
        params[key] = np.full_like(params[key], energy_bias)
        jrec.params = params_from_path_dict(params)
    rec = SpeechRecognizer(dict(cfg, use_pallas=use_pallas), device="cpu")
    load_path_dict(rec.net, params)
    return jrec, rec


def _cost_pair(cfg, use_pallas, data, prediction=None, energy_bias=None):
    """JAX and port cost dicts and gradients of the summed costs."""
    jrec, rec = _pair(cfg, use_pallas, energy_bias)
    jdata = [jnp.asarray(a) for a in data]
    extra = ([jnp.asarray(a) for a in prediction]
             if prediction is not None else [])
    net = jrec.net

    def cost(p):
        out = net.apply(p, *jdata, *extra, method=net.cost)
        return out["costs"].sum(), out

    (_, ref), jgrads = jax.value_and_grad(cost, has_aux=True)(jrec.params)
    rec.net.requires_grad_(True)
    t = [torch.from_numpy(a) for a in data]
    t[2] = t[2].long()
    pred = ([torch.from_numpy(prediction[0]).long(),
             torch.from_numpy(prediction[1])]
            if prediction is not None else [None, None])
    out = rec.net.cost(*t, *pred, train=True)
    out["costs"].sum().backward()
    grads = {k: p.grad for k, p in rec.parameters().items()}
    return ref, param_path_dict(jgrads), out, grads


def _assert_grads(grads, ref_grads):
    """Every gradient within 1e-5 of the largest one (the bias's gradient
    sums every step and frame of a cost in the hundreds)."""
    assert set(grads) == set(ref_grads)
    scale = max(max(float(np.abs(g).max()) for g in ref_grads.values()), 1.0)
    for key, g in grads.items():
        np.testing.assert_allclose(g.numpy() / scale, ref_grads[key] / scale,
                                   err_msg=key, **TOL)


MSE_MODELS = {
    "content": dict(attention_type="content", prior=None),
    "conv": {},
    "conv-logistic": dict(energy_normalizer="logistic"),
}


@pytest.mark.parametrize("fed", ["labels", "prediction"])
@pytest.mark.parametrize("model", sorted(MSE_MODELS))
@pytest.mark.parametrize("criterion", ["mse_gain", "mse_reward"])
def test_mse_cost_and_gradients_match_jax(criterion, model, fed):
    cfg = dict(NET, criterion={"name": criterion, "min_reward": -3},
               **MSE_MODELS[model])
    data = _data()
    prediction = None
    if fed == "prediction":
        rng = np.random.RandomState(5)
        pred = rng.randint(0, EOS + 1, size=(B, TL + 3)).astype(np.int32)
        prediction = (pred, np.ones((B, TL + 3), np.float32))
    ref, ref_grads, out, grads = _cost_pair(cfg, "never", data, prediction)
    for key in ("gain_matrix", "reward_matrix"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    assert float(out["gain_matrix"].min()) >= -3
    for key in ("costs", "readouts", "gain_mse_loss", "reward_mse_loss"):
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(ref[key]), err_msg=key,
                                   rtol=1e-5, atol=1e-4)
    _assert_grads(grads, ref_grads)


@pytest.mark.parametrize("use_pallas", ["interpret", "never"])
@pytest.mark.parametrize("normalizer", ["logistic", "relu"])
def test_normalizer_cost_and_gradients_match_jax(normalizer, use_pallas,
                                                 monkeypatch):
    cfg = dict(NET, energy_normalizer=normalizer)
    calls = []
    real = generator_mod.decoder_scan_train
    monkeypatch.setattr(generator_mod, "decoder_scan_train",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    ref, ref_grads, out, grads = _cost_pair(
        cfg, use_pallas, _data(2), energy_bias=ENERGY_BIAS[normalizer])
    # the route taken: the training decoder, with the normalizer and bias
    assert bool(calls) == (use_pallas != "never")
    if calls:
        assert calls[0]["normalizer"] == normalizer
        assert calls[0]["e_bias"] is not None
    for key in ("costs", "weights", "energies"):
        got = out[key].detach().numpy()
        assert np.isfinite(got).all(), key
        np.testing.assert_allclose(got, np.asarray(ref[key]), err_msg=key,
                                   **TOL)
    assert "/recognizer/generator/attention/energy_comp/bias" in grads
    _assert_grads(grads, ref_grads)


def _glimpse_pair(normalizer, bias, beam=1):
    """The JAX and port conv attention modules with the same weights, and
    one glimpse of each from the same inputs."""
    rng = np.random.RandomState(4)
    U, L, D, M, S = 2, 9, 6, 5, 4
    attended = rng.randn(U, L, D).astype(np.float32)
    amask = np.ones((U, L), np.float32)
    amask[1, 6:] = 0
    states = rng.randn(U * beam, S).astype(np.float32)
    w = rng.rand(U * beam, L).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    glimpses = {"weights": w, "step": np.full((U * beam,), 2, np.int32)}
    jatt = JaxConvAttention(state_names=("states",), attended_dim=D,
                            match_dim=M, conv_n=2, prior=MEDIAN,
                            energy_normalizer=normalizer, use_pallas="never")
    jg = {"weights": jnp.asarray(w), "step": jnp.asarray(glimpses["step"]),
          "weighted_averages": jnp.zeros((U * beam, D)),
          "energies": jnp.zeros((U * beam, L))}
    call = lambda m, *a: m.take_glimpses(*a, beam=beam)
    args = (jnp.asarray(attended), None, jnp.asarray(amask), jg,
            {"states": jnp.asarray(states)})
    params = jatt.init(jax.random.PRNGKey(1), *args, method=call)
    flat = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    params_np = {"/".join(p.key for p in path): np.asarray(v)
                 for path, v in flat}
    params_np["energy_comp/bias"] = np.full((1,), bias, np.float32)
    params = {"params": _unflatten(params_np)}
    ref = jatt.apply(params, *args, method=call)
    att = SequenceContentAndConvAttention(("states",), S, D, M, 2,
                                          prior=MEDIAN,
                                          energy_normalizer=normalizer)
    names = {"preprocess": "preprocessor"}
    with torch.no_grad():
        for key, value in params_np.items():
            target = att
            for part in key.split("/"):
                target = getattr(target, names.get(part, part))
            target.copy_(torch.from_numpy(np.array(value)))
        t = lambda a: torch.from_numpy(np.asarray(a))
        got = att.take_glimpses(
            t(attended), att.preprocess(t(attended)), t(amask),
            {"weights": t(w), "step": t(glimpses["step"])},
            {"states": t(states)}, beam=beam)
    return got, ref


def _unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return tree


@pytest.mark.parametrize("beam", [1, 3])
@pytest.mark.parametrize("normalizer,bias", [("logistic", 0.3),
                                             ("relu", 2.0)])
def test_glimpse_matches_jax(normalizer, bias, beam):
    """The module-driven glimpse: the energies (through
    ``beam_attention_energies`` at beam > 1, with the bias) and the
    weights."""
    got, ref = _glimpse_pair(normalizer, bias, beam)
    for key in ("energies", "weights", "weighted_averages"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   err_msg=key, **TOL)


def test_relu_all_zero_rows_match_jax():
    """A large negative bias makes every relu numerator zero: the rows
    whose window is live divide 0 by 0 in both packages (NaN), the rows
    without a live frame get zero weights."""
    got, ref = _glimpse_pair("relu", -50.0)
    gw, rw = got["weights"].numpy(), np.asarray(ref["weights"])
    assert np.isnan(rw).any()
    np.testing.assert_array_equal(np.isnan(gw), np.isnan(rw))
    np.testing.assert_allclose(gw[~np.isnan(rw)], rw[~np.isnan(rw)])


# ---- the loop decode's branches vs the JAX kernel in interpret mode ----

LOOP_NET = dict(NET, dims_bidir=[7], subsample=[1], data_prepend_eos=False,
                prior={"type": "window_around_median", "before": 3,
                       "after": 3})
LOOP_CASES = {
    "mse-logistic": (dict(energy_normalizer="logistic",
                          criterion={"name": "mse_gain"}), 0.5),
    "logistic": (dict(energy_normalizer="logistic"), 0.5),
    "relu": (dict(energy_normalizer="relu"), 1.0),
    # every numerator zero: the rows lose the selection after step one
    "relu-all-zero": (dict(energy_normalizer="relu"), -50.0),
    "mse-content": (dict(attention_type="content", prior=None,
                         criterion={"name": "mse_reward"}), None),
}


def _loop_inputs(case):
    over, bias = LOOP_CASES[case]
    cfg = dict(LOOP_NET, **over)
    jrec, rec = _pair(cfg, "interpret", bias)
    p = jrec.params["params"]["generator"]["readout"]["post_merge_0"]
    p["bias"] = p["bias"].at[EOS].add(1.5)
    load_path_dict(rec.net, param_path_dict(jrec.params))
    rng = np.random.RandomState(3)
    x = rng.randn(3, 16, 5).astype(np.float32)
    m = (np.arange(16)[None] < np.array([[16], [12], [0]])).astype("f")
    data = jrec.net.apply(jrec.params, x, m, method=jrec.net.decode_loop)
    L = data["attended"].shape[1]
    tables = jrec.net.apply(jrec.params, L, jnp.float32,
                            method=jrec.net.decode_loop_tables)
    return cfg, jrec, rec, data, tables, x, m


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_loop_branches_match_jax_interpret(case):
    cfg, jrec, rec, data, tables, _, _ = _loop_inputs(case)
    content = cfg["attention_type"] == "content"
    normalizer = cfg.get("energy_normalizer") or "softmax"
    mse = cfg["criterion"]["name"].startswith("mse")
    L = data["attended"].shape[1]
    prior = ({"type": "expanding", "initial_end": float(L) + 1.0}
             if content else cfg["prior"])
    kw = dict(beam=3, max_len=12, eol=EOS, char_discount=0.1,
              prior=prior["type"],
              before=float(prior.get("before", 0.0)),
              after=float(prior.get("after", 0.0)),
              initial_end=float(prior.get("initial_end", 1e4)),
              content_attention=content)
    ref_out, ref_meta, ref_steps = (np.asarray(a) for a in
                                    jax_beam_search_loop(
        data["pre"], data["attended"], data["attended_mask"], tables,
        normalizer=normalizer, mse_cost=mse, interpret=True, **kw))
    t = lambda a: torch.from_numpy(np.array(a))
    port_tables = rec.net.decode_loop_tables()
    assert ("energy_b" in port_tables) == (normalizer != "softmax")
    with torch.no_grad():
        out, meta, steps = beam_search_loop(
            t(data["pre"]), t(data["attended"]), t(data["attended_mask"]),
            port_tables, normalizer=normalizer, mse_cost=mse, **kw)
    valid = ref_meta[:, :, 1] < 1e9 / 2
    if case != "relu-all-zero":
        assert valid.any(), "vacuous: nothing finished"
    np.testing.assert_array_equal(out.numpy(), ref_out)
    np.testing.assert_array_equal(meta.numpy()[:, :, 2], ref_meta[:, :, 2])
    np.testing.assert_array_equal(steps.numpy(), ref_steps)
    np.testing.assert_allclose(meta.numpy()[:, :, :2], ref_meta[:, :, :2],
                               rtol=1e-5, atol=1e-5)


def test_beam_search_of_an_mse_logistic_model_matches_jax():
    """``SpeechRecognizer.beam_search``: the port's loop route (the plain
    loop on the CPU) and its module route (``use_pallas: never``) against
    the JAX package's search (its module route on the CPU): identical
    hypotheses, costs within 1e-4."""
    cfg, jrec, rec, _, _, x, m = _loop_inputs("mse-logistic")
    jrec.init_beam_search(4)
    rec.init_beam_search(4)
    kw = dict(char_discount=0.2, round_to_inf=4.5)
    found = 0
    for u in range(2):
        ref_h, ref_c = jrec.beam_search(x[u, :int(m[u].sum())], **kw)
        got_h, got_c = rec.beam_search(x[u, :int(m[u].sum())], **kw)
        core = SpeechRecognizer(dict(cfg, use_pallas="never"),
                                device="cpu")
        load_path_dict(core.net, rec.param_path_dict())
        core.init_beam_search(4)
        core_h, core_c = core.beam_search(x[u, :int(m[u].sum())], **kw)
        for h, c in ((got_h, got_c), (core_h, core_c)):
            assert [list(map(int, o)) for o in h] == \
                [list(map(int, o)) for o in ref_h]
            np.testing.assert_allclose(c, ref_c, rtol=1e-4, atol=1e-4)
        found += len(ref_h)
    assert found


# ---- exploration ---------------------------------------------------------

def _train_config(exploration, criterion="mse_gain"):
    net = dict(NET, energy_normalizer="logistic",
               criterion={"name": criterion, "min_reward": -2},
               use_pallas="never")
    return {"net": net,
            "training": {"rules": ["adadelta"], "decay_rate": 0.95,
                         "epsilon": 1e-6, "gradient_threshold": 1.0,
                         "exploration": exploration},
            "regularization": {"max_norm": 0.8}}


def _steps(exploration, n=2, coin_of=None):
    """``n`` steps of both packages from the same parameters and batch;
    ``coin_of(rng)`` gives the mixed coin JAX draws from a step's key."""
    config = _train_config(exploration)
    batch = _data(3)
    jrec = JaxRecognizer(dict(config["net"], input_num_chars={}),
                         init_config=INIT, seed=7)
    jopt = jax_build_optimizer(config["training"], config["regularization"])
    jstep = jax.jit(jax_make_train_step(jrec, jopt, config, EOS,
                                        "recordings"))
    jparams, jstate = jrec.params, jopt.init(jrec.params)
    rec = SpeechRecognizer(config["net"], device="cpu")
    load_path_dict(rec.net, param_path_dict(jparams))
    opt = build_optimizer(config["training"], config["regularization"])
    step = make_train_step(rec, opt, config)
    state = opt.init({k: p.detach() for k, p in rec.parameters().items()})
    tb = [torch.from_numpy(a) for a in batch]
    tb[2] = tb[2].long()
    for i in range(n):
        key = jax.random.PRNGKey(i)
        jparams, jstate, jmon = jstep(jparams, jstate, key,
                                      *map(jnp.asarray, batch))
        coin = None if coin_of is None else coin_of(key)
        state, mon = step(state, *tb, coin=coin)
        yield i, jmon, mon, param_path_dict(jparams), rec


def _expl_coin(key):
    _, _, expl = jax.random.split(key, 3)
    return torch.from_numpy(np.asarray(
        jax.random.bernoulli(expl, 0.5, (B,))))


@pytest.mark.parametrize("exploration", ["greedy", "mixed"])
def test_exploration_steps_match_jax(exploration):
    coin_of = _expl_coin if exploration == "mixed" else None
    for i, jmon, mon, ref, rec in _steps(exploration, coin_of=coin_of):
        for k in ("train_cost", "total_gradient_norm", "total_step_norm",
                  "mask_density", "weights_entropy_per_label"):
            np.testing.assert_allclose(float(mon[k]), float(jmon[k]),
                                       err_msg=f"step {i}: {k}", **TOL)
        assert set(jmon) <= set(mon)
        for k, p in rec.param_path_dict().items():
            np.testing.assert_allclose(p, ref[k], err_msg=f"step {i}: {k}",
                                       **TOL)


def test_mixed_exploration_is_deterministic():
    """The same seed gives the same bits: two runs of two mixed steps
    whose coins come from ``noise_generator``-style generators."""
    config = _train_config("mixed")
    tb = [torch.from_numpy(a) for a in _data(3)]
    tb[2] = tb[2].long()
    runs = []
    for _ in range(2):
        rec = SpeechRecognizer(config["net"], init_config=INIT, seed=7,
                               device="cpu")
        opt = build_optimizer(config["training"], config["regularization"])
        step = make_train_step(rec, opt, config)
        state = opt.init({k: p.detach() for k, p in
                          rec.parameters().items()})
        mons = []
        for i in range(2):
            gen = torch.Generator().manual_seed(1234 * 2 ** 32 + i)
            state, mon = step(state, *tb, generator=gen)
            mons.append({k: float(v) for k, v in mon.items()})
        runs.append((mons, rec.param_path_dict()))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        np.testing.assert_array_equal(v, runs[1][1][k])


# ---- routing and configs -------------------------------------------------

def test_loop_route_falls_back_from_what_the_kernel_cannot_hold():
    """JAX's rule: beams up to 512 take the loop kernel (past a block's
    shared memory its workspace instance), inputs whose L x L tables pass
    JAX's budget do not."""
    cfg = dict(FLAGSHIP_NET, num_phonemes=32, eos_label=31)
    assert beam_mod.loop_route(cfg, 10, 800)
    assert beam_mod.loop_route(cfg, 20, 800)
    # 3200 frames: L = 800
    assert beam_mod.loop_route(cfg, 10, 3200)
    # 16000 frames: L = 4000, whose tables pass 1.5 x 64 MB
    assert not beam_mod.loop_route(cfg, 10, 16000)
    assert not beam_mod.loop_route(dict(cfg, use_pallas="never"), 10, 800)
    assert not beam_mod.loop_route(dict(cfg, lm={"path": "G.fst"}), 10,
                                   800)
    assert not beam_mod.loop_route(dict(cfg, conv_num_filters=17), 10, 800)
    assert not beam_mod.loop_route(dict(cfg, post_merge_dims=[]), 10, 800)
    assert not beam_mod.loop_route(cfg, 513, 8)
    assert beam_mod.loop_route(dict(cfg, energy_normalizer="relu"), 10,
                               800)


def test_a_decode_the_loop_cannot_hold_runs_the_module_route(monkeypatch):
    """A decode past the loop kernel's budget (beam 64 over 3,600 encoded
    frames at tiny widths: JAX's L x L tables alone pass 1.5 x 64 MB)
    takes ``_search_core`` with no exception, and its hypotheses are the
    plain loop's."""
    cfg = dict(NET, max_decoded_length_scale=720.0, subsample=[2])
    rec = SpeechRecognizer(cfg, init_config=INIT, seed=3, device="cpu")
    rec.net.generator.readout.post_merge_0.bias.data[EOS] += 2.0
    x = np.random.RandomState(0).randn(7200, 5).astype(np.float32)
    assert not beam_mod.loop_route(rec.net_config, 64, 7200)
    launched = []
    real = beam_mod.beam_search_loop
    monkeypatch.setattr(beam_mod, "beam_search_loop",
                        lambda *a, **k: launched.append(1) or real(*a, **k))
    rec.init_beam_search(64)
    out = rec.beam_search(x, as_arrays=True, char_discount=0.5)
    assert not launched and np.ndim(out["steps"]) == 0
    monkeypatch.setattr(beam_mod, "loop_route", lambda *a: True)
    ref = rec.beam_search(x, as_arrays=True, char_discount=0.5)
    assert launched
    valid = ref["done_valid"][0]
    assert valid.any()
    np.testing.assert_array_equal(out["done_valid"][0], valid)
    for k in np.nonzero(valid)[0]:
        n = ref["done_len"][0, k]
        assert out["done_len"][0, k] == n
        np.testing.assert_array_equal(out["done_out"][0, k, :n],
                                      ref["done_out"][0, k, :n])
    np.testing.assert_allclose(out["done_cost"][0][valid],
                               ref["done_cost"][0][valid], rtol=1e-5)


UNLOCKED = ["exp/wsj/configs/wsj_reward%s.yaml" % s for s in (
    "", "1", "1f", "2", "3", "4", "5", "6", "10", "11", "_mixed")] + [
    "exp/timit/configs/iclr_reward.yaml",
    "exp/timit/configs/nips_smooth.yaml"]


def _stages(path):
    conf = Configuration(os.path.join(ROOT, path))
    if getattr(conf, "multi_stage", False):
        return list(conf.ordered_stages.values())
    return [conf]


@pytest.mark.parametrize("path", UNLOCKED)
def test_task_loss_configs_are_ported(path):
    for stage in _stages(path):
        assert unported_piece(stage["net"]) is None
        assert unported_training(stage) is None


@pytest.mark.parametrize("path,override,piece", [
    ("exp/wsj/configs/wsj_jan_debug.yaml", {"dec_transition": "lstm"},
     "GRU"),
    ("exp/wsj/configs/wsj_jan_wsj13v2.yaml", {"dims_top": [8]}, "dims_top"),
])
def test_other_configs_still_refused(path, override, piece):
    """The stacked recipes pass since their decoder is ported; a piece no
    config uses is still named on them."""
    for s in _stages(path):
        assert unported_piece(s["net"]) is None
        assert piece in (unported_piece(dict(s["net"], **override)) or "")



def test_constrained_decode_of_a_logistic_model_takes_the_module_route():
    """Under ``use_pallas: fused`` a logistic model's constrained decode
    keeps the module-driven glimpse (the fused score step is softmax
    only, as JAX's ``fused_score_supported``) and finds JAX's finished
    hypotheses."""
    chars = [chr(ord("a") + i) for i in range(26)] + [
        "<spc>", "'", ".", "-", "<bol>", "<eol>"]
    char_map = {c: i for i, c in enumerate(chars)}
    cfg = dict(_tiny_net_config(), energy_normalizer="logistic")
    jrec, rec = _pair(cfg, "fused", energy_bias=0.2)
    assert not rec.net.generator.fused_score_supported()
    jrec.params["params"]["generator"]["readout"]["post_merge_0"]["bias"] = \
        jrec.params["params"]["generator"]["readout"]["post_merge_0"][
            "bias"].at[31].add(3.0)
    load_path_dict(rec.net, param_path_dict(jrec.params))
    words = ["ab", "bad", "cab", "dd", "e"]
    rng = np.random.RandomState(4)
    x = rng.randn(2, 41, 12).astype(np.float32)
    m = (np.arange(41)[None] < np.array([[41], [33]])).astype("f")
    for r in (jrec, rec):
        r.init_beam_search(4)
    ref = jrec.beam_search(x, m, as_arrays=True, char_discount=0.1,
                           validate_solution_function=JaxDecodeConstraint
                           .from_words(words, char_map, 32))
    got = rec.beam_search(x, m, as_arrays=True, char_discount=0.1,
                          validate_solution_function=DecodeConstraint
                          .from_words(words, char_map, 32))
    valid = np.asarray(ref["done_valid"])[:2]
    assert valid.any()
    np.testing.assert_array_equal(got["done_valid"][:2], valid)
    for u, k in zip(*np.nonzero(valid)):
        n = int(ref["done_len"][u, k])
        assert int(got["done_len"][u, k]) == n
        np.testing.assert_array_equal(got["done_out"][u, k, :n],
                                      np.asarray(ref["done_out"])[u, k, :n])
    np.testing.assert_allclose(got["done_cost"][:2][valid],
                               np.asarray(ref["done_cost"])[:2][valid],
                               rtol=1e-5, atol=1e-5)
