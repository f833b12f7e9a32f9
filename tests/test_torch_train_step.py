"""The port's training step vs the JAX package's (CPU, f32 both sides).

Each rule of ``build_optimizer`` is held to the JAX package's optax chain
on the same parameters and gradients over three updates; then three steps
of ``make_train_step`` on the tiny config, from the same numpy parameters
and batch, with gradient clipping, max-norm, the monotonicity penalty and
weight decay: every monitor and every updated parameter agree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_lvcsr_tpu.models.recognizer import \
    SpeechRecognizer as JaxRecognizer
from attention_lvcsr_tpu.models.recognizer import (param_path_dict,
                                                   params_from_path_dict)
from attention_lvcsr_tpu.train.driver import \
    make_train_step as jax_make_train_step
from attention_lvcsr_tpu.train.rules import \
    build_optimizer as jax_build_optimizer
from attention_lvcsr_torch.models.params import load_path_dict
from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
from attention_lvcsr_torch.train.driver import make_train_step, weight_leaf
from attention_lvcsr_torch.train.rules import (build_optimizer,
                                               load_state_arrays,
                                               state_arrays)

TOL = dict(rtol=1e-5, atol=1e-6)

RULE_CASES = {
    "adadelta-clip": ({"rules": ["adadelta"], "decay_rate": 0.95,
                       "epsilon": 1e-6, "gradient_threshold": 0.5}, {}),
    "momentum-maxnorm": ({"rules": ["momentum"], "scale": 0.1,
                          "momentum": 0.9}, {"max_norm": 0.3}),
    "rmsprop-schedule": ({"rules": ["rmsprop"], "scale": 0.01,
                          "scale_schedule": [[1, 0.5], [2, 0.1]]}, {}),
    "adam-burn-in": ({"rules": ["adam"], "scale": 0.01,
                      "burn_in_steps": 1}, {}),
    "adagrad-maxnorm-no-lookup": ({"rules": ["adagrad"], "scale": 0.05},
                                  {"max_norm": 0.3,
                                   "max_norm_exclude_lookup": True}),
}


def _tree(rng):
    shapes = {"/recognizer/a/kernel": (4, 3), "/recognizer/a/bias": (3,),
              "/recognizer/feedback/lookup/embedding": (5, 3),
              "/recognizer/cell/state_to_state": (3, 3),
              "/recognizer/attention/conv_filters": (1, 5)}
    return {k: (rng.randn(*s) * 0.5).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_rule_chain_matches_optax(case):
    train_conf, reg_conf = RULE_CASES[case]
    rng = np.random.RandomState(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    grads[2]["/recognizer/a/bias"][0] = np.nan    # RemoveNotFinite
    jopt = jax_build_optimizer(train_conf, reg_conf)
    jp = params_from_path_dict(params)["params"]
    jstate = jopt.init(jp)
    topt = build_optimizer(train_conf, reg_conf)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    tstate = topt.init(tp)
    for g in grads:
        jg = params_from_path_dict(g)["params"]
        jupd, jstate = jopt.update(jg, jstate, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, jupd)
        tupd, tstate = topt.update({k: torch.tensor(v) for k, v in
                                    g.items()}, tstate, tp)
        tp = {k: tp[k] + u for k, u in tupd.items()}
        ref = param_path_dict({"params": jp})
        for k, v in tp.items():
            np.testing.assert_allclose(v.numpy(), ref[k], err_msg=k, **TOL)
    # the state is savable: flattened and loaded back it is the same
    back = load_state_arrays(topt.init(tp), state_arrays(tstate))
    for k, v in state_arrays(back).items():
        np.testing.assert_array_equal(v, state_arrays(tstate)[k])


NET = dict(
    input_dims={"recordings": 5}, eos_label=4, num_phonemes=5, dim_dec=8,
    dims_bidir=[6], enc_transition="gru", dec_transition="gru",
    attention_type="content_and_conv", conv_n=2,
    use_states_for_readout=True, criterion={"name": "log_likelihood"},
    bottom={"bottom_class": "speech"}, subsample=[2],
    post_merge_dims=[10], max_decoded_length_scale=1.0,
    prior={"type": "window_around_median", "before": 2, "after": 2},
    use_pallas="never")
CONFIG = {
    "net": NET,
    "training": {"rules": ["adadelta"], "decay_rate": 0.95,
                 "epsilon": 1e-6, "gradient_threshold": 1.0},
    "regularization": {"max_norm": 0.8, "penalty_coof": 0.5,
                       "decay": 1e-3},
}
INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.3],
                        "biases_init": ["isotropic_gaussian", 0.1],
                        "rec_weights_init": ["orthogonal"]}}


def _batch(seed=3, B=3, T=10, TL=5):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, 5).astype(np.float32),
            (np.arange(T)[None] < np.array([[T], [T - 3], [T]])).astype("f"),
            rng.randint(0, 5, size=(B, TL)).astype(np.int32),
            (np.arange(TL)[None] < np.array([[TL], [TL - 2], [3]])).astype(
                "f"))


def test_three_train_steps_match_jax():
    batch = _batch()
    jnet = dict(NET, input_num_chars={})
    jrec = JaxRecognizer(jnet, init_config=INIT, seed=7)
    jopt = jax_build_optimizer(CONFIG["training"], CONFIG["regularization"])
    jstep = jax.jit(jax_make_train_step(jrec, jopt, CONFIG, 4,
                                        "recordings"))
    jparams, jstate = jrec.params, jopt.init(jrec.params)

    rec = SpeechRecognizer(NET, device="cpu")
    load_path_dict(rec.net, param_path_dict(jparams))
    opt = build_optimizer(CONFIG["training"], CONFIG["regularization"])
    step = make_train_step(rec, opt, CONFIG)
    state = opt.init({k: p.detach() for k, p in rec.parameters().items()})
    tbatch = [torch.from_numpy(a) for a in batch]
    tbatch[2] = tbatch[2].long()
    for i in range(3):
        jparams, jstate, jmon = jstep(jparams, jstate,
                                      jax.random.PRNGKey(i),
                                      *map(jnp.asarray, batch))
        state, mon = step(state, *tbatch)
        assert set(jmon) <= set(mon)
        for k, v in jmon.items():
            np.testing.assert_allclose(float(mon[k]), float(v),
                                       err_msg=f"step {i}: {k}", **TOL)
        ref = param_path_dict(jparams)
        for k, p in rec.param_path_dict().items():
            np.testing.assert_allclose(p, ref[k], err_msg=f"step {i}: {k}",
                                       **TOL)


@pytest.mark.parametrize("path,decayed", [
    ("/recognizer/generator/attention/conv_filters", True),
    ("/recognizer/encoder/bidir0/forward/cell/state_to_gates", True),
    ("/recognizer/generator/feedback/lookup/embedding", True),
    ("/recognizer/generator/readout/merge_bias", False),
    ("/recognizer/encoder/bidir0/forward/cell/initial_state", False),
    ("/recognizer/generator/fork_0_inputs/bias", False),
])
def test_weight_decay_leaves(path, decayed):
    assert weight_leaf(path) is decayed


@pytest.mark.parametrize("reg,train,piece", [
    ({"noise": 0.1}, {}, "weight noise"),
    ({"adaptive_noise": {}}, {}, None),        # an empty section is off
    ({"adaptive_noise": {"init_sigma": 1e-6}}, {}, "adaptive weight noise"),
    ({}, {"exploration": "greedy"}, "exploration 'greedy'"),
    ({}, {"compute_dtype": "bfloat16"}, "compute_dtype 'bfloat16'"),
])
def test_unported_training_pieces_raise(reg, train, piece):
    rec = SpeechRecognizer(NET, device="cpu")
    config = {"regularization": reg, "training": train}
    opt = build_optimizer({}, {})
    if piece is None:
        make_train_step(rec, opt, config)
        return
    with pytest.raises(NotImplementedError, match=piece):
        make_train_step(rec, opt, config)
