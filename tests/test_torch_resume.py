"""Resuming training with the port (CPU), against itself and the JAX
package.

The toy config (validation every epoch, no search, batches of 2: 8 an
epoch) from one start checkpoint: a port run stopped after epoch 1 and
resumed with ``use_load_ext`` repeats the bits of an uninterrupted
two-epoch run and matches the JAX package's run resumed the same way; the
port resumes from a checkpoint the JAX package wrote (parameters, the
optax state through the mapping unpickler, the log) as the JAX package
resumes from it; ``load_log`` alone restores the log and not the
optimizer state; the JAX package reads the port's log; an optimizer state
the port cannot map raises."""
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from attention_lvcsr_tpu.config import Configuration as JaxConfiguration
from attention_lvcsr_tpu.data import Data as JaxData
from attention_lvcsr_tpu.models.recognizer import param_path_dict
from attention_lvcsr_tpu.train import checkpoint as jax_checkpoint
from attention_lvcsr_tpu.train import driver as jax_driver
from attention_lvcsr_tpu.train import rules as jax_rules
from attention_lvcsr_tpu.train.log import TrainingLog as JaxLog
from attention_lvcsr_torch.config import Configuration
from attention_lvcsr_torch.train import checkpoint, driver, rules

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tiny widths of test_torch_training_services.py, batches of 2
CHANGES = [("net.dim_dec", "8"), ("net.dims_bidir", "[6]"),
           ("net.dim_matcher", "8"), ("net.post_merge_dims", "[8]"),
           ("data.batch_size", "2")]
FILES = ["model.zip", "model_best_ll.zip", "model_best_ll_params.npz",
         "model_params.npz"]
RECORDS = ("valid_sequence_total_cost", "best_valid_sequence_total_cost",
           "average_train_cost", "average_total_gradient_norm",
           "average_weights_entropy_per_label")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The runs the tests compare, by name: each the finished loop and
    its directory."""
    tmp = tmp_path_factory.mktemp("resume")
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_toy_dataset import make_toy_dataset
    make_toy_dataset(str(tmp / "toy.h5"), num_examples=20, num_chars=4,
                     feat_dim=5, max_len=4, seed=5)
    text = open(os.path.join(ROOT, "tests", "configs", "toy.yaml")).read()
    text = text.replace("/tmp/toy.h5", str(tmp / "toy.h5"))
    (tmp / "toy.yaml").write_text(
        text[:text.index("monitoring:")]
        + "monitoring:\n    validate_every_epochs: 1\n")

    def config(package, epochs):
        cls = JaxConfiguration if package == "jax" else Configuration
        return cls(str(tmp / "toy.yaml"), config_changes=CHANGES + [
            ("training.num_epochs", str(epochs))])

    start = str(tmp / "start.zip")
    jconf = config("jax", 1)
    jrec = jax_driver.create_model(jconf, JaxData(**jconf["data"]))
    jax_checkpoint.save_checkpoint(start, param_path_dict(jrec.params))
    out = {}

    def port(name, epochs, params, **kwargs):
        (tmp / name).mkdir(exist_ok=True)
        out[name] = (driver.train(config("port", epochs),
                                  str(tmp / name / "model.zip"), params,
                                  device="cpu", **kwargs), tmp / name)

    def jax(name, epochs, params, **kwargs):
        (tmp / name).mkdir(exist_ok=True)
        out[name] = (jax_driver.train(config("jax", epochs),
                                      str(tmp / name / "model.zip"), params,
                                      **kwargs), tmp / name)

    port("straight", 2, start)
    port("resumed", 1, start)
    shutil.copy(tmp / "resumed" / "model.zip", tmp / "first.zip")
    port("resumed", 2, str(tmp / "resumed" / "model.zip"),
         use_load_ext=True)
    jax("jax", 1, start)
    shutil.copytree(tmp / "jax", tmp / "from_jax")
    shutil.copy(tmp / "jax" / "model.zip", tmp / "jax_first.zip")
    jax("jax", 2, str(tmp / "jax" / "model.zip"), use_load_ext=True)
    port("from_jax", 2, str(tmp / "from_jax" / "model.zip"),
         use_load_ext=True)
    port("load_log", 2, str(tmp / "first.zip"), load_log=True)
    port("fresh", 1, str(tmp / "first.zip"), fast_start=True)
    out["first"] = (None, tmp / "first.zip")
    out["jax_first"] = (None, tmp / "jax_first.zip")
    return out


def _parameters(directory, name):
    return jax_checkpoint.load_parameters(str(directory / name))


def _close_to_jax(ours, theirs):
    """Files, parameters (rtol 1e-4, atol 1e-6) and the records of RECORDS
    at the same iterations (1e-5) of two resumed runs."""
    (ploop, pdir), (jloop, jdir) = ours, theirs
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir)) == FILES
    for name in FILES:
        mine, other = _parameters(pdir, name), _parameters(jdir, name)
        assert set(mine) == set(other)
        for k, v in other.items():
            np.testing.assert_allclose(mine[k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name}: {k}")
    for name in RECORDS:
        times, values = ploop.log.channel(name)
        jtimes, jvalues = jloop.log.channel(name)
        assert times == jtimes and times, name
        np.testing.assert_allclose(np.asarray(values, float),
                                   np.asarray(jvalues, float), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    # the steps after the resumption (the optimizer state carried over)
    for name in ("train_cost", "total_step_norm"):
        times, values = ploop.log.channel(name)
        jtimes, jvalues = jloop.log.channel(name)
        assert times == jtimes == list(range(1, 17))
        np.testing.assert_allclose(values, jvalues, rtol=1e-4, err_msg=name)
    assert ploop.log.status["resumed_from"] == str(pdir / "model.zip")
    assert ploop.log.status["_epoch_ends"] == [8, 16]


def test_resumed_run_repeats_the_uninterrupted_bits(runs):
    (loop, directory), (straight, straight_dir) = (runs["resumed"],
                                                   runs["straight"])
    assert sorted(os.listdir(directory)) == FILES
    for name in FILES:
        mine, other = (_parameters(directory, name),
                       _parameters(straight_dir, name))
        assert set(mine) == set(other)
        assert all(np.array_equal(mine[k], v) for k, v in other.items()), \
            name
    for name in ("train_cost", "total_gradient_norm", "total_step_norm",
                 "valid_sequence_total_cost"):
        assert loop.log.channel(name) == straight.log.channel(name), name
    assert loop.log.status["_epoch_ends"] == \
        straight.log.status["_epoch_ends"] == [8, 16]


def test_resumed_run_matches_jax(runs):
    """The resumed runs of both packages, each from its own checkpoint of
    epoch 1; the first average after the resumption (batch 10) also takes
    batch 8, the last of the run resumed from, in both packages."""
    _close_to_jax(runs["resumed"], runs["jax"])
    times, values = runs["resumed"][0].log.channel("average_train_cost")
    costs = dict(zip(*runs["resumed"][0].log.channel("train_cost")))
    assert times == [10]
    assert values[0] == pytest.approx(np.mean([costs[t] for t in (8, 9, 10)]))


def test_resumes_from_a_jax_checkpoint(runs):
    """The port resumes from the file the JAX package wrote after epoch 1
    (its optax state read through the mapping unpickler), as the JAX
    package resumes from it."""
    state = checkpoint.load_checkpoint(str(runs["jax_first"][1]))
    assert {k.split("/recognizer/")[0] for k in state["opt_state"]} == {
        "1/e_g", "1/e_x"}
    _close_to_jax(runs["from_jax"], runs["jax"])


def test_load_log_restores_the_log_alone(runs):
    """``load_log``: the log of epoch 1 carries on, the parameters come
    from the checkpoint and the optimizer starts afresh: the first step
    after it equals the first step of a fresh run from that checkpoint,
    bit for bit, and differs from the resumed run's."""
    loop = runs["load_log"][0]
    first = runs["resumed"][0]
    times, values = loop.log.channel("train_cost")
    assert times == list(range(1, 17))
    assert loop.log.status["resumed_from"] is None
    assert loop.log.status["_epoch_ends"] == [8, 16]
    earlier = first.log.channel("train_cost")
    assert (times[:8], values[:8]) == (earlier[0][:8], earlier[1][:8])
    norm = dict(zip(*loop.log.channel("total_step_norm")))[9]
    fresh = dict(zip(*runs["fresh"][0].log.channel("total_step_norm")))[1]
    resumed = dict(zip(*first.log.channel("total_step_norm")))[9]
    assert norm == fresh and norm != resumed


def test_jax_reads_the_port_log(runs):
    loop, directory = runs["resumed"]
    state = jax_checkpoint.load_checkpoint(str(directory / "model.zip"))
    log = JaxLog.from_state_dict(state["log_state"])
    for name in ("train_cost", "valid_sequence_total_cost",
                 "average_train_cost", "total_step_norm"):
        assert log.channel(name) == loop.log.channel(name), name
    assert log.status["iterations_done"] == 16


@pytest.mark.parametrize("rules,error,words", [
    (None, NotImplementedError, "AdaptiveClipState"),
    ({"rules": ["momentum"]}, KeyError, "lacks"),
    ({"rules": ["adadelta"], "burn_in_steps": 3}, KeyError, "unexpected"),
], ids=["adaptive_clipping", "other_rule", "longer_chain"])
def test_an_optimizer_state_the_port_cannot_map_raises(runs, tmp_path, rules,
                                                       error, words):
    """No silent fresh optimizer state: a state type the port has no
    stand-in for, a state of another rule, a chain of another length."""
    from attention_lvcsr_tpu.models.recognizer import params_from_path_dict
    params = jax_checkpoint.load_parameters(str(runs["first"][1]))
    tree = params_from_path_dict(params)
    if rules is None:
        state = jax_rules.adaptive_clipping(1.0).init(tree)
    else:
        state = jax_rules.build_optimizer(dict(rules)).init(tree)
    path = str(tmp_path / "bad.zip")
    jax_checkpoint.save_checkpoint(path, params, opt_state=state)
    with pytest.raises(error, match=words):
        driver.train(
            Configuration(str(runs["first"][1].parent / "toy.yaml"),
                          config_changes=CHANGES + [
                              ("training.num_epochs", "2")]),
            str(tmp_path / "model.zip"), path, device="cpu",
            use_load_ext=True)



def test_load_goes_on_without_a_checkpoint(runs, tmp_path, capsys):
    """As in the JAX package, ``Load`` and ``LoadLog`` print and go on
    when the checkpoint does not exist: the run starts afresh."""
    missing = str(tmp_path / "missing.zip")
    loop = driver.train(
        Configuration(str(runs["first"][1].parent / "toy.yaml"),
                      config_changes=CHANGES + [("training.num_batches",
                                                 "2")]),
        str(tmp_path / "model.zip"), missing, device="cpu",
        use_load_ext=True, load_log=True, fast_start=True)
    err = capsys.readouterr().err
    assert f"Load: no checkpoint at {missing}" in err
    assert f"LoadLog: no checkpoint at {missing}" in err
    assert loop.log.channel("train_cost")[0] == [1, 2]
    assert loop.log.status["resumed_from"] is None


def _jax_rule_states(node):
    """The rule states (optax's NamedTuples) of a nested optax chain
    state, in order."""
    if hasattr(node, "_fields"):
        return [node]
    return [s for child in node for s in _jax_rule_states(child)]


@pytest.mark.parametrize("conf", [
    {"rules": ["momentum"], "momentum": 0.9},
    {"rules": ["rmsprop"]},
    {"rules": ["adam"]},
    {"rules": ["adagrad"]},
    {"rules": ["adadelta"], "scale_schedule": [[2, 0.5]]},
    {"rules": ["momentum", "adadelta"], "momentum": 0.5,
     "burn_in_steps": 2},
], ids=["momentum", "rmsprop", "adam", "adagrad", "scale_schedule",
        "burn_in"])
def test_reads_each_rule_chain_jax_writes(tmp_path, conf):
    """Every rule's optax state, as the JAX package pickles it after two
    steps, read through the stand-ins: each leaf equals the field of the
    same name in the tree JAX wrote, and a third step from it gives
    optax's updates."""
    from attention_lvcsr_tpu.models.recognizer import params_from_path_dict
    rng = np.random.RandomState(3)
    shapes = {"/recognizer/enc/kernel": (3, 4), "/recognizer/enc/bias": (4,),
              "/recognizer/emb/embedding": (5, 3)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    conf = dict(conf, gradient_threshold=100.0)
    jax_opt = jax_rules.build_optimizer(conf, {"max_norm": 1.0})
    jax_params = params_from_path_dict(params)
    state = jax_opt.init(jax_params)
    for g in grads[:2]:
        _, state = jax_opt.update(params_from_path_dict(g), state,
                                  jax_params)
    path = str(tmp_path / "opt.zip")
    jax_checkpoint.save_checkpoint(path, params, opt_state=state)

    opt = rules.build_optimizer(conf, {"max_norm": 1.0})
    torch_params = {k: torch.from_numpy(v) for k, v in params.items()}
    loaded = rules.load_state_arrays(
        opt.init(torch_params), checkpoint.load_checkpoint(path)["opt_state"])
    written = _jax_rule_states(state)
    assert len(written) == len(opt.rules) == len(loaded)
    for i, rule_state in enumerate(written):
        assert set(loaded[str(i)]) == set(rule_state._fields), i
        for field in rule_state._fields:
            value, mine = getattr(rule_state, field), loaded[str(i)][field]
            if isinstance(mine, dict):
                assert set(mine) == set(shapes)
                for k, leaf in mine.items():
                    parts = k.split("/")[2:]
                    jax_leaf = value["params"]
                    for part in parts:
                        jax_leaf = jax_leaf[part]
                    assert np.array_equal(leaf.numpy(), np.asarray(jax_leaf)), \
                        (i, field, k)
            else:
                assert np.array_equal(mine.numpy(), np.asarray(value)), \
                    (i, field)
    updates, _ = opt.update({k: torch.from_numpy(v)
                             for k, v in grads[2].items()}, loaded,
                            torch_params)
    jax_updates, _ = jax_opt.update(params_from_path_dict(grads[2]), state,
                                    jax_params)
    for k, u in updates.items():
        jax_u = jax_updates["params"]
        for part in k.split("/")[2:]:
            jax_u = jax_u[part]
        np.testing.assert_allclose(u.numpy(), np.asarray(jax_u), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
