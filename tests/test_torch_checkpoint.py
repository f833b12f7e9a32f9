"""Checkpoints between the packages, and ``run.py train`` of the port.

A checkpoint the port writes is the JAX package's tar: its
``load_parameters`` and ``SpeechRecognizer.load_params`` read it; a
checkpoint the JAX package writes loads into the port; the port's
optimizer state comes back as it was saved.  ``run.py train`` on the toy
config and data trains a few batches on the CPU and writes such a
checkpoint."""
import os
import sys

import numpy as np

from attention_lvcsr_tpu.models.recognizer import \
    SpeechRecognizer as JaxRecognizer
from attention_lvcsr_tpu.models.recognizer import param_path_dict
from attention_lvcsr_tpu.train import checkpoint as jax_checkpoint
from attention_lvcsr_torch.cli import run
from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
from attention_lvcsr_torch.train import checkpoint
from attention_lvcsr_torch.train.driver import run_training
from attention_lvcsr_torch.train.rules import (build_optimizer,
                                               load_state_arrays,
                                               state_arrays)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET = dict(
    input_dims={"recordings": 5}, eos_label=4, num_phonemes=5, dim_dec=8,
    dims_bidir=[6], enc_transition="gru", dec_transition="gru",
    attention_type="content_and_conv", conv_n=2,
    criterion={"name": "log_likelihood"}, bottom={"bottom_class": "speech"},
    subsample=[1], post_merge_dims=[10],
    prior={"type": "expanding", "initial_begin": 0, "initial_end": 4,
           "min_speed": 1.0, "max_speed": 2.0})
INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.3],
                        "biases_init": ["isotropic_gaussian", 0.1],
                        "rec_weights_init": ["orthogonal"]}}


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        out.append({
            "recordings": rng.randn(2, 7, 5).astype(np.float32),
            "recordings_mask": np.array([[1] * 7, [1] * 5 + [0] * 2], "f"),
            "labels": rng.randint(0, 5, size=(2, 4)),
            "labels_mask": np.array([[1] * 4, [1] * 3 + [0]], "f")})
    return out


def test_port_checkpoint_reads_in_jax_and_back(tmp_path):
    rec = SpeechRecognizer(NET, init_config=INIT, seed=3, device="cpu")
    optimizer = build_optimizer({"rules": ["adadelta"]}, {"max_norm": 1.0})
    path = str(tmp_path / "port.zip")
    batches = _batches(3)
    loop = run_training(rec, optimizer, lambda: batches, path,
                        num_batches=2, printing=False)
    assert loop.log.status["iterations_done"] == 2
    assert len(loop.log.channel("train_cost")[1]) == 2
    # the JAX package reads the parameters the port trained
    ours = rec.param_path_dict()
    theirs = jax_checkpoint.load_parameters(path)
    assert set(theirs) == set(ours)
    for k, v in ours.items():
        np.testing.assert_array_equal(theirs[k], v)
    jrec = JaxRecognizer(dict(NET, input_num_chars={}), seed=9)
    jrec.load_params(path)
    for k, v in param_path_dict(jrec.params).items():
        np.testing.assert_array_equal(np.asarray(v), ours[k])
    # ... and the port reads back parameters, optimizer state and log
    state = checkpoint.load_checkpoint(path)
    assert state["meta"]["iterations_done"] == 2
    assert state["log_state"]["status"]["iterations_done"] == 2
    fresh = SpeechRecognizer(NET, seed=11, device="cpu")
    fresh.load_params(path)
    for k, v in fresh.param_path_dict().items():
        np.testing.assert_array_equal(v, ours[k])
    template = optimizer.init({k: p.detach()
                               for k, p in fresh.parameters().items()})
    loaded = load_state_arrays(template, state["opt_state"])
    saved = loop.algorithm.opt_state_arrays()
    for k, v in state_arrays(loaded).items():
        np.testing.assert_array_equal(v, saved[k])


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    jrec = JaxRecognizer(dict(NET, input_num_chars={}), init_config=INIT,
                         seed=5)
    path = str(tmp_path / "jax.zip")
    jax_checkpoint.save_checkpoint(path, param_path_dict(jrec.params),
                                   meta={"iterations_done": 7})
    rec = SpeechRecognizer(NET, seed=1, device="cpu")
    rec.load_params(path)
    ref = param_path_dict(jrec.params)
    for k, v in rec.param_path_dict().items():
        np.testing.assert_array_equal(v, np.asarray(ref[k]))
    assert checkpoint.load_checkpoint(path)["meta"] == {"iterations_done": 7}


def test_nan_gradient_norm_stops_training(tmp_path):
    rec = SpeechRecognizer(NET, init_config=INIT, seed=3, device="cpu")
    batches = _batches(4)
    batches[1]["recordings"][0, 0, 0] = np.nan
    loop = run_training(rec, build_optimizer({}, {}), lambda: batches,
                        str(tmp_path / "nan.zip"), printing=False)
    assert loop.log.status["iterations_done"] == 2
    assert np.isnan(loop.log.last_value("total_gradient_norm"))


def test_cli_train_on_toy_config_writes_a_jax_checkpoint(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_toy_dataset import make_toy_dataset

    make_toy_dataset(str(tmp_path / "toy.h5"), num_examples=20,
                     num_chars=4, feat_dim=5, max_len=4, seed=5)
    cfg_text = open(os.path.join(ROOT, "tests", "configs",
                                 "toy.yaml")).read()
    (tmp_path / "toy.yaml").write_text(
        cfg_text.replace("/tmp/toy.h5", str(tmp_path / "toy.h5")))
    save = str(tmp_path / "toy_model.zip")
    loop = run.main(["train", save, str(tmp_path / "toy.yaml"),
                     "net.dim_dec", "8", "net.dims_bidir", "[6]",
                     "net.dim_matcher", "8", "net.post_merge_dims", "[8]",
                     "training.num_batches", "3", "data.batch_size", "4",
                     "--device", "cpu"])
    assert loop.log.status["iterations_done"] == 3
    costs = loop.log.channel("train_cost")[1]
    assert len(costs) == 3 and np.isfinite(costs).all()
    params = jax_checkpoint.load_parameters(save)
    assert params["/recognizer/generator/transition_0/state_to_state"] \
        .shape == (8, 8)
    assert all(np.isfinite(v).all() for v in params.values())
    # as the JAX driver: validation and a checkpoint before the first
    # epoch, a checkpoint after it (the stop after 3 batches ends it) with
    # its _params.npz sidecar; toy.yaml validates every second epoch, so
    # no epoch improved the validation cost and there is no _best_ll copy
    sidecar = jax_checkpoint.load_parameters(
        str(tmp_path / "toy_model_params.npz"))
    assert set(sidecar) == set(params)
    for k, v in params.items():
        np.testing.assert_array_equal(sidecar[k], v)
    times, costs = loop.log.channel("valid_sequence_total_cost")
    assert times == [0] and np.isfinite(costs).all()
    assert loop.log.channel("saved_to")[0] == [0, 3]
    assert sorted(os.listdir(tmp_path)) == [
        "toy.h5", "toy.yaml", "toy_model.zip", "toy_model_params.npz"]
