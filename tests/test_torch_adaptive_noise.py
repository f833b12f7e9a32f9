"""Adaptive weight noise in the port vs the JAX package (CPU, f32 both
sides).

The log-variances start as the JAX package's; two steps of
``make_adaptive_noise_train_step`` on a content-attention model match the
JAX step, at ``init_sigma`` 1e-12 (the noise lies below float32's
resolution of the weights, so the port's own draws do) and at 1e-2 with
the JAX step's own draws, reproduced here with ``jax.random`` and given to
the port's step; the monitors are the JAX step's, key for key.  Then the
TIMIT recipe, ``exp/timit/configs/nips_baseline.yaml`` (pretraining, then
``main`` and ``annealing`` with adaptive noise, each from the stage
before's ``_best_ll`` checkpoint), cut to the toy dataset and tiny widths:
``run.py train`` of both packages writes the same files, the same
parameters and log-variances, and the same records; the port resumes from
the ``main`` checkpoint the JAX package wrote (its optax state's noise
subtree read through the mapping unpickler) as the JAX package does, and a
resumed port run repeats the bits of a straight one."""
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_lvcsr_tpu.config import Configuration as JaxConfiguration
from attention_lvcsr_tpu.data import Data as JaxData
from attention_lvcsr_tpu.models.recognizer import \
    SpeechRecognizer as JaxRecognizer
from attention_lvcsr_tpu.models.recognizer import param_path_dict
from attention_lvcsr_tpu.train import checkpoint as jax_checkpoint
from attention_lvcsr_tpu.train import driver as jax_driver
from attention_lvcsr_tpu.train.rules import \
    build_optimizer as jax_build_optimizer
from attention_lvcsr_torch.cli import run
from attention_lvcsr_torch.config import Configuration
from attention_lvcsr_torch.models.params import load_path_dict
from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
from attention_lvcsr_torch.train import checkpoint, driver
from attention_lvcsr_torch.train.rules import build_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)          # the train step's (test_torch_
                                          # train_step.py)
NET = dict(
    input_dims={"recordings": 5}, eos_label=4, num_phonemes=5, dim_dec=8,
    dims_bidir=[6], enc_transition="gru", dec_transition="gru",
    attention_type="content", use_states_for_readout=False,
    criterion={"name": "log_likelihood"}, bottom={"bottom_class": "speech"},
    subsample=[2], post_merge_dims=[10], max_decoded_length_scale=1.0,
    use_pallas="never")
INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.3],
                        "biases_init": ["isotropic_gaussian", 0.1],
                        "rec_weights_init": ["orthogonal"]}}
MONITORS = {"sequence_total_cost", "batch_size", "weights_entropy",
            "weights_penalty", "train_cost", "model_cost",
            "model_prior_mean", "model_prior_variance",
            "total_gradient_norm", "total_step_norm"}


def _config(init_sigma):
    return {"net": NET,
            "training": {"rules": ["adadelta"], "decay_rate": 0.95,
                         "epsilon": 1e-6, "gradient_threshold": 100.0},
            "regularization": {"adaptive_noise": {
                "init_sigma": init_sigma, "model_cost_coefficient": 0.1,
                "num_examples": 20}}}


def _batch(seed=3, B=3, T=10, TL=5):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, 5).astype(np.float32),
            (np.arange(T)[None] < np.array([[T], [T - 3], [T]])).astype("f"),
            rng.randint(0, 5, size=(B, TL)).astype(np.int32),
            (np.arange(TL)[None] < np.array([[TL], [TL - 2], [3]])).astype(
                "f"))


def _pair():
    jrec = JaxRecognizer(dict(NET, input_num_chars={}), init_config=INIT,
                         seed=7)
    rec = SpeechRecognizer(NET, device="cpu")
    load_path_dict(rec.net, param_path_dict(jrec.params))
    return jrec, rec


def test_log_variances_start_as_in_jax():
    jrec, rec = _pair()
    jax_driver.init_adaptive_noise_params(jrec, 1e-3)
    driver.init_adaptive_noise_params(rec, 1e-3)
    ref = param_path_dict(jrec.params)
    ours = rec.param_path_dict()
    noise = sorted(k for k in ref if k.startswith("/adaptive_noise/"))
    assert noise and len(noise) * 2 == len(ref)
    assert sorted(ours) == sorted(ref)
    for k in noise:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def _jax_draws(model, rng):
    """The standard normal draws of the JAX step under ``rng``, by the
    port's parameter paths."""
    flat, _ = jax.tree_util.tree_flatten_with_path(model)
    keys = jax.random.split(rng, len(flat))
    return {"/recognizer/" + "/".join(p.key for p in path):
            torch.from_numpy(np.asarray(
                jax.random.normal(k, leaf.shape, leaf.dtype)))
            for (path, leaf), k in zip(flat, keys)}


@pytest.mark.parametrize("init_sigma,draws", [(1e-12, "port"),
                                              (1e-2, "jax")])
def test_two_steps_match_jax(init_sigma, draws):
    config = _config(init_sigma)
    batch = _batch()
    jrec, rec = _pair()
    jopt = jax_build_optimizer(config["training"], config["regularization"])
    jstep = jax.jit(jax_driver.make_train_step(jrec, jopt, config, 4,
                                               "recordings"))
    jparams = jrec.params
    assert "noise" in jparams
    jstate = jopt.init(jparams)
    opt = build_optimizer(config["training"], config["regularization"])
    step = driver.make_train_step(rec, opt, config)
    assert rec.noise is not None
    state = opt.init(rec.optimized())
    tbatch = [torch.from_numpy(a) for a in batch]
    tbatch[2] = tbatch[2].long()
    for i in range(2):
        rng = jax.random.PRNGKey(11 + i)
        kwargs = ({"noise": _jax_draws(jparams["params"], rng)}
                  if draws == "jax" else
                  {"generator": torch.Generator().manual_seed(i)})
        jparams, jstate, jmon = jstep(jparams, jstate, rng,
                                      *map(jnp.asarray, batch))
        state, mon = step(state, *tbatch, **kwargs)
        assert set(mon) == set(jmon) == MONITORS
        for k, v in jmon.items():
            np.testing.assert_allclose(float(mon[k]), float(v),
                                       err_msg=f"step {i}: {k}", **TOL)
        ref = param_path_dict(jparams)
        ours = rec.param_path_dict()
        assert set(ours) == set(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(ours[k], v, err_msg=f"step {i}: {k}",
                                       **TOL)
    assert float(mon["model_cost"]) > 0


# nips_baseline.yaml on the toy data: tiny widths, 2, 2 and 1 epochs, the
# beam search of monitoring.search every epoch.  Each stage starts from
# the one before's _best_ll checkpoint, so each must improve the
# validation cost within its epochs, by more than float32 noise: the noise's
# model cost is over TIMIT's 3696 training utterances, not the toy set's,
# and adadelta's epsilon 1e-6 (annealing keeps its 1e-10)
CONFIG = """
parent: {root}/exp/timit/configs/nips_baseline.yaml
data:
    dataset_filename: {dataset}
    dataset_class: H5AudioDataset
    name_mapping: {{train: train, valid: valid, test: test}}
    sources_map: {{recordings: recordings, labels: labels, uttids: uttids}}
    validation_batch_size: 4
    sort_k_batches: 2
    add_bos: 0
    pad_multiple: {{recordings: 12, labels: 5}}
    prefetch: false
net:
    dim_dec: 8
    dims_bidir: [6, 6]
    subsample: [1, 2]
    dim_matcher: 8
    post_merge_dims: [8]
    bottom: {{dims: [7]}}
    max_decoded_length_scale: 1.0
training:
    epsilon: 1.0e-6
stages:
    pretraining:
        training: {{num_epochs: 2}}
    main:
        regularization: {{adaptive_noise: {{num_examples: 3696}}}}
        training: {{num_epochs: 2}}
    annealing:
        regularization: {{adaptive_noise: {{num_examples: 3696}}}}
        training: {{num_epochs: 1}}
"""
STAGES = ("pretraining", "main", "annealing")
STAGE_FILES = ("{}.zip", "{}_best_ll.zip", "{}_best_ll_params.npz",
               "{}_params.npz")
RECORDS = ("valid_sequence_total_cost", "valid_per",
           "best_valid_sequence_total_cost", "total_gradient_norm")


@pytest.fixture(scope="module")
def timit(tmp_path_factory):
    """The toy data, the nips_baseline child config, the start checkpoint
    (the JAX package's initialisation of ``pretraining``), and the runs
    the tests compare: both packages' three stages, the JAX package's
    ``main`` alone for one epoch and then resumed for a second, and the
    port's ``main`` resumed from that JAX file, straight for two epochs,
    and stopped after one and resumed."""
    tmp = tmp_path_factory.mktemp("timit")
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_toy_dataset import make_toy_dataset
    make_toy_dataset(str(tmp / "toy.h5"), num_examples=40, num_chars=4,
                     feat_dim=5, max_len=4, seed=5)
    path = tmp / "nips.yaml"
    path.write_text(CONFIG.format(root=ROOT, dataset=tmp / "toy.h5"))
    jconf = JaxConfiguration(str(path))
    start = str(tmp / "start.zip")
    jrec = jax_driver.create_model(jconf.ordered_stages["pretraining"],
                                   JaxData(**jconf["data"]))
    jax_checkpoint.save_checkpoint(start, param_path_dict(jrec.params))
    out = {"tmp": tmp}
    out["jax"] = jax_driver.train_multistage(jconf, str(tmp / "jax"), start)
    out["port"] = run.main(["train", str(tmp / "port"), str(path),
                            "--params", start, "--device", "cpu"])
    # main alone from pretraining's best model: the JAX package one epoch,
    # then resumed for a second; the port from that file, straight, and
    # resumed from its own first epoch
    main_start = str(tmp / "jax" / "pretraining_best_ll.zip")

    def stage(package, epochs):
        cls = JaxConfiguration if package == "jax" else Configuration
        conf = cls(str(path), config_changes=[
            ("stages.main.training.num_epochs", str(epochs))])
        return conf.ordered_stages["main"]

    for name in ("jax_main", "from_jax", "straight", "resumed"):
        (tmp / name).mkdir()
    jax_driver.train(stage("jax", 1), str(tmp / "jax_main" / "main.zip"),
                     main_start)
    shutil.copy(tmp / "jax_main" / "main.zip", tmp / "jax_first.zip")
    shutil.copytree(tmp / "jax_main", tmp / "from_jax", dirs_exist_ok=True)
    out["jax_main"] = jax_driver.train(
        stage("jax", 2), str(tmp / "jax_main" / "main.zip"),
        str(tmp / "jax_main" / "main.zip"), use_load_ext=True)
    out["from_jax"] = driver.train(
        stage("port", 2), str(tmp / "from_jax" / "main.zip"),
        str(tmp / "from_jax" / "main.zip"), use_load_ext=True, device="cpu")
    out["straight"] = driver.train(
        stage("port", 2), str(tmp / "straight" / "main.zip"), main_start,
        device="cpu")
    driver.train(stage("port", 1), str(tmp / "resumed" / "main.zip"),
                 main_start, device="cpu")
    out["resumed"] = driver.train(
        stage("port", 2), str(tmp / "resumed" / "main.zip"),
        str(tmp / "resumed" / "main.zip"), use_load_ext=True, device="cpu")
    return out


def _same_parameters(ours, theirs, name):
    assert set(ours) == set(theirs), name
    assert any(k.startswith("/adaptive_noise/") for k in theirs) == (
        not name.startswith("pretraining")), name
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{name}: {k}")


def _same_records(ploop, jloop, names, label):
    compared = []
    for name in names:
        times, values = ploop.log.channel(name)
        jtimes, jvalues = jloop.log.channel(name)
        assert times == jtimes, f"{label}: {name}"
        np.testing.assert_allclose(np.asarray(values, float),
                                   np.asarray(jvalues, float), rtol=1e-5,
                                   atol=1e-5, err_msg=f"{label}: {name}")
        if times:
            compared.append(name)
    assert ploop.log.status["_epoch_ends"] == jloop.log.status["_epoch_ends"]
    return compared


def test_nips_baseline_stages_match_jax(timit):
    tmp = timit["tmp"]
    files = sorted(os.listdir(tmp / "port"))
    assert files == sorted(os.listdir(tmp / "jax"))
    assert {f.format(s) for s in STAGES for f in STAGE_FILES} <= set(files)
    for name in files:
        _same_parameters(
            jax_checkpoint.load_parameters(str(tmp / "port" / name)),
            jax_checkpoint.load_parameters(str(tmp / "jax" / name)), name)
    for stage, ploop, jloop in zip(STAGES, timit["port"], timit["jax"]):
        columns = set(ploop.log.columns)
        assert columns == set(jloop.log.columns), stage
        noisy = stage != "pretraining"
        assert ("model_cost" in columns) == noisy
        assert ("min_energy" in columns) is False
        names = RECORDS + ("train_cost", "total_step_norm") + (
            ("model_cost", "model_prior_variance") if noisy else ())
        compared = _same_records(ploop, jloop, names, stage)
        assert {"valid_sequence_total_cost", "valid_per",
                "train_cost"} <= set(compared), stage
    # each stage's rule chain: max-norm only in pretraining, annealing at
    # epsilon 1e-10, the noise coefficient 0.1 over the training set
    rec = timit["port"][2].algorithm.recognizer
    assert rec.net_config["attention_type"] == "content"
    eps = [loop.algorithm.optimizer.rules[1].eps for loop in timit["port"]]
    assert eps == [1e-6, 1e-6, 1e-10]


def test_resumes_from_a_jax_main_checkpoint(timit):
    """The port resumes ``main`` from the file the JAX package wrote after
    its first epoch: the log-variances from its parameters, their optax
    state from its ``_opt_state.pkl``'s noise subtree; it then trains as
    the JAX package's resumed run does."""
    state = checkpoint.load_checkpoint(str(timit["tmp"] / "jax_first.zip"))
    prefixes = {k.split("/", 2)[2].split("/")[0] for k in state["opt_state"]
                if k.count("/") > 2}
    assert prefixes == {"recognizer", "adaptive_noise"}
    ploop, jloop = timit["from_jax"], timit["jax_main"]
    tmp = timit["tmp"]
    for name in sorted(os.listdir(tmp / "jax_main")):
        _same_parameters(
            jax_checkpoint.load_parameters(str(tmp / "from_jax" / name)),
            jax_checkpoint.load_parameters(str(tmp / "jax_main" / name)),
            name)
    compared = _same_records(ploop, jloop, ("train_cost", "model_cost",
                                            "valid_sequence_total_cost"),
                             "main resumed")
    assert len(compared) == 3


def test_resumed_run_repeats_the_straight_bits(timit):
    """The noise of a step is drawn from the training seed and the
    iteration, so ``main`` resumed after its first epoch repeats the
    straight run bit for bit."""
    tmp = timit["tmp"]
    for name in os.listdir(tmp / "straight"):
        ours = jax_checkpoint.load_parameters(str(tmp / "resumed" / name))
        theirs = jax_checkpoint.load_parameters(str(tmp / "straight" / name))
        assert set(ours) == set(theirs)
        assert all(np.array_equal(ours[k], v) for k, v in theirs.items()), \
            name
    for name in ("train_cost", "model_cost", "total_step_norm"):
        assert timit["resumed"].log.channel(name) == \
            timit["straight"].log.channel(name), name


def test_noise_collection_goes_through_the_checkpoint(tmp_path):
    """With a noise collection, ``param_path_dict`` adds the
    ``/adaptive_noise`` keys and ``load_params`` takes them back; without
    one, a checkpoint's ``/adaptive_noise`` keys are skipped and a
    checkpoint without them leaves the noise as it was."""
    from attention_lvcsr_torch.train.checkpoint import save_checkpoint
    _, rec = _pair()
    driver.init_adaptive_noise_params(rec, 1e-2)
    with torch.no_grad():
        for i, v in enumerate(rec.noise.values()):
            v.add_(0.001 * i)
    saved = rec.param_path_dict()
    path = str(tmp_path / "noisy.zip")
    save_checkpoint(path, saved)
    _, other = _pair()
    other.load_params(path)                      # no noise collection
    assert other.noise is None
    assert set(other.param_path_dict()) == {
        k for k in saved if k.startswith("/recognizer/")}
    driver.init_adaptive_noise_params(other, 1e-3)
    other.load_params(path)
    for k, v in saved.items():
        np.testing.assert_array_equal(other.param_path_dict()[k], v,
                                      err_msg=k)
    plain = str(tmp_path / "plain.zip")
    save_checkpoint(plain, {k: v for k, v in saved.items()
                            if k.startswith("/recognizer/")})
    other.load_params(plain)
    for k, v in saved.items():
        np.testing.assert_array_equal(other.param_path_dict()[k], v,
                                      err_msg=k)


@pytest.mark.parametrize("iteration", [None, lambda: 7])
def test_each_step_draws_from_the_seed_and_the_iteration(iteration):
    """``GradientDescent`` gives every step :func:`driver.noise_generator`
    of its seed and the iterations done before it: by default the batches
    it has processed, else what ``iteration`` reads (``run_training``
    reads the loop's log)."""
    _, rec = _pair()
    seeds = []

    def step(opt_state, *tensors, generator):
        seeds.append(generator.initial_seed())
        return opt_state, {"train_cost": torch.tensor(0.0)}
    algorithm = driver.GradientDescent(rec, build_optimizer({}, {}), step,
                                       seed=3, iteration=iteration)
    batch = {"recordings": np.zeros((1, 4, 5), np.float32),
             "recordings_mask": np.ones((1, 4), np.float32),
             "labels": np.zeros((1, 2), np.int64),
             "labels_mask": np.ones((1, 2), np.float32)}
    for _ in range(2):
        algorithm.process_batch(batch)
    done = [0, 1] if iteration is None else [7, 7]
    assert seeds == [3 * 2 ** 32 + i for i in done]
