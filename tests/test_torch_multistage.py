"""Multistage training of the port against the JAX package's (CPU).

A config whose ``parent:`` is ``exp/wsj/configs/wsj_paper.yaml`` (the
paper's three stages: ``pretraining`` with the expanding prior, ``main``
restarted from ``pretraining_best_ll.zip``, ``annealing`` at epsilon
1e-10), cut to the toy dataset of ``tools/make_toy_dataset.py`` and the toy
widths, with a maximum input length that ``training.stop_filtering``
switches off in ``main``.  ``run.py train`` of both packages, from the same
start checkpoint, writes the same files, the same parameters (rtol 1e-4,
atol 1e-6) and the same records at the same iterations (1e-5): the
validation cost, ``valid_per``, the averaged train records, the length
filter's switch and, with ``training.patience``, the patience.
``--start-stage`` and ``--final-stage`` run one stage alone."""
import os
import sys

import numpy as np
import pytest

from attention_lvcsr_tpu.config import Configuration as JaxConfiguration
from attention_lvcsr_tpu.data import Data as JaxData
from attention_lvcsr_tpu.models.recognizer import param_path_dict
from attention_lvcsr_tpu.train import checkpoint as jax_checkpoint
from attention_lvcsr_tpu.train import driver as jax_driver
from attention_lvcsr_torch.cli import run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDS = ("valid_sequence_total_cost", "valid_per", "patience",
           "length_filter_switched", "best_valid_sequence_total_cost")
STAGE_FILES = ("{}.zip", "{}_best_ll.zip", "{}_best_ll_params.npz",
               "{}_params.npz")

CONFIG = """
parent: {root}/exp/wsj/configs/wsj_paper.yaml
data:
    dataset_filename: {dataset}
    name_mapping: {{train: train, valid: valid, test: test}}
    sources_map: {{recordings: recordings, labels: labels, uttids: uttids}}
    batch_size: 2
    validation_batch_size: 4
    sort_k_batches: 2
    max_length: 9
    add_bos: 0
    pad_multiple: {{recordings: 12, labels: 5}}
    prefetch: false
net:
    dim_dec: 8
    dims_bidir: [6]
    subsample: [1]
    dim_matcher: 8
    post_merge_dims: [8]
    conv_n: 2
    prior: {{before: 3, after: 3}}
training:
    stop_filtering: 14
stages:
    pretraining:
        net: {{prior: {{initial_end: 4, min_speed: 1.0, max_speed: 2.0}}}}
    main:
        training: {{num_epochs: 2}}
    annealing:
        training: {{num_epochs: 1}}
"""


@pytest.fixture
def staged(tmp_path):
    """(config path, start checkpoint): the toy data (utterances of 6-12
    frames, the 12-frame ones over ``max_length``) and the wsj_paper
    config cut to it; the start parameters from the JAX package's
    initialisation of the first stage."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_toy_dataset import make_toy_dataset
    make_toy_dataset(str(tmp_path / "toy.h5"), num_examples=40, num_chars=4,
                     feat_dim=5, max_len=4, seed=5)
    path = tmp_path / "staged.yaml"
    path.write_text(CONFIG.format(root=ROOT, dataset=tmp_path / "toy.h5"))
    config = JaxConfiguration(str(path))
    start = str(tmp_path / "start.zip")
    jrec = jax_driver.create_model(config.ordered_stages["pretraining"],
                                   JaxData(**config["data"]))
    jax_checkpoint.save_checkpoint(start, param_path_dict(jrec.params))
    return path, start


def _train_both(tmp_path, config, start, flags=(), changes=()):
    """``run.py train`` of both packages into ``jax/`` and ``port/``:
    (JAX loops, port loops)."""
    jconf = JaxConfiguration(str(config), config_changes=list(changes))
    stage_flags = dict(zip(flags[::2], flags[1::2]))
    jloops = jax_driver.train_multistage(
        jconf, str(tmp_path / "jax"), start,
        start_stage=stage_flags.get("--start-stage"),
        final_stage=stage_flags.get("--final-stage"))
    ploops = run.main(["train", str(tmp_path / "port"), str(config),
                       "--params", start, "--device", "cpu", *flags]
                      + [x for pair in changes for x in pair])
    return jloops, ploops


def _same_files(tmp_path, stages):
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax")) == sorted(
        f.format(stage) for stage in stages for f in STAGE_FILES)
    for name in files:
        theirs = jax_checkpoint.load_parameters(str(tmp_path / "jax" / name))
        ours = jax_checkpoint.load_parameters(str(tmp_path / "port" / name))
        assert set(ours) == set(theirs)
        for k, v in theirs.items():
            np.testing.assert_allclose(ours[k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name}: {k}")


def _same_records(stage, ploop, jloop):
    """The records of RECORDS and the average_* ones: the same iterations,
    values within 1e-5; returns the names compared."""
    averaged = sorted(n for n in jloop.log.columns
                      if n.startswith("average_"))
    assert averaged == sorted(n for n in ploop.log.columns
                              if n.startswith("average_"))
    compared = []
    for name in RECORDS + tuple(averaged):
        times, values = ploop.log.channel(name)
        jtimes, jvalues = jloop.log.channel(name)
        assert times == jtimes, f"{stage}: {name}"
        np.testing.assert_allclose(np.asarray(values, float),
                                   np.asarray(jvalues, float), rtol=1e-5,
                                   atol=1e-5, err_msg=f"{stage}: {name}")
        if times:
            compared.append(name)
    assert ploop.log.status["_epoch_ends"] == jloop.log.status["_epoch_ends"]
    return compared


def test_three_stages_match_jax(staged, tmp_path):
    config, start = staged
    jloops, ploops = _train_both(tmp_path, config, start)
    stages = ("pretraining", "main", "annealing")
    assert len(ploops) == len(jloops) == 3
    _same_files(tmp_path, stages)
    for stage, ploop, jloop in zip(stages, ploops, jloops):
        compared = _same_records(stage, ploop, jloop)
        assert {"valid_sequence_total_cost", "valid_per",
                "average_train_cost"} <= set(compared), stage
    # each stage built its own model and rule chain: the pretraining
    # prior expands, the later ones follow the median, and annealing
    # steps at epsilon 1e-10
    priors = [loop.algorithm.recognizer.net_config["prior"]["type"]
              for loop in ploops]
    assert priors == ["expanding", "window_around_median",
                      "window_around_median"]
    epsilons = [loop.algorithm.optimizer.rules[1].eps for loop in ploops]
    assert epsilons == [1e-8, 1e-8, 1e-10]
    # the switch at batch 14 lets the 12-frame utterances into main's
    # second epoch: 10 batches before it, 15 after it
    assert ploops[1].log.status["_epoch_ends"] == [10, 25]
    assert ploops[1].log.channel("length_filter_switched")[0][0] == 14


def test_start_and_final_stage_with_patience_match_jax(staged, tmp_path):
    """``main`` alone, from the start checkpoint, for up to 4 epochs with
    patience: at least 2 epochs, and as many as the epoch of the last
    improvement of the validation cost; the stage stops after its second
    epoch."""
    config, start = staged
    jloops, ploops = _train_both(
        tmp_path, config, start,
        flags=("--start-stage", "main", "--final-stage", "main"),
        changes=[("training.patience",
                  "{min_epochs: 2, patience_factor: 1.0}"),
                 ("stages.main.training.num_epochs", "4")])
    assert len(ploops) == len(jloops) == 1
    _same_files(tmp_path, ("main",))
    compared = _same_records("main", ploops[0], jloops[0])
    assert "patience" in compared
    assert ploops[0].log.status["_epoch_ends"] == [10, 25]
    assert ploops[0].log.channel("patience")[1][-1] == 2
