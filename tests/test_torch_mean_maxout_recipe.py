"""The repo's mean-window + maxout recipe, ``exp/wsj/configs/
wsj_mean_maxout.yaml``, trained by the port against the JAX package
(CPU).

Its first two stages, cut to the toy dataset of
``tools/make_toy_dataset.py`` and toy widths, keeping the recipe's ten
conv filters, the maxout:2 readout with the decoder states and the
priors: ``pretraining`` on the expanding window, then ``main`` restarted
from ``pretraining_best_ll.zip`` on ``window_around_mean``; the stages
validate on the training utterances, whose cost falls, so that
``pretraining_best_ll.zip`` is written.  ``run.py train`` of both
packages, from the same start checkpoint, writes the same files, the same
parameters (rtol 1e-4, atol 1e-6) and the same records at the same
iterations (1e-5): the validation cost, ``valid_per`` (a beam
search of the validation set on the loop route) and the averaged train
records."""
import os
import sys

import pytest

from attention_lvcsr_tpu.config import Configuration as JaxConfiguration
from attention_lvcsr_tpu.data import Data as JaxData
from attention_lvcsr_tpu.models.recognizer import param_path_dict
from attention_lvcsr_tpu.train import checkpoint as jax_checkpoint
from attention_lvcsr_tpu.train import driver as jax_driver
from test_torch_multistage import _same_files, _same_records, _train_both

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIG = """
parent: {root}/exp/wsj/configs/wsj_mean_maxout.yaml
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
net:
    dim_dec: 8
    dims_bidir: [6]
    subsample: [1]
    dim_matcher: 8
    post_merge_dims: [8]
    conv_n: 2
    prior: {{before: 3, after: 3}}
stages:
    pretraining:
        net: {{prior: {{initial_end: 4, min_speed: 1.0, max_speed: 2.0}}}}
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


def test_pretraining_and_main_match_jax(staged, tmp_path):
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
    assert [n["prior"]["type"] for n in nets] == ["expanding",
                                                 "window_around_mean"]
    assert all(n["conv_num_filters"] == 10
               and n["post_merge_activation"] == "maxout:2"
               and n["use_states_for_readout"] for n in nets)
    params = ploops[1].algorithm.recognizer.parameters()
    assert tuple(params["/recognizer/generator/attention/conv_filters"]
                 .shape) == (10, 5)
    assert tuple(params["/recognizer/generator/readout/post_merge_0/kernel"]
                 .shape) == (4, 5)
