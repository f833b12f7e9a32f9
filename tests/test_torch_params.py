"""Parameter bridge: the port's config-driven init is bit-identical to the
JAX package's, and JAX-written checkpoints load into the port with no
missing or unexpected keys."""
import os

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_net_config
from attention_lvcsr_tpu.config import Configuration
from attention_lvcsr_tpu.models.recognizer import \
    SpeechRecognizer as JaxRecognizer
from attention_lvcsr_tpu.models.recognizer import param_path_dict
from attention_lvcsr_tpu.train.checkpoint import (save_checkpoint,
                                                  save_parameters)
from attention_lvcsr_torch.models.params import load_path_dict
from attention_lvcsr_torch.models.recognizer import SpeechRecognizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.1],
                        "biases_init": ["constant", 0.0],
                        "rec_weights_init": ["orthogonal"]},
        "/recognizer/generator/attention": {
            "weights_init": ["uniform", 0.0, 0.3]}}


def _toy_net_config():
    config = Configuration(os.path.join(ROOT, "tests", "configs",
                                        "toy.yaml"))
    net = dict(config["net"])
    net.update(input_dims={"recordings": 5}, input_num_chars={},
               eos_label=4, num_phonemes=5, data_prepend_eos=False)
    return net, config["initialization"]


def _configs():
    toy, toy_init = _toy_net_config()
    return {"tiny": (_tiny_net_config(), INIT), "toy": (toy, toy_init)}


@pytest.mark.parametrize("name", ["tiny", "toy"])
@pytest.mark.parametrize("seed", [1234, 7])
def test_init_bit_identical_to_jax(name, seed):
    cfg, init = _configs()[name]
    jax_params = param_path_dict(
        JaxRecognizer(cfg, init_config=init, seed=seed).params)
    port = SpeechRecognizer(cfg, init_config=init, seed=seed,
                            device="cpu")
    port_params = port.param_path_dict()
    assert sorted(port_params) == sorted(jax_params)
    for key, value in jax_params.items():
        assert port_params[key].dtype == np.float32
        np.testing.assert_array_equal(port_params[key], value, err_msg=key)


@pytest.mark.parametrize("writer", ["checkpoint_tar", "parameters_npz"])
def test_jax_checkpoint_loads_into_port(tmp_path, writer):
    cfg, init = _configs()["toy"]
    jax_rec = JaxRecognizer(cfg, init_config=init, seed=3)
    # make every leaf distinct from the port's own init
    params = jax.tree.map(lambda a: a + 0.25, jax_rec.params)
    path_dict = param_path_dict(params)
    path = str(tmp_path / "model.zip")
    if writer == "checkpoint_tar":
        save_checkpoint(path, dict(path_dict, **{
            "/adaptive_noise/generator/readout/merge_bias":
                np.zeros(3, np.float32)}))
    else:
        save_parameters(path, path_dict)
    port = SpeechRecognizer(cfg, init_config=init, seed=3, device="cpu")
    port.load_params(path)
    loaded = port.param_path_dict()
    assert sorted(loaded) == sorted(path_dict)
    for key, value in path_dict.items():
        np.testing.assert_array_equal(loaded[key], value, err_msg=key)


def test_load_path_dict_rejects_missing_and_unexpected_keys():
    cfg, init = _configs()["tiny"]
    port = SpeechRecognizer(cfg, init_config=init, device="cpu")
    full = port.param_path_dict()
    some_key = sorted(full)[0]
    missing = {k: v for k, v in full.items() if k != some_key}
    with pytest.raises(KeyError, match="missing"):
        load_path_dict(port.net, missing)
    with pytest.raises(KeyError, match="unexpected"):
        load_path_dict(port.net, dict(full, **{"/recognizer/extra":
                                               np.zeros(1)}))
    bad = dict(full, **{some_key: np.zeros((1, 1, 1), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        load_path_dict(port.net, bad)
    # the failed loads left the parameters untouched where keys were bad
    assert torch.isfinite(next(port.net.parameters())).all()
