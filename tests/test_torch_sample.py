"""Sampling in the port against the JAX package (CPU).

The draws cannot match JAX's bits (``jax.random.categorical`` against a
``torch.Generator``), so a sample without an LM is held to JAX through its
costs: each sample's per-step costs and attention weights equal the JAX
package's teacher-forced ``cost`` of the same outputs.  With an LM the
emitter is argmax, so the outputs themselves equal those of the JAX
package's sampling steps, and ``run.py sample`` prints them.  The same
seed gives the same samples."""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_net_config
from attention_lvcsr_tpu.models.recognizer import \
    SpeechRecognizer as JaxRecognizer
from attention_lvcsr_tpu.models.recognizer import param_path_dict
from attention_lvcsr_tpu.train import driver as jax_driver
from attention_lvcsr_torch.cli import run
from attention_lvcsr_torch.models.params import load_path_dict
from attention_lvcsr_torch.models.recognizer import SpeechRecognizer

INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.5],
                        "biases_init": ["isotropic_gaussian", 0.1],
                        "rec_weights_init": ["orthogonal"]}}
EXPANDING = {"type": "expanding", "initial_begin": 0, "initial_end": 6,
             "min_speed": 1.0, "max_speed": 2.0}


@pytest.fixture(scope="module")
def tiny_lm(tmp_path_factory):
    from test_torch_lm import _lm_npz
    return _lm_npz(str(tmp_path_factory.mktemp("lm")))


def _pair(prior="median", lm=None):
    cfg = dict(_tiny_net_config(), use_pallas="never",
               max_decoded_length_scale=2.0)
    if prior == "expanding":
        cfg["prior"] = EXPANDING
    if lm:
        cfg["lm"] = {"path": lm, "weight": 0.5, "no_transition_cost": 20.0}
    jrec = JaxRecognizer(cfg, init_config=INIT, seed=5)
    rec = SpeechRecognizer(cfg, device="cpu")
    load_path_dict(rec.net, param_path_dict(jrec.params))
    return jrec, rec


def _inputs(B=3, T=19):
    rng = np.random.RandomState(8)
    return rng.randn(B, T, 12).astype(np.float32)


@pytest.mark.parametrize("prior", ["median", "expanding"])
def test_sample_costs_match_jax_teacher_forced(prior):
    """Per-step costs and weights within 1e-5 of JAX's ``cost`` of the
    sampled outputs (all steps live: sampling does not stop at EOS)."""
    jrec, rec = _pair(prior)
    x = _inputs()
    out = rec.sample(x)
    T = x.shape[1] // 2                       # max_decoded_length_scale 2
    assert out["outputs"].shape == (T, 3)
    assert out["costs"].shape == (T, 3) and out["weights"].shape[:2] == (
        T, 3)
    labels = out["outputs"].T.astype(np.int32)
    ref = jrec.net.apply(jrec.params, jnp.asarray(x), jnp.ones(x.shape[:2]),
                         jnp.asarray(labels), jnp.ones(labels.shape),
                         method=jrec.net.cost)
    np.testing.assert_allclose(out["costs"], np.asarray(ref["costs"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out["weights"], np.asarray(ref["weights"]),
                               rtol=1e-5, atol=1e-5)
    assert len(np.unique(out["outputs"])) > 3, "vacuous: one symbol drawn"


def test_single_utterance_sample_equals_its_analysis():
    """One (T, F) utterance: its sample's costs are the port's own
    teacher-forced ``analyze`` of the outputs (1e-5)."""
    _, rec = _pair()
    x = _inputs(B=1)[0]
    out = rec.sample(x, n_steps=7)
    assert out["outputs"].shape == (7, 1)
    labels = out["outputs"].T
    ana = rec.analyze(x[None], np.ones((1, len(x))), labels,
                      np.ones(labels.shape))
    np.testing.assert_allclose(out["costs"], ana["costs"], rtol=1e-5,
                               atol=1e-5)


def test_same_seed_gives_the_same_samples():
    _, rec = _pair()
    x = _inputs()
    first, again = rec.sample(x), rec.sample(x)
    for key in ("outputs", "costs", "weights", "readouts"):
        np.testing.assert_array_equal(first[key], again[key])
    seeded = [rec.sample(x, generator=torch.Generator().manual_seed(9))
              for _ in range(2)]
    np.testing.assert_array_equal(seeded[0]["outputs"], seeded[1]["outputs"])
    assert not np.array_equal(seeded[0]["outputs"], first["outputs"])


def jax_generate(jrec, x, n_steps, rng):
    """The JAX package's sampling step by step: ``generate_step`` of its
    generator, the body of its ``generate`` scan, unrolled in Python.  The
    scan itself fails with an LM: it broadcasts the ``params`` collection
    and not the LM's ``fst`` tables (``ScopeCollectionNotFound``), so
    ``SpeechRecognizer.sample`` of the JAX package cannot sample an LM
    model; the steps it would take can be."""
    def fn(mdl, x, m):
        encoded, encoded_mask, _ = mdl.encode(x, m, fast=True)
        gen = mdl.generator
        contexts = {"attended": encoded,
                    "preprocessed": gen.attention.preprocess(encoded),
                    "attended_mask": encoded_mask}
        carry = gen.initial_states(x.shape[0], encoded)
        steps = []
        for r in jax.random.split(rng, n_steps):
            carry, out = gen.generate_step(carry, contexts, r)
            steps.append(out)
        return {k: jnp.stack([o[k] for o in steps])
                for k in ("outputs", "costs", "weights", "readouts")}
    x = jnp.asarray(x)
    out = jrec.net.apply(jrec.params, x, jnp.ones(x.shape[:2]),
                         method=fn)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("prior", ["median", "expanding"])
def test_lm_sample_outputs_match_jax(prior, tiny_lm):
    """With an LM the emitter is argmax: the outputs equal JAX's, and the
    costs, weights and readouts within 1e-5."""
    jrec, rec = _pair(prior, lm=tiny_lm)
    x = _inputs()
    out = rec.sample(x)
    ref = jax_generate(jrec, x, x.shape[1] // 2, jax.random.PRNGKey(3))
    np.testing.assert_array_equal(out["outputs"], ref["outputs"])
    for key in ("costs", "weights", "readouts"):
        np.testing.assert_allclose(out[key], ref[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    assert len(np.unique(out["outputs"])) > 1, "vacuous: one symbol"


def test_jax_sample_with_lm_fails_in_its_scan(tiny_lm):
    """Why the test above unrolls the JAX steps: the JAX package's own
    ``sample`` of an LM model raises (see :func:`jax_generate`)."""
    from flax.errors import ScopeCollectionNotFound
    jrec, _ = _pair(lm=tiny_lm)
    with pytest.raises(ScopeCollectionNotFound):
        jrec.sample(_inputs())


def test_cli_sample_with_lm_prints_the_jax_steps(toy_lm_config, capsys):
    """``run.py sample`` with ``net.lm`` on the toy dataset prints, for
    each example of the valid part, its groundtruth and the argmax sample
    of the JAX package's steps."""
    from attention_lvcsr_tpu.config import Configuration as JaxConfiguration
    from attention_lvcsr_tpu.data import Data as JaxData
    path, ckpt, changes = toy_lm_config
    jconf = JaxConfiguration(path, config_changes=list(
        zip(changes[::2], changes[1::2])))
    data = JaxData(**jconf["data"])
    jrec = jax_driver.create_model(jconf, data, ckpt)
    dataset = data.get_dataset("valid")
    expected = io.StringIO()
    for number, example in enumerate(
            data.get_stream("valid", batches=False, shuffle=False)):
        x = np.asarray(example["recordings"], np.float32)
        outputs = jax_generate(jrec, x[None], len(x),
                               jax.random.PRNGKey(0))["outputs"][:, 0]
        print(f"Utterance {number}", file=expected)
        print("Groundtruth:", dataset.pretty_print(example["labels"],
                                                   example), file=expected)
        print("Recognized:", dataset.pretty_print(outputs, example),
              file=expected)
    run.main(["sample", path, "--params", ckpt, "--device", "cpu"]
             + changes)
    ours = capsys.readouterr().out
    assert ours == expected.getvalue()
    assert ours.count("Recognized:") == 2


@pytest.fixture
def toy_lm_config(tmp_path):
    """The toy dataset and config, an LM over its characters and a
    JAX-written checkpoint of the tiny widths."""
    import os
    import sys

    from attention_lvcsr_tpu.config import Configuration as JaxConfiguration
    from attention_lvcsr_tpu.data import Data as JaxData
    from attention_lvcsr_tpu.train import checkpoint as jax_checkpoint
    from test_torch_search import ROOT, WIDTHS, _lm_fst
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_toy_dataset import make_toy_dataset
    make_toy_dataset(str(tmp_path / "toy.h5"), num_examples=20, num_chars=4,
                     feat_dim=5, max_len=4, seed=5)
    text = open(os.path.join(ROOT, "tests", "configs", "toy.yaml")).read()
    path = tmp_path / "toy.yaml"
    path.write_text(text.replace("/tmp/toy.h5", str(tmp_path / "toy.h5")))
    changes = WIDTHS + [
        "net.lm.path", _lm_fst(str(tmp_path / "g.fst.txt")),
        "net.lm.weight", "0.5", "net.lm.no_transition_cost", "20.0"]
    jconf = JaxConfiguration(str(path), config_changes=list(
        zip(changes[::2], changes[1::2])))
    jrec = jax_driver.create_model(jconf, JaxData(**jconf["data"]))
    ckpt = str(tmp_path / "model.zip")
    jax_checkpoint.save_checkpoint(ckpt, param_path_dict(jrec.params))
    return str(path), ckpt, changes
