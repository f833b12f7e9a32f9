"""The port's quality proxy (``attention_lvcsr_torch/cli/quality_proxy.py``)
against the JAX package's tool (``tools/quality_proxy.py``), on the CPU at
the ``fast`` tier and seed 7.

- The corpus, the ARPA text (bytes), ``LG_pushed.npz`` (every array) and
  the rendered acoustics equal the JAX tool's; the H5 files the two tools
  write hold the same sources, value map and splits.
- The port's ``Data`` gives the same batches in the same order over its H5
  file and over the ``--in-memory`` arrays, and so does the JAX package's
  ``Data`` over its own file.
- From JAX's initial parameters, the first three training batches' costs
  agree within 1e-5 relative and the parameters after them within rtol
  1e-4, atol 1e-6 (the tolerances of ``tests/test_torch_multistage.py``).
- From one checkpoint the port trained on the CPU (the tier's 1 + 2
  epochs, after which most hypotheses are non-empty), both tools'
  ``decode_and_score`` give the same best hypotheses, ``cer``, ``wer``
  and ``empty`` without the LM at beam 10, with it at beam 10, and
  without it at the wide beam (20), over the first 16 test utterances.
- The module imports no JAX, and the H5 path without h5py raises.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from attention_lvcsr_tpu.config import Configuration as JaxConfiguration
from attention_lvcsr_tpu.data import Data as JaxData
from attention_lvcsr_tpu.models.recognizer import param_path_dict
from attention_lvcsr_tpu.ops.lm_graph import \
    build_decoding_graph as jax_build_decoding_graph
from attention_lvcsr_tpu.train import checkpoint as jax_checkpoint
from attention_lvcsr_tpu.train import driver as jax_driver
from attention_lvcsr_torch.cli import quality_proxy as qp
from attention_lvcsr_torch.config import Configuration
from attention_lvcsr_torch.data import Data
from attention_lvcsr_torch.train import driver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from tools import quality_proxy as jqp  # noqa: E402

SEED = 7
LIMIT = 16
SEARCH = dict(stop_on="patience", round_to_inf=1e9)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Both tools' steps 1-4 at the fast tier from seed 7: the port's
    ``build`` (H5 path) and the JAX tool's functions, in its order."""
    work = tmp_path_factory.mktemp("quality")
    port = qp.build(str(work / "port"), SEED, "fast")
    (n_train, n_valid, n_test, num_words, (min_len, max_len), feat_dim,
     (frames_lo, frames_hi), noise, *_) = qp.SIZES["fast"]
    rng = np.random.RandomState(SEED)
    os.makedirs(work / "jax")
    words, succ = jqp.make_language(rng, num_words=num_words)
    corpus = jqp.sample_corpus(words, succ, rng, n_train + n_valid + n_test,
                               min_len=min_len, max_len=max_len)
    arpa = str(work / "jax" / "lm.arpa")
    jqp.estimate_arpa(corpus[:n_train], words, arpa)
    jax_build_decoding_graph(arpa, port["rendered"]["value_map"],
                             out_dir=str(work / "jax" / "lm"),
                             deterministic=False, no_transition_cost=20.0)
    h5 = str(work / "jax" / "synth.h5")
    texts = jqp.make_dataset(
        h5, corpus, port["rendered"]["value_map"], rng, feat_dim=feat_dim,
        frames_lo=frames_lo, frames_hi=frames_hi, noise=noise,
        splits=(("train", n_train), ("valid", n_valid), ("test", n_test)))
    return {"port": port, "work": work, "corpus": corpus, "arpa": arpa,
            "npz": str(work / "jax" / "lm" / "LG_pushed.npz"), "h5": h5,
            "texts": texts}


def _h5_contents(path):
    import h5py
    with h5py.File(path, "r") as f:
        sources = {name: [np.asarray(x) for x in f[name][...]]
                   for name in f.keys()}
        attrs = {name: f[name].attrs["value_map"].tolist()
                 for name in f.keys() if "value_map" in f[name].attrs}
        split = [tuple(row)[:4] for row in f.attrs["split"]]
    return sources, attrs, split


def test_language_arpa_graph_and_acoustics_equal_jax(built):
    port = built["port"]
    assert port["corpus"] == built["corpus"]
    with open(port["arpa"], "rb") as a, open(built["arpa"], "rb") as b:
        assert a.read() == b.read()
    ours, theirs = np.load(port["lm_npz"]), np.load(built["npz"])
    assert sorted(ours.files) == sorted(theirs.files)
    for key in theirs.files:
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    assert port["graph"]["LG_pushed"].num_states == 512
    rendered = port["rendered"]
    assert rendered["texts"] == built["texts"]
    sources, _, _ = _h5_contents(built["h5"])
    shapes = sources["recordings_shapes"]
    for i, (rec, lab) in enumerate(zip(rendered["recordings"],
                                       rendered["labels"])):
        assert rec.dtype == np.float32 and lab.dtype == np.int64
        np.testing.assert_array_equal(rec.shape, shapes[i])
        np.testing.assert_array_equal(rec.ravel(), sources["recordings"][i])
        np.testing.assert_array_equal(lab, sources["labels"][i])
    assert rendered["splits"] == {"train": (0, 400), "valid": (400, 450),
                                  "test": (450, 500)}


def test_h5_files_hold_the_same_sources_and_splits(built):
    ours = _h5_contents(os.path.join(os.path.dirname(built["port"]["arpa"]),
                                     "synth.h5"))
    theirs = _h5_contents(built["h5"])
    assert sorted(ours[0]) == sorted(theirs[0])
    for name, arrays in theirs[0].items():
        assert len(ours[0][name]) == len(arrays)
        for a, b in zip(ours[0][name], arrays):
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert ours[1] == theirs[1] and ours[2] == theirs[2]


def _streams(data):
    """The train epoch's batches (shuffled), the valid batches and the test
    examples, as the training and the decodes read them."""
    return (list(data.get_stream("train")),
            list(data.get_stream("valid", shuffle=False)),
            list(data.get_stream("test", batches=False, shuffle=False)))


def _same_streams(got, ref):
    for part, (g, r) in enumerate(zip(got, ref)):
        assert len(g) == len(r) > 0, part
        for i, (a, b) in enumerate(zip(g, r)):
            assert sorted(a) == sorted(b), (part, i)
            for key in b:
                np.testing.assert_array_equal(np.asarray(a[key]),
                                              np.asarray(b[key]),
                                              err_msg=f"{part} {i} {key}")
                assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype


def test_in_memory_batches_equal_the_h5_batches(built):
    port = built["port"]
    h5 = Data(**port["config"]["data"])
    cls = qp.array_dataset_class(port["rendered"])
    memory = Data(**dict(port["config"]["data"], dataset_class=cls))
    ref = _streams(h5)
    _same_streams(_streams(memory), ref)
    # each stage's config reads the arrays too
    config = qp.load_config(port["cfg_path"], cls)
    for stage in config.ordered_stages.values():
        assert stage["data"]["dataset_class"] is cls
    # the JAX package's pipeline over its own file
    jconf = JaxConfiguration(port["cfg_path"])
    _same_streams(_streams(JaxData(**dict(jconf["data"],
                                          dataset_filename=built["h5"]))),
                  ref)
    dataset = memory.get_dataset("train")
    reference = h5.get_dataset("train")
    assert dataset.num_examples == reference.num_examples == 400
    assert dataset.character_map("labels") == \
        reference.character_map("labels")
    assert dataset.dim("recordings") == reference.dim("recordings") == 12
    np.testing.assert_array_equal(dataset.example_lengths("recordings"),
                                  reference.example_lengths("recordings"))
    assert (dataset.eos_label, dataset.bos_label, dataset.num_characters) \
        == (reference.eos_label, reference.bos_label,
            reference.num_characters)
    np.testing.assert_array_equal(dataset.get_example(3)[1],
                                  reference.get_example(3)[1])
    assert dataset.decode([2, 0, 3, 1]) == reference.decode([2, 0, 3, 1])


def test_first_training_batches_match_jax(built, tmp_path):
    """Three batches of ``pretraining`` from JAX's initial parameters on
    both packages' drivers."""
    port = built["port"]
    changes = [("stages.pretraining.training.num_batches", "3")]
    jconf = JaxConfiguration(port["cfg_path"], config_changes=changes)
    jrec = jax_driver.create_model(jconf.ordered_stages["pretraining"],
                                   JaxData(**jconf["data"]))
    start = str(tmp_path / "start.zip")
    jax_checkpoint.save_checkpoint(start, param_path_dict(jrec.params))
    jloops = jax_driver.train_multistage(
        jconf, str(tmp_path / "jax"), start, final_stage="pretraining",
        fast_start=True)
    pconf = Configuration(port["cfg_path"], config_changes=changes)
    ploops = driver.train_multistage(
        pconf, str(tmp_path / "port"), start, final_stage="pretraining",
        fast_start=True, device="cpu")
    for key in ("train_cost", "total_gradient_norm"):
        times, got = ploops[0].log.channel(key)
        jtimes, ref = jloops[0].log.channel(key)
        assert times == jtimes == [1, 2, 3], key
        np.testing.assert_allclose(got, ref, rtol=1e-5, err_msg=key)
    ours = jax_checkpoint.load_parameters(
        str(tmp_path / "port" / "pretraining.zip"))
    theirs = jax_checkpoint.load_parameters(
        str(tmp_path / "jax" / "pretraining.zip"))
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.fixture(scope="module")
def trained(built, tmp_path_factory):
    """The port's checkpoint after the fast tier's stages on the CPU, and
    the tool's ``train_meta``."""
    save_dir = str(tmp_path_factory.mktemp("model"))
    meta, _ = qp.train(built["port"], save_dir, "cpu")
    return os.path.join(save_dir, "main.zip"), meta


def _jax_decode(rec, data, beam, kwargs):
    """JAX's ``decode_and_score`` and the best hypothesis of each
    utterance, from the outputs its timed calls return."""
    outs, search = [], rec.beam_search

    def capture(*args, **kw):
        out = search(*args, **kw)
        outs.append(out)
        return out
    rec.beam_search = capture
    try:
        row = jqp.decode_and_score(rec, data, beam, kwargs, limit=LIMIT)
    finally:
        del rec.beam_search
    # the first batch runs twice: its warm-up call, then the timed one
    return row, _best([(len(out["done_valid"]), out) for out in outs[1:]])


def _best(outputs):
    """The best hypotheses of ``decode_and_score``'s ``outputs``."""
    hyps = [qp.best_hypothesis({k: np.asarray(v) for k, v in out.items()},
                               j)
            for n, out in outputs for j in range(n)]
    return hyps[:LIMIT]


@pytest.mark.parametrize("lm,beam,char_discount", [
    (False, 10, 0.1), (True, 10, 1.0), (False, 20, 0.1)])
def test_decodes_of_a_trained_checkpoint_match_jax(built, trained, lm, beam,
                                                   char_discount):
    port = built["port"]
    ckpt, meta = trained
    assert meta["train_kernel_launches"] == dict.fromkeys(qp.TRAIN_KERNELS,
                                                          0)
    data = Data(**port["config"]["data"])
    jconf = JaxConfiguration(port["cfg_path"])
    jdata = JaxData(**jconf["data"])
    if lm:
        rec = qp.lm_model(port, data, ckpt, "cpu")
        jconf["net"]["lm"] = {"path": port["lm_npz"], "weight": 0.5,
                              "no_transition_cost": 20.0}
    else:
        rec = driver.create_model(port["config"], data, ckpt, device="cpu")
    jrec = jax_driver.create_model(jconf, jdata, ckpt)
    kwargs = dict(SEARCH, char_discount=char_discount)
    outputs = []
    row = qp.decode_and_score(rec, data, beam, kwargs, limit=LIMIT,
                              outputs=outputs)
    hyps = _best(outputs)
    jrow, jhyps = _jax_decode(jrec, jdata, beam, kwargs)
    assert hyps == jhyps
    assert sum(h is not None for h in hyps) > LIMIT // 2
    for key in ("cer", "wer", "empty", "utterances", "beam", "batch"):
        assert row[key] == jrow[key], key
    assert row["launches"] == dict.fromkeys(qp.DECODE_KERNELS, 0)


def test_module_imports_no_jax():
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'flax', 'attention_lvcsr_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import attention_lvcsr_torch.cli.quality_proxy\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'attention_lvcsr_tpu', 'h5py') "
            "and sys.modules[m] is not None)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_h5_path_without_h5py_raises(monkeypatch, tmp_path):
    """No silent switch of data path: only ``--in-memory`` reads arrays."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(RuntimeError, match="--in-memory"):
        qp.build(str(tmp_path), SEED, "fast")
    assert not os.listdir(tmp_path)


def test_cli_flags_exist():
    out = subprocess.run(
        [sys.executable, "-m", "attention_lvcsr_torch.cli.quality_proxy",
         "--help"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0
    for flag in ("--out", "--work", "--fast", "--tier", "--seed",
                 "--skip-train", "--epochs", "--pad", "--device",
                 "--in-memory"):
        assert flag in out.stdout
