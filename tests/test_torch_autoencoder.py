"""``prototype_autoencoder.yaml`` through the port's entry points against
the JAX package (CPU, f32 both sides), on a seeded text-only dataset
(``cli/make_toy_dataset.py::make_text_dataset``: ``inputs`` equal to the
labels, one character map): a lookup bottom over integer tokens, a GRU
encoder, content attention, the decoder states in the readout and no
post-merge layer, at widths cut to a few units.

* ``tests/configs/autoencoder.yaml``, a child config whose ``parent:``
  names the prototype, resolves to the same config in both packages;
* three batches of ``run.py train`` (the port's ``train`` driver), from
  the same checkpoint: the same per-batch ``train_cost`` and validation
  records (rtol 1e-5, as ``test_torch_training_services.py``), the same
  files and parameters (rtol 1e-4, atol 1e-6);
* the search: the port's ``beam_search`` of the validation utterances
  gives the JAX package's hypotheses (every finished one, tokens
  identical, costs within 1e-5), and ``run.py search`` prints them.  The
  JAX package's own ``search`` entry cannot run this model: it casts the
  inputs to float32, which its ``nn.Embed`` refuses; the port's keeps
  them integer, and ``run.py sample`` does too."""
import io
import os

import numpy as np
import pytest

from attention_lvcsr_torch.cli import run
from attention_lvcsr_torch.cli.make_toy_dataset import make_text_dataset
from attention_lvcsr_torch.config import Configuration
from attention_lvcsr_torch.data import Data
from attention_lvcsr_torch.train import driver
from attention_lvcsr_tpu.config import Configuration as JaxConfiguration
from attention_lvcsr_tpu.data import Data as JaxData
from attention_lvcsr_tpu.models.recognizer import param_path_dict
from attention_lvcsr_tpu.train import checkpoint as jax_checkpoint
from attention_lvcsr_tpu.train import driver as jax_driver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The text dataset, the config, and three batches trained by each
    package from the same JAX-written start: (config path, tmp dir, JAX
    loop, port loop)."""
    tmp = tmp_path_factory.mktemp("autoencoder")
    make_text_dataset(str(tmp / "text.h5"), num_examples=40, num_chars=4,
                      max_len=6, seed=5)
    path = tmp / "autoencoder.yaml"
    text = open(os.path.join(ROOT, "tests", "configs",
                             "autoencoder.yaml")).read()
    path.write_text(text.replace("/tmp/text.h5", str(tmp / "text.h5")))
    jconf = JaxConfiguration(str(path))
    jrec = jax_driver.create_model(jconf, JaxData(**jconf["data"]))
    start = str(tmp / "start.zip")
    jax_checkpoint.save_checkpoint(start, param_path_dict(jrec.params))
    for name in ("jax", "port"):
        (tmp / name).mkdir()
    jloop = jax_driver.train(jconf, str(tmp / "jax" / "model.zip"), start)
    ploop = driver.train(Configuration(str(path)),
                         str(tmp / "port" / "model.zip"), start,
                         device="cpu")
    return str(path), tmp, jloop, ploop


def test_prototype_resolves_as_in_jax(trained):
    path = trained[0]
    ours, theirs = Configuration(path), JaxConfiguration(path)
    for section in ("net", "data", "training", "monitoring",
                    "initialization"):
        assert dict(ours[section]) == dict(theirs[section]), section
    net = ours["net"]
    assert net["bottom"] == {"bottom_class": "LookupBottom", "dim": 10}
    assert net["attention_type"] == "content"
    assert net["use_states_for_readout"] is True
    assert not net.get("post_merge_dims")


def test_three_batches_match_jax(trained):
    _, tmp, jloop, ploop = trained
    for record in ("train_cost", "valid_sequence_total_cost", "valid_per"):
        times, values = ploop.log.channel(record)
        jtimes, jvalues = jloop.log.channel(record)
        assert times == jtimes and times, record
        np.testing.assert_allclose(values, jvalues, rtol=1e-5,
                                   err_msg=record)
    assert ploop.log.channel("train_cost")[0] == [1, 2, 3]
    files = sorted(os.listdir(tmp / "port"))
    assert files == sorted(os.listdir(tmp / "jax"))
    assert "model.zip" in files
    for name in files:
        theirs = jax_checkpoint.load_parameters(str(tmp / "jax" / name))
        ours = jax_checkpoint.load_parameters(str(tmp / "port" / name))
        assert set(ours) == set(theirs)
        assert "/recognizer/bottom/lookup/embedding" in ours
        for k, v in theirs.items():
            np.testing.assert_allclose(ours[k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name}: {k}")


def _valid(path):
    jconf = JaxConfiguration(path)
    data = JaxData(**jconf["data"])
    return jconf, data, list(data.get_stream("valid", batches=False,
                                             shuffle=False))


def test_search_matches_jax(trained):
    """The validation utterances, one batch of integer tokens through both
    packages' ``beam_search`` (both take their module paths: no
    post-merge layer), every finished hypothesis; then ``run.py search``
    prints the JAX package's best hypotheses."""
    path, tmp, _, _ = trained
    ckpt = str(tmp / "jax" / "model.zip")
    jconf, data, examples = _valid(path)
    jrec = jax_driver.create_model(jconf, data, ckpt)
    rec = driver.create_model(Configuration(path), Data(**jconf["data"]),
                              ckpt, device="cpu")
    T = max(len(ex["inputs"]) for ex in examples)
    x = np.zeros((len(examples), T), np.int64)
    m = np.zeros((len(examples), T), np.float32)
    for i, ex in enumerate(examples):
        x[i, :len(ex["inputs"])] = ex["inputs"]
        m[i, :len(ex["inputs"])] = 1.0
    for r in (jrec, rec):
        r.init_beam_search(10)
    kw = dict(as_arrays=True, char_discount=4.0, pad_frames_multiple=1,
              stop_on="optimistic_future_cost")
    ref = jrec.beam_search(x, m, **kw)
    got = rec.beam_search(x, m, **kw)
    assert int(got["steps"]) == int(ref["steps"])
    assert got["done_valid"].sum() == ref["done_valid"].sum() > 10
    for u, k in zip(*np.nonzero(ref["done_valid"])):
        n = ref["done_len"][u, k]
        assert got["done_len"][u, k] == n
        np.testing.assert_array_equal(got["done_out"][u, k, :n],
                                      ref["done_out"][u, k, :n])
        np.testing.assert_allclose(got["done_cost"][u, k],
                                   ref["done_cost"][u, k], rtol=1e-5,
                                   atol=1e-5)

    buf = io.StringIO()
    driver.search(Configuration(path), ckpt, device="cpu", print_to=buf)
    recognized = [line[len("Recognized: "):] for line in
                  buf.getvalue().splitlines()
                  if line.startswith("Recognized:")]
    dataset = data.get_dataset("valid")
    expected = []
    for ex in examples:
        outputs, _ = jrec.beam_search(np.asarray(ex["inputs"]),
                                      char_discount=4.0,
                                      stop_on="optimistic_future_cost")
        expected.append(dataset.pretty_print(outputs[0], ex))
    assert recognized == expected
    assert any(expected), "vacuous: every hypothesis empty"


def test_jax_search_entry_casts_tokens_to_float(trained):
    """Why the test above calls the JAX package's ``beam_search``: its
    ``search`` entry fails on a lookup model."""
    path, tmp, _, _ = trained
    with pytest.raises(ValueError, match="integer"):
        jax_driver.search(JaxConfiguration(path),
                          str(tmp / "jax" / "model.zip"))


def test_cli_train_search_and_sample(trained, tmp_path, capsys):
    """The README's CPU commands: ``run.py train`` for three batches, then
    ``search`` and ``sample`` of the validation part."""
    path = trained[0]
    save = str(tmp_path / "cli.zip")
    run.main(["train", save, path, "--device", "cpu"])
    assert os.path.exists(save)
    run.main(["search", path, "--params", save, "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("Recognized:") == len(_valid(path)[2])
    run.main(["sample", path, "--params", save, "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("Recognized:") == len(_valid(path)[2])


def test_prototype_copies_match(tmp_path):
    """The port's ``prototype_autoencoder.yaml`` is the JAX package's file,
    and the config ``chip_smoke.py`` reads on the card
    (``autoencoder_config``: a file whose ``parent:`` names the JAX
    package's prototype, through the port's loader) is its content with
    four batches."""
    import chip_smoke
    from attention_lvcsr_torch.config import read_config
    ours, theirs = (os.path.join(ROOT, pkg, "config", "prototypes",
                                 "prototype_autoencoder.yaml")
                    for pkg in ("attention_lvcsr_torch",
                                "attention_lvcsr_tpu"))
    assert open(ours).read() == open(theirs).read()
    with open(theirs) as f:
        want = read_config(f)
    want["training"]["num_batches"] = 4
    assert dict(chip_smoke.autoencoder_config(str(tmp_path))) == want
