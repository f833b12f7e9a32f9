"""The port's search driver against the JAX package's (CPU).

``weights_std`` and ``SpeechRecognizer.analyze`` (the teacher-forced cost
and alignment the driver prints) match the JAX package's on the same
weights, with and without an LM, under both priors and both decoder
routes; ``run.py search`` on the toy dataset (``tools/make_toy_dataset.py``
as ``tests/test_cli.py`` makes it), from a JAX-written checkpoint whose
EOS logit is raised, prints the JAX package's report line for line (the
numbers within float32 rounding, ``Decoding took`` apart), returns the
same totals and writes the same decoded file, one utterance at a time and
in chunks of 4, with and without ``net.lm``, ``--nll-only``,
``--decode-only`` and ``--report``; ``show_data``, ``init_norm`` and
``test`` do what the JAX entries do."""
import io
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from __graft_entry__ import _tiny_net_config
from attention_lvcsr_tpu.cli import run as jax_run
from attention_lvcsr_tpu.config import Configuration as JaxConfiguration
from attention_lvcsr_tpu.data import Data as JaxData
from attention_lvcsr_tpu.models.recognizer import \
    SpeechRecognizer as JaxRecognizer
from attention_lvcsr_tpu.models.recognizer import param_path_dict
from attention_lvcsr_tpu.ops import fst as jax_fst
from attention_lvcsr_tpu.ops.expressions import \
    weights_std as jax_weights_std
from attention_lvcsr_tpu.train import checkpoint as jax_checkpoint
from attention_lvcsr_tpu.train import driver as jax_driver
from attention_lvcsr_torch.cli import run
from attention_lvcsr_torch.config import Configuration
from attention_lvcsr_torch.models.params import load_path_dict
from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
from attention_lvcsr_torch.ops.expressions import weights_std
from attention_lvcsr_torch.train import driver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tiny widths of test_torch_training_services.py; a character
# discount of 2.5 makes the random model's best hypotheses non-empty
WIDTHS = ["net.dim_dec", "8", "net.dims_bidir", "[6]",
          "net.dim_matcher", "8", "net.post_merge_dims", "[8]",
          "monitoring.search.char_discount", "2.5"]
CHARS = ["a", "b", "c", "d", "<eol>"]
# the training part, shuffled with seed 1: 16 utterances of the toy set
PART = dict(part="train", seed=1)


def test_weights_std_matches_jax():
    rng = np.random.RandomState(0)
    w = rng.rand(7, 3, 11).astype(np.float32)
    w /= w.sum(axis=2, keepdims=True)
    mask = (np.arange(7)[:, None] < np.array([[7, 5, 2]])).astype("f")
    for m in (None, mask):
        # float32 sums of up to 11 terms (1e-6 relative)
        np.testing.assert_allclose(
            float(weights_std(w, m)),
            float(jax_weights_std(jnp.asarray(w),
                                  None if m is None else jnp.asarray(m))),
            rtol=1e-6)


def _lm_fst(path):
    """A random bigram LM over the toy characters, an FST text file with
    its ``.syms`` (the construction of ``test_torch_lm.py``)."""
    from test_torch_lm import _arpa
    arpa, _ = _arpa(5, seed=5)
    arpa = {order: {tuple(CHARS[int(t[1:])] if t.startswith("c") else t
                          for t in gram): value
                    for gram, value in grams.items()}
            for order, grams in arpa.items()}
    syms = {c: i + 1 for i, c in enumerate(CHARS)}
    jax_fst.write_fst_text(jax_fst.arpa_to_fst(arpa, syms), path)
    jax_fst.write_symbols(path + ".syms", dict(syms, **{"<eps>": 0}))
    return path


ANALYZE_INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.5],
                                "biases_init": ["isotropic_gaussian", 0.1],
                                "rec_weights_init": ["orthogonal"]}}
EXPANDING = {"type": "expanding", "initial_begin": 0, "initial_end": 6,
             "min_speed": 1.0, "max_speed": 2.0}


@pytest.fixture(scope="module")
def tiny_lm(tmp_path_factory):
    """A packed bigram over the tiny config's 32 symbols."""
    from test_torch_lm import _lm_npz
    return _lm_npz(str(tmp_path_factory.mktemp("lm")))


@pytest.mark.parametrize("mode", ["never", "interpret"])
@pytest.mark.parametrize("prior", ["median", "expanding"])
@pytest.mark.parametrize("lm", [False, True], ids=["no_lm", "lm"])
def test_analyze_matches_jax(lm, prior, mode, tiny_lm):
    """Costs and weights of a ragged batch (frames and labels) within
    1e-5: the JAX module scan or its Pallas decoder in interpret mode, the
    port's module scan or its plain decoder scan."""
    cfg = dict(_tiny_net_config(), use_pallas=mode)
    if prior == "expanding":
        cfg["prior"] = EXPANDING
    if lm:
        cfg["lm"] = {"path": tiny_lm, "weight": 0.5,
                     "no_transition_cost": 20.0}
    jrec = JaxRecognizer(cfg, init_config=ANALYZE_INIT, seed=3)
    rec = SpeechRecognizer(cfg, device="cpu")
    load_path_dict(rec.net, param_path_dict(jrec.params))
    rng = np.random.RandomState(2)
    B, T, TL = 3, 23, 7
    x = rng.randn(B, T, 12).astype(np.float32)
    xm = (np.arange(T)[None] < np.array([[T], [17], [11]])).astype("f")
    y = rng.randint(0, 32, size=(B, TL)).astype(np.int32)
    ym = (np.arange(TL)[None] < np.array([[TL], [5], [3]])).astype("f")
    ours = rec.analyze(x, xm, y, ym)
    theirs = jrec.analyze(jnp.asarray(x), jnp.asarray(xm), jnp.asarray(y),
                          jnp.asarray(ym))
    for key in ("costs", "weights", "energies"):
        assert ours[key].shape == theirs[key].shape, key
    for key in ("costs", "weights"):
        np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    assert np.isfinite(ours["costs"]).all() and ours["costs"].sum() > 0


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy dataset, its config, an LM over its characters, and a
    JAX-written checkpoint of the tiny widths with the EOS logit raised
    by 1."""
    d = tmp_path_factory.mktemp("search")
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_toy_dataset import make_toy_dataset
    make_toy_dataset(str(d / "toy.h5"), num_examples=20, num_chars=4,
                     feat_dim=5, max_len=4, seed=5)
    text = open(os.path.join(ROOT, "tests", "configs", "toy.yaml")).read()
    (d / "toy.yaml").write_text(text.replace("/tmp/toy.h5",
                                             str(d / "toy.h5")))
    lm = _lm_fst(str(d / "g.fst.txt"))
    jconf = JaxConfiguration(str(d / "toy.yaml"),
                             config_changes=_pairs(WIDTHS))
    data = JaxData(**jconf["data"])
    jrec = jax_driver.create_model(jconf, data)
    post = jrec.params["params"]["generator"]["readout"]["post_merge_0"]
    post["bias"] = post["bias"].at[data.eos_label].add(1.0)
    ckpt = str(d / "model.zip")
    jax_checkpoint.save_checkpoint(ckpt, param_path_dict(jrec.params))
    return {"dir": d, "config": str(d / "toy.yaml"), "ckpt": ckpt,
            "lm": ["net.lm.path", lm, "net.lm.weight", "0.5",
                   "net.lm.no_transition_cost", "20.0"]}


def _pairs(flat):
    return list(zip(flat[::2], flat[1::2]))


def _configs(toy, extra=()):
    changes = _pairs(WIDTHS + list(extra))
    return (JaxConfiguration(toy["config"], config_changes=changes),
            Configuration(toy["config"], config_changes=changes))


def _number(token):
    try:
        return float(token)
    except ValueError:
        return None


def assert_same_report(ours, theirs):
    """Line for line: the same words, and numbers within 1e-5 relative +
    1e-6 (float32 costs and weight spreads of two implementations; the
    CERs and counts are exact); ``Decoding took`` is a wall time."""
    a, b = ours.splitlines(), theirs.splitlines()
    assert len(a) == len(b), (len(a), len(b))
    for x, y in zip(a, b):
        if y.startswith("Decoding took:"):
            assert x.startswith("Decoding took:"), (x, y)
            continue
        tx, ty = x.split(), y.split()
        assert len(tx) == len(ty), (x, y)
        for u, v in zip(tx, ty):
            fu, fv = _number(u), _number(v)
            if fv is None:
                assert u == v, (x, y)
            elif math.isnan(fv):
                assert fu is not None and math.isnan(fu), (x, y)
            else:
                assert fu == pytest.approx(fv, rel=1e-5, abs=1e-6), (x, y)


def assert_same_stats(ours, theirs):
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        assert ours[k] == pytest.approx(v, rel=1e-6), k


def _recognized(report):
    """The texts of the ``Recognized:`` lines."""
    return [line[len("Recognized:"):].strip()
            for line in report.splitlines()
            if line.startswith("Recognized:")]


@pytest.mark.parametrize("run_name,extra,kwargs", [
    ("batch1", [], {}),
    ("batch4", ["monitoring.search.decode_batch", "4"], {}),
    ("lm_batch1", "lm", {}),
    ("lm_batch4", "lm+4", {}),
    ("nll_only", [], {"nll_only": True}),
    ("decode_only", ["monitoring.search.decode_batch", "4"],
     {"decode_only": [0, 2, 3, 7, 11, 14]}),
], ids=lambda v: v if isinstance(v, str) else None)
def test_search_matches_jax(toy, tmp_path, run_name, extra, kwargs):
    if extra == "lm":
        extra = toy["lm"]
    elif extra == "lm+4":
        extra = toy["lm"] + ["monitoring.search.decode_batch", "4"]
    jconf, conf = _configs(toy, extra)
    theirs, ours = io.StringIO(), io.StringIO()
    jstats = jax_driver.search(jconf, toy["ckpt"], print_to=theirs,
                               decoded_save=str(tmp_path / "jax.txt"),
                               **PART, **kwargs)
    stats = driver.search(conf, toy["ckpt"], print_to=ours,
                          decoded_save=str(tmp_path / "port.txt"),
                          device="cpu", **PART, **kwargs)
    assert_same_report(ours.getvalue(), theirs.getvalue())
    assert_same_stats(stats, jstats)
    decoded = open(tmp_path / "port.txt").read()
    assert decoded == open(tmp_path / "jax.txt").read()
    expected = len(kwargs.get("decode_only", range(16)))
    assert stats["num_examples"] == expected
    if kwargs.get("nll_only"):
        assert decoded == "" and not _recognized(ours.getvalue())
    else:
        texts = _recognized(ours.getvalue())
        assert len(texts) == expected
        assert sum(bool(t) for t in texts) * 2 >= expected, \
            "vacuous: most hypotheses are empty"


def test_cli_search_report_matches_jax(toy, tmp_path):
    """``run.py search --report`` of both packages: report.txt line for
    line, the same alignment plots (two for each non-empty hypothesis)."""
    args = ["search", toy["config"], "--params", toy["ckpt"], "--part",
            "train", "--seed", "1", "--decode-only", "range(0, 16, 3)"]
    jax_run.main(args + ["--report", str(tmp_path / "jax")] + WIDTHS)
    stats = run.main(args + ["--report", str(tmp_path / "port"), "--device",
                             "cpu"] + WIDTHS)
    assert stats["num_examples"] == 6
    report = open(tmp_path / "port" / "report.txt").read()
    assert_same_report(report,
                       open(tmp_path / "jax" / "report.txt").read())
    plots = sorted(os.listdir(tmp_path / "port" / "alignments"))
    assert plots == sorted(os.listdir(tmp_path / "jax" / "alignments"))
    assert len(plots) == 2 * sum(bool(t) for t in _recognized(report)) > 0


def test_show_data_prints_what_jax_prints(toy, capsys):
    jconf, _ = _configs(toy)
    jax_driver.show_data(jconf)
    theirs = capsys.readouterr().out
    run.main(["show_data", toy["config"]] + WIDTHS)
    assert capsys.readouterr().out == theirs
    assert "recordings: shape=" in theirs


def test_init_norm_matches_jax(toy, tmp_path, capsys):
    jconf, _ = _configs(toy)
    jax_driver.init_norm(jconf, str(tmp_path / "jax.npz"))
    theirs = capsys.readouterr().out
    run.main(["init_norm", str(tmp_path / "port.npz"), toy["config"]]
             + WIDTHS)
    ours = capsys.readouterr().out
    assert ours.replace("port.npz", "jax.npz") == theirs
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(a.files) == sorted(b.files)
    for name in a.files:
        np.testing.assert_array_equal(a[name], b[name])


def test_test_entry_raises_as_in_jax(toy):
    with pytest.raises(NotImplementedError):
        run.main(["test", toy["config"]] + WIDTHS)
