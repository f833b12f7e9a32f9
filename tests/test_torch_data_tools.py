"""The port's dataset, scoring, checkpoint and configuration tools against
the JAX package's: ``cli.make_toy_dataset`` and every subcommand of
``cli.kaldi2hdf`` write the datasets, attributes and split tables of
``tools/make_toy_dataset.py`` and ``tools/kaldi2hdf.py``; ``cli.score``,
``cli.edit_params`` and ``cli.print_config`` print (and write) what
``tools/score.py``, ``tools/edit_params.py`` and ``tools/print_config.py``
do.  Each tool runs in-process through its ``main(argv)``."""
import contextlib
import importlib.util
import io
import os
import wave

import h5py
import numpy as np
import pytest

from attention_lvcsr_torch.cli import edit_params as port_edit
from attention_lvcsr_torch.cli import kaldi2hdf as port_kaldi
from attention_lvcsr_torch.cli import make_toy_dataset as port_toy
from attention_lvcsr_torch.cli import print_config as port_print
from attention_lvcsr_torch.cli import score as port_score

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX = {name: _tool(name) for name in ("kaldi2hdf", "make_toy_dataset",
                                      "score", "edit_params",
                                      "print_config")}


def _run(main, argv, cwd=None):
    """(stdout, exit code, return value) of ``main(argv)``."""
    buf = io.StringIO()
    code, value = 0, None
    with contextlib.redirect_stdout(buf), \
            contextlib.chdir(cwd or os.getcwd()):
        try:
            value = main(argv)
        except SystemExit as exc:
            code = exc.code
    return buf.getvalue(), code, value


def _h5_items(path):
    """Every dataset (dtype, shape, values, dimension labels) and every
    attribute of a file; references in the split table replaced by the
    indices they point to."""
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if not isinstance(obj, h5py.Dataset):
                return
            values = obj[...]
            if obj.dtype.kind == "O":
                values = [np.asarray(v).tolist() if not isinstance(
                    v, (bytes, str)) else v for v in values]
            else:
                values = values.tolist()
            out[name] = (str(obj.dtype), obj.shape, values,
                         [d.label for d in obj.dims],
                         {k: _attr(f, v) for k, v in obj.attrs.items()
                          if not k.startswith(("DIMENSION", "REFERENCE",
                                               "CLASS", "NAME"))})
        f.visititems(visit)
        out["/attrs"] = {k: _attr(f, v) for k, v in f.attrs.items()}
    return out


def _attr(f, value):
    value = np.asarray(value)
    if value.dtype.names and "indices" in value.dtype.names:
        return [tuple(f[row[n]][...].tolist() if n == "indices" and row[n]
                      else (None if n == "indices" else row[n].tolist())
                      for n in value.dtype.names) for row in value]
    return (str(value.dtype), value.tolist())


def _same_h5(got, ref):
    a, b = _h5_items(got), _h5_items(ref)
    assert sorted(a) == sorted(b)
    assert len(b) > 1, "vacuous: an empty file"
    for name in b:
        assert a[name] == b[name], name


@pytest.mark.parametrize("kw", [
    {}, {"num_examples": 30, "num_chars": 4, "feat_dim": 5, "seed": 3}],
    ids=["defaults", "small"])
def test_make_toy_dataset_writes_what_jax_writes(kw, tmp_path):
    """The port's command line against the JAX script's function (which
    parses its arguments under ``__main__`` alone) and its line."""
    argv = [str(tmp_path / "port.h5")]
    for key, value in kw.items():
        argv += ["--" + key.replace("_", "-"), str(value)]
    got = _run(port_toy.main, argv)[0]
    path = str(tmp_path / "jax.h5")
    vm = JAX["make_toy_dataset"].make_toy_dataset(path, **kw)
    assert got == f"wrote {argv[0]} with alphabet {vm}\n"
    _same_h5(argv[0], path)


def _write_wav(path, samples, rate):
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.asarray(samples, "<i2").tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four wavs (8 and 16 kHz, 0.2-0.5 s, seeded), their scp, a Kaldi text
    archive of features, character and phone transcripts, a symbol table
    and the uttid lists of two splits."""
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(23)
    uttids = [f"spk1_utt{i}" for i in range(4)]
    scp, ark = [], []
    for i, u in enumerate(uttids):
        rate = 16000 if i % 2 else 8000
        path = str(d / f"{u}.wav")
        _write_wav(path, rng.randint(-3000, 3000,
                                     size=int(rate * (0.2 + 0.1 * i))), rate)
        scp.append(f"{u} {path}\n")
        rows = rng.randn(3 + i, 5)
        ark.append(f"{u}  [\n" + "".join(
            "  " + " ".join(f"{x:.5f}" for x in r) + ("\n" if j < len(rows)
                                                      - 1 else " ]\n")
            for j, r in enumerate(rows)))
    (d / "wav.scp").write_text("".join(scp))
    (d / "feats.ark").write_text("".join(ark))
    (d / "text").write_text("".join(
        f"{u} THE CAT{'S' * i} SAT{'!' if i == 2 else ''}\n"
        for i, u in enumerate(uttids)))
    (d / "phones").write_text("".join(
        f"{u} sil dh ah k ae t{' s' * i} sil\n" for i, u in enumerate(uttids)))
    (d / "chars.txt").write_text("".join(
        f"{c} {i}\n" for i, c in enumerate(
            ["<spc>", "<noise>", "<eol>", "A", "C", "E", "H", "S", "T"])))
    (d / "train.lst").write_text("".join(f"{u}\n" for u in uttids[:3]))
    (d / "test.lst").write_text(f"{uttids[3]} extra\n")
    return str(d)


# the steps of a dataset build, in order; each runs on the port's file and
# on JAX's, which must then be the same (``{d}`` the corpus, ``{h5}`` the
# file); the read-* steps print (or write) what JAX's print
BUILDS = {
    "wavs_text_split": [
        ["add-wavs", "{h5}", "{d}/wav.scp"],
        ["add-text", "{h5}", "{d}/text"],
        ["split", "{h5}", "train={d}/train.lst", "test={d}/test.lst"],
        ["add-label", "{h5}", "<bol>"],
        ["read-symbols", "{h5}"],
        ["read-symbols", "{h5}", "syms.txt"],
        ["read-text", "{h5}"],
        ["read-text", "{h5}", "text_test.txt", "--subset", "test"]],
    "wavs_options_symbols": [
        ["add-wavs", "{h5}", "{d}/wav.scp", "--num-bins", "23", "--deltas",
         "1", "--no-energy", "--source", "fbank"],
        ["add-text", "{h5}", "{d}/text", "--symbols", "{d}/chars.txt"],
        ["add-label", "{h5}", "<bol>", "--id", "40"],
        ["read-text", "{h5}"]],
    "ark_tokens": [
        ["add-ark", "{h5}", "{d}/feats.ark"],
        ["add-text", "{h5}", "{d}/phones", "--tokens", "--source",
         "phones"],
        ["split", "{h5}", "all={d}/train.lst"],
        ["read-symbols", "{h5}", "--source", "phones"],
        ["read-text", "{h5}", "--source", "phones", "--subset", "all"]],
}


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_kaldi2hdf_writes_what_jax_writes(build, corpus, tmp_path):
    for name in ("port", "jax"):
        (tmp_path / name).mkdir()
    printed = []
    for argv in BUILDS[build]:
        outs = {}
        for name, main in (("port", port_kaldi.main),
                           ("jax", JAX["kaldi2hdf"].main)):
            args = [a.format(d=corpus, h5="data.h5") for a in argv]
            outs[name] = _run(main, args, str(tmp_path / name))
        assert outs["port"] == outs["jax"], argv
        wrote = tmp_path / "jax" / args[2] if len(args) > 2 else None
        printed.append(outs["jax"][0] or (wrote is not None and
                                          wrote.is_file() and
                                          wrote.stat().st_size > 0))
    _same_h5(str(tmp_path / "port" / "data.h5"),
             str(tmp_path / "jax" / "data.h5"))
    for name in os.listdir(tmp_path / "jax"):
        if name.endswith(".txt"):
            assert (tmp_path / "port" / name).read_bytes() == \
                (tmp_path / "jax" / name).read_bytes(), name
    assert all(printed), "vacuous: a step printed and wrote nothing"


def test_kaldi2hdf_refuses_as_jax_refuses(corpus, tmp_path):
    """A second label of the same name, a token outside the table, and
    sources whose utterances differ stop both tools with one message."""
    for name in ("port", "jax"):
        (tmp_path / name).mkdir()
    (tmp_path / "other.scp").write_text(
        open(os.path.join(corpus, "wav.scp")).read().split("\n", 1)[1])
    (tmp_path / "phones").write_text("spk1_utt0 sil zz\n")
    steps = [
        ["add-text", "data.h5", f"{corpus}/text"],
        ["add-label", "data.h5", "<eol>"],
        ["add-wavs", "data.h5", str(tmp_path / "other.scp")],
        ["add-text", "t.h5", str(tmp_path / "phones"), "--tokens",
         "--symbols", f"{corpus}/chars.txt"]]
    codes = []
    for argv in steps:
        outs = {name: _run(main, argv, str(tmp_path / name))
                for name, main in (("port", port_kaldi.main),
                                   ("jax", JAX["kaldi2hdf"].main))}
        assert outs["port"] == outs["jax"], argv
        codes.append(outs["jax"][1])
    assert codes[0] == 0 and all(isinstance(c, str) for c in codes[1:])


@pytest.fixture(scope="module")
def transcripts(tmp_path_factory):
    d = tmp_path_factory.mktemp("score")
    (d / "ref.txt").write_text(
        "u1 THE CAT SAT <noise>\nu2 A Dog [laughter] ran\n"
        "u3 on the mat\nu4 missing hyp\n")
    (d / "hyp.txt").write_text(
        "u1 the cat sat\nu2 A DOG ran ran\nu3 on a mat ~~\nu5 extra\n")
    return str(d)


@pytest.mark.parametrize("flags", [
    [], ["--lowercase"], ["--keep-tags"], ["--cer"], ["--per-utt"],
    ["--cer", "--per-utt", "--lowercase", "--keep-tags"]],
    ids=["plain", "lowercase", "keep-tags", "cer", "per-utt", "all"])
def test_score_prints_what_jax_prints(flags, transcripts):
    argv = [os.path.join(transcripts, "ref.txt"),
            os.path.join(transcripts, "hyp.txt")] + flags
    got = _run(port_score.main, argv)
    ref = _run(JAX["score"].main, argv)
    assert got == ref
    assert "%" in ref[0] and ref[2] > 0


@pytest.fixture()
def params(tmp_path):
    """A tar checkpoint (the JAX package's writer) and a raw npz."""
    from attention_lvcsr_tpu.train.checkpoint import (save_checkpoint,
                                                      save_parameters)
    rng = np.random.RandomState(4)
    arrays = {
        "/recognizer/generator/lookup/embeddings":
            rng.randn(33, 4).astype(np.float32),
        "/recognizer/generator/readout/bias": rng.randn(33).astype("f"),
        "/recognizer/encoder/kernel": rng.randn(4, 33).astype(np.float32),
        "/recognizer/encoder/steps": np.arange(5, dtype=np.int64)}
    save_checkpoint(str(tmp_path / "model.zip"), arrays,
                    meta={"iterations": 7})
    save_parameters(str(tmp_path / "overlay.npz"), {
        "/recognizer/encoder/kernel": np.zeros((4, 33), np.float32),
        "/recognizer/new/bias": np.ones(3, np.float32)})
    return str(tmp_path)


@pytest.mark.parametrize("argv", [
    ["list", "{d}/model.zip"],
    ["list", "{d}/overlay.npz"],
    ["grow", "{d}/model.zip", "out.npz", "--dim-size", "33"],
    ["grow", "{d}/model.zip", "out.npz", "--dim-size", "33", "--extra", "2",
     "--key", "readout"],
    ["rename", "{d}/model.zip", "out.npz", "^/recognizer/encoder",
     "/recognizer/bottom"],
    ["rename", "{d}/model.zip", "out.npz", "(bias|kernel)$", "steps"],
    ["extract", "{d}/model.zip", "out.npz", "generator"],
    ["extract", "{d}/model.zip", "out.npz", "nothing"],
    ["merge", "{d}/model.zip", "{d}/overlay.npz", "out.npz"]],
    ids=["list", "list-npz", "grow", "grow-key", "rename",
         "rename-collision", "extract", "extract-none", "merge"])
def test_edit_params_does_what_jax_does(argv, params, tmp_path):
    outs = {}
    for name, main in (("port", port_edit.main),
                       ("jax", JAX["edit_params"].main)):
        (tmp_path / name).mkdir()
        outs[name] = _run(main, [a.format(d=params) for a in argv],
                          str(tmp_path / name))
    assert outs["port"] == outs["jax"]
    assert outs["jax"][0] or outs["jax"][1], "vacuous: nothing happened"
    written = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == written
    for name in written:
        with np.load(tmp_path / "port" / name) as a, \
                np.load(tmp_path / "jax" / name) as b:
            assert a.files == b.files
            for key in b.files:
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("argv", [
    ["exp/wsj/configs/wsj_paper.yaml", "{net[dims_bidir]}"],
    ["exp/wsj/configs/wsj_paper.yaml", "{0}", "--positional"],
    ["exp/wsj/configs/wsj_paper.yaml", "{net[dim_dec]} {training[rules]}",
     "net.dim_dec", "300", "training.rules", "[adadelta]"],
    ["exp/wsj/configs/wsj_lm.yaml", "{net[lm]} {monitoring[search]}"],
    ["exp/wsj/configs/wsj_lm.yaml", "{0}", "--positional", "net.lm.weight",
     "0.25", "monitoring.search.beam_size", "20"]],
    ids=["paper-dims", "paper-whole", "paper-overrides", "lm-sections",
         "lm-whole-overrides"])
def test_print_config_prints_what_jax_prints(argv):
    got = _run(port_print.main, argv, ROOT)
    ref = _run(JAX["print_config"].main, argv, ROOT)
    assert got == ref
    assert len(ref[0]) > 10
