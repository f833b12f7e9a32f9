"""The port's training extensions and log exports against the JAX
package's (CPU).

The JAX and the port ``MainLoop`` run a stub algorithm that gives the same
monitors, as ``test_torch_training_services.py`` drives them, with each
extension of ``train/extensions.py`` in both: ``CodeVersion`` records the
same commit; the two ``GradientDescent``'s ``compile_stats`` have the same
keys and count the same shapes; ``Plot`` writes a byte-equal JSON (and a
PNG where matplotlib exists); ``PlotServer`` serves the same
``/data.json``, its page at ``/``, 404 elsewhere, and shuts down after
training; ``NanGuard`` raises in both, one batch apart (the recorded
deviation); ``LogInputs`` and ``ProgressBar`` print the same text;
``Printing(hide_regex=)`` hides what the JAX package hides; ``EmbedShell``
installs a SIGUSR1 handler; ``TorchProfiler`` traces its window of
batches.  The log's ``previous_row``, ``iter_rows``, ``to_dataframe`` and
``to_sqlite`` and the notebook helpers give the JAX package's results."""
import json
import os
import re
import signal
import sqlite3
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from attention_lvcsr_tpu.train import extensions as jax_ext
from attention_lvcsr_tpu.train.log import TrainingLog as JaxLog
from attention_lvcsr_tpu.train.loop import MainLoop as JaxLoop
from attention_lvcsr_torch.train import extensions as ext
from attention_lvcsr_torch.train import loop
from attention_lvcsr_torch.train.checkpoint import save_checkpoint
from attention_lvcsr_torch.train.log import TrainingLog
from attention_lvcsr_torch.utils import notebook

COSTS = [3.0, 2.5, 2.0, 1.75, 1.5, 1.25]
# the port's extensions live in train/loop.py (the core ones) and
# train/extensions.py (the rest); the JAX package's in one module
PORT = types.SimpleNamespace(**{**vars(loop), **vars(ext)})
PACKAGES = {"jax": (jax_ext, JaxLoop), "port": (PORT, loop.MainLoop)}


class _Algo:
    """Each batch's monitors: the next cost, a gradient norm, and an
    energy record that is an int."""
    params = {}
    opt_state = None

    def __init__(self, costs=COSTS):
        self.costs = list(costs)

    def process_batch(self, batch):
        cost = self.costs.pop(0)
        return {"train_cost": cost, "total_gradient_norm": cost * 2,
                "max_energy": 7}


def _batches(n=len(COSTS)):
    return [{"labels": np.arange(6).reshape(2, 3) + i,
             "labels_mask": np.array([[1, 1, 1], [1, 1, 0]], "f")}
            for i in range(n)]


def _run(package, extensions, costs=COSTS, epochs=1):
    module, main_loop = PACKAGES[package]
    loop_ = main_loop(_Algo(costs), lambda: _batches(len(costs)),
                      extensions=list(extensions)
                      + [module.FinishAfter(after_n_epochs=epochs)])
    return loop_.run() or loop_


def test_code_version_is_the_jax_packages():
    versions = {}
    for package, (module, _) in PACKAGES.items():
        loop_ = _run(package, [module.CodeVersion()])
        versions[package] = loop_.log.status["code_version"]
    assert versions["port"] == versions["jax"]
    assert versions["port"]


def test_compile_stats_keys_as_in_jax():
    import jax.numpy as jnp
    import optax
    from attention_lvcsr_tpu.train.algorithm import \
        GradientDescent as JaxGradientDescent
    from attention_lvcsr_torch.models.bottom import SpeechBottom
    from attention_lvcsr_torch.train.driver import GradientDescent

    jalgo = JaxGradientDescent(
        {"w": jnp.zeros(3)}, optax.sgd(0.1),
        lambda p, s, rng, x, m: (p, s, {"c": x.sum()}),
        batch_keys=("recordings", "recordings_mask"))

    class Rec:
        device = torch.device("cpu")
        net = types.SimpleNamespace(bottom=SpeechBottom)

        def inputs_tensor(self, x):
            return torch.as_tensor(x, dtype=torch.float32)

        def optimized(self):
            return {}

    class Opt:
        def init(self, params):
            return ()

    algo = GradientDescent(Rec(), Opt(), lambda state, *a, **k: (
        state, {"c": a[0].sum()}))
    for T in (4, 4, 6):
        batch = {"recordings": np.ones((2, T, 3), "f"),
                 "recordings_mask": np.ones((2, T), "f"),
                 "labels": np.zeros((2, 2), "i"),
                 "labels_mask": np.ones((2, 2), "f")}
        jalgo.process_batch(batch).items()
        algo.process_batch(batch)
    assert set(algo.compile_stats) == set(jalgo.compile_stats) == {
        "compile_time_s", "num_compiled_shapes"}
    assert algo.compile_stats["num_compiled_shapes"] == \
        jalgo.compile_stats["num_compiled_shapes"] == 2
    assert algo.compile_stats["compile_time_s"] > 0
    # the port copies them into the status after the batches
    loop_ = loop.MainLoop(algo, lambda: [batch], extensions=[
        ext.CompilationStatistics(), loop.FinishAfter(after_n_epochs=1)])
    loop_.run()
    assert loop_.log.status["num_compiled_shapes"] == 2


def test_plot_json_is_the_jax_packages(tmp_path):
    written = {}
    for package, (module, _) in PACKAGES.items():
        path = str(tmp_path / package)
        _run(package, [module.Plot(path, [["train_cost"],
                                          ["total_gradient_norm",
                                           "max_energy", "missing"]],
                                   every_n_batches=2)])
        written[package] = open(path + ".json", "rb").read()
    assert written["port"] == written["jax"]
    series = json.loads(written["port"])
    assert [v for _, v in series["train_cost"]] == COSTS
    pytest.importorskip("matplotlib")
    assert os.path.getsize(tmp_path / "port.png") > 0


def test_plot_writes_the_json_when_drawing_fails(tmp_path, monkeypatch,
                                                 capsys):
    def broken(*args, **kwargs):
        raise ImportError("No module named 'matplotlib'")
    monkeypatch.setattr(notebook, "plot_channels", broken)
    path = str(tmp_path / "curves")
    _run("port", [ext.Plot(path, [["train_cost"]], every_n_batches=0)])
    assert "Plot: No module named 'matplotlib'" in capsys.readouterr().err
    assert not os.path.exists(path + ".png")
    assert json.load(open(path + ".json"))["train_cost"][0] == [1, 3.0]


def test_plot_server_serves_what_jax_serves():
    fetched = {}
    for package, (module, _) in PACKAGES.items():
        server = module.PlotServer([["train_cost"], ["max_energy"]], port=0)
        got = fetched[package] = {}

        class Probe(module.TrainingExtension):
            def after_epoch(self):
                base = f"http://127.0.0.1:{server.port}"
                with urllib.request.urlopen(base + "/", timeout=10) as r:
                    got["html"] = r.read().decode()
                with urllib.request.urlopen(base + "/data.json",
                                            timeout=10) as r:
                    got["data"] = json.loads(r.read())
                try:
                    urllib.request.urlopen(base + "/nope", timeout=10)
                except urllib.error.HTTPError as e:
                    got["missing"] = e.code

        _run(package, [server, Probe()])
        assert server._httpd is None            # shut down after training
    assert fetched["port"] == fetched["jax"]
    assert "<canvas" in fetched["port"]["html"] or \
        "canvas" in fetched["port"]["html"]
    assert fetched["port"]["missing"] == 404
    assert [v for _, v in fetched["port"]["data"][0]["train_cost"]] == COSTS


def test_plot_server_shuts_down_on_error():
    server = ext.PlotServer([["train_cost"]], port=0)
    costs = [1.0, float("nan"), 1.0]
    with pytest.raises(FloatingPointError):
        _run("port", [server, ext.NanGuard()], costs=costs)
    assert server._httpd is None


@pytest.mark.parametrize("package,iteration", [("jax", 3), ("port", 2)])
def test_nan_guard_raises_at_the_pinned_iteration(package, iteration):
    """The NaN comes from batch 2: the JAX package records monitors one
    batch late and raises at batch 3; the port raises at batch 2."""
    module, _ = PACKAGES[package]
    with pytest.raises(FloatingPointError) as info:
        _run(package, [module.NanGuard()],
             costs=[1.0, float("nan"), 5.0, 4.0])
    assert str(info.value) == \
        f"non-finite train_cost=nan at iteration {iteration}"


class _Chars:
    def pretty_print(self, labels, example):
        return "".join(chr(97 + int(c)) for c in labels)


def test_log_inputs_and_progress_bar_print_what_jax_prints(capsys):
    printed = {}
    costs = [1.0] * 12
    for package, (module, _) in PACKAGES.items():
        capsys.readouterr()
        _run(package, [module.LogInputs(_Chars(), every_n_batches=5,
                                        with_gains=True),
                       module.ProgressBar()], costs=costs)
        # the rate is the one number that differs between two runs
        printed[package] = re.sub(r"\(\d+\.\d it/s\)", "(R it/s)",
                                  capsys.readouterr().err)
    assert printed["port"] == printed["jax"]
    assert "--- inputs at iteration 10 ---\n  jkl\n  mn\n" in printed["port"]
    assert "batch 10 (R it/s)" in printed["port"]


def test_log_inputs_appends_to_its_file(tmp_path):
    files = {}
    for package, (module, _) in PACKAGES.items():
        path = tmp_path / f"{package}.txt"
        _run(package, [module.LogInputs(_Chars(), dump_path=str(path),
                                        every_n_batches=2)])
        files[package] = path.read_text()
    assert files["port"] == files["jax"]
    assert files["port"].count("--- inputs") == 3


def test_printing_hides_what_jax_hides(capsys):
    printed = {}
    for package, (module, _) in PACKAGES.items():
        capsys.readouterr()
        _run(package, [module.Printing(hide_regex="total_|max_")])
        printed[package] = capsys.readouterr().out
    assert printed["port"] == printed["jax"]
    assert "train_cost: 1.25" in printed["port"]
    assert "total_gradient_norm" not in printed["port"]
    assert "max_energy" not in printed["port"]


def test_embed_shell_installs_a_sigusr1_handler():
    old = signal.getsignal(signal.SIGUSR1)
    try:
        ext.EmbedShell().before_training()
        handler = signal.getsignal(signal.SIGUSR1)
        assert callable(handler) and handler is not old
    finally:
        signal.signal(signal.SIGUSR1, old)


class _Traced(_Algo):
    def process_batch(self, batch):
        n = len(COSTS) - len(self.costs)
        with torch.profiler.record_function(f"batch_{n}"):
            torch.ones(8).add_(1.0)
        return super().process_batch(batch)


def test_torch_profiler_traces_its_window(tmp_path):
    prof = ext.TorchProfiler(str(tmp_path / "trace"), start_batch=1,
                             num_batches=2)
    main = loop.MainLoop(_Traced(), _batches, extensions=[
        prof, loop.FinishAfter(after_n_epochs=1)])
    main.run()
    assert prof.path == str(tmp_path / "trace" / "trace_1_3.json")
    events = json.load(open(prof.path))["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"batch_1", "batch_2"} <= names
    assert not names & {"batch_0", "batch_3", "batch_4"}
    assert prof._prof is None


def test_torch_profiler_stops_after_training(tmp_path):
    prof = ext.TorchProfiler(str(tmp_path), start_batch=4, num_batches=10)
    main = loop.MainLoop(_Traced(), _batches, extensions=[
        prof, loop.FinishAfter(after_n_epochs=1)])
    main.run()
    assert prof._prof is None and os.path.exists(prof.path)


def _log_pair():
    logs = (TrainingLog(), JaxLog())
    for log in logs:
        for t in (1, 2, 4):
            log.record(t, "train_cost", 1.0 / t)
        log.record(2, "saved_to", "m.zip")
        log.record(4, "weights", np.arange(3))      # not JSON
        log.record(3, "flag", True)
        log.status["iterations_done"] = 4
    return logs


def test_log_exports_are_the_jax_packages(tmp_path):
    ours, theirs = _log_pair()
    assert dict(ours.previous_row) == dict(theirs.previous_row)
    rows, jrows = list(ours.iter_rows()), list(theirs.iter_rows())
    assert [t for t, _ in rows] == [t for t, _ in jrows] == [1, 2, 3, 4]
    for (_, a), (_, b) in zip(rows, jrows):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    pytest.importorskip("pandas")
    frame, jframe = ours.to_dataframe(), theirs.to_dataframe()
    assert list(frame.index) == list(jframe.index)
    assert list(frame.columns) == list(jframe.columns)
    assert frame.drop(columns="weights").equals(
        jframe.drop(columns="weights"))
    tables = []
    for log, name in ((ours, "port.db"), (theirs, "jax.db")):
        log.to_sqlite(str(tmp_path / name))
        with sqlite3.connect(str(tmp_path / name)) as conn:
            tables.append(conn.execute(
                "SELECT * FROM log ORDER BY name, time").fetchall())
    assert tables[0] == tables[1]
    assert ("weights" in {r[1] for r in tables[0]})


def test_notebook_reads_the_log_of_a_checkpoint(tmp_path):
    ours, _ = _log_pair()
    path = str(tmp_path / "m.zip")
    save_checkpoint(path, {"/recognizer/w": np.zeros(2, "f")},
                    log_state=ours.state_dict())
    back = notebook.load_log(path)
    assert back.channel("train_cost") == ours.channel("train_cost")
    pytest.importorskip("pandas")
    frame = notebook.log_to_dataframe(path)
    assert list(frame.index) == [1, 2, 3, 4]
    save_checkpoint(str(tmp_path / "bare.zip"),
                    {"/recognizer/w": np.zeros(2, "f")})
    with pytest.raises(ValueError, match="no training log"):
        notebook.load_log(str(tmp_path / "bare.zip"))
    assert notebook.wav_player(np.zeros(10)).startswith("<audio")
