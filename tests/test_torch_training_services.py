"""The port's training services against the JAX package's (CPU).

The loop's trigger conditions fire where the JAX ``SimpleExtension``'s
fire, on one scripted callback sequence; the validation records of
``make_eval_fn`` equal the JAX package's on the same weights and batch;
``run.py train`` on the toy config (its ``monitoring.search`` removed,
validation every epoch) trains two epochs with both packages from the
same parameters and writes the same files, the same parameters and the
same validation records at the same iterations; with its
``monitoring.search`` kept, it writes the same beam-search error rates and
the same ``_best`` checkpoints; and it warns once for each config key it
does not honour."""
import logging
import os
import sys

import numpy as np
import pytest

from attention_lvcsr_tpu.config import Configuration as JaxConfiguration
from attention_lvcsr_tpu.data import Data as JaxData
from attention_lvcsr_tpu.models.recognizer import \
    SpeechRecognizer as JaxRecognizer
from attention_lvcsr_tpu.models.recognizer import param_path_dict
from attention_lvcsr_tpu.train import checkpoint as jax_checkpoint
from attention_lvcsr_tpu.train import driver as jax_driver
from attention_lvcsr_tpu.train import extensions as jax_extensions
from attention_lvcsr_tpu.data.pipeline import LengthFilter as JaxLengthFilter
from attention_lvcsr_tpu.train import monitoring as jax_monitoring
from attention_lvcsr_tpu.train.log import TrainingLog as JaxLog
from attention_lvcsr_torch.cli import run
from attention_lvcsr_torch.config import Configuration
from attention_lvcsr_torch.data.pipeline import LengthFilter
from attention_lvcsr_torch.models.params import load_path_dict
from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
from attention_lvcsr_torch.train import driver, loop
from attention_lvcsr_torch.train.log import TrainingLog
from attention_lvcsr_torch.train import monitoring
from attention_lvcsr_torch.train.monitoring import make_eval_fn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tiny widths of test_torch_checkpoint.py's CLI test
WIDTHS = [("net.dim_dec", "8"), ("net.dims_bidir", "[6]"),
          ("net.dim_matcher", "8"), ("net.post_merge_dims", "[8]"),
          ("data.batch_size", "4")]


def _script():
    """(callback, iterations_done, epochs_done, args) of three epochs of
    four batches, and an after_batch at iteration 0 first (a condition on
    batches must skip it)."""
    calls = [("before_training", 0, 0, ()), ("after_batch", 0, 0, ("b0",))]
    it = 0
    for epoch in range(3):
        calls.append(("before_epoch", it, epoch, ()))
        for _ in range(4):
            calls.append(("before_batch", it, epoch, (f"b{it}",)))
            it += 1
            calls.append(("after_batch", it, epoch, (f"b{it - 1}",)))
        calls.append(("after_epoch", it, epoch + 1, ()))
    calls.append(("after_training", it, 3, ()))
    return calls


def _fired(base, log_cls, conditions, extra):
    """What an extension built on ``base`` does over the script."""

    class Recorder(base):
        def do(self, which_callback, *args):
            status = self.main_loop.log.status
            done.append((which_callback, status["iterations_done"],
                         status["epochs_done"], args))

    class Loop:
        log = log_cls()

    done = []
    ext = Recorder().set_conditions(**conditions)
    for names, predicate, arguments in extra:
        ext.add_condition(names, predicate, arguments)
    ext.main_loop = Loop()
    for name, it, epoch, args in _script():
        Loop.log.status.update(iterations_done=it, epochs_done=epoch)
        ext.dispatch(name, *args)
    return done


def _odd_epoch(log):
    return log.status["epochs_done"] % 2 == 1


@pytest.mark.parametrize("conditions,extra", [
    ({"before_first_epoch": True}, []),
    ({"before_epoch": True, "after_training": True}, []),
    ({"every_n_epochs": 2}, []),
    ({"every_n_batches": 3}, []),
    ({"after_n_batches": 10}, []),
    ({"after_n_epochs": 2, "before_training": True}, []),
    ({"before_first_epoch": True, "after_epoch": True,
      "every_n_batches": 4}, []),
    ({"after_epoch": True},
     [(["after_epoch"], _odd_epoch, ("model_best_ll.zip",)),
      (["after_batch"], None, ())]),
    ({"every_n_epochs": 0, "before_first_epoch": False}, []),
], ids=["before_first_epoch", "before_epoch+after_training",
        "every_n_epochs", "every_n_batches", "after_n_batches",
        "after_n_epochs", "three", "add_condition_arguments", "all_off"])
def test_conditions_fire_as_in_jax(conditions, extra):
    ours = _fired(loop.SimpleExtension, TrainingLog, conditions, extra)
    theirs = _fired(jax_extensions.SimpleExtension, JaxLog, conditions,
                    extra)
    assert ours == theirs


def _monitors(it):
    """The synthetic monitors of batch ``it``."""
    return {"train_cost": 10.0 / it + 0.1 * (it % 3),
            "total_gradient_norm": float(it % 5), "batch_size": 2.0}


def _driven(ext, log, resume_at=0, epochs=3, batches=4, best=(4, 6, 12)):
    """The log after ``ext`` saw ``epochs`` epochs of ``batches`` batches
    on a loop whose log gets each batch's monitors before its
    ``after_batch``, and ``best_x`` set at the iterations ``best`` (by an
    extension before it, as TrackTheBest's notification); with
    ``resume_at``, from a log that holds that many batches (one epoch)
    already."""

    class Loop:
        pass

    Loop.log = log
    ext.main_loop = Loop()
    it = resume_at
    for t in range(1, resume_at + 1):
        for name, value in _monitors(t).items():
            log.record(t, name, value)
    log.status.update(iterations_done=it, epochs_done=int(resume_at > 0))
    ext.dispatch("before_training")
    for _ in range(epochs):
        ext.dispatch("before_epoch")
        for _ in range(batches):
            ext.dispatch("before_batch", None)
            it += 1
            log.status["iterations_done"] = it
            for name, value in _monitors(it).items():
                log.record(it, name, value)
            if it in best and it % batches:
                log.record(it, "best_x", True)
            ext.dispatch("after_batch", None)
        log.status["epochs_done"] += 1
        if it in best:
            log.record(it, "best_x", True)
        ext.dispatch("after_epoch")
    ext.dispatch("after_training")
    return {name: log.channel(name) for name in log.columns}


@pytest.mark.parametrize("kind,kwargs,resume_at", [
    ("patience", {"min_iterations": 5, "patience_factor": 1.5,
                  "notification_names": ["best_x"]}, 0),
    ("patience", {"min_epochs": 2, "patience_factor": 1.5,
                  "notification_names": ["best_x"]}, 0),
    ("patience", {"min_epochs": 1, "patience_factor": 2.0,
                  "notification_names": ["best_x"]}, 4),
    ("length_filter", {"after_n_batches": 6}, 0),
    ("averaged", {"every_n_batches": 3}, 0),
    ("averaged", {"every_n_batches": 10}, 0),
    ("averaged", {"every_n_batches": 3}, 4),
], ids=["patience_min_iterations", "patience_min_epochs",
        "patience_resumed", "switch_off_length_filter", "averaged_every_3",
        "averaged_every_10", "averaged_resumed"])
def test_training_services_record_as_in_jax(kind, kwargs, resume_at):
    """Patience (both modes), SwitchOffLengthFilter and
    AveragedTrainMonitoring driven over the same synthetic run, the port's
    and the JAX package's: the same records at the same iterations (and
    the finish requests), and the length filter cleared in both."""
    filters = (LengthFilter("recordings", 9),
               JaxLengthFilter("recordings", 9))
    made = []
    for package, log_cls in (("port", TrainingLog), ("jax", JaxLog)):
        if kind == "patience":
            cls = loop.Patience if package == "port" else \
                jax_extensions.Patience
            ext = cls(**kwargs)
        elif kind == "length_filter":
            cls = loop.SwitchOffLengthFilter if package == "port" else \
                jax_extensions.SwitchOffLengthFilter
            ext = cls(filters[package == "jax"], **kwargs)
        else:
            cls = monitoring.AveragedTrainMonitoring if package == "port" \
                else jax_monitoring.AveragedTrainMonitoring
            ext = cls(["train_cost", "total_gradient_norm"], **kwargs)
        made.append(_driven(ext, log_cls(), resume_at=resume_at))
    ours, theirs = made
    assert ours == theirs
    recorded = {"patience": "patience",
                "length_filter": "length_filter_switched",
                "averaged": "average_train_cost"}[kind]
    assert ours[recorded][0], "vacuous: nothing recorded"
    if kind == "length_filter":
        assert filters[0].max_length is filters[1].max_length is None
        assert ours[recorded][0] == list(range(6, 13))
    if kind == "patience" and "min_iterations" in kwargs:
        assert ours["training_finish_requested"][0][0] == 9


class _Counting:
    """An algorithm whose step returns the batch number as its cost."""

    def process_batch(self, batch):
        return {"train_cost": float(batch)}


def test_resumed_loop_clears_the_finish_flag_and_profiles(capsys):
    """A log resumed from a finished run (its last row asks to finish)
    trains on: the loop records ``training_finish_requested`` False at
    the resumed iteration and dispatches ``on_resumption``; with
    ``profile_enabled`` it prints the host times of its parts."""
    log = TrainingLog()
    log.status.update(iterations_done=3, epochs_done=1,
                      resumed_from="model.zip")
    log.record(3, "training_finish_requested", True)
    seen = []

    class Seen(loop.TrainingExtension):
        def on_resumption(self):
            seen.append(self.main_loop.log.status["iterations_done"])

    main = loop.MainLoop(_Counting(), lambda: [1, 2], log=log,
                         extensions=[Seen(), loop.FinishAfter(
                             after_n_epochs=2)], profile_enabled=True)
    main.run()
    assert seen == [3]
    assert log.channel("train_cost") == ([4, 5], [1.0, 2.0])
    assert log.channel("training_finish_requested") == ([3, 5],
                                                       [False, True])
    report = capsys.readouterr().err
    for part in ("Training profile:", "epoch/read_data", "epoch/train",
                 "extensions/after_batch", "extensions/before_training"):
        assert part in report


NET = dict(
    input_dims={"recordings": 5}, eos_label=4, num_phonemes=5, dim_dec=8,
    dims_bidir=[6], enc_transition="gru", dec_transition="gru",
    attention_type="content_and_conv", conv_n=2,
    criterion={"name": "log_likelihood"}, bottom={"bottom_class": "speech"},
    subsample=[1], post_merge_dims=[10],
    prior={"type": "expanding", "initial_begin": 0, "initial_end": 4,
           "min_speed": 1.0, "max_speed": 2.0})
INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.3],
                        "biases_init": ["isotropic_gaussian", 0.1],
                        "rec_weights_init": ["orthogonal"]}}


def test_eval_fn_records_match_jax():
    rng = np.random.RandomState(4)
    B, T, TL = 3, 9, 5
    batch = {
        "recordings": rng.randn(B, T, 5).astype(np.float32),
        "recordings_mask": (np.arange(T)[None] < np.array(
            [[T], [T - 2], [T - 4]])).astype("f"),
        "labels": rng.randint(0, 5, size=(B, TL)).astype(np.int32),
        "labels_mask": (np.arange(TL)[None] < np.array(
            [[TL], [TL - 1], [2]])).astype("f")}
    jrec = JaxRecognizer(dict(NET, input_num_chars={}), init_config=INIT,
                         seed=6)
    rec = SpeechRecognizer(NET, device="cpu")
    load_path_dict(rec.net, param_path_dict(jrec.params))
    theirs = jax_driver.make_eval_fn(jrec, "recordings")(batch)
    ours = make_eval_fn(rec)(batch)
    assert set(ours) == set(theirs)
    # f32 on both sides, as test_torch_train_step.py's TOL (the penalty is
    # a difference of near-equal sums, about 0 here)
    for name, (value, weight) in theirs.items():
        np.testing.assert_allclose(ours[name], (value, weight), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.fixture
def toy(tmp_path):
    """The toy dataset and toy.yaml pointing at it; returns the config's
    path."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_toy_dataset import make_toy_dataset
    make_toy_dataset(str(tmp_path / "toy.h5"), num_examples=20,
                     num_chars=4, feat_dim=5, max_len=4, seed=5)
    text = open(os.path.join(ROOT, "tests", "configs", "toy.yaml")).read()
    path = tmp_path / "toy.yaml"
    path.write_text(text.replace("/tmp/toy.h5", str(tmp_path / "toy.h5")))
    return path


def test_two_epochs_match_jax(toy, tmp_path):
    text = toy.read_text()
    # validation every epoch, and no search (the test below keeps it)
    (tmp_path / "two.yaml").write_text(
        text[:text.index("monitoring:")]
        + "monitoring:\n    validate_every_epochs: 1\n")
    changes = WIDTHS + [("training.num_epochs", "2")]
    jconf = JaxConfiguration(str(tmp_path / "two.yaml"),
                             config_changes=changes)
    start = str(tmp_path / "start.zip")
    jrec = jax_driver.create_model(jconf, JaxData(**jconf["data"]))
    jax_checkpoint.save_checkpoint(start, param_path_dict(jrec.params))
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
    jloop = jax_driver.train(jconf, str(tmp_path / "jax" / "model.zip"),
                             start)
    ploop = driver.train(
        Configuration(str(tmp_path / "two.yaml"), config_changes=changes),
        str(tmp_path / "port" / "model.zip"), start, device="cpu")
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax")) == [
        "model.zip", "model_best_ll.zip", "model_best_ll_params.npz",
        "model_params.npz"]
    for name in files:
        theirs = jax_checkpoint.load_parameters(str(tmp_path / "jax" / name))
        ours = jax_checkpoint.load_parameters(str(tmp_path / "port" / name))
        assert set(ours) == set(theirs)
        for k, v in theirs.items():
            np.testing.assert_allclose(ours[k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name}: {k}")
    record = "valid_sequence_total_cost"
    times, values = ploop.log.channel(record)
    jtimes, jvalues = jloop.log.channel(record)
    assert times == jtimes == [0, 4, 8]
    np.testing.assert_allclose(values, jvalues, rtol=1e-5)
    assert ploop.log.status["best_" + record] == pytest.approx(
        jloop.log.status["best_" + record], rel=1e-5)


def test_search_during_training_matches_jax(toy, tmp_path):
    """``monitoring.search`` kept (beam 3), searched before the first
    epoch and after each of two, from a model the JAX package trained for
    12 epochs (a random model gets every validation utterance wrong; this
    one gets them half right after two more): the same ``valid_per``
    records as the JAX package's, ``model_best.zip`` and its sidecar
    written at the same epochs, the same file set and parameters."""
    (tmp_path / "pre").mkdir()
    jax_driver.train(
        JaxConfiguration(str(toy), config_changes=WIDTHS + [
            ("training.num_epochs", "12"),
            ("monitoring.validate_every_epochs", "0"),
            ("monitoring.search_every_epochs", "0")]),
        str(tmp_path / "pre" / "start.zip"), fast_start=True)
    start = str(tmp_path / "pre" / "start.zip")
    changes = WIDTHS + [("training.num_epochs", "2"),
                        ("monitoring.validate_every_epochs", "1"),
                        ("monitoring.search_every_epochs", "1")]
    jconf = JaxConfiguration(str(toy), config_changes=changes)
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
    jloop = jax_driver.train(jconf, str(tmp_path / "jax" / "model.zip"),
                             start)
    ploop = driver.train(Configuration(str(toy), config_changes=changes),
                         str(tmp_path / "port" / "model.zip"), start,
                         device="cpu")
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax"))
    assert {"model_best.zip", "model_best_params.npz"} <= set(files)
    for name in files:
        theirs = jax_checkpoint.load_parameters(str(tmp_path / "jax" / name))
        ours = jax_checkpoint.load_parameters(str(tmp_path / "port" / name))
        assert set(ours) == set(theirs)
        for k, v in theirs.items():
            np.testing.assert_allclose(ours[k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name}: {k}")
    # CERs of identical hypotheses: equal to float rounding
    times, values = ploop.log.channel("valid_per")
    jtimes, jvalues = jloop.log.channel("valid_per")
    assert times == jtimes == [0, 4, 8]
    np.testing.assert_allclose(values, jvalues, rtol=1e-12)
    assert 0 < min(values) < 1, "vacuous: every hypothesis wrong"
    # the rows where valid_per improved: those epochs wrote model_best.zip
    improved = ploop.log.channel("best_valid_per")[0]
    assert improved == jloop.log.channel("best_valid_per")[0]
    assert any(t > 0 for t in improved), "vacuous: no epoch improved"


@pytest.mark.parametrize("sections,keys", [
    ({}, []),
    ({"monitoring": {"validate_every_epochs": 1, "search": {}}}, []),
    ({"monitoring": {"search": {"beam_size": 3}, "plot": {"path": "p"}},
      "training": {"patience": {"min_epochs": 2}, "stop_filtering": 10,
                   "num_epochs": 3}},
     []),                   # monitoring.plot is ported: nothing is unported
])
def test_unported_keys_come_from_the_config(sections, keys):
    assert driver.unported_keys(sections) == keys


def test_cli_warns_once_for_each_unported_key(toy, tmp_path, caplog):
    caplog.set_level(logging.WARNING)
    loop_ = run.main(["train", str(tmp_path / "m.zip"), str(toy)]
                     + [x for pair in WIDTHS for x in pair]
                     + ["training.num_batches", "2", "monitoring.plot",
                        f"{{path: {tmp_path / 'plot'}}}", "--fast-start",
                        "--device", "cpu"])
    warned = [r.getMessage() for r in caplog.records
              if r.levelno == logging.WARNING]
    # no key is left unported: the toy config's monitoring.search is
    # honoured, and so are the averaged train records, Patience, the
    # length filter's switch and the plot channels: no warning
    assert driver.UNPORTED_KEYS == {}
    assert not any("not ported" in msg for msg in warned)
    assert (tmp_path / "plot.json").exists()
    # --fast-start: no validation and no checkpoint before the first epoch
    assert loop_.log.channel("valid_sequence_total_cost") == ([], [])
    assert loop_.log.channel("saved_to")[0] == [2]
