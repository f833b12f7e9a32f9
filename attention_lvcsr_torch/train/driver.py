"""The training driver: model construction, the train step, the loop.

Counterpart of ``attention_lvcsr_tpu/train/driver.py`` for teacher-forced
(``exploration: imitative``) training:

* :func:`create_model` builds the recognizer from a config and its data
  manager and loads a checkpoint of either package;
* :func:`make_train_step` is one step of forward, backward, update and
  monitors (JAX ``make_train_step`` :110-261): the mean cost over the
  batch, plus ``penalty_coof`` times the monotonicity penalty per
  recording and ``decay`` times the squared norm of the weight leaves
  (``_weight_leaf`` :99-102), through ``train/rules.py``'s chain; the
  same monitors, ``total_gradient_norm`` and ``total_step_norm``
  included.  The parameters are updated in place;
* :func:`run_training` runs the loop over a batch stream with the JAX
  ``initialize_all`` extensions that are ported (JAX :455-559): Timing;
  with a validation stream, the validation cost (``train/monitoring.py``)
  before the first epoch and every n epochs or batches and TrackTheBest
  on ``valid_sequence_total_cost``; FinishAfter (batches, epochs, a NaN
  gradient norm); Checkpoint before the first epoch, after every epoch
  and every n batches, with its ``_params.npz`` sidecar, and the
  ``_best_ll`` copy when the validation cost improves; Printing;
* :func:`train` is the CLI part: it reads the config's data (``yaml`` and
  ``h5py`` are imported there only) and calls :func:`run_training` over
  the ``train`` part, validating on the ``valid`` part.

Not ported, and refused with ``NotImplementedError`` naming the piece:
weight noise, adaptive noise, dropout, greedy and mixed exploration, a
bf16 compute dtype, and multistage configs.  Not ported, and named in one
``logging`` warning each when a config sets them (:data:`UNPORTED_KEYS`):
search during training with its ``_best`` checkpoint, Patience,
``stop_filtering`` and the plot channels; and, for every config, the
averaged train records (``average_*``).
"""
from __future__ import annotations

import logging
import os
from typing import Any, Callable, Iterable, Mapping, Optional

import torch

from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
from attention_lvcsr_torch.ops.expressions import (entropy,
                                                   monotonicity_penalty)
from attention_lvcsr_torch.train.loop import (Checkpoint, FinishAfter,
                                              MainLoop, Printing, Timing,
                                              TrackTheBest,
                                              gradient_norm_is_nan, on_record)
from attention_lvcsr_torch.train.monitoring import (DataStreamMonitoring,
                                                    batch_tensors,
                                                    make_eval_fn)
from attention_lvcsr_torch.train.rules import (build_optimizer, global_norm,
                                               state_arrays)

logger = logging.getLogger(__name__)

# Keys of a config's monitoring and training sections that the JAX driver
# honours and the port does not yet: what each stands for, and the
# ROADMAP item that ports it.
UNPORTED_KEYS = {
    "monitoring.search": "beam-search validation during training and the "
                         "_best checkpoint (ROADMAP Queue 1 item 4)",
    "training.patience": "early stopping, Patience (ROADMAP Queue 1 item 4)",
    "training.stop_filtering": "switching off the length filter, "
                               "SwitchOffLengthFilter (ROADMAP Queue 1 "
                               "item 4)",
    "monitoring.plot": "the plot channels (ROADMAP Queue 1 item 9)",
}
AVERAGED_RECORDS = ("the averaged train records (average_*, every 10 "
                    "batches; ROADMAP Queue 1 item 4)")

_DECAYED_LEAVES = ("kernel", "embedding", "state_to_state", "state_to_gates",
                   "W", "W_state", "conv_filters")


def weight_leaf(path: str) -> bool:
    """Whether weight decay applies to a parameter (by its leaf name)."""
    return path.rsplit("/", 1)[-1] in _DECAYED_LEAVES


def create_model(config, data, load_path=None, device="cuda"):
    """Build the recognizer from a config and its data manager and load a
    checkpoint written by either package."""
    net_config = dict(config["net"])
    net_config.pop("input_sources", None)
    if config.get("regularization", {}).get("dropout"):
        net_config["dropout"] = True
    recognizer = SpeechRecognizer(
        dict(net_config,
             input_dims={"recordings": data.num_features("recordings")},
             input_num_chars={},
             eos_label=data.eos_label,
             num_phonemes=data.num_labels,
             character_map=data.character_map("labels"),
             data_prepend_eos=bool(data.add_bos)),
        init_config=config.get("initialization", {}),
        seed=config.get("training", {}).get("seed", 1234),
        device=device)
    if load_path:
        recognizer.load_params(load_path)
    return recognizer


def unported_training(config) -> Optional[str]:
    """The first part of a training config the port does not cover."""
    reg = config.get("regularization", {}) or {}
    train_conf = config.get("training", {}) or {}
    checks = [
        (not reg.get("adaptive_noise"), "adaptive weight noise"),
        (not float(reg.get("noise", 0.0) or 0.0), "weight noise"),
        (not reg.get("dropout"), "dropout"),
        (train_conf.get("exploration", "imitative") == "imitative",
         f"exploration {train_conf.get('exploration')!r}"),
        (not train_conf.get("compute_dtype"),
         f"compute_dtype {train_conf.get('compute_dtype')!r}"),
    ]
    for ok, piece in checks:
        if not ok:
            return piece
    return None


def make_train_step(recognizer: SpeechRecognizer, optimizer, config):
    """``step(opt_state, inputs, inputs_mask, labels, labels_mask) ->
    (opt_state, monitors)``: one teacher-forced training step on
    batch-major tensors, the parameters updated in place; ``monitors`` is
    a dict of 0-d tensors."""
    piece = unported_training(config)
    if piece is not None:
        raise NotImplementedError(f"not ported yet: {piece}")
    reg = config.get("regularization", {}) or {}
    decay = float(reg.get("decay", 0.0) or 0.0)
    penalty_coof = float(reg.get("penalty_coof", 0.0) or 0.0)
    net = recognizer.net
    params = recognizer.parameters()
    decayed = [p for path, p in params.items() if weight_leaf(path)]

    def step(opt_state, inputs, inputs_mask, labels, labels_mask):
        B, TL = labels.shape
        net.requires_grad_(True)
        out = net.cost(inputs, inputs_mask, labels, labels_mask, train=True)
        batch_cost = out["costs"].sum()
        cost = batch_cost / B
        lm = labels_mask.T
        w_penalty = monotonicity_penalty(out["weights"], lm)
        w_entropy = entropy(out["weights"], lm)
        train_cost = cost
        if penalty_coof:
            train_cost = train_cost + penalty_coof * w_penalty / B
        if decay:
            train_cost = train_cost + decay * sum(
                (p ** 2).sum() for p in decayed)
        grads = dict(zip(params, torch.autograd.grad(
            train_cost, list(params.values()))))
        net.requires_grad_(False)
        with torch.no_grad():
            current = {k: p.detach() for k, p in params.items()}
            updates, opt_state = optimizer.update(grads, opt_state, current)
            for k, u in updates.items():
                params[k].add_(u)
            f32 = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                            device=batch_cost.device)
            monitors = {
                "train_cost": train_cost,
                "sequence_total_cost": cost,
                "batch_cost": batch_cost,
                "batch_size": f32(B),
                "weights_penalty": w_penalty,
                "weights_entropy": w_entropy,
                "weights_penalty_per_recording": w_penalty / B,
                "weights_entropy_per_label": w_entropy / lm.sum(),
                "max_recording_length": f32(inputs.shape[1]),
                "max_attended_length": f32(out["encoded"].shape[1]),
                "max_num_phonemes": f32(TL),
                "mask_density": lm.mean(),
                "mean_attended": out["encoded"].abs().mean(),
                "mean_bottom_output": out["bottom_output"].abs().mean(),
                "min_energy": out["energies"].min(),
                "max_energy": out["energies"].max(),
                "total_gradient_norm": global_norm(grads),
                "total_step_norm": global_norm(updates),
            }
        return opt_state, {k: v.detach() for k, v in monitors.items()}

    return step


def unported_keys(config):
    """The keys of :data:`UNPORTED_KEYS` that ``config`` sets."""
    return [key for key in UNPORTED_KEYS
            if (config.get(key.split(".")[0]) or {}).get(key.split(".")[1])]


class GradientDescent:
    """Owns the optimizer state and the train step; takes numpy or tensor
    batches and returns each step's monitors as Python floats."""

    def __init__(self, recognizer, optimizer, step_fn):
        self.recognizer = recognizer
        self.optimizer = optimizer
        self.step_fn = step_fn
        self.opt_state = optimizer.init(
            {k: p.detach() for k, p in recognizer.parameters().items()})

    def process_batch(self, batch: Mapping[str, Any]):
        self.opt_state, monitors = self.step_fn(
            self.opt_state, *batch_tensors(batch, self.recognizer.device))
        names = sorted(monitors)
        values = torch.stack([monitors[k] for k in names]).tolist()
        return dict(zip(names, values))

    def parameter_dict(self):
        return self.recognizer.param_path_dict()

    def opt_state_arrays(self):
        return state_arrays(self.opt_state)


def run_training(recognizer: SpeechRecognizer, optimizer,
                 batch_stream: Callable[[], Iterable], save_path: str,
                 config: Optional[Mapping] = None, *, num_batches=None,
                 num_epochs=None, save_every_n_batches=None,
                 valid_stream: Optional[Callable[[], Iterable]] = None,
                 fast_start=False, printing=True):
    """Train ``recognizer`` with ``optimizer`` over ``batch_stream()``
    (called once per epoch; each batch a mapping with ``recordings``,
    ``recordings_mask``, ``labels`` and ``labels_mask``), checkpointing to
    ``save_path`` before the first epoch (unless ``fast_start``), after
    every epoch and every ``save_every_n_batches``.  With
    ``valid_stream`` (a factory like ``batch_stream``), the validation
    cost is taken before the first epoch (unless ``fast_start``) and at
    the config's ``monitoring.validate_every_epochs`` (default 1) and
    ``validate_every_batches``, and each epoch that improves it is also
    saved to ``<root>_best_ll<ext>``.  Returns the finished
    :class:`MainLoop` (its ``log`` holds every step's monitors)."""
    config = dict(config or {})
    mon_conf = config.get("monitoring", {}) or {}
    step = make_train_step(recognizer, optimizer, config)
    algorithm = GradientDescent(recognizer, optimizer, step)
    exts = [Timing()]
    best = None
    if valid_stream is not None:
        validation = DataStreamMonitoring(
            make_eval_fn(recognizer), valid_stream, prefix="valid",
            before_first_epoch=not fast_start,
            every_n_epochs=mon_conf.get("validate_every_epochs", 1),
            every_n_batches=mon_conf.get("validate_every_batches", 0))
        best = TrackTheBest(validation.record_name("sequence_total_cost"),
                            before_first_epoch=True, after_epoch=True)
        exts += [validation, best]
    finish = FinishAfter(after_n_batches=num_batches,
                         after_n_epochs=num_epochs)
    finish.add_condition(["after_batch"], gradient_norm_is_nan)
    checkpoint = Checkpoint(save_path, before_first_epoch=not fast_start,
                            after_epoch=True,
                            every_n_batches=save_every_n_batches)
    if best is not None:
        root, ext = os.path.splitext(save_path)
        checkpoint.add_condition(["after_epoch"],
                                 on_record(best.notification_name),
                                 arguments=(root + "_best_ll" + ext,))
    exts += [finish, checkpoint]
    if printing:
        exts.append(Printing(every_n_batches=1))
    loop = MainLoop(algorithm, batch_stream, extensions=exts)
    return loop.run()


def train(config, save_path, params_path=None, fast_start=False,
          device="cuda"):
    """CLI entry (``run.py train``): the config's data, model and rule
    chain, then :func:`run_training` over the training part, validating
    on the ``valid`` part.  Warns once for each config key the port does
    not honour yet."""
    from attention_lvcsr_torch.data import Data      # h5py: CLI path only
    if getattr(config, "multi_stage", False):
        raise NotImplementedError("not ported yet: multistage training")
    config = dict(config)
    piece = unported_training(config)
    if piece is not None:
        raise NotImplementedError(f"not ported yet: {piece}")
    for key in unported_keys(config):
        logger.warning("not ported yet, ignored: %s, %s", key,
                       UNPORTED_KEYS[key])
    logger.warning("not ported yet: %s", AVERAGED_RECORDS)
    data = Data(**config["data"])
    recognizer = create_model(config, data, params_path, device=device)
    train_conf = config.get("training", {}) or {}
    optimizer = build_optimizer(train_conf, config.get("regularization", {}))
    return run_training(
        recognizer, optimizer, lambda: data.get_stream("train"), save_path,
        config, num_batches=train_conf.get("num_batches"),
        num_epochs=train_conf.get("num_epochs"),
        save_every_n_batches=train_conf.get("save_every_n_batches"),
        valid_stream=lambda: data.get_stream("valid", shuffle=False),
        fast_start=fast_start)
