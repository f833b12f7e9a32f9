"""The driver: model construction, the train step, the loop, and the
search, sampling and data entries of ``run.py``.

Counterpart of ``attention_lvcsr_tpu/train/driver.py``:

* :func:`create_model` builds the recognizer from a config and its data
  manager and loads a checkpoint of either package;
* :func:`make_train_step` is one step of forward, backward, update and
  monitors (JAX ``make_train_step`` :110-261): the mean cost over the
  batch, plus ``penalty_coof`` times the monotonicity penalty per
  recording and ``decay`` times the squared norm of the weight leaves
  (``_weight_leaf`` :99-102), through ``train/rules.py``'s chain; the
  same monitors, ``total_gradient_norm`` and ``total_step_norm``
  included; with ``training.exploration`` ``greedy`` or ``mixed`` (JAX
  :128-172, the task loss's) the decoder is fed the model's own outputs
  (:func:`explore`); ``regularization.noise`` adds Gaussian noise to the
  weights outside the attention for the step's forward and backward (JAX
  :181-190), ``regularization.dropout`` drops half of the bottom's output
  (JAX :192-197); with ``regularization.adaptive_noise`` it is
  :func:`make_adaptive_noise_train_step` (JAX :263-380), Graves' adaptive
  weight noise over the recognizer's noise collection.  The parameters
  are updated in place;
* :func:`run_training` runs the loop over a batch stream with the JAX
  ``initialize_all`` extensions (JAX :419-559), in its order, after the
  adaptive noise's log-variances (when the config has an
  ``adaptive_noise`` section, even an empty one; ``num_examples``
  defaulting to the training set's size): with a
  checkpoint to resume from, Load (parameters, optimizer state and log)
  or LoadLog (the log alone); Timing, CodeVersion and
  CompilationStatistics (``train/extensions.py``); the averaged train
  records (``average_*`` of :data:`PRIMARY_OBSERVABLES`, every 10
  batches); with a validation stream, the validation cost
  (``train/monitoring.py``) before the first epoch and every n epochs or
  batches, with ``monitoring.search`` the beam search's error rate
  (``BeamSearchErrorRate``, ``valid_per``), and TrackTheBest on each;
  SwitchOffLengthFilter after ``training.stop_filtering`` batches;
  FinishAfter (batches, epochs, a NaN gradient norm); Checkpoint before
  the first epoch, after every epoch and every n batches, with its
  ``_params.npz`` sidecar, the ``_best`` copy when ``valid_per`` improves
  and the ``_best_ll`` copy when the validation cost does; Patience with
  ``training.patience``; with ``monitoring.plot``, Plot and PlotServer;
  Printing;
* :func:`run_multistage` chains the stages of a multistage config (JAX
  ``train_multistage`` :593-621): each stage builds its model and rule
  chain from its own config and writes ``<stage>.zip`` in a directory, a
  later stage starts from ``<previous stage><restart_from>.zip``;
* :func:`train` and :func:`train_multistage` are the CLI part: they read
  the config's data (``yaml`` and ``h5py`` are imported there only) and
  run the ``train`` part, validating on the ``valid`` part;
* :func:`run_search` decodes and scores examples (JAX ``search``
  :671-826): per utterance the groundtruth's teacher-forced cost and
  alignment (``SpeechRecognizer.analyze``), the beam search, one at a time
  or in chunks of ``monitoring.search.decode_batch``
  (:func:`_batched_decode_iter`), the recognized hypothesis's cost, its
  CER (and WER with a vocabulary), with the JAX package's report lines;
  :func:`search` is its CLI part over a dataset part;
* :func:`sample`, :func:`show_data`, :func:`init_norm` and :func:`test`
  are the other entries of the JAX ``run.py`` (:829-881).

Not ported, and refused with ``NotImplementedError`` naming the piece: a
bf16 compute dtype (and an exploration the JAX package does not know).
:data:`UNPORTED_KEYS` names the config keys the port would ignore with a
``logging`` warning: none is left.
"""
from __future__ import annotations

import logging
import os
import pprint
import sys
import time
from typing import Any, Callable, Iterable, Mapping, Optional

import numpy as np
import torch

from attention_lvcsr_torch.models.bottom import SpeechBottom, bottom_class
from attention_lvcsr_torch.models.params import NOISE_PREFIX, PREFIX
from attention_lvcsr_torch.models.recognizer import (SpeechRecognizer,
                                                     draw_dropout_mask)
from attention_lvcsr_torch.ops.error_rate import wer
from attention_lvcsr_torch.ops.expressions import (entropy,
                                                   monotonicity_penalty,
                                                   weights_std)
from attention_lvcsr_torch.train.extensions import (CodeVersion,
                                                    CompilationStatistics,
                                                    Plot, PlotServer)
from attention_lvcsr_torch.train.log import TrainingLog
from attention_lvcsr_torch.train.loop import (Checkpoint, FinishAfter, Load,
                                              LoadLog, MainLoop, Patience,
                                              Printing, SwitchOffLengthFilter,
                                              Timing, TrackTheBest,
                                              gradient_norm_is_nan, on_record)
from attention_lvcsr_torch.train.monitoring import (AveragedTrainMonitoring,
                                                    BeamSearchErrorRate,
                                                    DataStreamMonitoring,
                                                    batch_tensors,
                                                    input_key,
                                                    make_eval_fn)
from attention_lvcsr_torch.train.rules import (build_optimizer, global_norm,
                                               load_state_arrays,
                                               state_arrays)

logger = logging.getLogger(__name__)

# Keys of a config's monitoring and training sections that the JAX driver
# honours and the port does not yet, each with what it stands for: none.
UNPORTED_KEYS = {}

# the train step's monitors averaged into the average_* records
PRIMARY_OBSERVABLES = (
    "train_cost", "total_gradient_norm", "total_step_norm",
    "max_recording_length", "max_attended_length", "max_num_phonemes",
    "weights_entropy_per_label", "weights_penalty_per_recording")

_DECAYED_LEAVES = ("kernel", "embedding", "state_to_state", "state_to_gates",
                   "W", "W_state", "conv_filters")


def weight_leaf(path: str) -> bool:
    """Whether weight decay applies to a parameter (by its leaf name)."""
    return path.rsplit("/", 1)[-1] in _DECAYED_LEAVES


def attention_leaf(path: str) -> bool:
    """Whether a parameter lies under a component named ``attention``
    (JAX ``_attention_leaf``): the additive weight noise spares it."""
    return "attention" in path.split("/")


def create_model(config, data, load_path=None, device="cuda"):
    """Build the recognizer from a config and its data manager and load a
    checkpoint written by either package.  The bottom's kind picks its
    source (JAX ``driver.py:74-81``): the ``recordings`` features of the
    speech bottom, the ``inputs`` alphabet of the lookup bottom."""
    net_config = dict(config["net"])
    net_config.pop("input_sources", None)
    if config.get("regularization", {}).get("dropout"):
        net_config["dropout"] = True
    bottom = bottom_class(net_config.get("bottom"))
    source = bottom.input_source
    if bottom is SpeechBottom:
        input_dims, input_num_chars = {source: data.num_features(source)}, {}
    else:
        input_dims = {}
        input_num_chars = {source: len(data.character_map(source))}
    recognizer = SpeechRecognizer(
        dict(net_config, input_dims=input_dims,
             input_num_chars=input_num_chars,
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
    train_conf = config.get("training", {}) or {}
    checks = [
        (train_conf.get("exploration", "imitative")
         in ("imitative", "greedy", "mixed"),
         f"exploration {train_conf.get('exploration')!r}"),
        (not train_conf.get("compute_dtype"),
         f"compute_dtype {train_conf.get('compute_dtype')!r}"),
    ]
    for ok, piece in checks:
        if not ok:
            return piece
    return None


def explore(net, exploration, eos_label, inputs, inputs_mask, labels,
            labels_mask, generator=None, coin=None):
    """The fed outputs of a greedy or mixed exploration step (JAX
    ``make_train_step`` :144-165, the reference's ``lvsr/main.py:245-283``):
    ``TL + 10`` steps of the model's own outputs (``net.generate``: the
    argmax of a task-loss model, a draw from ``generator`` of a
    log-likelihood one), masked after the first EOS (the mask rolled by
    one, so the EOS step still counts); for ``mixed``, each row keeps them
    or takes the labels (padded to ``TL + 10``) by a coin of probability
    0.5, ``coin`` (B,) bool or, when None, drawn from ``generator``.
    Returns batch-major (prediction, prediction_mask), without gradient."""
    B, TL = labels.shape
    n_steps = TL + 10
    with torch.no_grad():
        pred = net.generate(inputs, inputs_mask, n_steps,
                            generator)["outputs"]          # (T', B)
        pmask = (torch.cumsum((pred == eos_label).to(torch.int32), dim=0)
                 < 1).to(torch.float32)
        pmask = torch.roll(pmask, 1, dims=0)
        pmask[0] = 1.0
        if exploration == "mixed":
            pad = n_steps - TL
            targets = torch.cat([labels.T.to(pred.dtype),
                                 pred.new_zeros(pad, B)])
            tmask = torch.cat([labels_mask.T, pmask.new_zeros(pad, B)])
            if coin is None:
                coin = torch.rand(B, generator=generator,
                                  device=pred.device) < 0.5
            coin = coin.to(pred.device)[None, :]
            pred = torch.where(coin, pred, targets)
            pmask = torch.where(coin, pmask, tmask)
    return pred.T.contiguous(), pmask.T.contiguous()


def regularization_draws(recognizer, config, inputs_shape, generator):
    """The draws of a standard step's regularizers, from ``generator`` in
    this order: with ``regularization.noise``, a standard normal tensor
    for each parameter outside the attention (:func:`attention_leaf`), in
    the order of ``recognizer.parameters()``; then, with the net's
    ``dropout``, the bottom's dropout mask over (B, T, bottom width) of
    ``inputs_shape``.  Returns (``{path: draw}`` or None, mask or None).
    A greedy or mixed exploration draws from the same generator after
    these."""
    reg = config.get("regularization", {}) or {}
    dev = recognizer.device
    noise = None
    if float(reg.get("noise", 0.0) or 0.0):
        noise = {k: torch.randn(p.shape, generator=generator, device=dev)
                 for k, p in recognizer.parameters().items()
                 if not attention_leaf(k)}
    mask = None
    if recognizer.net.dropout:
        B, T = inputs_shape[:2]
        mask = draw_dropout_mask((B, T, recognizer.net.bottom.output_dim),
                                 generator, dev)
    return noise, mask


def make_train_step(recognizer: SpeechRecognizer, optimizer, config):
    """``step(opt_state, inputs, inputs_mask, labels, labels_mask, *,
    generator=None, coin=None, weight_noise=None, dropout_mask=None) ->
    (opt_state, monitors)``: one training step on batch-major tensors, the
    parameters updated in place; ``monitors`` is a dict of 0-d tensors.
    Under ``training.exploration`` ``imitative`` the labels are fed
    (teacher forcing); under ``greedy`` and ``mixed`` the outputs of
    :func:`explore`, ``coin`` fixing the mixed one.  With
    ``regularization.noise`` the parameters outside the attention carry
    ``noise`` times a standard normal draw through the forward and
    backward, and the gradients go to the parameters without it (weight
    decay too is of those); with the net's ``dropout`` (the config's
    ``regularization.dropout``) the bottom's output is dropped out.  The
    draws come from ``weight_noise`` (``{'/recognizer/...': tensor}``)
    and ``dropout_mask`` where given (another package's draws), else
    from ``generator`` (a ``torch.Generator`` on the model's device; a
    fresh one seeded 0 when None) in :func:`regularization_draws`'
    order, before the exploration's.  A non-empty
    ``regularization.adaptive_noise`` section gives
    :func:`make_adaptive_noise_train_step`'s step (an empty one is off
    here, as in the JAX ``make_train_step``; ``run_training`` fills it
    in)."""
    piece = unported_training(config)
    if piece is not None:
        raise NotImplementedError(f"not ported yet: {piece}")
    reg = config.get("regularization", {}) or {}
    if reg.get("adaptive_noise"):
        return make_adaptive_noise_train_step(recognizer, optimizer, config)
    decay = float(reg.get("decay", 0.0) or 0.0)
    penalty_coof = float(reg.get("penalty_coof", 0.0) or 0.0)
    noise_std = float(reg.get("noise", 0.0) or 0.0)
    exploration = (config.get("training", {}) or {}).get("exploration",
                                                         "imitative")
    net = recognizer.net
    params = recognizer.parameters()
    decayed = [k for k in params if weight_leaf(k)]
    noised = [k for k in params if not attention_leaf(k)] if noise_std \
        else []

    def step(opt_state, inputs, inputs_mask, labels, labels_mask, *,
             generator=None, coin=None, weight_noise=None,
             dropout_mask=None):
        B, TL = labels.shape
        if generator is None:
            generator = torch.Generator(device=labels.device).manual_seed(0)
        if (noised and weight_noise is None) \
                or (net.dropout and dropout_mask is None):
            drawn, mask = regularization_draws(recognizer, config,
                                               inputs.shape, generator)
            weight_noise = weight_noise if weight_noise is not None \
                else drawn
            dropout_mask = dropout_mask if dropout_mask is not None \
                else mask
        prediction = prediction_mask = None
        if exploration != "imitative":
            prediction, prediction_mask = explore(
                net, exploration, recognizer.eos_label, inputs, inputs_mask,
                labels, labels_mask, generator, coin)
        # the noised parameters hold mean + noise for the forward and
        # backward and get their means back after it, bit for bit
        means = {}
        with torch.no_grad():
            for k in noised:
                means[k] = params[k].detach().clone()
                params[k].copy_(means[k] + noise_std
                                * weight_noise[k].to(means[k].device))
        # weight decay is of the means: under noise its leaves are the
        # means' copies, whose gradients are added to the parameters'
        decay_leaves = {k: means[k].requires_grad_(True) if k in means
                        else params[k] for k in decayed} if decay else {}
        extra = [k for k in decay_leaves if k in means]
        net.requires_grad_(True)
        try:
            out = net.cost(inputs, inputs_mask, labels, labels_mask,
                           prediction, prediction_mask, train=True,
                           dropout_mask=dropout_mask)
            batch_cost = out["costs"].sum()
            cost = batch_cost / B
            lm = (prediction_mask if prediction_mask is not None
                  else labels_mask).T
            w_penalty = monotonicity_penalty(out["weights"], lm)
            w_entropy = entropy(out["weights"], lm)
            train_cost = cost
            if penalty_coof:
                train_cost = train_cost + penalty_coof * w_penalty / B
            if decay:
                train_cost = train_cost + decay * sum(
                    (p ** 2).sum() for p in decay_leaves.values())
            got = torch.autograd.grad(
                train_cost, list(params.values())
                + [means[k] for k in extra])
        finally:
            net.requires_grad_(False)
            with torch.no_grad():
                for k in noised:
                    params[k].copy_(means[k])
        grads = dict(zip(params, got))
        for k, g in zip(extra, got[len(params):]):
            grads[k] = grads[k] + g
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
                "total_gradient_norm": global_norm(grads),
                "total_step_norm": global_norm(updates),
            }
            if out["energies"] is not None:
                monitors["min_energy"] = out["energies"].min()
                monitors["max_energy"] = out["energies"].max()
        return opt_state, {k: v.detach() for k, v in monitors.items()}

    return step


# the log-variances are ls2 = log(sigma^2) / LOG_SIGMA_SCALE
LOG_SIGMA_SCALE = 2048.0


def noise_path(path: str) -> str:
    """'/recognizer/a/b' -> '/adaptive_noise/a/b'."""
    return NOISE_PREFIX + path[len(PREFIX):]


def init_adaptive_noise_params(recognizer, init_sigma=1e-6):
    """Give the recognizer its noise collection (JAX
    ``init_adaptive_noise_params``): every parameter's log-variance
    ``2 log(init_sigma) / LOG_SIGMA_SCALE``."""
    init_val = float(np.log(init_sigma) * 2.0 / LOG_SIGMA_SCALE)
    recognizer.noise = {
        noise_path(k): torch.full(p.shape, init_val, dtype=torch.float32,
                                  device=p.device)
        for k, p in recognizer.parameters().items()}
    return recognizer.noise


def noise_generator(device, seed, iteration):
    """The ``torch.Generator`` of one step's draws: seeded from the
    training seed and the iteration, so a resumed run draws what the
    straight run drew at the same iteration."""
    return torch.Generator(device=device).manual_seed(
        int(seed) * 2 ** 32 + int(iteration))


def make_adaptive_noise_train_step(recognizer, optimizer, config):
    """Graves' adaptive (variational) weight noise step (JAX
    ``make_adaptive_noise_train_step``, the reference's
    ``lvsr/graph.py:71-251``): each parameter is a Gaussian of mean the
    parameter and variance ``exp(LOG_SIGMA_SCALE * ls2)``; the cost graph
    runs on sampled weights, the model cost against the empirical
    Gaussian prior of all the parameters is added, and the means and
    log-variances get the reference's gradients, the log-variances' with
    the task gradient squared (a diagonal Hessian estimate for a batch of
    one).  Options of ``regularization.adaptive_noise``: ``init_sigma``
    (1e-6), ``model_cost_coefficient`` (1), ``num_examples`` (1).

    ``step(opt_state, inputs, inputs_mask, labels, labels_mask, *,
    generator=None, noise=None)``: the standard normal draws come from
    ``noise`` (``{'/recognizer/...': tensor}``, e.g. another package's
    draws) or else from ``generator`` (a ``torch.Generator`` on the
    model's device; a fresh one seeded 0 when None).  Parameters and
    log-variances are updated in place; the monitors are the JAX step's.
    The recognizer gets its noise collection here if it has none."""
    reg = config.get("regularization", {}) or {}
    conf = dict(reg.get("adaptive_noise") or {})
    init_sigma = float(conf.get("init_sigma", 1e-6))
    coeff = float(conf.get("model_cost_coefficient", 1.0))
    num_examples = int(conf.get("num_examples", 1))
    if recognizer.noise is None:
        init_adaptive_noise_params(recognizer, init_sigma)
    net = recognizer.net
    params = recognizer.parameters()
    ls2 = {k: recognizer.noise[noise_path(k)] for k in params}
    total_count = sum(p.numel() for p in params.values())

    def step(opt_state, inputs, inputs_mask, labels, labels_mask, *,
             generator=None, noise=None):
        B = labels.shape[0]
        dev = labels.device
        with torch.no_grad():
            s2 = {k: torch.exp(l * LOG_SIGMA_SCALE) for k, l in ls2.items()}
            if noise is None:
                if generator is None:
                    generator = torch.Generator(device=dev).manual_seed(0)
                noise = {k: torch.randn(p.shape, generator=generator,
                                        device=dev)
                         for k, p in params.items()}
            sampled = {k: noise[k] * torch.sqrt(s2[k]) for k in params}
            # the empirical prior over all noisy parameters
            # (graph.py:185-198), a constant of the gradients
            prior_u = sum(p.sum() for p in params.values()) / total_count
            prior_s2 = (sum(v.sum() for v in s2.values())
                        + sum(((p - prior_u) ** 2).sum()
                              for p in params.values())) / total_count
            means = {k: p.detach().clone() for k, p in params.items()}
            for k, p in params.items():
                p.copy_(p + sampled[k])
        net.requires_grad_(True)
        try:
            # no dropout here, as in the JAX package's noise step
            out = net.cost(inputs, inputs_mask, labels, labels_mask)
            task_cost = out["costs"].sum() / B
            g = dict(zip(params, torch.autograd.grad(
                task_cost, list(params.values()))))
        finally:
            net.requires_grad_(False)
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(means[k])
        with torch.no_grad():
            lm = labels_mask.T
            # the model cost (graph.py:206-214)
            model_cost = sum(
                0.5 * (torch.log(prior_s2) - ls2[k] * LOG_SIGMA_SCALE).sum()
                + (1.0 / (2.0 * prior_s2))
                * (((p - prior_u) ** 2) + s2[k] - prior_s2).sum()
                for k, p in params.items())
            model_cost = model_cost / num_examples * coeff
            # the custom gradients (graph.py:236-249)
            grads = {k: g[k] + coeff * (p - prior_u)
                     / (num_examples * prior_s2) for k, p in params.items()}
            grads.update({
                noise_path(k): (coeff * 0.5 / num_examples
                                * LOG_SIGMA_SCALE) * (s2[k] / prior_s2 - 1.0)
                + 0.5 * LOG_SIGMA_SCALE * s2[k] * g[k] ** 2
                for k in params})
            current = recognizer.optimized()
            updates, opt_state = optimizer.update(grads, opt_state, current)
            for k, u in updates.items():
                current[k].add_(u)
            monitors = {
                "sequence_total_cost": task_cost,
                "batch_size": torch.tensor(float(B), device=dev),
                "weights_entropy": entropy(out["weights"], lm),
                "weights_penalty": monotonicity_penalty(out["weights"], lm),
                "train_cost": task_cost + model_cost,
                "model_cost": model_cost,
                "model_prior_mean": prior_u,
                "model_prior_variance": prior_s2,
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
    batches and returns each step's monitors as Python floats.  Each step
    gets :func:`noise_generator` of ``seed`` and ``iteration()``, the
    iterations done before it (by default the batches this object has
    processed; ``run_training`` reads the loop's log, which a resumed run
    restores); a step without noise ignores it.  A batch's inputs are the
    recognizer's source (the JAX ``GradientDescent``'s ``batch_keys``):
    ``recordings``, or a lookup bottom's ``inputs``.

    ``compile_stats`` holds what the JAX package's ``GradientDescent``
    keeps of its compilations: ``compile_time_s``, the summed wall time of
    the first step of each new batch shape (ending in the step's host
    pull of its monitors, which waits for the card), and
    ``num_compiled_shapes``, the shapes seen.  Nothing is compiled per
    shape here, but on the card the first step's time includes building
    and loading the kernels when it is the process's first use of
    them."""

    def __init__(self, recognizer, optimizer, step_fn, seed=1234,
                 iteration: Optional[Callable[[], int]] = None):
        self.recognizer = recognizer
        self.optimizer = optimizer
        self.step_fn = step_fn
        self.seed = seed
        self.processed = 0
        self.iteration = iteration or (lambda: self.processed)
        self.opt_state = self._init_opt_state()
        self.compile_stats = {}
        self._shapes = set()

    def process_batch(self, batch: Mapping[str, Any]):
        t0 = time.time()
        generator = noise_generator(self.recognizer.device, self.seed,
                                    self.iteration())
        tensors = batch_tensors(batch, self.recognizer)
        shapes = tuple(tuple(x.shape) for x in tensors)
        first = shapes not in self._shapes
        self._shapes.add(shapes)
        self.opt_state, monitors = self.step_fn(self.opt_state, *tensors,
                                                generator=generator)
        self.processed += 1
        names = sorted(monitors)
        values = torch.stack([monitors[k] for k in names]).tolist()
        if first:
            self.compile_stats["compile_time_s"] = self.compile_stats.get(
                "compile_time_s", 0.0) + time.time() - t0
            self.compile_stats["num_compiled_shapes"] = len(self._shapes)
        return dict(zip(names, values))

    def _init_opt_state(self):
        return self.optimizer.init(self.recognizer.optimized())

    def parameter_dict(self):
        return self.recognizer.param_path_dict()

    def opt_state_arrays(self):
        return state_arrays(self.opt_state)

    def set_parameters(self, path_dict):
        """Load ``{'/recognizer/...': array}`` and, with adaptive noise,
        the ``/adaptive_noise`` log-variances (other keys skipped), and
        start the optimizer state afresh."""
        self.recognizer.load_path_dict(path_dict)
        self.opt_state = self._init_opt_state()

    def set_opt_state(self, opt_state):
        """The flat optimizer state of a checkpoint of either package
        (``checkpoint.load_checkpoint``'s ``opt_state``)."""
        self.opt_state = load_state_arrays(self.opt_state, opt_state)


def run_training(recognizer: SpeechRecognizer, optimizer,
                 batch_stream: Callable[[], Iterable], save_path: str,
                 config: Optional[Mapping] = None, *, num_batches=None,
                 num_epochs=None, save_every_n_batches=None,
                 valid_stream: Optional[Callable[[], Iterable]] = None,
                 search_data=None, length_filter=None, fast_start=False,
                 load_path=None, use_load_ext=False, load_log=False,
                 profile=False, printing=True, num_examples=None,
                 extensions=()):
    """Train ``recognizer`` with ``optimizer`` over ``batch_stream()``
    (called once per epoch; each batch a mapping with the recognizer's
    source, ``recordings`` or a lookup bottom's ``inputs``, its mask,
    ``labels`` and ``labels_mask``), checkpointing to
    ``save_path`` before the first epoch (unless ``fast_start``), after
    every epoch and every ``save_every_n_batches``.  With
    ``valid_stream`` (a factory like ``batch_stream``), the validation
    cost is taken before the first epoch (unless ``fast_start``) and at
    the config's ``monitoring.validate_every_epochs`` (default 1) and
    ``validate_every_batches``, and each epoch that improves it is also
    saved to ``<root>_best_ll<ext>``.  With the config's
    ``monitoring.search`` section as well, the beam search's error rate
    on ``valid_stream`` (``valid_per``) is taken before the first epoch
    (unless ``fast_start``) and at ``monitoring.search_every_epochs``
    (default 1) and ``search_every_batches``, the characters coming from
    ``search_data.decode``, and each epoch that improves it is saved to
    ``<root>_best<ext>``.  ``training.stop_filtering`` clears
    ``length_filter.max_length`` (the data's ``LengthFilter``) after that
    many batches; ``training.patience`` (``min_iterations`` or
    ``min_epochs``, ``patience_factor``) stops early, counting an
    improvement of ``valid_per`` or of the validation cost.

    ``load_path`` is a checkpoint of either package to resume from: with
    ``use_load_ext`` its parameters, optimizer state and log (the epochs
    and batches then count on from it), with ``load_log`` its log alone.
    ``profile`` prints the loop's host times at the end.  The config's
    ``monitoring.plot`` (``path``, ``every_n_batches`` (100), ``serve``,
    ``port`` (0), ``channels``) adds the JAX package's ``Plot`` of the
    channels to ``<path>.json`` (and ``.png``) and its ``PlotServer``.
    ``extensions`` (such as ``train/extensions.py``'s ``NanGuard``,
    ``ProgressBar``, ``LogInputs``, ``TorchProfiler`` or ``EmbedShell``)
    run after all of these.

    A ``regularization.adaptive_noise`` section (an empty one too) trains
    with adaptive weight noise: the log-variances are made here, after
    ``recognizer``'s checkpoint has loaded (a ``Load`` resume then takes
    the checkpoint's), and the section's ``num_examples`` defaults to
    ``num_examples``, the training set's size.  Returns the finished
    :class:`MainLoop` (its ``log`` holds every step's monitors)."""
    config = dict(config or {})
    train_conf = config.get("training", {}) or {}
    mon_conf = config.get("monitoring", {}) or {}
    search_conf = mon_conf.get("search") or {}
    reg = config.get("regularization", {}) or {}
    adaptive = reg.get("adaptive_noise")
    if adaptive is not None and adaptive is not False:
        adaptive = dict(adaptive or {})
        if "num_examples" not in adaptive:
            if num_examples is None:
                raise ValueError("adaptive noise needs num_examples, the "
                                 "training set's size")
            adaptive["num_examples"] = int(num_examples)
        config["regularization"] = dict(reg, adaptive_noise=adaptive)
        init_adaptive_noise_params(recognizer,
                                   float(adaptive.get("init_sigma", 1e-6)))
    step = make_train_step(recognizer, optimizer, config)
    loop = None     # the step's iteration is read from the loop's log
    algorithm = GradientDescent(
        recognizer, optimizer, step, seed=train_conf.get("seed", 1234),
        iteration=lambda: loop.log.status["iterations_done"])
    exts = []
    if use_load_ext and load_path:
        exts.append(Load(load_path))
    if load_log and load_path:
        exts.append(LoadLog(load_path))
    exts += [Timing(), CodeVersion(), CompilationStatistics(),
             AveragedTrainMonitoring(PRIMARY_OBSERVABLES,
                                     every_n_batches=10)]
    best = best_per = per = None
    if valid_stream is not None:
        validation = DataStreamMonitoring(
            make_eval_fn(recognizer), valid_stream, prefix="valid",
            before_first_epoch=not fast_start,
            every_n_epochs=mon_conf.get("validate_every_epochs", 1),
            every_n_batches=mon_conf.get("validate_every_batches", 0))
        exts.append(validation)
        if search_conf:
            if search_data is None:
                raise ValueError("monitoring.search needs search_data, the "
                                 "object whose decode() gives the "
                                 "characters of label ids")
            per = BeamSearchErrorRate(
                recognizer, search_data, valid_stream,
                beam_size=search_conf.get("beam_size", 10),
                char_discount=search_conf.get("char_discount"),
                round_to_inf=search_conf.get("round_to_inf"),
                stop_on=search_conf.get("stop_on"),
                before_first_epoch=not fast_start,
                every_n_epochs=mon_conf.get("search_every_epochs", 1),
                every_n_batches=mon_conf.get("search_every_batches", 0))
            best_per = TrackTheBest(per.record_name,
                                    before_first_epoch=True,
                                    after_epoch=True)
            exts += [per, best_per]
        best = TrackTheBest(validation.record_name("sequence_total_cost"),
                            before_first_epoch=True, after_epoch=True)
        exts.append(best)
    stop_filtering = train_conf.get("stop_filtering")
    if length_filter is not None:
        exts.append(SwitchOffLengthFilter(length_filter,
                                          after_n_batches=stop_filtering))
    elif stop_filtering:
        raise ValueError("training.stop_filtering needs length_filter, the "
                         "data's LengthFilter")
    finish = FinishAfter(after_n_batches=num_batches,
                         after_n_epochs=num_epochs)
    finish.add_condition(["after_batch"], gradient_norm_is_nan)
    checkpoint = Checkpoint(save_path, before_first_epoch=not fast_start,
                            after_epoch=True,
                            every_n_batches=save_every_n_batches)
    root, ext = os.path.splitext(save_path)
    if best_per is not None:
        checkpoint.add_condition(["after_epoch"],
                                 on_record(best_per.notification_name),
                                 arguments=(root + "_best" + ext,))
    if best is not None:
        checkpoint.add_condition(["after_epoch"],
                                 on_record(best.notification_name),
                                 arguments=(root + "_best_ll" + ext,))
    exts += [finish, checkpoint]
    if train_conf.get("patience"):
        patience_conf = dict(train_conf["patience"])
        if not patience_conf.get("notification_names"):
            patience_conf["notification_names"] = [
                t.notification_name for t in (best_per, best)
                if t is not None]
        exts.append(Patience(**patience_conf))
    exts += plot_extensions(mon_conf.get("plot"), per)
    if printing:
        exts.append(Printing(every_n_batches=1))
    exts += list(extensions)
    log = TrainingLog()
    log.status["_config"] = repr(config)
    loop = MainLoop(algorithm, batch_stream, log=log, extensions=exts,
                    profile_enabled=profile)
    return loop.run()


def plot_extensions(plot_conf, per=None):
    """``monitoring.plot``'s extensions (JAX ``initialize_all``
    :537-557): the reference's five channel groups (or the section's
    ``channels``), the beam search's error rate in the second when
    ``per`` (``BeamSearchErrorRate``) runs, empty groups dropped; ``Plot``
    when ``path`` is set (environment variables expanded), ``PlotServer``
    when ``serve`` is."""
    if not plot_conf:
        return []
    channels = plot_conf.get("channels") or [
        ["train_cost", "valid_sequence_total_cost"],
        [per.record_name] if per is not None else [],
        ["total_gradient_norm", "total_step_norm"],
        ["max_energy", "min_energy"],
        ["weights_entropy", "weights_penalty"]]
    channels = [group for group in channels if group]
    exts = []
    if plot_conf.get("path"):
        exts.append(Plot(os.path.expandvars(plot_conf["path"]), channels,
                         every_n_batches=plot_conf.get("every_n_batches",
                                                       100)))
    if plot_conf.get("serve"):
        exts.append(PlotServer(channels, port=int(plot_conf.get("port", 0))))
    return exts


def run_stage(config, save_path, make_stage, params_path=None,
              fast_start=False, use_load_ext=False, load_log=False,
              profile=False, printing=True, extensions=()):
    """One training run of ``config`` (a dict) to ``save_path``:
    ``make_stage(config, load_path)`` builds the recognizer (with the
    parameters of ``load_path`` when it is not None) and the streams, a
    dict of :func:`run_training`'s ``recognizer``, ``batch_stream``,
    ``valid_stream``, ``search_data``, ``length_filter`` and
    ``num_examples``; the rule
    chain comes from the config.  With ``use_load_ext`` the recognizer is
    built without ``params_path``, and ``Load`` restores it with the
    optimizer state and the log; ``extensions`` go to
    :func:`run_training`.  Warns once for each config key the port does
    not honour yet (:data:`UNPORTED_KEYS`)."""
    piece = unported_training(config)
    if piece is not None:
        raise NotImplementedError(f"not ported yet: {piece}")
    for key in unported_keys(config):
        logger.warning("not ported yet, ignored: %s, %s", key,
                       UNPORTED_KEYS[key])
    train_conf = config.get("training", {}) or {}
    made = make_stage(config, None if use_load_ext else params_path)
    optimizer = build_optimizer(train_conf, config.get("regularization", {}))
    return run_training(
        made["recognizer"], optimizer, made["batch_stream"], save_path,
        config, num_batches=train_conf.get("num_batches"),
        num_epochs=train_conf.get("num_epochs"),
        save_every_n_batches=train_conf.get("save_every_n_batches"),
        valid_stream=made.get("valid_stream"),
        search_data=made.get("search_data"),
        length_filter=made.get("length_filter"), fast_start=fast_start,
        load_path=params_path, use_load_ext=use_load_ext,
        load_log=load_log, profile=profile, printing=printing,
        num_examples=made.get("num_examples"), extensions=extensions)


def run_multistage(stages, save_path, make_stage, params_path=None,
                   start_stage=None, final_stage=None, **kwargs):
    """The stages of a multistage config, in order: ``stages`` holds
    (name, config dict) pairs, ``make_stage`` is :func:`run_stage`'s.
    ``save_path`` is a directory; each stage writes ``<name>.zip`` there
    and starts from ``params_path`` if it is the first stage run, else
    from ``<previous stage><restart_from>.zip`` (``training.restart_from``
    of the stage, such as ``_best_ll``).  The run starts at
    ``start_stage`` and stops after ``final_stage``.  ``kwargs`` go to
    :func:`run_stage` (``fast_start``, ``use_load_ext``, ``load_log``,
    ``profile``, ``printing``).  Returns the stages' main loops."""
    os.makedirs(save_path, exist_ok=True)
    stages = list(stages)
    names = [name for name, _ in stages]
    start = names.index(start_stage) if start_stage else 0
    loops = []
    for number in range(start, len(stages)):
        name, stage_config = stages[number]
        if kwargs.get("printing", True):
            print(f"Stage '{name}' config:\n"
                  + pprint.pformat(stage_config, width=100))
        if number and not params_path:
            restart_from = (stage_config.get("training", {}) or {}).get(
                "restart_from", "")
            stage_params = os.path.join(
                save_path, f"{names[number - 1]}{restart_from}.zip")
        else:
            stage_params, params_path = params_path, None
        loops.append(run_stage(stage_config,
                               os.path.join(save_path, f"{name}.zip"),
                               make_stage, stage_params, **kwargs))
        if final_stage is not None and name == final_stage:
            break
    return loops


def data_stage(device="cuda"):
    """:func:`run_stage`'s ``make_stage`` over the config's data manager
    (``h5py``): the ``train`` part, validated on the ``valid`` part."""
    from attention_lvcsr_torch.data import Data      # h5py: CLI path only

    def make_stage(config, load_path):
        data = Data(**config["data"])
        return dict(
            recognizer=create_model(config, data, load_path, device=device),
            batch_stream=lambda: data.get_stream("train"),
            valid_stream=lambda: data.get_stream("valid", shuffle=False),
            search_data=data, length_filter=data.length_filter,
            num_examples=data.get_dataset("train").num_examples)

    return make_stage


def train(config, save_path, params_path=None, fast_start=False,
          use_load_ext=False, load_log=False, profile=False, device="cuda"):
    """CLI entry for a config without stages: :func:`run_stage` over the
    config's data."""
    return run_stage(dict(config), save_path, data_stage(device), params_path,
                     fast_start=fast_start, use_load_ext=use_load_ext,
                     load_log=load_log, profile=profile)


def train_multistage(config, save_path, params_path=None, start_stage=None,
                     final_stage=None, fast_start=False, use_load_ext=False,
                     load_log=False, profile=False, device="cuda"):
    """CLI entry (``run.py train``): :func:`run_multistage` over
    ``config.ordered_stages`` and the config's data, or :func:`train` for a
    config without stages."""
    kwargs = dict(fast_start=fast_start, use_load_ext=use_load_ext,
                  load_log=load_log, profile=profile)
    if not getattr(config, "multi_stage", False):
        return train(config, save_path, params_path, device=device, **kwargs)
    return run_multistage(list(config.ordered_stages.items()), save_path,
                          data_stage(device), params_path, start_stage,
                          final_stage, **kwargs)


def _batched_decode_iter(stream, recognizer, key, decode_batch,
                         search_kwargs, decode_only):
    """Decode the stream's examples in chunks of ``decode_batch``, one
    batched beam search a chunk (zero-padded to its longest utterance);
    yields (number, example, best-first outputs, costs, seconds per
    utterance).  The decode-length cap comes from the chunk's longest
    utterance."""
    chunk = []

    def flush():
        if not chunk:
            return
        B = len(chunk)
        arrs = [np.asarray(ex[key]) for _, ex in chunk]
        max_t = max(len(a) for a in arrs)
        batch = np.zeros((B, max_t) + arrs[0].shape[1:], arrs[0].dtype)
        mask = np.zeros((B, max_t), np.float32)
        for i, a in enumerate(arrs):
            batch[i, :len(a)] = a
            mask[i, :len(a)] = 1.0
        before = time.time()
        out = recognizer.beam_search(batch, mask, as_arrays=True,
                                     **search_kwargs)
        took = (time.time() - before) / B
        for i, (number, ex) in enumerate(chunk):
            valid = out["done_valid"][i]
            if not valid.any():
                yield number, ex, [[]], [np.nan], took
                continue
            order = [k for k in np.argsort(out["done_adjusted"][i])
                     if valid[k]]
            outputs = [list(out["done_out"][i, k, :out["done_len"][i, k]])
                       for k in order]
            costs = [float(out["done_cost"][i, k]) for k in order]
            yield number, ex, outputs, costs, took
        chunk.clear()

    for number, example in enumerate(stream):
        if decode_only is not None and number not in decode_only:
            continue
        chunk.append((number, example))
        if len(chunk) >= decode_batch:
            yield from flush()
    yield from flush()


def _analyze_one(recognizer, inputs, labels):
    """The teacher-forced costs (T,) and weights (T, L) of one
    utterance's labels."""
    out = recognizer.analyze(inputs[None], np.ones((1, len(inputs))),
                             np.asarray(labels, np.int64)[None],
                             np.ones((1, len(labels))))
    return out["costs"], out["weights"][:, 0, :]


def _std(weights):
    return float(weights_std(weights[:, None, :],
                             np.ones((len(weights), 1), "f")))


def run_search(recognizer, examples, dataset, search_conf, *,
               vocabulary=None, decode_only=None, nll_only=False,
               report=None, decoded_save=None,
               validate_solution_function=None, print_to=None):
    """Decode and score ``examples`` (an iterable of example dicts with
    the input features, ``labels`` and optionally ``uttids``), printing
    the JAX package's report lines to ``print_to`` (standard output by
    default; with ``report``, to ``<report>/report.txt``, with alignment
    plots in ``<report>/alignments``).  ``dataset`` gives ``decode(labels)`` (the
    characters scored) and ``pretty_print(labels, example)``;
    ``search_conf`` is the config's ``monitoring.search`` section
    (``beam_size``, ``char_discount``, ``round_to_inf``, ``stop_on``,
    ``decode_batch``); ``vocabulary`` maps words to words for the WER;
    ``decode_only`` holds the numbers of the examples to decode;
    ``nll_only`` prints the groundtruth costs alone; ``decoded_save``
    receives one ``<uttid> <characters>`` line per decoded example.
    Returns the totals (``num_examples``, ``total_nll``,
    ``total_errors``, ``total_length``, ``total_wer_errors``,
    ``total_word_length``)."""
    from attention_lvcsr_torch.search.beam import CandidateNotFoundError
    print_to = print_to or sys.stdout
    recognizer.init_beam_search(search_conf.get("beam_size", 10))
    key = input_key(recognizer)

    def to_words(chars):
        return [vocabulary.get(word, vocabulary.get("<UNK>", "<UNK>"))
                for word in chars.split()]

    report_file = decoded_file = None
    if report:
        os.makedirs(os.path.join(report, "alignments"), exist_ok=True)
        print_to = report_file = open(os.path.join(report, "report.txt"),
                                      "w")
    if decoded_save:
        decoded_file = open(decoded_save, "w")

    stats = dict(num_examples=0, total_nll=0.0, total_errors=0.0,
                 total_length=0.0, total_wer_errors=0.0,
                 total_word_length=0.0)
    search_kwargs = {k: v for k, v in dict(
        char_discount=search_conf.get("char_discount"),
        round_to_inf=search_conf.get("round_to_inf"),
        stop_on=search_conf.get("stop_on"),
        validate_solution_function=validate_solution_function).items() if v}
    decode_batch = int(search_conf.get("decode_batch", 1) or 1)
    if decode_batch > 1 and not nll_only:
        example_iter = _batched_decode_iter(
            examples, recognizer, key, decode_batch, search_kwargs,
            decode_only)
    else:
        example_iter = ((n, ex, None, None, None)
                        for n, ex in enumerate(examples)
                        if decode_only is None or n in decode_only)
    try:
        for number, example, pre_out, pre_costs, pre_took in example_iter:
            uttids = example.pop("uttids", None)
            raw_groundtruth = np.asarray(example["labels"], np.int64)
            inputs = recognizer.inputs_tensor(example[key])
            print(f"Utterance {number} ({uttids})", file=print_to)
            groundtruth = dataset.decode(raw_groundtruth)
            groundtruth_text = dataset.pretty_print(raw_groundtruth, example)

            costs_gt, weights_gt = _analyze_one(recognizer, inputs,
                                                raw_groundtruth)
            nll = float(costs_gt.sum())
            stats["total_nll"] += nll
            stats["num_examples"] += 1
            print("Groundtruth:", groundtruth_text, file=print_to)
            print("Groundtruth cost:", nll, file=print_to)
            print("Groundtruth weight std:", _std(weights_gt), file=print_to)
            print("Average groundtruth cost: {}".format(
                stats["total_nll"] / stats["num_examples"]), file=print_to)
            if nll_only:
                print_to.flush()
                continue

            if pre_out is not None:
                outputs, search_costs, took = pre_out, pre_costs, pre_took
            else:
                before = time.time()
                try:
                    outputs, search_costs = recognizer.beam_search(
                        inputs, **search_kwargs)
                except CandidateNotFoundError:
                    outputs, search_costs = [[]], [np.nan]
                took = time.time() - before

            recognized = dataset.decode(outputs[0])
            recognized_text = dataset.pretty_print(outputs[0], example)
            error = min(1, wer(groundtruth, recognized)) if recognized else 1
            stats["total_errors"] += len(groundtruth) * error
            stats["total_length"] += len(groundtruth)

            costs_recognized = weights_recognized = None
            if recognized:
                costs_rec, weights_recognized = _analyze_one(
                    recognizer, inputs, outputs[0])
                costs_recognized = float(costs_rec.sum())

            if vocabulary is not None:
                wer_error = min(1, wer(to_words(groundtruth_text),
                                       to_words(recognized_text)))
                stats["total_wer_errors"] += len(groundtruth) * wer_error
                stats["total_word_length"] += len(groundtruth)

            if report and recognized:
                from attention_lvcsr_torch.utils.plots import save_alignment
                save_alignment(weights_gt, groundtruth, os.path.join(
                    report, "alignments", f"{number}.groundtruth.png"))
                save_alignment(weights_recognized, recognized, os.path.join(
                    report, "alignments", f"{number}.recognized.png"))

            if decoded_file is not None:
                print("{} {}".format(uttids, " ".join(recognized)),
                      file=decoded_file)

            print("Decoding took:", took, file=print_to)
            print("Beam search cost:", search_costs[0], file=print_to)
            print("Recognized:", recognized_text, file=print_to)
            if costs_recognized is not None:
                print("Recognized cost:", costs_recognized, file=print_to)
                print("Recognized weight std:", _std(weights_recognized),
                      file=print_to)
            print("CER:", error, file=print_to)
            print("Average CER:",
                  stats["total_errors"] / stats["total_length"],
                  file=print_to)
            if vocabulary is not None:
                print("WER:", wer_error, file=print_to)
                print("Average WER:", stats["total_wer_errors"]
                      / stats["total_word_length"], file=print_to)
            print_to.flush()
    finally:
        for f in (report_file, decoded_file):
            if f is not None:
                f.close()
    return stats


def read_vocabulary(path):
    """``{word: word}`` of the first two columns of each line."""
    vocabulary = {}
    with open(os.path.expandvars(path)) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                vocabulary[parts[0]] = parts[1]
    return vocabulary


def search(config, load_path, part="valid", decode_only=None, report=None,
           decoded_save=None, nll_only=False, seed=None, device="cuda",
           print_to=None):
    """CLI entry (``run.py search``): decode and score a dataset part with
    the config's ``monitoring.search`` settings, as the JAX ``search``
    reads them; see :func:`run_search`."""
    from attention_lvcsr_torch.data import Data      # h5py: CLI path only
    data = Data(**config["data"])
    search_conf = config.get("monitoring", {}).get("search", {})
    recognizer = create_model(config, data, load_path, device=device)
    add_sources = ("uttids",) if "uttids" in data.sources_map else ()
    dataset = data.get_dataset(part, add_sources=add_sources)
    stream = data.get_stream(part, batches=False, shuffle=part == "train",
                             add_sources=add_sources,
                             num_examples=(500 if part == "train" else None),
                             seed=seed)
    vocabulary = (read_vocabulary(config["vocabulary"])
                  if config.get("vocabulary") else None)
    return run_search(
        recognizer, stream, dataset, search_conf, vocabulary=vocabulary,
        decode_only=decode_only, nll_only=nll_only, report=report,
        decoded_save=decoded_save,
        validate_solution_function=getattr(data.info_dataset,
                                           "validate_solution", None),
        print_to=print_to)


def sample(config, load_path, part="valid", device="cuda", print_to=None):
    """CLI entry (``run.py sample``): the groundtruth and a sample of the
    model for each example of a dataset part."""
    from attention_lvcsr_torch.data import Data
    print_to = print_to or sys.stdout
    data = Data(**config["data"])
    recognizer = create_model(config, data, load_path, device=device)
    dataset = data.get_dataset(part)
    key = input_key(recognizer)
    for number, example in enumerate(
            data.get_stream(part, batches=False, shuffle=False)):
        raw_groundtruth = example["labels"]
        print(f"Utterance {number}", file=print_to)
        print("Groundtruth:",
              dataset.pretty_print(raw_groundtruth, example), file=print_to)
        result = recognizer.sample(recognizer.inputs_tensor(example[key]))
        outputs = result["outputs"][:, 0]
        print("Recognized:", dataset.pretty_print(outputs, example),
              file=print_to)


def show_data(config):
    """CLI entry (``run.py show_data``): the shape and dtype of each
    source of the first training batch, and the mean and std of the
    float ones."""
    from attention_lvcsr_torch.data import Data
    data = Data(**config["data"])
    batch = next(iter(data.get_stream("train")))
    for key, value in batch.items():
        arr = np.asarray(value)
        print(f"{key}: shape={arr.shape} dtype={arr.dtype}")
        if arr.dtype.kind == "f":
            print(f"  mean={arr.mean():.4f} std={arr.std():.4f}")
    return batch


def init_norm(config, save_path):
    """CLI entry (``run.py init_norm``): the feature mean and std of the
    training part (without the config's own normalization), saved to
    ``save_path``."""
    from attention_lvcsr_torch.data import Data
    from attention_lvcsr_torch.data.preprocessing import Normalization
    data_conf = dict(config["data"])
    data_conf.pop("normalization", None)
    data = Data(**data_conf)
    norm = Normalization.compute(
        data.get_stream("train", batches=False, shuffle=False),
        source="recordings")
    norm.save(save_path)
    print(f"saved normalization to {save_path}")
    return norm


def test(config, **kwargs):
    raise NotImplementedError("the reference's 'test' entry is also "
                              "unimplemented (lvsr/main.py:925-926)")
