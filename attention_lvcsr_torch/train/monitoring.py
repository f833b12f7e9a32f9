"""Monitoring during training: the averaged train records, the
validation cost over a stream, weighted means, and the error rate of a
beam search.

Counterparts of ``AveragedTrainMonitoring``, ``DataStreamMonitoring`` and
``BeamSearchErrorRate`` (``attention_lvcsr_tpu/train/monitoring.py``) and
``make_eval_fn``
(``attention_lvcsr_tpu/train/driver.py:383-416``).  ``make_eval_fn`` runs
the port's ``net.cost`` under ``torch.no_grad()`` (on a CUDA device: the
encoder's and the decoder's training forward kernels) and returns the JAX
package's four weighted records; ``DataStreamMonitoring`` sums them over
the stream and writes ``<prefix>_<record>`` into the log;
``BeamSearchErrorRate`` decodes the stream's batches with the
recognizer's beam search (on a CUDA device: the encoder and the whole-loop
decode kernel) and writes the mean character error rate,
``<prefix>_per``.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from attention_lvcsr_torch.ops.error_rate import wer
from attention_lvcsr_torch.ops.expressions import (entropy,
                                                   monotonicity_penalty)
from attention_lvcsr_torch.train.loop import SimpleExtension

def input_key(recognizer):
    """The source a recognizer reads, its bottom's ``input_source`` (JAX
    ``driver.py:428-430``): ``recordings`` for the speech bottom,
    ``inputs`` for the lookup bottom."""
    return recognizer.net.bottom.input_source


def batch_tensors(batch, recognizer):
    """(inputs, inputs_mask, labels, labels_mask) of a batch mapping of
    numpy arrays or tensors, on the recognizer's device, as its cost takes
    them: the inputs are its source (:func:`input_key`) as its bottom
    reads them (``SpeechRecognizer.inputs_tensor``)."""
    key = input_key(recognizer)
    inputs_mask, labels, labels_mask = (
        torch.as_tensor(batch[k] if torch.is_tensor(batch[k])
                        else np.asarray(batch[k]), device=recognizer.device)
        for k in (f"{key}_mask", "labels", "labels_mask"))
    return (recognizer.inputs_tensor(batch[key]), inputs_mask.float(),
            labels.long(), labels_mask.float())


class AveragedTrainMonitoring(SimpleExtension):
    """The mean of each of ``record_names`` over the batches since the last
    fire, written into the fire's row as ``average_<name>``.

    The loop records a batch's monitors before its ``after_batch``; the
    JAX extension reads each row one batch late, and the windows here are
    the rows it takes: those after the last row taken, up to the fire's
    own, where each ``after_batch`` first takes the row before it.  So
    the first window after a resumption also holds the last row of the
    run resumed from."""

    def __init__(self, record_names, **conditions):
        self.record_names = list(record_names)
        self._values: Dict[str, list] = {}
        self._last_time = 0          # the last row taken
        super().__init__(**conditions)

    def _take(self, time):
        if time <= self._last_time:
            return
        row = self.main_loop.log[time]
        for name in self.record_names:
            value = row.get(name)
            if isinstance(value, (int, float, np.floating, np.integer)):
                self._values.setdefault(name, []).append(float(value))
        self._last_time = time

    def dispatch(self, callback_name, *args):
        if callback_name == "after_batch":
            self._take(self.main_loop.log.status["iterations_done"] - 1)
        super().dispatch(callback_name, *args)

    def do(self, which_callback, *args):
        log = self.main_loop.log
        self._take(log.status["iterations_done"])
        row = log.current_row
        for name, values in self._values.items():
            if values:
                row[f"average_{name}"] = float(np.mean(values))
        self._values = {}


def make_eval_fn(recognizer):
    """``eval_fn(batch) -> {record: (value_sum, weight)}``: the validation
    cost of one batch with the JAX package's weights."""
    net = recognizer.net

    def eval_fn(batch):
        inputs, inputs_mask, labels, labels_mask = batch_tensors(
            batch, recognizer)
        with torch.no_grad():
            out = net.cost(inputs, inputs_mask, labels, labels_mask)
            lm = labels_mask.T
            batch_cost, batch_size, num_labels, penalty, ent = torch.stack([
                out["costs"].sum(),
                torch.tensor(float(labels.shape[0]), device=inputs.device),
                labels_mask.sum(), monotonicity_penalty(out["weights"], lm),
                entropy(out["weights"], lm)]).tolist()
        return {
            "sequence_total_cost": (batch_cost, batch_size),
            "num_utterances": (batch_size, 1.0),
            "weights_penalty_per_recording": (penalty, batch_size),
            "weights_entropy_per_label": (ent, num_labels),
        }

    return eval_fn


class DataStreamMonitoring(SimpleExtension):
    """Weighted-mean aggregation of an eval function over a stream.

    ``eval_fn(batch) -> dict`` where values are either floats (weight 1)
    or ``(value_sum, weight)`` pairs aggregated as
    ``sum(value_sum) / sum(weight)``."""

    def __init__(self, eval_fn: Callable, stream_factory: Callable,
                 prefix="valid", **conditions):
        self.eval_fn = eval_fn
        self.stream_factory = stream_factory
        self.prefix = prefix
        super().__init__(**conditions)

    def record_name(self, name):
        return f"{self.prefix}_{name}"

    def do(self, which_callback, *args):
        sums: Dict[str, float] = {}
        weights: Dict[str, float] = {}
        for batch in self.stream_factory():
            for name, value in self.eval_fn(batch).items():
                vsum, w = value if isinstance(value, tuple) else (value, 1.0)
                sums[name] = sums.get(name, 0.0) + float(vsum)
                weights[name] = weights.get(name, 0.0) + float(w)
        row = self.main_loop.log.current_row
        for name in sums:
            row[self.record_name(name)] = sums[name] / max(weights[name],
                                                           1e-12)


class BeamSearchErrorRate(SimpleExtension):
    """The validation CER of a batched beam search (the JAX
    ``BeamSearchErrorRate``): a hypothesis that fails to decode counts as
    error 1, and after more than 10 examples at a mean error above 0.8 the
    pass stops and records 1 (an untrained model).  ``data`` turns label
    ids into characters (``decode``); a ``validate_solution`` of its
    ``info_dataset`` (or of itself) constrains the search.  The record is
    ``valid_per``."""

    record_name = "valid_per"

    def __init__(self, recognizer, data, stream_factory, beam_size,
                 char_discount=None, round_to_inf=None, stop_on=None,
                 **conditions):
        self.recognizer = recognizer
        self.data = data
        self.stream_factory = stream_factory
        self.beam_size = beam_size
        self.search_kwargs = {}
        if char_discount is not None:
            self.search_kwargs["char_discount"] = char_discount
        if round_to_inf is not None:
            self.search_kwargs["round_to_inf"] = round_to_inf
        if stop_on is not None:
            self.search_kwargs["stop_on"] = stop_on
        validate = getattr(getattr(data, "info_dataset", data),
                           "validate_solution", None)
        if validate is not None:
            self.search_kwargs["validate_solution_function"] = validate
        super().__init__(**conditions)

    def do(self, which_callback, *args):
        from attention_lvcsr_torch.search.beam import CandidateNotFoundError
        self.recognizer.init_beam_search(self.beam_size)
        total_errors = total_length = 0.0
        num_examples = 0
        for batch in self.stream_factory():
            key = input_key(self.recognizer)
            inputs = batch[key]
            try:
                out = self.recognizer.beam_search(
                    inputs, batch[f"{key}_mask"], as_arrays=True,
                    **self.search_kwargs)
                best = np.where(out["done_valid"].any(axis=1),
                                np.argmin(out["done_adjusted"], axis=1), -1)
            except CandidateNotFoundError:
                best = None
            labels = _numpy(batch["labels"])
            labels_mask = batch.get("labels_mask")
            for b in range(inputs.shape[0]):
                L = (int(_numpy(labels_mask[b]).sum())
                     if labels_mask is not None else labels.shape[1])
                groundtruth = self.data.decode(labels[b, :L])
                if not groundtruth:
                    continue
                error = 1.0
                if best is not None and best[b] >= 0:
                    k = int(best[b])
                    n = int(out["done_len"][b, k])
                    recognized = self.data.decode(out["done_out"][b, k, :n])
                    error = min(1.0, wer(groundtruth, recognized))
                total_errors += error * len(groundtruth)
                total_length += len(groundtruth)
                num_examples += 1
            if num_examples > 10 and \
                    total_errors / max(total_length, 1) > 0.8:
                total_errors, total_length = 1.0, 1.0
                break
        self.main_loop.log.current_row[self.record_name] = (
            total_errors / max(total_length, 1e-12))


def _numpy(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
