"""Validation during training: the cost over a stream, weighted means.

Counterparts of ``DataStreamMonitoring`` (``attention_lvcsr_tpu/train/
monitoring.py:91-124``) and ``make_eval_fn`` (``attention_lvcsr_tpu/train/
driver.py:383-416``).  ``make_eval_fn`` runs the port's ``net.cost`` under
``torch.no_grad()`` (on a CUDA device: the encoder's and the decoder's
training forward kernels) and returns the JAX package's four weighted
records; ``DataStreamMonitoring`` sums them over the stream and writes
``<prefix>_<record>`` into the log.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from attention_lvcsr_torch.ops.expressions import (entropy,
                                                   monotonicity_penalty)
from attention_lvcsr_torch.train.loop import SimpleExtension

BATCH_KEYS = ("recordings", "recordings_mask", "labels", "labels_mask")


def batch_tensors(batch, device):
    """(inputs, inputs_mask, labels, labels_mask) of a batch mapping of
    numpy arrays or tensors, on ``device``, as the cost takes them."""
    inputs, inputs_mask, labels, labels_mask = (
        torch.as_tensor(batch[k] if torch.is_tensor(batch[k])
                        else np.asarray(batch[k]), device=device)
        for k in BATCH_KEYS)
    return (inputs.float(), inputs_mask.float(), labels.long(),
            labels_mask.float())


def make_eval_fn(recognizer):
    """``eval_fn(batch) -> {record: (value_sum, weight)}``: the validation
    cost of one batch with the JAX package's weights."""
    net = recognizer.net

    def eval_fn(batch):
        inputs, inputs_mask, labels, labels_mask = batch_tensors(
            batch, recognizer.device)
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
