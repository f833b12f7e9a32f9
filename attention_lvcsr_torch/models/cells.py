"""The GRU cell with a trainable initial state.

Counterpart of ``attention_lvcsr_tpu/models/cells.py::GatedRecurrent``:
blocks' gate layout (update first, then reset) and update rule
``h' = z*tanh((r*h) Wss + x) + (1-z)*h`` with ``[z, r] = sigmoid(h Wsg +
xg)``; a masked step (mask 0) keeps the state.  Input projections are
computed by the caller for the whole sequence; ``scan`` runs the
recurrence through ``ops/gru_scan.py`` (inference) or, with ``train``,
through the differentiable ``ops/gru_train.py`` (the CUDA kernels on a
CUDA tensor); the encoder runs both directions of a layer in one call.
"""
from __future__ import annotations

import torch
from torch import nn

from attention_lvcsr_torch.ops.gru_scan import gru_scan
from attention_lvcsr_torch.ops.gru_train import gru_scan_train


class GatedRecurrent(nn.Module):
    sequence_names = ("inputs", "gate_inputs")

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.state_to_state = nn.Parameter(torch.zeros(dim, dim))
        self.state_to_gates = nn.Parameter(torch.zeros(dim, 2 * dim))
        self.initial_state = nn.Parameter(torch.zeros(dim))

    def sequence_dims(self):
        return {"inputs": self.dim, "gate_inputs": 2 * self.dim}

    def initial_states(self, batch_size):
        return self.initial_state.expand(batch_size, self.dim)

    def one_step(self, h, seqs, mask=None):
        gates = torch.sigmoid(h @ self.state_to_gates + seqs["gate_inputs"])
        update = gates[..., :self.dim]
        reset = gates[..., self.dim:]
        candidate = torch.tanh((h * reset) @ self.state_to_state
                               + seqs["inputs"])
        new_h = update * candidate + (1.0 - update) * h
        if mask is None:
            return new_h
        m = mask[..., None]
        return m * new_h + (1.0 - m) * h

    def scan_weights(self, batch_size):
        """(h0, state_to_state, state_to_gates) as the scans take them."""
        return (self.initial_states(batch_size).contiguous(),
                self.state_to_state.contiguous(),
                self.state_to_gates.contiguous())

    def scan(self, seqs, mask=None, train=False):
        """seqs: name -> (T, B, d) projections; mask (T, B) or None ->
        states (T, B, dim).  ``train`` takes the differentiable scan."""
        proj = torch.cat([seqs["inputs"], seqs["gate_inputs"]], dim=-1)
        fn = gru_scan_train if train else gru_scan
        return fn(proj, mask.contiguous() if mask is not None else None,
                  self.scan_weights(proj.shape[1]))
