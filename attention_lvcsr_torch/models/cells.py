"""The GRU cell with a trainable initial state.

Counterpart of ``attention_lvcsr_tpu/models/cells.py::GatedRecurrent``:
blocks' gate layout (update first, then reset) and update rule
``h' = z*tanh((r*h) Wss + x) + (1-z)*h`` with ``[z, r] = sigmoid(h Wsg +
xg)``; a masked step (mask 0) keeps the state.  Input projections are
computed by the caller for the whole sequence; ``scan`` runs the
recurrence through ``ops/gru_scan.py`` (the CUDA kernel on a CUDA tensor);
the encoder runs both directions of a layer in one ``gru_scan`` call.
"""
from __future__ import annotations

import torch
from torch import nn

from attention_lvcsr_torch.ops.gru_scan import gru_scan


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

    def scan(self, seqs, mask=None, initial_states=None):
        """seqs: name -> (T, B, d) projections; mask (T, B) or None ->
        states (T, B, dim)."""
        batch = seqs["inputs"].shape[1]
        if initial_states is None:
            initial_states = self.initial_states(batch)
        proj = torch.cat([seqs["inputs"], seqs["gate_inputs"]], dim=-1)
        return gru_scan(proj, mask.contiguous() if mask is not None else None,
                        (initial_states.contiguous(),
                         self.state_to_state.contiguous(),
                         self.state_to_gates.contiguous()))
