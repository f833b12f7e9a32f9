"""Speech encoder: stacked bidirectional GRUs with temporal subsampling.

Counterpart of ``attention_lvcsr_tpu/models/encoder.py`` (inference
branch).  Batch-major ``(B, T, F)`` at the API, time-major inside.  Per
layer, the four input projections (inputs and gates of both directions)
are one batched matmul over the whole sequence, and both directions'
recurrences run in one ``gru_scan`` launch, the backward one in
reverse time.  That is the JAX package's backward direction (flip inputs
and mask, scan, flip back): padded frames (mask 0) keep the state, so
the backward scan meets the zero-padded tail first and leaves its
initial state untouched.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from attention_lvcsr_torch.models.cells import GatedRecurrent
from attention_lvcsr_torch.models.layers import Dense
from attention_lvcsr_torch.ops.gru_scan import gru_scan


class RecurrentWithFork(nn.Module):
    """A GRU cell with its input fork: ``fork_inputs``, ``fork_gate_inputs``
    project a layer's input into the cell's two sequences."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.cell = GatedRecurrent(dim)
        for name, d in self.cell.sequence_dims().items():
            self.add_module(f"fork_{name}", Dense(in_dim, d))

    def fork_weights(self):
        forks = [getattr(self, f"fork_{n}") for n in self.cell.sequence_names]
        return [f.kernel for f in forks], [f.bias for f in forks]

    def scan_weights(self, batch_size):
        cell = self.cell
        return (cell.initial_states(batch_size).contiguous(),
                cell.state_to_state.contiguous(),
                cell.state_to_gates.contiguous())


class Bidirectional(nn.Module):
    """Forward + reverse-time pass, concatenated features.

    The submodules are ``fwd``/``bwd`` (``forward``/``backward`` in the
    JAX parameter paths; see models/params.py)."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.fwd = RecurrentWithFork(in_dim, dim)
        self.bwd = RecurrentWithFork(in_dim, dim)

    def forward(self, x, mask=None):
        """x (T, B, F) time-major, mask (T, B) -> (T, B, 2*dim)."""
        kf, bf = self.fwd.fork_weights()
        kb, bb = self.bwd.fork_weights()
        proj = x @ torch.cat(kf + kb, dim=1) + torch.cat(bf + bb)
        B = x.shape[1]
        return gru_scan(proj.contiguous(),
                        mask.contiguous() if mask is not None else None,
                        self.fwd.scan_weights(B), self.bwd.scan_weights(B))


class Encoder(nn.Module):
    """``dims`` per layer, ``subsample`` strides applied to each layer's
    output and mask (``x[:, ::take_each]``)."""

    def __init__(self, in_dim: int, dims: Sequence[int],
                 subsample: Sequence[int]):
        super().__init__()
        self.subsample = list(subsample)
        for i, dim in enumerate(dims):
            self.add_module(f"bidir{i}", Bidirectional(in_dim, dim))
            in_dim = 2 * dim
        self.dim_encoded = in_dim
        self.num_layers = len(dims)

    def forward(self, x, mask=None):
        """x (B, T, F), mask (B, T) or None -> (B, L, D), mask (B, L)."""
        x = x.transpose(0, 1)
        mask = mask.transpose(0, 1) if mask is not None else None
        for i, take_each in zip(range(self.num_layers), self.subsample):
            x = getattr(self, f"bidir{i}")(x, mask)[::take_each]
            if mask is not None:
                mask = mask[::take_each]
        x = x.transpose(0, 1)
        if mask is None:
            return x, torch.ones(x.shape[:2], dtype=x.dtype, device=x.device)
        return x, mask.transpose(0, 1)
