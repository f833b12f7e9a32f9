"""Encoder: stacked (bi)directional GRUs, LSTMs or simple RNNs with
temporal subsampling.

Counterpart of ``attention_lvcsr_tpu/models/encoder.py``.  Batch-major
``(B, T, F)`` at the API, time-major inside.  Per layer, the input
projections (every fork of both directions) are one batched matmul over
the whole sequence, and a bidirectional layer runs both directions'
recurrences in one scan call, the backward one in reverse time.  That is
the JAX package's backward direction (flip inputs and mask, scan, flip
back): padded frames (mask 0) keep the state, so the backward scan meets
the zero-padded tail first and leaves its initial state untouched.  An
LSTM layer's scan also returns its cells; only the states go downstream,
as in the JAX encoder.

``train`` selects the differentiable scans of the training path
(``ops/gru_train.py``, ``ops/lstm_train.py``); inference takes
``ops/gru_scan.py`` or ``ops/lstm_scan.py`` (the cell's ``scan_fn``).  A
simple-RNN layer runs the module scan ``models/cells.py::simple_scan`` on
both routes, as the JAX encoder runs its XLA scan (``cells.py:55-90``):
neither package has a kernel for it.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from attention_lvcsr_torch.models.cells import make_cell
from attention_lvcsr_torch.models.layers import Dense


def _states(out):
    """The states of a scan's output: the LSTM's scans also return cells."""
    return out[0] if isinstance(out, tuple) else out


class RecurrentWithFork(nn.Module):
    """A cell with its input forks, ``fork_<sequence>`` for each sequence
    the cell reads (the GRU's inputs and gate inputs, the LSTM's four gate
    inputs in one, the simple RNN's inputs)."""

    def __init__(self, in_dim: int, dim: int, transition="gru"):
        super().__init__()
        self.cell = make_cell(transition, dim)
        for name, d in self.cell.sequence_dims().items():
            self.add_module(f"fork_{name}", Dense(in_dim, d))

    def fork_weights(self):
        forks = [getattr(self, f"fork_{n}") for n in self.cell.sequence_names]
        return [f.kernel for f in forks], [f.bias for f in forks]

    def forward(self, x, mask=None, train=False):
        """One direction alone: x (T, B, F) time-major -> (T, B, dim)."""
        seqs = {n: getattr(self, f"fork_{n}")(x)
                for n in self.cell.sequence_names}
        return _states(self.cell.scan(seqs, mask, train=train))


class Bidirectional(nn.Module):
    """Forward + reverse-time pass, concatenated features.

    The submodules are ``fwd``/``bwd`` (``forward``/``backward`` in the
    JAX parameter paths; see models/params.py)."""

    def __init__(self, in_dim: int, dim: int, transition="gru"):
        super().__init__()
        self.fwd = RecurrentWithFork(in_dim, dim, transition)
        self.bwd = RecurrentWithFork(in_dim, dim, transition)

    def forward(self, x, mask=None, train=False):
        """x (T, B, F) time-major, mask (T, B) -> (T, B, 2*dim)."""
        kf, bf = self.fwd.fork_weights()
        kb, bb = self.bwd.fork_weights()
        proj = x @ torch.cat(kf + kb, dim=1) + torch.cat(bf + bb)
        B = x.shape[1]
        scan = self.fwd.cell.scan_fn(train)
        return _states(scan(proj.contiguous(),
                            mask.contiguous() if mask is not None else None,
                            self.fwd.cell.scan_weights(B),
                            self.bwd.cell.scan_weights(B)))


class Encoder(nn.Module):
    """``dims`` per layer, ``subsample`` strides applied to each layer's
    output and mask (``x[:, ::take_each]``); ``bidir: false`` stacks
    one-directional layers (``with_fork{i}``); ``transition`` names the
    cell (GRU, LSTM or simple RNN)."""

    def __init__(self, in_dim: int, dims: Sequence[int],
                 subsample: Sequence[int], bidir: bool = True,
                 transition="gru"):
        super().__init__()
        self.subsample = list(subsample)
        for i, dim in enumerate(dims):
            if bidir:
                self.add_module(f"bidir{i}",
                                Bidirectional(in_dim, dim, transition))
            else:
                self.add_module(f"with_fork{i}",
                                RecurrentWithFork(in_dim, dim, transition))
            in_dim = (2 if bidir else 1) * dim
        self.layer_names = [f"bidir{i}" if bidir else f"with_fork{i}"
                            for i in range(len(dims))]
        self.dim_encoded = (2 if bidir else 1) * dims[-1]

    def forward(self, x, mask=None, train=False):
        """x (B, T, F), mask (B, T) or None -> (B, L, D), mask (B, L)."""
        x = x.transpose(0, 1)
        mask = mask.transpose(0, 1) if mask is not None else None
        for name, take_each in zip(self.layer_names, self.subsample):
            x = getattr(self, name)(x, mask, train=train)[::take_each]
            if mask is not None:
                mask = mask[::take_each]
        x = x.transpose(0, 1)
        if mask is None:
            return x, torch.ones(x.shape[:2], dtype=x.dtype, device=x.device)
        return x, mask.transpose(0, 1)
