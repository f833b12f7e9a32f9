"""Speech encoder: stacked (bi)directional GRUs with temporal subsampling.

Counterpart of ``attention_lvcsr_tpu/models/encoder.py``.  Batch-major
``(B, T, F)`` at the API, time-major inside.  Per layer, the input
projections (inputs and gates, of both directions) are one batched matmul
over the whole sequence, and a bidirectional layer runs both directions'
recurrences in one scan call, the backward one in reverse time.  That is
the JAX package's backward direction (flip inputs and mask, scan, flip
back): padded frames (mask 0) keep the state, so the backward scan meets
the zero-padded tail first and leaves its initial state untouched.

``train`` selects the differentiable scans of the training path
(``ops/gru_train.py``); inference takes ``ops/gru_scan.py``.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from attention_lvcsr_torch.models.cells import GatedRecurrent
from attention_lvcsr_torch.models.layers import Dense
from attention_lvcsr_torch.ops.gru_scan import gru_scan
from attention_lvcsr_torch.ops.gru_train import gru_scan_train


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

    def forward(self, x, mask=None, train=False):
        """One direction alone: x (T, B, F) time-major -> (T, B, dim)."""
        seqs = {n: getattr(self, f"fork_{n}")(x)
                for n in self.cell.sequence_names}
        return self.cell.scan(seqs, mask, train=train)


class Bidirectional(nn.Module):
    """Forward + reverse-time pass, concatenated features.

    The submodules are ``fwd``/``bwd`` (``forward``/``backward`` in the
    JAX parameter paths; see models/params.py)."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.fwd = RecurrentWithFork(in_dim, dim)
        self.bwd = RecurrentWithFork(in_dim, dim)

    def forward(self, x, mask=None, train=False):
        """x (T, B, F) time-major, mask (T, B) -> (T, B, 2*dim)."""
        kf, bf = self.fwd.fork_weights()
        kb, bb = self.bwd.fork_weights()
        proj = x @ torch.cat(kf + kb, dim=1) + torch.cat(bf + bb)
        B = x.shape[1]
        scan = gru_scan_train if train else gru_scan
        return scan(proj.contiguous(),
                    mask.contiguous() if mask is not None else None,
                    self.fwd.cell.scan_weights(B),
                    self.bwd.cell.scan_weights(B))


class Encoder(nn.Module):
    """``dims`` per layer, ``subsample`` strides applied to each layer's
    output and mask (``x[:, ::take_each]``); ``bidir: false`` stacks
    one-directional layers (``with_fork{i}``)."""

    def __init__(self, in_dim: int, dims: Sequence[int],
                 subsample: Sequence[int], bidir: bool = True):
        super().__init__()
        self.subsample = list(subsample)
        for i, dim in enumerate(dims):
            if bidir:
                self.add_module(f"bidir{i}", Bidirectional(in_dim, dim))
            else:
                self.add_module(f"with_fork{i}",
                                RecurrentWithFork(in_dim, dim))
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
