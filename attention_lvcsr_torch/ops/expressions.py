"""Small expressions of the attention and of the training monitors.

Counterpart of ``attention_lvcsr_tpu/ops/expressions.py``: ``conv1d`` in
'full' mode (``torch.nn.functional.conv1d`` computes a cross-correlation,
so the filter is flipped, as the JAX version flips it for XLA), and the
attention diagnostics ``monotonicity_penalty`` and ``entropy`` over
time-major ``(T_out, B, L)`` weights.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def conv1d_full(sequences, filters):
    """(B, L) sequences, (num_filters, k) filters -> (B, num_filters,
    L + k - 1): ``out[b, f, t] = sum_i seq[b, i] * filters[f, t - i]``."""
    k = filters.shape[-1]
    kernel = torch.flip(filters, dims=(-1,))[:, None, :].to(sequences.dtype)
    return F.conv1d(sequences[:, None, :], kernel, padding=k - 1)


def monotonicity_penalty(weights, mask_x=None):
    """Penalty for attention moving backwards: the increase of the
    weights' running sum from one step to the next."""
    cumsums = torch.cumsum(weights, dim=2)
    penalties = torch.clamp(cumsums[1:] - cumsums[:-1], min=0).sum(dim=2)
    if mask_x is not None:
        penalties = penalties * mask_x[1:]
    return penalties.sum()


def entropy(weights, mask_x):
    """(Negated) entropy of the attention weights, summed over steps and
    batch."""
    entropies = (weights * torch.log(weights + 1e-7)).sum(dim=2)
    return (entropies * mask_x).sum()
