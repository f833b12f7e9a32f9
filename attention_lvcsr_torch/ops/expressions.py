"""The one expression the attention needs: a true 1-D convolution.

Counterpart of ``attention_lvcsr_tpu/ops/expressions.py::conv1d`` in
'full' mode.  ``torch.nn.functional.conv1d`` computes a cross-correlation,
so the filter is flipped, as the JAX version flips it for XLA.
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
