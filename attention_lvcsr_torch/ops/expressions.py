"""Small expressions of the attention and of the training monitors.

Counterpart of ``attention_lvcsr_tpu/ops/expressions.py``: ``conv1d`` in
'full' mode (``torch.nn.functional.conv1d`` computes a cross-correlation,
so the filter is flipped, as the JAX version flips it for XLA), and the
attention diagnostics ``monotonicity_penalty`` and ``entropy`` over
time-major ``(T_out, B, L)`` weights, ``weights_std``, the spread of
the attention that the search driver prints for each alignment, and the
readout's post-merge activations (JAX ``generator.py::Readout.
_activation``), which the plain decode loop applies too.
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


def weights_std(weights, mask_outputs=None):
    """Std of the attention position distribution, summed over steps and
    divided by their number.  ``weights``: (T_out, B, L) time-major
    attention weights (a tensor or an array); ``mask_outputs`` (T_out,
    B) or None."""
    weights = torch.as_tensor(weights)
    positions = torch.arange(weights.shape[2], dtype=weights.dtype,
                             device=weights.device)
    expected = (weights * positions).sum(dim=2)
    expected2 = (weights * positions ** 2).sum(dim=2)
    result = torch.sqrt(torch.clamp(expected2 - expected ** 2, min=0.0))
    if mask_outputs is not None:
        result = result * torch.as_tensor(mask_outputs, dtype=result.dtype,
                                          device=result.device)
    return result.sum() / weights.shape[0]


# the post-merge activations of JAX ``Readout._activation`` (:104-125);
# ``maxout[:k]`` besides, the max over groups of k consecutive units
ACTIVATIONS = ("tanh", "relu", "rectifier", "sigmoid", "logistic",
               "identity")


def maxout_pieces(activation):
    """k of a ``maxout[:k]`` activation (2 without ``:k``), else 0."""
    if not activation.startswith("maxout"):
        return 0
    return int(activation.split(":")[1]) if ":" in activation else 2


def post_merge_activation(x, activation):
    """The readout's activation of ``x``'s last dimension; maxout shrinks
    it k times and raises on a width that k does not divide."""
    if activation == "tanh":
        return torch.tanh(x)
    if activation in ("relu", "rectifier"):
        return torch.relu(x)
    if activation in ("sigmoid", "logistic"):
        return torch.sigmoid(x)
    if activation == "identity":
        return x
    pieces = maxout_pieces(activation)
    if not pieces:
        raise ValueError(activation)
    d = x.shape[-1]
    if d % pieces:
        raise ValueError(f"maxout: last dim {d} not divisible by {pieces}")
    return x.reshape(x.shape[:-1] + (d // pieces, pieces)).amax(dim=-1)
