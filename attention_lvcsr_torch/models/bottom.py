"""The speech bottom: identity or an MLP over feature frames.

Counterpart of ``attention_lvcsr_tpu/models/bottom.py::SpeechBottom``
(layout ``(B, T, F)``, layers ``mlp_{i}``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from attention_lvcsr_torch.models.layers import Dense


class SpeechBottom(nn.Module):
    def __init__(self, num_features: int, dims: Optional[Sequence[int]] = None,
                 activation: str = "tanh"):
        super().__init__()
        if activation not in ("tanh", None, "relu", "rectifier"):
            raise ValueError(activation)
        self.activation = activation
        self.dims = list(dims or [])
        self.output_dim = self.dims[-1] if self.dims else num_features
        in_dim = num_features
        for i, d in enumerate(self.dims):
            self.add_module(f"mlp_{i}", Dense(in_dim, d))
            in_dim = d

    def forward(self, recordings):
        x = recordings
        for i in range(len(self.dims)):
            x = getattr(self, f"mlp_{i}")(x)
            x = torch.relu(x) if self.activation in ("relu", "rectifier") \
                else torch.tanh(x)
        return x
