"""Dense and embedding layers with flax's parameter names and layout.

Kernels keep flax's ``(in, out)`` layout and compute ``x @ kernel + bias``,
so every parameter maps one to one, with no transpose, onto the JAX
package's ``/recognizer/...`` checkpoint keys.
"""
from __future__ import annotations

import torch
from torch import nn


class Dense(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if use_bias else None

    def forward(self, x):
        y = x @ self.kernel
        return y + self.bias if self.bias is not None else y


class Embed(nn.Module):
    def __init__(self, num: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num, dim))

    def forward(self, ids):
        return self.embedding[ids]
