"""Content + convolutional attention with a windowed prior: parameters,
key preprocessing and the decode tables.

Counterpart of ``attention_lvcsr_tpu/models/attention.py::
SequenceContentAndConvAttention`` as far as the whole-loop decode needs
it: the per-step glimpse (window prior, alignment convolution, energies,
softmax normalizer) runs inside ``ops/beam_loop.py``, as it runs inside
the TPU kernel.  The module-driven ``take_glimpses`` of the XLA decode
path comes with the LM-fused decode.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import torch
from torch import nn

from attention_lvcsr_torch.models.layers import Dense


class SequenceContentAndConvAttention(nn.Module):
    """One conv filter and the softmax normalizer (so the energy has no
    bias), the configuration the decode kernel covers.

    ``prior``: ``{"type": "expanding", "initial_begin", "initial_end",
    "min_speed", "max_speed"}`` or ``{"type": "window_around_median",
    "before", "after"}``; None means an expanding window over everything.
    The preprocessing layer is ``preprocessor`` here and ``preprocess`` in
    the JAX parameter paths (models/params.py)."""

    def __init__(self, state_names: Sequence[str], state_dim: int,
                 attended_dim: int, match_dim: int, conv_n: int,
                 prior: Optional[Mapping[str, Any]] = None):
        super().__init__()
        self.state_names = tuple(state_names)
        self.attended_dim = attended_dim
        self.match_dim = match_dim
        self.conv_n = conv_n
        self.prior = dict(prior) if prior else None
        for name in self.state_names:
            self.add_module(f"state_trans_{name}",
                            Dense(state_dim, match_dim, use_bias=False))
        self.preprocessor = Dense(attended_dim, match_dim)
        self.energy_comp = Dense(match_dim, 1, use_bias=False)
        self.handler = Dense(1, match_dim, use_bias=False)
        self.conv_filters = nn.Parameter(torch.zeros(1, 2 * conv_n + 1))

    def prior_config(self):
        if self.prior:
            return dict(self.prior)
        return dict(type="expanding", initial_begin=0, initial_end=10000,
                    min_speed=0, max_speed=0)

    def preprocess(self, attended):
        return self.preprocessor(attended)

    def loop_tables(self):
        """Dense tables of the decode kernel's attention step."""
        (name,) = self.state_names
        return {
            "state_trans": getattr(self, f"state_trans_{name}").kernel,
            "handler": self.handler.kernel[0],
            "v": self.energy_comp.kernel[:, 0],
            "conv_filters": self.conv_filters,
        }
