"""The bottoms: the speech bottom (identity or an MLP over feature
frames) and the lookup bottom (an embedding of discrete input tokens).

Counterparts of ``attention_lvcsr_tpu/models/bottom.py``: ``SpeechBottom``
(layout ``(B, T, F)``, layers ``mlp_{i}``), ``LookupBottom`` (``(B, T)``
integer tokens, the embedding ``lookup``) and ``make_bottom`` with the
registry names ``speech``/``SpeechBottom`` and ``lookup``/``LookupBottom``.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch
from torch import nn

from attention_lvcsr_torch.models.layers import Dense, Embed


class SpeechBottom(nn.Module):
    # the source a recognizer with this bottom reads, and its dtype
    input_source = "recordings"
    input_dtype = torch.float32

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


class LookupBottom(nn.Module):
    """Embedding over discrete input tokens (the ``inputs`` source)."""
    input_source = "inputs"
    input_dtype = torch.long

    def __init__(self, num_chars: int, dim: int):
        super().__init__()
        self.output_dim = dim
        self.lookup = Embed(num_chars, dim)

    def forward(self, inputs):
        return self.lookup(inputs.long())


BOTTOM_REGISTRY = {
    "speech": SpeechBottom,
    "lookup": LookupBottom,
    # the reference's YAML tags
    "SpeechBottom": SpeechBottom,
    "LookupBottom": LookupBottom,
}


def bottom_class(spec: Optional[Mapping]):
    """The bottom class a net config's ``bottom`` section names."""
    kind = dict(spec or {}).get("bottom_class", "speech")
    return BOTTOM_REGISTRY[str(kind).rsplit(".", 1)[-1]]


def make_bottom(spec: Optional[Mapping], input_dims: Mapping[str, int],
                input_num_chars: Mapping[str, int]) -> nn.Module:
    """The bottom of ``spec`` over its source's features
    (``input_dims``) or alphabet (``input_num_chars``)."""
    spec = dict(spec or {})
    cls = bottom_class(spec)
    spec.pop("bottom_class", None)
    if cls is SpeechBottom:
        return SpeechBottom(input_dims[cls.input_source], **spec)
    return LookupBottom(input_num_chars[cls.input_source], **spec)
