"""Content + convolutional attention with a windowed prior.

Counterpart of ``attention_lvcsr_tpu/models/attention.py::
SequenceContentAndConvAttention`` for one conv filter and the softmax
normalizer: parameters, key preprocessing, the whole-loop decode tables
(the loop kernel, ``ops/beam_loop.py``, runs its own glimpse), and the
module-driven glimpse of the step-by-step decode (``take_glimpses``),
whose energies go through ``ops/attention_energy.py``.

The module-driven window is the JAX module's: a static mask over all L
frames, its bounds taken over EVERY row of the batch (all utterances'
hypotheses, padding rows included), with the argmax-of-switches median
(0 when no frame switches).  The loop kernel and the fused score kernel
take the bounds per utterance instead; the three agree when each
utterance decodes alone.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import torch
from torch import nn

from attention_lvcsr_torch.models.layers import Dense
from attention_lvcsr_torch.ops.attention_energy import \
    beam_attention_energies
from attention_lvcsr_torch.ops.expressions import conv1d_full


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

    # -- the module-driven glimpse ----------------------------------------
    def initial_glimpses(self, batch_size, attended):
        L = attended.shape[1]
        onehot = attended.new_zeros(batch_size, L)
        onehot[:, 0] = 1.0
        return {
            "weighted_averages": attended.new_zeros(batch_size,
                                                    self.attended_dim),
            "weights": onehot,
            "energies": onehot.clone(),
            "step": torch.zeros(batch_size, dtype=torch.int32,
                                device=attended.device),
        }

    def _window(self, weights, step, length):
        """(1, L) window of the whole batch and, for the window_around
        priors, each row's own (B, L) mask (strict bounds)."""
        p = self.prior_config()
        f32 = torch.float32
        positions = torch.arange(length, dtype=f32, device=weights.device)
        if p.get("type", "expanding") == "expanding":
            s = step[0].to(f32)
            begin = p["initial_begin"] + s * p["min_speed"]
            end = p["initial_end"] + s * p["max_speed"]
            begin = torch.floor(begin.clamp(max=length - 1).clamp(min=0))
            end = torch.ceil(end.clamp(max=length).clamp(min=0))
            window = (positions >= begin) & (positions < end)
            return window.to(f32)[None, :], None
        # window_around_median: the first frame whose cumulative weight
        # reaches 0.5, minus one (argmax of the switches; 0 without one)
        above_half = (torch.cumsum(weights, dim=1) - 0.5 >= 0).to(torch.int32)
        switches = above_half[:, 1:] - above_half[:, :-1]
        if switches.shape[1]:
            expected = torch.argmax(switches, dim=1).to(f32)
        else:
            expected = weights.new_zeros(weights.shape[0])
        begins = torch.floor(expected - p["before"])
        ends = torch.ceil(expected + p["after"])
        begin = torch.floor(begins.min().clamp(min=0))
        end = torch.ceil(ends.max().clamp(max=length))
        window = ((positions >= begin) & (positions < end)).to(f32)
        additional = ((positions[None, :] > begins[:, None])
                      & (positions[None, :] < ends[:, None])).to(f32)
        return window[None, :], additional

    def compute_energies(self, preprocessed, windowed_weights, states,
                         beam=1):
        """Energies (U*beam, L) of per-hypothesis states over the shared
        per-utterance keys (U, L, M), through ``beam_attention_energies``
        (the CUDA kernel on a CUDA tensor)."""
        (name,) = self.state_names
        state_sum = getattr(self, f"state_trans_{name}")(states[name])
        n, L = self.conv_n, windowed_weights.shape[1]
        conv = conv1d_full(windowed_weights, self.conv_filters)[:, 0, n:n + L]
        return beam_attention_energies(
            preprocessed, state_sum.contiguous(), conv.contiguous(),
            self.handler.kernel[0], self.energy_comp.kernel[:, 0], 0.0,
            beam=beam)

    @staticmethod
    def _normalize(energies, global_mask, combined):
        """The softmax normalizer; its max runs over the window only."""
        masked = torch.where(global_mask > 0, energies,
                             torch.finfo(energies.dtype).min)
        m = masked.max(dim=1, keepdim=True).values
        m = torch.where(torch.isfinite(m), m, 0.0)
        unnorm = torch.exp(energies - m) * combined
        denom = unnorm.sum(dim=1, keepdim=True) + (
            combined == 0).all(dim=1, keepdim=True).to(energies.dtype)
        return unnorm / denom

    def take_glimpses(self, attended, preprocessed, attended_mask, glimpses,
                      states, beam=1):
        """One glimpse of every hypothesis row: contexts per utterance (U,
        ...), glimpses and states per row (U*beam, ...)."""
        weights, step = glimpses["weights"], glimpses["step"]
        U, L, D = attended.shape
        global_mask, additional = self._window(weights, step, L)
        combined = global_mask * attended_mask.repeat_interleave(beam, dim=0)
        if additional is not None:
            combined = combined * additional
        energies = self.compute_energies(preprocessed, weights * global_mask,
                                         states, beam=beam)
        new_weights = self._normalize(energies, global_mask, combined)
        weighted = torch.bmm(new_weights.view(U, beam, L), attended)
        return {
            "weighted_averages": weighted.view(U * beam, D),
            "weights": new_weights,
            "energies": energies * global_mask,
            "step": step + 1,
        }
