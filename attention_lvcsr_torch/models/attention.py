"""Content attention, and content + convolutional attention with a
windowed prior.

:class:`SequenceContentAttention` is the counterpart of
``attention_lvcsr_tpu/models/attention.py::SequenceContentAttention``
(Bahdanau content attention, no window, no convolution; its energies are
plain PyTorch on every device, as the JAX module computes them outside
any Pallas kernel).  :class:`SequenceContentAndConvAttention` is the
counterpart of ``SequenceContentAndConvAttention`` for any number of conv
filters (``conv_num_filters``), the expanding, ``window_around_median``
and ``window_around_mean`` priors and the softmax, logistic or relu
energy normalizer (the last two with a biased energy projection, JAX
``attention.py:189``, ``_normalize`` :316-333): parameters, key
preprocessing, the whole-loop decode tables (the loop kernel,
``ops/beam_loop.py``, runs its own glimpse), the tables of the
teacher-forced decoder scan (``train_tables``), and the module-driven
glimpse (``take_glimpses``) of the step-by-step decode, whose energies
go through ``ops/attention_energy.py`` with one filter and are plain
PyTorch with more (JAX ``attention.py:269-275``), and of the
teacher-forced module scan, where they are differentiable PyTorch.

The module-driven window is the JAX module's: a static mask over all L
frames, its bounds taken over EVERY row of the batch (all utterances'
hypotheses, padding rows included), around the argmax-of-switches median
(0 when no frame switches) or the mean position of the previous
weights.  The loop kernel and the fused score kernel
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
from attention_lvcsr_torch.ops.decoder_train import toeplitz_band
from attention_lvcsr_torch.ops.expressions import conv1d_full


class SequenceContentAttention(nn.Module):
    """Bahdanau content attention: ``e = v^T tanh(Wa a + Ws s)`` over all
    frames.  Its glimpses are ``weights`` (zeros at first) and
    ``weighted_averages``, with no energies and no step.  The kernels'
    tables (``train_tables``, ``loop_tables``) carry no conv term:
    ``conv`` is False."""
    conv = False

    def __init__(self, state_names: Sequence[str], state_dim: int,
                 attended_dim: int, match_dim: int):
        super().__init__()
        self.state_names = tuple(state_names)
        self.attended_dim = attended_dim
        self.match_dim = match_dim
        for name in self.state_names:
            self.add_module(f"state_trans_{name}",
                            Dense(state_dim, match_dim, use_bias=False))
        self.preprocessor = Dense(attended_dim, match_dim)
        self.energy_comp = Dense(match_dim, 1, use_bias=False)

    def prior_config(self, length=None):
        """The synthetic prior of the kernels: an expanding window over
        every frame (``initial_end`` the length, or 1e4 without one)."""
        return dict(type="expanding", initial_begin=0,
                    initial_end=float(length) if length else 1e4,
                    min_speed=0, max_speed=0)

    def preprocess(self, attended):
        return self.preprocessor(attended)

    def state_trans(self):
        """The state transforms of every state name, row-stacked (N*S,
        M) in the names' order (JAX ``generator.py:762-767``): the state
        sum of a stacked decoder is one product over its layers."""
        return _row_stack(self)

    def train_tables(self, length):
        """The tables of ``decoder_scan_train`` with ``n_filters=0``, as the
        JAX package passes them: zero Toeplitz band and handler."""
        M = self.match_dim
        v = self.energy_comp.kernel
        return {"toep": v.new_zeros(length, length),
                "st": self.state_trans(),
                "hand": v.new_zeros(1, M), "v": v[:, 0].contiguous()}

    def loop_tables(self):
        """Dense tables of the decode kernel's attention step (no handler,
        no taps)."""
        return {"state_trans": self.state_trans(),
                "v": self.energy_comp.kernel[:, 0]}

    def initial_glimpses(self, batch_size, attended):
        return {"weighted_averages": attended.new_zeros(batch_size,
                                                        self.attended_dim),
                "weights": attended.new_zeros(batch_size, attended.shape[1])}

    def compute_energies(self, preprocessed, states, beam=1):
        """Energies (U*beam, L) of per-hypothesis states over the shared
        per-utterance keys (U, L, M)."""
        state_sum = 0.0
        for name in self.state_names:
            state_sum = state_sum + getattr(self, f"state_trans_{name}")(
                states[name])
        U, L, M = preprocessed.shape
        match = preprocessed[:, None] + state_sum.view(U, beam, 1, M)
        return self.energy_comp(torch.tanh(match))[..., 0].reshape(
            U * beam, L)

    def take_glimpses(self, attended, preprocessed, attended_mask, glimpses,
                      states, beam=1, train=False):
        """One glimpse of every hypothesis row: contexts per utterance (U,
        ...), states per row (U*beam, ...); differentiable on every
        route (``train`` changes nothing).  The softmax runs over every
        frame, with the reference's all-masked guard
        (``blocks/bricks/attention.py:229-235``)."""
        energies = self.compute_energies(preprocessed, states, beam=beam)
        U, L, D = attended.shape
        mask = attended_mask.repeat_interleave(beam, dim=0)
        m = energies.max(dim=1, keepdim=True).values
        unnorm = torch.exp(energies - m) * mask
        denom = unnorm.sum(dim=1, keepdim=True) + (
            mask == 0).all(dim=1, keepdim=True).to(energies.dtype)
        weights = unnorm / denom
        weighted = torch.bmm(weights.view(U, beam, L), attended)
        return {"weighted_averages": weighted.view(U * beam, D),
                "weights": weights}


class SequenceContentAndConvAttention(nn.Module):
    """Content + convolutional attention with ``conv_num_filters`` filters
    (``conv_filters`` (F, 2n+1), ``handler`` Dense(F -> M)).

    ``prior``: ``{"type": "expanding", "initial_begin", "initial_end",
    "min_speed", "max_speed"}`` or ``{"type": "window_around_median" |
    "window_around_mean", "before", "after"}``; None means an expanding
    window over everything.
    ``energy_normalizer``: ``softmax`` (the energy has no bias),
    ``logistic`` or ``relu`` (it has one, ``energy_comp/bias``).
    The preprocessing layer is ``preprocessor`` here and ``preprocess`` in
    the JAX parameter paths (models/params.py)."""
    conv = True

    def __init__(self, state_names: Sequence[str], state_dim: int,
                 attended_dim: int, match_dim: int, conv_n: int,
                 conv_num_filters: int = 1,
                 prior: Optional[Mapping[str, Any]] = None,
                 energy_normalizer: str = "softmax"):
        super().__init__()
        if energy_normalizer not in ("softmax", "logistic", "relu"):
            raise ValueError(
                f"Unknown energy_normalizer: {energy_normalizer}")
        self.state_names = tuple(state_names)
        self.attended_dim = attended_dim
        self.match_dim = match_dim
        self.conv_n = conv_n
        self.conv_num_filters = int(conv_num_filters)
        self.prior = dict(prior) if prior else None
        self.energy_normalizer = energy_normalizer
        for name in self.state_names:
            self.add_module(f"state_trans_{name}",
                            Dense(state_dim, match_dim, use_bias=False))
        self.preprocessor = Dense(attended_dim, match_dim)
        self.energy_comp = Dense(match_dim, 1,
                                 use_bias=energy_normalizer != "softmax")
        self.handler = Dense(self.conv_num_filters, match_dim,
                             use_bias=False)
        self.conv_filters = nn.Parameter(
            torch.zeros(self.conv_num_filters, 2 * conv_n + 1))

    def prior_config(self, length=None):
        """The configured window (``length`` is not used: this prior does
        not depend on the number of frames)."""
        if self.prior:
            return dict(self.prior)
        return dict(type="expanding", initial_begin=0, initial_end=10000,
                    min_speed=0, max_speed=0)

    def preprocess(self, attended):
        return self.preprocessor(attended)

    def state_trans(self):
        """The row-stacked state transforms, as the content attention's."""
        return _row_stack(self)

    def energy_vector(self):
        """(v (M,), bias (1,) or None): the energy projection as the JAX
        tables extract it through identity inputs, ``energy(I) -
        energy(0) = (kernel + bias) - bias`` with a bias, so the two
        packages' tables hold the same bits; differentiable."""
        e = self.energy_comp
        if e.bias is None:
            return e.kernel[:, 0], None
        return (e.kernel[:, 0] + e.bias) - e.bias, e.bias

    def train_tables(self, length):
        """The attention's tables of ``decoder_scan_train``, taken from the
        parameters so that autograd reaches them: the Toeplitz bands of the
        conv filters over ``length`` frames, (L, F*L) filter-major as JAX
        ``generator.py:516-523`` stacks them, the state transform, the
        handler rows (F, M), the energy vector and (logistic, relu) the
        energy bias."""
        v, bias = self.energy_vector()
        filters = self.conv_filters
        toep = (toeplitz_band(filters, length) if len(filters) == 1
                else torch.cat([toeplitz_band(f, length) for f in filters],
                               dim=1))
        return {
            "toep": toep,
            "st": self.state_trans(),
            "hand": self.handler.kernel,
            "v": v.contiguous(), "e_b": bias,
        }

    def loop_tables(self):
        """Dense tables of the decode kernel's attention step: the handler
        row (M,) of one filter or the rows (F, M) of more, the taps (F,
        2n+1); with a biased energy its bias as ``energy_b``."""
        v, bias = self.energy_vector()
        hand = self.handler.kernel
        t = {
            "state_trans": self.state_trans(),
            "handler": hand[0] if len(hand) == 1 else hand,
            "v": v,
            "conv_filters": self.conv_filters,
        }
        if bias is not None:
            t["energy_b"] = bias
        return t

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
        if p["type"] == "window_around_mean":
            expected = (weights * positions[None, :]).sum(dim=1)
        elif p["type"] == "window_around_median":
            # the first frame whose cumulative weight reaches 0.5, minus
            # one (argmax of the switches; 0 without one)
            above_half = (torch.cumsum(weights, dim=1) - 0.5 >= 0).to(
                torch.int32)
            switches = above_half[:, 1:] - above_half[:, :-1]
            if switches.shape[1]:
                expected = torch.argmax(switches, dim=1).to(f32)
            else:
                expected = weights.new_zeros(weights.shape[0])
        else:
            raise ValueError(f"Unknown prior type: {p['type']}")
        begins = torch.floor(expected - p["before"])
        ends = torch.ceil(expected + p["after"])
        begin = torch.floor(begins.min().clamp(min=0))
        end = torch.ceil(ends.max().clamp(max=length))
        window = ((positions >= begin) & (positions < end)).to(f32)
        additional = ((positions[None, :] > begins[:, None])
                      & (positions[None, :] < ends[:, None])).to(f32)
        return window[None, :], additional

    def compute_energies(self, preprocessed, windowed_weights, states,
                         beam=1, train=False):
        """Energies (U*beam, L) of per-hypothesis states over the shared
        per-utterance keys (U, L, M): with one filter through
        ``beam_attention_energies`` (the CUDA kernel on a CUDA tensor),
        with more in plain PyTorch, as the JAX module computes them
        (``attention.py:269-275``).  ``train`` (the teacher-forced module
        scan) computes them in plain differentiable PyTorch, as the JAX
        module does."""
        state_sum = 0.0
        for name in self.state_names:
            state_sum = state_sum + getattr(self, f"state_trans_{name}")(
                states[name])
        n, L = self.conv_n, windowed_weights.shape[1]
        conv = conv1d_full(windowed_weights,
                           self.conv_filters)[:, :, n:n + L]     # (B, F, L)
        if train or self.conv_num_filters > 1:
            conv_proj = self.handler(conv.transpose(1, 2))       # (B, L, M)
            U, L, M = preprocessed.shape
            match = (preprocessed[:, None] + state_sum.view(U, beam, 1, M)
                     + conv_proj.view(U, beam, L, M))
            return self.energy_comp(torch.tanh(match))[..., 0].reshape(
                U * beam, L)
        v, bias = self.energy_vector()
        return beam_attention_energies(
            preprocessed, state_sum.contiguous(), conv[:, 0].contiguous(),
            self.handler.kernel[0], v.contiguous(),
            0.0 if bias is None else float(bias), beam=beam)

    def _normalize(self, energies, global_mask, combined):
        """The configured normalizer (JAX ``_normalize``); softmax's max
        runs over the window only.  A relu row whose numerators are all
        zero over a non-empty mask divides 0 by 0, as in the JAX module."""
        if self.energy_normalizer == "softmax":
            masked = torch.where(global_mask > 0, energies,
                                 torch.finfo(energies.dtype).min)
            m = masked.max(dim=1, keepdim=True).values
            m = torch.where(torch.isfinite(m), m, 0.0)
            unnorm = torch.exp(energies - m)
        elif self.energy_normalizer == "logistic":
            unnorm = torch.sigmoid(energies)
        else:
            unnorm = torch.clamp(energies / 1000.0, min=0.0)
        unnorm = unnorm * combined
        denom = unnorm.sum(dim=1, keepdim=True) + (
            combined == 0).all(dim=1, keepdim=True).to(energies.dtype)
        return unnorm / denom

    def take_glimpses(self, attended, preprocessed, attended_mask, glimpses,
                      states, beam=1, train=False):
        """One glimpse of every hypothesis row: contexts per utterance (U,
        ...), glimpses and states per row (U*beam, ...); ``train`` as in
        :meth:`compute_energies`."""
        weights, step = glimpses["weights"], glimpses["step"]
        U, L, D = attended.shape
        global_mask, additional = self._window(weights, step, L)
        combined = global_mask * attended_mask.repeat_interleave(beam, dim=0)
        if additional is not None:
            combined = combined * additional
        energies = self.compute_energies(preprocessed, weights * global_mask,
                                         states, beam=beam, train=train)
        new_weights = self._normalize(energies, global_mask, combined)
        weighted = torch.bmm(new_weights.view(U, beam, L), attended)
        return {
            "weighted_averages": weighted.view(U * beam, D),
            "weights": new_weights,
            "energies": energies * global_mask,
            "step": step + 1,
        }


def _row_stack(attention):
    kernels = [getattr(attention, f"state_trans_{name}").kernel
               for name in attention.state_names]
    return kernels[0] if len(kernels) == 1 else torch.cat(kernels)


def make_attention(attention_type, state_names, state_dim, attended_dim,
                   match_dim, conv_n=None, conv_num_filters=1, prior=None,
                   energy_normalizer=None):
    """The attention of a net config's ``attention_type`` (JAX
    ``make_attention``); content attention is softmax only, as there."""
    if attention_type == "content":
        return SequenceContentAttention(state_names, state_dim, attended_dim,
                                        match_dim)
    if attention_type == "content_and_conv":
        return SequenceContentAndConvAttention(
            state_names, state_dim, attended_dim, match_dim, conv_n,
            conv_num_filters=conv_num_filters or 1, prior=prior,
            energy_normalizer=energy_normalizer or "softmax")
    raise ValueError(f"Unknown attention type {attention_type}")
