"""The attention decoder's parameters and the whole-loop decode tables.

Counterpart of ``attention_lvcsr_tpu/models/generator.py`` as far as
``loop_decode_tables`` (``:779-847``) and ``fused_score_tables``
(``:707-777``) read it: the feedback embedding, the readout (merge of the
weighted averages and optionally the states, tanh post-merge), the
decoder GRU with its fork and distribute projections.  The step itself
runs inside ``ops/beam_loop.py``.  Parameter names are the flax ones
(``feedback/lookup/embedding``, ``transition_0``, ``fork_0_inputs``, ...).
"""
from __future__ import annotations

from typing import Mapping, Sequence

import torch
from torch import nn

from attention_lvcsr_torch.models.cells import GatedRecurrent
from attention_lvcsr_torch.models.layers import Dense, Embed


class LookupFeedback(nn.Module):
    """Embeds integer outputs (one extra row: the initial output)."""

    def __init__(self, num_outputs: int, feedback_dim: int):
        super().__init__()
        self.lookup = Embed(num_outputs, feedback_dim)

    def forward(self, outputs):
        return self.lookup(outputs)


class Readout(nn.Module):
    """Per-source bias-free merge into ``merged_dim``, summed, plus
    ``merge_bias``; then tanh and one post-merge layer to the logits."""

    def __init__(self, source_dims: Mapping[str, int], readout_dim: int,
                 post_merge_dims: Sequence[int]):
        super().__init__()
        self.source_names = tuple(source_dims)
        self.merged_dim = post_merge_dims[0]
        for name, dim in source_dims.items():
            self.add_module(f"merge_{name}",
                            Dense(dim, self.merged_dim, use_bias=False))
        self.merge_bias = nn.Parameter(torch.zeros(self.merged_dim))
        self.post_merge_0 = Dense(self.merged_dim, readout_dim)


def _unbiased(dense):
    """(kernel, bias) of a Dense as the JAX tables extract them through
    identity inputs: ``dense(I) - dense(0) = (kernel + bias) - bias``.
    Keeping that rounding makes the two packages' tables bit-identical."""
    return (dense.kernel + dense.bias) - dense.bias, dense.bias


class SequenceGenerator(nn.Module):
    """One GRU decoder layer + attention + readout (``dec_stack`` 1)."""

    def __init__(self, attention, num_outputs: int, dim_dec: int,
                 feedback_dim: int, post_merge_dims: Sequence[int],
                 use_states_for_readout: bool = False):
        super().__init__()
        self.num_outputs = num_outputs
        self.dim_dec = dim_dec
        self.use_states_for_readout = use_states_for_readout
        self.attention = attention
        D = attention.attended_dim
        self.feedback = LookupFeedback(num_outputs + 1, feedback_dim)
        self.transition_0 = GatedRecurrent(dim_dec)
        for seq, d in self.transition_0.sequence_dims().items():
            self.add_module(f"fork_0_{seq}", Dense(feedback_dim, d))
            self.add_module(f"distribute_0_{seq}",
                            Dense(D, d, use_bias=False))
        sources = {"states": dim_dec} if use_states_for_readout else {}
        sources["weighted_averages"] = D
        self.readout = Readout(sources, num_outputs, post_merge_dims)

    def loop_decode_tables(self):
        """Dense weight tables of the whole-loop decode kernel; the same
        values as the JAX ``loop_decode_tables`` for one decoder layer
        (the Toeplitz band of the TPU kernel is replaced by the filter
        taps themselves)."""
        t = self.attention.loop_tables()
        readout = self.readout
        post_k, post_b = _unbiased(readout.post_merge_0)
        fin_w, fin_b = _unbiased(self.fork_0_inputs)
        fgate_w, fgate_b = _unbiased(self.fork_0_gate_inputs)
        cell = self.transition_0
        t.update({
            "merge_k": readout.merge_weighted_averages.kernel,
            "merge_b": readout.merge_bias,
            "post_k": post_k,
            "post_b": post_b,
            "embed": self.feedback.lookup.embedding,
            "fork_in_w": fin_w,
            "fork_in_b": fin_b,
            "fork_gate_w": fgate_w,
            "fork_gate_b": fgate_b,
            "dist_in_w": self.distribute_0_inputs.kernel,
            "dist_gate_w": self.distribute_0_gate_inputs.kernel,
            "wsg": cell.state_to_gates,
            "wss": cell.state_to_state,
            "h0": cell.initial_state,
        })
        if self.use_states_for_readout:
            t["merge_states_k"] = readout.merge_states.kernel
        return {k: v.detach().contiguous() for k, v in t.items()}
