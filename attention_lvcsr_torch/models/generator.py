"""The attention decoder: parameters, decode tables and the decode step.

Counterpart of ``attention_lvcsr_tpu/models/generator.py`` for one GRU
decoder layer: the feedback embedding, the readout (merge of the weighted
averages and optionally the states, tanh post-merge), its shallow-fusion
variant with an FST language model, and the decoder GRU with its fork and
distribute projections.  Two decode routes read it:

* the whole-loop kernel (``ops/beam_loop.py``) takes the dense tables of
  ``loop_decode_tables`` (``:779-847``) and runs the step itself;
* the module-driven decode (``search/beam.py::BeamSearch._search_core``)
  calls ``initial_states``, ``score_step`` (glimpses + per-symbol costs,
  ``:874-897``) and ``advance_states`` (consume the chosen symbols,
  ``:899-910``); with ``fused_score_tables`` in its contexts the score
  step is one ``fused_decode_score`` launch (``:849-872``).

``evaluate`` is the teacher-forced pass of the training cost
(``:380-433``): the whole label loop through ``decoder_scan_train`` (the
CUDA kernels on a CUDA tensor), or, under ``use_pallas: never``, where the
JAX package takes its XLA scan, through the plain module scan.

Parameter names are the flax ones (``feedback/lookup/embedding``,
``transition_0``, ``fork_0_inputs``, ...); the language model holds only
buffers, so it adds no parameter.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch
from torch import nn

from attention_lvcsr_torch.models.cells import GatedRecurrent
from attention_lvcsr_torch.models.layers import Dense, Embed
from attention_lvcsr_torch.ops.decode_score import fused_decode_score
from attention_lvcsr_torch.ops.decoder_train import decoder_scan_train


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

    def forward(self, sources):
        merged = self.merge_bias
        for name in self.source_names:
            merged = merged + getattr(self, f"merge_{name}")(sources[name])
        return self.post_merge_0(torch.tanh(merged))


class ShallowFusionReadout(Readout):
    """AM/LM shallow fusion (``generator.py:142-166``):
    ``am_beta * AM + lm_weight * (-lm_add)``, with optional log-softmax
    normalisation of each term and of the sum.  Same parameters as
    :class:`Readout`."""

    def __init__(self, source_dims, readout_dim, post_merge_dims,
                 lm_weight=0.0, normalize_am_weights=True,
                 normalize_lm_weights=False, normalize_tot_weights=False,
                 am_beta=1.0):
        super().__init__(source_dims, readout_dim, post_merge_dims)
        self.lm_weight = lm_weight
        self.normalize_am_weights = normalize_am_weights
        self.normalize_lm_weights = normalize_lm_weights
        self.normalize_tot_weights = normalize_tot_weights
        self.am_beta = am_beta

    def forward(self, sources):
        sources = dict(sources)
        lm_costs = -sources.pop("lm_add")
        if self.normalize_lm_weights:
            lm_costs = torch.log_softmax(lm_costs, dim=-1)
        am = self.am_beta * super().forward(sources)
        if self.normalize_am_weights:
            am = torch.log_softmax(am, dim=-1)
        x = am + self.lm_weight * lm_costs
        if self.normalize_tot_weights:
            x = torch.log_softmax(x, dim=-1)
        return x


class SoftmaxEmitter:
    """Per-symbol costs of the plain readout: ``-log_softmax``; ``cost``
    picks the cost of the given outputs (the log-likelihood criterion)."""

    @staticmethod
    def costs(readouts):
        return -torch.log_softmax(readouts, dim=-1)

    @staticmethod
    def cost(readouts, outputs):
        logp = torch.log_softmax(readouts, dim=-1)
        return -torch.gather(logp, -1, outputs[..., None])[..., 0]


class LMEmitter:
    """Per-symbol costs of the shallow-fusion readout, which normalises
    itself: ``-readouts``."""

    @staticmethod
    def costs(readouts):
        return -readouts


def _unbiased(dense):
    """(kernel, bias) of a Dense as the JAX tables extract them through
    identity inputs: ``dense(I) - dense(0) = (kernel + bias) - bias``.
    Keeping that rounding makes the two packages' tables bit-identical."""
    return (dense.kernel + dense.bias) - dense.bias, dense.bias


class SequenceGenerator(nn.Module):
    """One GRU decoder layer + attention + readout (``dec_stack`` 1)."""

    def __init__(self, attention, num_outputs: int, dim_dec: int,
                 feedback_dim: int, post_merge_dims: Sequence[int],
                 use_states_for_readout: bool = False,
                 language_model: Optional[nn.Module] = None,
                 fusion: Optional[Mapping] = None):
        """``language_model`` (``models/lm.py``) with ``fusion``, the
        keyword arguments of :class:`ShallowFusionReadout`, selects the
        shallow-fusion readout."""
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
        self.language_model = language_model
        if language_model is None:
            self.readout = Readout(sources, num_outputs, post_merge_dims)
            self.emitter = SoftmaxEmitter
        else:
            self.readout = ShallowFusionReadout(
                sources, num_outputs, post_merge_dims, **dict(fusion or {}))
            self.emitter = LMEmitter

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

    # -- the module-driven decode step -------------------------------------
    def fused_score_supported(self):
        """Whether ``fused_decode_score`` covers this configuration (the
        port's other variants already are the kernel's)."""
        return (not self.use_states_for_readout
                and self.language_model is None)

    def fused_score_tables(self):
        """The tables of ``fused_decode_score``: those of the loop kernel
        it needs, the same values as the JAX ``fused_score_tables`` (the
        filter taps in place of the Toeplitz band)."""
        t = self.loop_decode_tables()
        return {k: t[k] for k in ("state_trans", "handler", "v", "merge_k",
                                  "merge_b", "post_k", "post_b",
                                  "conv_filters")}

    def initial_states(self, batch_size, attended):
        carry = {
            "states": self.transition_0.initial_states(batch_size)
            .contiguous(),
            "glimpses": self.attention.initial_glimpses(batch_size,
                                                        attended),
        }
        if self.language_model is not None:
            carry["lm"] = self.language_model.initial_states(batch_size)
        return carry

    def _compute_states(self, states, feedback, weighted_averages):
        seqs = {seq: getattr(self, f"fork_0_{seq}")(feedback)
                + getattr(self, f"distribute_0_{seq}")(weighted_averages)
                for seq in self.transition_0.sequence_names}
        return self.transition_0.one_step(states, seqs)

    def _readout_sources(self, states, glimpses, lm_state=None):
        sources = {}
        if self.use_states_for_readout:
            sources["states"] = states
        sources["weighted_averages"] = glimpses["weighted_averages"]
        if self.language_model is not None and lm_state is not None:
            sources["lm_add"] = lm_state["add"]
        return sources

    def _fused_score(self, carry, contexts, beam):
        p = self.attention.prior_config()
        g = carry["glimpses"]
        costs, wnew, energies, wa = fused_decode_score(
            contexts["preprocessed"], contexts["attended"],
            contexts["attended_mask"], g["weights"], g["step"],
            carry["states"], contexts["fused_tables"], beam=beam,
            prior=p.get("type", "expanding"),
            before=float(p.get("before", 0.0)),
            after=float(p.get("after", 0.0)),
            initial_begin=float(p.get("initial_begin", 0.0)),
            initial_end=float(p.get("initial_end", 1e4)),
            min_speed=float(p.get("min_speed", 0.0)),
            max_speed=float(p.get("max_speed", 0.0)))
        g_new = {"weighted_averages": wa, "weights": wnew,
                 "energies": energies, "step": g["step"] + 1}
        return g_new, costs

    def score_step(self, carry, contexts, beam=1):
        """Glimpses and per-symbol continuation costs of every hypothesis
        row: contexts per utterance (U, ...), carry rows per hypothesis
        (U*beam, ...).  Returns (glimpses, costs (U*beam, V))."""
        if beam > 1 and "fused_tables" in contexts:
            return self._fused_score(carry, contexts, beam)
        g_new = self.attention.take_glimpses(
            contexts["attended"], contexts["preprocessed"],
            contexts["attended_mask"], carry["glimpses"],
            {"states": carry["states"]}, beam=beam)
        readouts = self.readout(self._readout_sources(
            carry["states"], g_new, carry.get("lm")))
        return g_new, self.emitter.costs(readouts)

    def advance_states(self, carry, g_new, chosen_outputs):
        """Consume the chosen symbols: GRU transition and LM update."""
        states = self._compute_states(
            carry["states"], self.feedback(chosen_outputs),
            g_new["weighted_averages"])
        new_carry = {"states": states, "glimpses": g_new}
        if self.language_model is not None:
            new_carry["lm"] = self.language_model.one_step(carry["lm"],
                                                           chosen_outputs)
        return new_carry

    # -- the teacher-forced pass -------------------------------------------
    def evaluate(self, attended, attended_mask, outputs, mask=None,
                 use_pallas="auto"):
        """Teacher-forced pass over (T, B) fed labels ``outputs`` (mask
        (T, B) or None) against attended (B, L, D) and its mask (B, L).
        Returns ``costs`` (T, B), ``readouts`` (T, B, V), ``weights`` and
        ``energies`` (T, B, L)."""
        if self.language_model is not None:
            raise NotImplementedError(
                "not ported yet: teacher-forced evaluation with an LM")
        T, B = outputs.shape
        preprocessed = self.attention.preprocess(attended)
        feedback = self.feedback(outputs)                       # (T, B, E)
        forked = {seq: getattr(self, f"fork_0_{seq}")(feedback)
                  for seq in self.transition_0.sequence_names}
        # the port's readouts take no feedback source, so the JAX
        # package's rolled feedback has no reader here
        route = (self._evaluate_scan if use_pallas == "never"
                 else self._evaluate_fused)
        pre_states, glimpses = route(attended, preprocessed, attended_mask,
                                     forked, mask, T, B)
        return self._finish_evaluate(pre_states, glimpses, outputs, mask)

    def _evaluate_fused(self, attended, preprocessed, attended_mask, forked,
                        mask, T, B):
        """The label loop as one ``decoder_scan_train`` call, its tables
        taken from the parameters so that autograd reaches them."""
        L = attended.shape[1]
        t = self.attention.train_tables(L)
        cell = self.transition_0
        h0 = cell.initial_states(B).contiguous()
        glimpses = self.attention.initial_glimpses(B, attended)
        h, w, wa, e = decoder_scan_train(
            forked["inputs"].contiguous(),
            forked["gate_inputs"].contiguous(),
            mask.contiguous() if mask is not None else None,
            preprocessed.contiguous(), attended.contiguous(),
            attended_mask.contiguous(), h0, glimpses["weights"],
            glimpses["weighted_averages"], t["toep"], t["st"], t["hand"],
            t["v"], cell.state_to_state, cell.state_to_gates,
            self.distribute_0_inputs.kernel,
            self.distribute_0_gate_inputs.kernel,
            prior=self.attention.prior_config())
        pre_states = torch.cat([h0[None], h[:-1]])
        return pre_states, {"weights": w, "weighted_averages": wa,
                            "energies": e}

    def _evaluate_scan(self, attended, preprocessed, attended_mask, forked,
                       mask, T, B):
        """The label loop step by step through the modules: glimpse, GRU
        transition, and the recurrent mask over states and glimpses."""
        cell = self.transition_0
        states = cell.initial_states(B)
        glimpses = self.attention.initial_glimpses(B, attended)
        pre_states, seq = [], []
        for t in range(T):
            g_new = self.attention.take_glimpses(
                attended, preprocessed, attended_mask, glimpses,
                {"states": states}, train=True)
            seqs = {name: forked[name][t]
                    + getattr(self, f"distribute_0_{name}")(
                        g_new["weighted_averages"])
                    for name in cell.sequence_names}
            new_states = cell.one_step(states, seqs)
            if mask is not None:
                live = mask[t] > 0
                new_states = _mask_mix(live, new_states, states)
                g_new = {k: _mask_mix(live, v, glimpses[k])
                         for k, v in g_new.items()}
            pre_states.append(states)
            seq.append(g_new)
            states, glimpses = new_states, g_new
        return torch.stack(pre_states), {
            k: torch.stack([g[k] for g in seq])
            for k in ("weights", "weighted_averages", "energies")}

    def _finish_evaluate(self, pre_states, glimpses, outputs, mask):
        sources = {"weighted_averages": glimpses["weighted_averages"]}
        if self.use_states_for_readout:
            sources["states"] = pre_states
        readouts = self.readout(sources)                        # (T, B, V)
        costs = self.emitter.cost(readouts, outputs.long())
        if mask is not None:
            costs = costs * mask
        return {"costs": costs, "readouts": readouts,
                "weights": glimpses["weights"],
                "energies": glimpses["energies"]}


def _mask_mix(live, new, old):
    """``new`` where the row is live (a (B,) bool), else ``old``."""
    return torch.where(live.reshape(live.shape + (1,) * (new.dim() - 1)),
                       new, old)
