"""The attention decoder: parameters, decode tables and the decode step.

Counterpart of ``attention_lvcsr_tpu/models/generator.py`` for a stack
of ``dec_stack`` decoder layers of one cell, GRU, LSTM or simple RNN
(``_compute_states`` :350-365: layer l > 0 adds the interlayer
projections of layer l-1's new state): the feedback (the embedding, or
the one-hot ``OneOfNFeedback`` of ``embed_outputs: false``), the
readout (merge of the weighted
averages and optionally the states, then no post-merge layer or one or
more with the tanh, rectifier, sigmoid, identity or maxout activation),
its shallow-fusion
variant with an FST language model, the decoder GRU with its fork and
distribute projections, and the criterion: the log-likelihood, or the
task loss's ``mse_gain`` / ``mse_reward`` (arXiv:1511.06456), whose
readouts regress the edit-distance gains and rewards of
``ops/reward_op.py``.  Two decode routes read it:

* the whole-loop kernel (``ops/beam_loop.py``) takes the dense tables of
  ``loop_decode_tables`` (``:779-847``) and runs the step itself;
* the module-driven decode (``search/beam.py::BeamSearch._search_core``)
  calls ``initial_states``, ``score_step`` (glimpses + per-symbol costs,
  ``:874-897``) and ``advance_states`` (consume the chosen symbols,
  ``:899-910``); with ``fused_score_tables`` in its contexts the score
  step is one ``fused_decode_score`` launch (``:849-872``).

``evaluate`` is the teacher-forced pass of the training cost
(``:380-433``, the mse criteria ``_mse_costs`` :658-686): the whole label
loop through ``decoder_scan_train`` (the
CUDA kernels on a CUDA tensor), or, under ``use_pallas: never`` and above
16 conv filters, where the JAX package takes its XLA scan, through the
plain module scan; with an LM
the readout also reads the LM's teacher-forced costs (``lm.evaluate``).
``generate`` samples (``:912-942``): ``n_steps`` of the module step's
score, the emitter's draw (categorical, or argmax with an LM or a task
loss criterion) and the advance.

The first step's feedback symbol (the emitter's ``initial_output``: 0
for the task loss, ``num_outputs`` otherwise) reaches JAX's readout only
through a ``feedback`` source; the port's readouts read the weighted
averages and optionally the states, so no route here reads it.

Parameter names are the flax ones (``feedback/lookup/embedding``,
``transition_0``, ``fork_0_inputs``, ``interlayer_1_gate_inputs``, ...);
the one-hot feedback and the language model add no parameter.  The
carry's ``states`` are the layers' states lane-stacked, (B, N*S): what
the attention, the readout and the kernels read.  An LSTM decoder's
memory cells ride beside them under ``cells``, lane-stacked the same way.

The kernels of the decoder (the loop kernel, ``decoder_scan_train``) hold
a GRU: as in the JAX package, an LSTM or simple-RNN decoder takes the
module routes (``loop_route``, ``train_kernel_route``), while
``fused_decode_score``, which reads only the states, serves any cell.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch
from torch import nn

from attention_lvcsr_torch.models.cells import GatedRecurrent, make_cell
from attention_lvcsr_torch.models.layers import Dense, Embed
from attention_lvcsr_torch.ops.decode_score import fused_decode_score
from attention_lvcsr_torch.ops.decoder_train import (MAX_FILTERS, MAX_STACK,
                                                      decoder_scan_train)
from attention_lvcsr_torch.ops.expressions import (ACTIVATIONS,
                                                   maxout_pieces,
                                                   post_merge_activation)
from attention_lvcsr_torch.ops.reward_op import reward_and_gain


class LookupFeedback(nn.Module):
    """Embeds integer outputs (one extra row: the initial output)."""

    def __init__(self, num_outputs: int, feedback_dim: int):
        super().__init__()
        self.lookup = Embed(num_outputs, feedback_dim)

    def forward(self, outputs):
        return self.lookup(outputs)


class OneOfNFeedback(nn.Module):
    """One-hot feedback over ``num_outputs`` symbols (the initial output's
    row included), without parameters (JAX ``OneOfNFeedback``,
    ``generator.py:57-64``)."""

    def __init__(self, num_outputs: int):
        super().__init__()
        self.num_outputs = num_outputs

    def forward(self, outputs):
        return torch.nn.functional.one_hot(
            outputs.long(), self.num_outputs).to(torch.float32)


class Readout(nn.Module):
    """Per-source bias-free merge into ``merged_dim``, summed, plus
    ``merge_bias``; then, with ``post_merge_dims`` set, the activation and
    the post-merge layers (``post_merge_0`` ...) to the logits, the
    activation between them; without it the merged vector is the logits
    (``merged_dim`` the readout's width), as JAX ``Readout``."""

    def __init__(self, source_dims: Mapping[str, int], readout_dim: int,
                 post_merge_dims: Optional[Sequence[int]] = None,
                 post_merge_activation: str = "tanh"):
        super().__init__()
        if post_merge_activation not in ACTIVATIONS \
                and not maxout_pieces(post_merge_activation):
            raise ValueError(post_merge_activation)
        self.source_names = tuple(source_dims)
        self.activation = post_merge_activation
        dims = list(post_merge_dims or [])
        self.merged_dim = dims[0] if dims else readout_dim
        for name, dim in source_dims.items():
            self.add_module(f"merge_{name}",
                            Dense(dim, self.merged_dim, use_bias=False))
        self.merge_bias = nn.Parameter(torch.zeros(self.merged_dim))
        pieces = maxout_pieces(post_merge_activation) or 1
        self.num_post_merge = len(dims)
        for i, (d_in, d_out) in enumerate(zip(dims, dims[1:]
                                              + [readout_dim])):
            if d_in % pieces:
                raise ValueError(
                    f"maxout: last dim {d_in} not divisible by {pieces}")
            self.add_module(f"post_merge_{i}", Dense(d_in // pieces, d_out))

    def forward(self, sources):
        merged = self.merge_bias
        for name in self.source_names:
            merged = merged + getattr(self, f"merge_{name}")(sources[name])
        if not self.num_post_merge:
            return merged
        x = post_merge_activation(merged, self.activation)
        for i in range(self.num_post_merge):
            x = getattr(self, f"post_merge_{i}")(x)
            if i < self.num_post_merge - 1:
                x = post_merge_activation(x, self.activation)
        return x


class ShallowFusionReadout(Readout):
    """AM/LM shallow fusion (``generator.py:142-166``):
    ``am_beta * AM + lm_weight * (-lm_add)``, with optional log-softmax
    normalisation of each term and of the sum.  Same parameters as
    :class:`Readout`."""

    def __init__(self, source_dims, readout_dim, post_merge_dims,
                 post_merge_activation="tanh", lm_weight=0.0,
                 normalize_am_weights=True, normalize_lm_weights=False,
                 normalize_tot_weights=False, am_beta=1.0):
        super().__init__(source_dims, readout_dim, post_merge_dims,
                         post_merge_activation)
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
    """The categorical emitter of the plain readout: per-symbol costs
    ``-log_softmax``; ``cost`` picks the cost of the given outputs (the
    log-likelihood criterion); ``emit`` draws from ``softmax(readouts)``
    with an explicit ``torch.Generator``."""

    def __init__(self, initial_output=0):
        self.initial_output = initial_output

    def emit(self, readouts, generator=None):
        probs = torch.softmax(readouts, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    @staticmethod
    def costs(readouts):
        return -torch.log_softmax(readouts, dim=-1)

    @staticmethod
    def cost(readouts, outputs):
        logp = torch.log_softmax(readouts, dim=-1)
        return -torch.gather(logp, -1, outputs[..., None])[..., 0]

    def initial_outputs(self, batch_size, device=None):
        return torch.full((batch_size,), self.initial_output,
                          dtype=torch.long, device=device)


class LMEmitter(SoftmaxEmitter):
    """The emitter of the shallow-fusion readout, which normalises
    itself: costs ``-readouts``, emission by argmax."""

    def emit(self, readouts, generator=None):
        return torch.argmax(readouts, dim=-1)

    @staticmethod
    def costs(readouts):
        return -readouts

    @staticmethod
    def cost(readouts, outputs):
        return -torch.gather(readouts, -1, outputs[..., None])[..., 0]


class RewardRegressionEmitter(SoftmaxEmitter):
    """The emitter of the task loss (JAX ``RewardRegressionEmitter``,
    ``generator.py:214-235``): the readouts are predicted gains, emission
    is their argmax, ``cost`` the readout of the given outputs and
    ``costs`` the negated readouts.  Its initial output is 0."""

    def __init__(self):
        super().__init__(initial_output=0)

    def emit(self, readouts, generator=None):
        return torch.argmax(readouts, dim=-1)

    @staticmethod
    def costs(readouts):
        return -readouts

    @staticmethod
    def cost(readouts, outputs):
        return torch.gather(readouts, -1, outputs[..., None])[..., 0]


def _unbiased(dense):
    """(kernel, bias) of a Dense as the JAX tables extract them through
    identity inputs: ``dense(I) - dense(0) = (kernel + bias) - bias``.
    Keeping that rounding makes the two packages' tables bit-identical."""
    return (dense.kernel + dense.bias) - dense.bias, dense.bias


def state_names(dec_stack):
    """The decoder's state names (JAX ``generator.py:308-311``)."""
    if dec_stack == 1:
        return ("states",)
    return tuple(f"states_{i}" for i in range(dec_stack))


class SequenceGenerator(nn.Module):
    """``dec_stack`` decoder layers + attention + readout."""

    def __init__(self, attention, num_outputs: int, dim_dec: int,
                 feedback_dim: int, post_merge_dims: Optional[Sequence[int]],
                 post_merge_activation: str = "tanh",
                 use_states_for_readout: bool = False,
                 language_model: Optional[nn.Module] = None,
                 fusion: Optional[Mapping] = None,
                 criterion: str = "log_likelihood", min_reward: float = -1.0,
                 dec_stack: int = 1, transition: str = "gru",
                 embed_outputs: bool = True):
        """``language_model`` (``models/lm.py``) with ``fusion``, the
        keyword arguments of :class:`ShallowFusionReadout`, selects the
        shallow-fusion readout.  ``criterion``: ``log_likelihood``,
        ``mse_gain`` or ``mse_reward``; ``min_reward`` clamps the gains of
        the mse criteria from below.  ``transition`` names the decoder's
        cell (``models/cells.py::make_cell``); ``embed_outputs: false``
        feeds the outputs back one-hot, ``num_outputs + 1`` wide, in place
        of the ``feedback_dim`` embedding."""
        super().__init__()
        self.criterion = criterion
        self.min_reward = float(min_reward)
        self.num_outputs = num_outputs
        self.dim_dec = dim_dec
        self.dec_stack = int(dec_stack)
        self.state_names = state_names(self.dec_stack)
        self.use_states_for_readout = use_states_for_readout
        self.attention = attention
        D = attention.attended_dim
        if embed_outputs:
            self.feedback = LookupFeedback(num_outputs + 1, feedback_dim)
        else:
            self.feedback = OneOfNFeedback(num_outputs + 1)
            feedback_dim = num_outputs + 1
        for layer in range(self.dec_stack):
            cell = make_cell(transition, dim_dec)
            self.add_module(f"transition_{layer}", cell)
            for seq, d in cell.sequence_dims().items():
                self.add_module(f"fork_{layer}_{seq}", Dense(feedback_dim, d))
                self.add_module(f"distribute_{layer}_{seq}",
                                Dense(D, d, use_bias=False))
                if layer > 0:
                    self.add_module(f"interlayer_{layer}_{seq}",
                                    Dense(dim_dec, d, use_bias=False))
        sources = ({name: dim_dec for name in self.state_names}
                   if use_states_for_readout else {})
        sources["weighted_averages"] = D
        self.language_model = language_model
        if language_model is None:
            self.readout = Readout(sources, num_outputs, post_merge_dims,
                                   post_merge_activation)
        else:
            self.readout = ShallowFusionReadout(
                sources, num_outputs, post_merge_dims, post_merge_activation,
                **dict(fusion or {}))
        # the emitter choice of JAX's ``emitter`` (:338-343)
        if self.mse:
            self.emitter = RewardRegressionEmitter()
        elif language_model is None:
            self.emitter = SoftmaxEmitter(initial_output=num_outputs)
        else:
            self.emitter = LMEmitter(initial_output=num_outputs)

    @property
    def mse(self):
        """Whether the criterion is one of the task loss's."""
        return self.criterion.startswith("mse")

    @property
    def gru(self):
        """Whether the decoder's cell is the GRU the kernels hold."""
        return isinstance(self._cell(0), GatedRecurrent)

    @property
    def has_cells(self):
        """Whether the decoder's cell carries memory cells (the LSTM)."""
        return self._cell(0).has_cells

    def _cell(self, layer):
        return getattr(self, f"transition_{layer}")

    def _lane_stack(self, name, part=None):
        """A per-layer table ``name.format(layer)`` of every layer,
        lane-stacked layer-major (one layer: the table itself)."""
        parts = [self.get_submodule(name.format(layer)) if part
                 else self.get_parameter(name.format(layer))
                 for layer in range(self.dec_stack)]
        if part is not None:
            parts = [part(x) for x in parts]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)

    def _interlayer(self, seq):
        """(S, (N-1) * width) interlayer kernels of ``seq``, lane-stacked."""
        return torch.cat([getattr(self, f"interlayer_{layer}_{seq}").kernel
                          for layer in range(1, self.dec_stack)], dim=1)

    def _att_states(self, states):
        """The lane-stacked (B, N*S) states keyed by the state names."""
        S = self.dim_dec
        return {name: states[..., i * S:(i + 1) * S]
                for i, name in enumerate(self.state_names)}

    def loop_decode_tables(self):
        """Dense weight tables of the whole-loop decode kernel; the same
        values as the JAX ``loop_decode_tables`` (:779-847) for one
        post-merge layer: the per-layer fork, distribute and GRU tables
        and ``h0`` lane-stacked layer-major, the interlayer kernels
        ``inter_in_w`` (S, (N-1)*S) and ``inter_gate_w`` (S, (N-1)*2S) of
        a stack, ``state_trans`` and ``merge_states_k`` row-stacked over
        the state names (the Toeplitz band of the TPU kernel is replaced
        by the filter taps themselves; a maxout readout's ``post_k`` has
        ``merged_dim / k`` rows)."""
        t = self._score_tables()
        readout = self.readout
        if not self.gru:
            raise NotImplementedError(
                "the loop kernel's tables need a GRU decoder")
        kernel = lambda d: _unbiased(d)[0]
        bias = lambda d: _unbiased(d)[1]
        Vf = self.num_outputs + 1
        t.update({
            # the feedback of every symbol (JAX ``feedback(arange(Vf))``):
            # the one-hot feedback's is the (Vf, Vf) identity
            "embed": (self.feedback.lookup.embedding
                      if isinstance(self.feedback, LookupFeedback)
                      else torch.eye(Vf, device=readout.merge_bias.device)),
            "fork_in_w": self._lane_stack("fork_{}_inputs", kernel),
            "fork_in_b": self._lane_stack("fork_{}_inputs", bias),
            "fork_gate_w": self._lane_stack("fork_{}_gate_inputs", kernel),
            "fork_gate_b": self._lane_stack("fork_{}_gate_inputs", bias),
            "dist_in_w": self._lane_stack("distribute_{}_inputs.kernel"),
            "dist_gate_w": self._lane_stack(
                "distribute_{}_gate_inputs.kernel"),
            "wsg": self._lane_stack("transition_{}.state_to_gates"),
            "wss": self._lane_stack("transition_{}.state_to_state"),
            "h0": self._lane_stack("transition_{}.initial_state"),
        })
        if self.dec_stack > 1:
            t["inter_in_w"] = self._interlayer("inputs")
            t["inter_gate_w"] = self._interlayer("gate_inputs")
        if self.use_states_for_readout:
            t["merge_states_k"] = _row_cat(
                [getattr(readout, f"merge_{name}").kernel
                 for name in self.state_names])
        return {k: v.detach().contiguous() for k, v in t.items()}

    def _score_tables(self):
        """The attention's decode tables and the readout's: what a score
        step reads, for any decoder cell."""
        t = self.attention.loop_tables()
        readout = self.readout
        if readout.num_post_merge != 1:
            raise NotImplementedError(
                "the decode kernels' tables need exactly one post-merge "
                f"layer, not {readout.num_post_merge}")
        post_k, post_b = _unbiased(readout.post_merge_0)
        t.update({"merge_k": readout.merge_weighted_averages.kernel,
                  "merge_b": readout.merge_bias,
                  "post_k": post_k, "post_b": post_b})
        return t

    # -- the module-driven decode step -------------------------------------
    def fused_score_supported(self):
        """Whether ``fused_decode_score`` covers this configuration, as JAX
        ``fused_score_supported`` (:689-705): conv attention with one
        filter and the softmax normalizer, a readout of the weighted
        averages alone through exactly one post-merge layer after tanh,
        one decoder layer and no language model."""
        att, readout = self.attention, self.readout
        return (att.conv and att.conv_num_filters == 1
                and att.energy_normalizer == "softmax"
                and not self.use_states_for_readout
                and self.language_model is None
                and self.dec_stack == 1
                and readout.num_post_merge == 1
                and readout.activation == "tanh")

    def fused_score_tables(self):
        """The tables of ``fused_decode_score``: those of the loop kernel
        it needs, the same values as the JAX ``fused_score_tables`` (the
        filter taps in place of the Toeplitz band); the decoder's cell
        does not enter them."""
        t = self._score_tables()
        return {k: t[k].detach().contiguous()
                for k in ("state_trans", "handler", "v", "merge_k",
                          "merge_b", "post_k", "post_b", "conv_filters")}

    def _initial_states(self, batch_size, part=0):
        """(B, N*S) initial states (``part`` 0) or, of an LSTM, initial
        cells (1), lane-stacked."""
        inits = [self._cell(layer).initial_states(batch_size)
                 for layer in range(self.dec_stack)]
        if self.has_cells:
            inits = [pair[part] for pair in inits]
        return torch.cat(inits, dim=1).contiguous()

    def initial_states(self, batch_size, attended):
        carry = {
            "states": self._initial_states(batch_size),
            "glimpses": self.attention.initial_glimpses(batch_size,
                                                        attended),
        }
        if self.has_cells:
            carry["cells"] = self._initial_states(batch_size, 1)
        if self.language_model is not None:
            carry["lm"] = self.language_model.initial_states(batch_size)
        return carry

    def _compute_states(self, states, forked, weighted_averages,
                        cells=None):
        """One transition of the stack (JAX ``_compute_states``): layer l
        adds to its fork and distribute projections the interlayer
        projections of layer l-1's new state; ``forked`` is the fork
        projections of every layer, ``{(layer, seq): (B, width)}``.
        Returns the new lane-stacked states and, of an LSTM (``cells``
        its lane-stacked cells), the new cells, else None."""
        S = self.dim_dec
        lanes = lambda x, layer: x[..., layer * S:(layer + 1) * S]
        new, new_cells, below = [], [], None
        for layer in range(self.dec_stack):
            cell = self._cell(layer)
            seqs = {}
            for seq in cell.sequence_names:
                val = forked[layer, seq] + getattr(
                    self, f"distribute_{layer}_{seq}")(weighted_averages)
                if layer > 0:
                    val = val + getattr(
                        self, f"interlayer_{layer}_{seq}")(below)
                seqs[seq] = val
            if self.has_cells:
                below, c = cell.one_step(
                    (lanes(states, layer), lanes(cells, layer)), seqs)
                new_cells.append(c)
            else:
                below = cell.one_step(lanes(states, layer), seqs)
            new.append(below)
        cat = lambda xs: xs[0] if len(xs) == 1 else torch.cat(xs, dim=-1)
        return cat(new), cat(new_cells) if new_cells else None

    def _fork(self, feedback):
        """The fork projections of every layer, ``{(layer, seq): ...}``."""
        return {(layer, seq): getattr(self, f"fork_{layer}_{seq}")(feedback)
                for layer in range(self.dec_stack)
                for seq in self._cell(layer).sequence_names}

    def _readout_sources(self, states, glimpses, lm_state=None):
        sources = {}
        if self.use_states_for_readout:
            sources.update(self._att_states(states))
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

    def _glimpse_and_readouts(self, carry, contexts, beam):
        """The module step's glimpses and readouts (U*beam, V)."""
        g_new = self.attention.take_glimpses(
            contexts["attended"], contexts["preprocessed"],
            contexts["attended_mask"], carry["glimpses"],
            self._att_states(carry["states"]), beam=beam)
        readouts = self.readout(self._readout_sources(
            carry["states"], g_new, carry.get("lm")))
        return g_new, readouts

    def score_step(self, carry, contexts, beam=1):
        """Glimpses and per-symbol continuation costs of every hypothesis
        row: contexts per utterance (U, ...), carry rows per hypothesis
        (U*beam, ...).  Returns (glimpses, costs (U*beam, V))."""
        if beam > 1 and "fused_tables" in contexts:
            return self._fused_score(carry, contexts, beam)
        g_new, readouts = self._glimpse_and_readouts(carry, contexts, beam)
        return g_new, self.emitter.costs(readouts)

    def advance_states(self, carry, g_new, chosen_outputs):
        """Consume the chosen symbols: the decoder's transition (its cells
        too) and the LM update."""
        states, cells = self._compute_states(
            carry["states"], self._fork(self.feedback(chosen_outputs)),
            g_new["weighted_averages"], carry.get("cells"))
        new_carry = {"states": states, "glimpses": g_new}
        if cells is not None:
            new_carry["cells"] = cells
        if self.language_model is not None:
            new_carry["lm"] = self.language_model.one_step(carry["lm"],
                                                           chosen_outputs)
        return new_carry

    # -- sampling -----------------------------------------------------------
    def generate_step(self, carry, contexts, generator=None):
        """Score, emit and advance one step of every row (JAX
        ``generate_step``): returns the new carry and the step's
        ``outputs``, ``costs``, ``weights`` and ``readouts``."""
        g_new, readouts = self._glimpse_and_readouts(carry, contexts, 1)
        outputs = self.emitter.emit(readouts, generator)
        costs = self.emitter.cost(readouts, outputs)
        carry = self.advance_states(carry, g_new, outputs)
        return carry, {"outputs": outputs, "costs": costs,
                       "weights": g_new["weights"], "readouts": readouts}

    def generate(self, attended, attended_mask, n_steps, generator=None):
        """``n_steps`` of :meth:`generate_step` from the initial states
        over attended (B, L, D): each of ``outputs``, ``costs``,
        ``weights`` and ``readouts`` stacked time-major (n_steps, B, ...).
        No row stops at EOS, as in the JAX package."""
        B = attended.shape[0]
        contexts = {"attended": attended,
                    "preprocessed": self.attention.preprocess(attended),
                    "attended_mask": attended_mask}
        carry = self.initial_states(B, attended)
        steps = []
        for _ in range(n_steps):
            carry, out = self.generate_step(carry, contexts, generator)
            steps.append(out)
        return {k: torch.stack([out[k] for out in steps])
                for k in ("outputs", "costs", "weights", "readouts")}

    # -- the teacher-forced pass -------------------------------------------
    def evaluate(self, attended, attended_mask, outputs, mask=None,
                 use_pallas="auto", groundtruth=None):
        """Teacher-forced pass over (T, B) fed labels ``outputs`` (mask
        (T, B) or None) against attended (B, L, D) and its mask (B, L).
        Returns ``costs`` (T, B), ``readouts`` (T, B, V), ``weights`` and
        ``energies`` (T, B, L; None for content attention, whose glimpses
        have none); under an mse criterion also ``gain_mse_loss``,
        ``reward_mse_loss``, ``gain_matrix`` and ``reward_matrix``, the
        targets computed against ``groundtruth`` (T', B) (``outputs``
        when None)."""
        T, B = outputs.shape
        preprocessed = self.attention.preprocess(attended)
        feedback = self.feedback(outputs)                       # (T, B, E)
        forked = self._fork(feedback)
        # the port's readouts take no feedback source, so the JAX
        # package's rolled feedback has no reader here
        route = (self._evaluate_fused if self.train_kernel_route(use_pallas)
                 else self._evaluate_scan)
        pre_states, glimpses = route(attended, preprocessed, attended_mask,
                                     forked, mask, T, B)
        lm_add = None
        if self.language_model is not None:
            # the LM changes only the readout's sources
            lm_add = self.language_model.evaluate(outputs, mask)["add"]
        return self._finish_evaluate(pre_states, glimpses, outputs, mask,
                                     lm_add, groundtruth)

    def train_kernel_route(self, use_pallas="auto"):
        """Whether ``evaluate`` takes ``decoder_scan_train`` (else the
        module scan), as JAX's ``_fused_train_mode`` (:435-482) decides
        without shapes: the module scan under ``use_pallas: never``, for a
        decoder cell other than the GRU, above the kernels' filters and
        above their four layers."""
        att = self.attention
        return not (use_pallas == "never" or not self.gru
                    or (att.conv and att.conv_num_filters > MAX_FILTERS)
                    or self.dec_stack > MAX_STACK)

    def _evaluate_fused(self, attended, preprocessed, attended_mask, forked,
                        mask, T, B):
        """The label loop as one ``decoder_scan_train`` call, its tables
        taken from the parameters so that autograd reaches them."""
        L = attended.shape[1]
        t = self.attention.train_tables(L)
        N = self.dec_stack
        h0 = self._initial_states(B)
        glimpses = self.attention.initial_glimpses(B, attended)
        # content attention: no conv term, and a window over all L frames
        conv = self.attention.conv
        normalizer = self.attention.energy_normalizer if conv else "softmax"
        lanes = lambda seq: torch.cat([forked[layer, seq]
                                       for layer in range(N)], dim=-1)
        h, w, wa, e = decoder_scan_train(
            lanes("inputs").contiguous(), lanes("gate_inputs").contiguous(),
            mask.contiguous() if mask is not None else None,
            preprocessed.contiguous(), attended.contiguous(),
            attended_mask.contiguous(), h0, glimpses["weights"],
            glimpses["weighted_averages"], t["toep"], t["st"], t["hand"],
            t["v"], self._lane_stack("transition_{}.state_to_state"),
            self._lane_stack("transition_{}.state_to_gates"),
            self._lane_stack("distribute_{}_inputs.kernel"),
            self._lane_stack("distribute_{}_gate_inputs.kernel"),
            prior=self.attention.prior_config(L),
            n_filters=self.attention.conv_num_filters if conv else 0,
            e_bias=t.get("e_b"), normalizer=normalizer, dec_stack=N,
            inter_in=self._interlayer("inputs") if N > 1 else None,
            inter_gate=self._interlayer("gate_inputs") if N > 1 else None)
        pre_states = torch.cat([h0[None], h[:-1]])
        glimpses = {"weights": w, "weighted_averages": wa}
        if conv:
            glimpses["energies"] = e
        return pre_states, glimpses

    def _evaluate_scan(self, attended, preprocessed, attended_mask, forked,
                       mask, T, B):
        """The label loop step by step through the modules: glimpse, the
        stack's transition, and the recurrent mask over states and
        glimpses."""
        states = self._initial_states(B)
        cells = self._initial_states(B, 1) if self.has_cells else None
        glimpses = self.attention.initial_glimpses(B, attended)
        pre_states, seq = [], []
        for t in range(T):
            g_new = self.attention.take_glimpses(
                attended, preprocessed, attended_mask, glimpses,
                self._att_states(states), train=True)
            new_states, new_cells = self._compute_states(
                states, {k: v[t] for k, v in forked.items()},
                g_new["weighted_averages"], cells)
            if mask is not None:
                live = mask[t] > 0
                new_states = _mask_mix(live, new_states, states)
                if cells is not None:
                    new_cells = _mask_mix(live, new_cells, cells)
                g_new = {k: _mask_mix(live, v, glimpses[k])
                         for k, v in g_new.items()}
            pre_states.append(states)
            seq.append(g_new)
            states, cells, glimpses = new_states, new_cells, g_new
        return torch.stack(pre_states), {
            k: torch.stack([g[k] for g in seq])
            for k in ("weights", "weighted_averages", "energies")
            if k in seq[0]}

    def _finish_evaluate(self, pre_states, glimpses, outputs, mask, lm_add,
                         groundtruth=None):
        sources = {"weighted_averages": glimpses["weighted_averages"]}
        if self.use_states_for_readout:
            sources.update(self._att_states(pre_states))
        if lm_add is not None:
            sources["lm_add"] = lm_add
        readouts = self.readout(sources)                        # (T, B, V)
        aux = {}
        if self.mse:
            costs, aux = self._mse_costs(readouts, outputs.long(), groundtruth)
        else:
            costs = self.emitter.cost(readouts, outputs.long())
        if mask is not None:
            costs = costs * mask
        return dict({"costs": costs, "readouts": readouts,
                     "weights": glimpses["weights"],
                     "energies": glimpses.get("energies")}, **aux)

    def _mse_costs(self, readouts, outputs, groundtruth):
        """The task loss's criteria (JAX ``_mse_costs``, the reference's
        ``lvsr/bricks/__init__.py:134-182``): the readouts regress the
        gains of the fed outputs against the groundtruth, clamped below at
        ``min_reward`` (``mse_gain``), or the rewards they add up to
        (``mse_reward``).  Returns the (T, B) costs and the aux outputs."""
        if groundtruth is None:
            groundtruth = outputs
        rewards, gains = reward_and_gain(groundtruth, outputs,
                                         self.num_outputs)
        gains = torch.clamp(gains.to(readouts.dtype), min=self.min_reward)
        rewards = rewards.to(readouts.dtype)
        predicted = torch.gather(readouts, -1, outputs[..., None])[..., 0]
        predicted = torch.cat([torch.zeros_like(predicted[:1]),
                               predicted[1:]])
        predicted_rewards = readouts + torch.cumsum(predicted,
                                                    dim=0)[..., None]
        gain_mse = ((readouts - gains) ** 2).sum(dim=-1)
        reward_mse = ((predicted_rewards - rewards) ** 2).sum(dim=-1)
        aux = {"gain_mse_loss": gain_mse.sum(),
               "reward_mse_loss": reward_mse.sum(),
               "gain_matrix": gains, "reward_matrix": rewards}
        return (gain_mse if self.criterion == "mse_gain" else reward_mse), aux


def _row_cat(tables):
    return tables[0] if len(tables) == 1 else torch.cat(tables)


def _mask_mix(live, new, old):
    """``new`` where the row is live (a (B,) bool), else ``old``."""
    return torch.where(live.reshape(live.shape + (1,) * (new.dim() - 1)),
                       new, old)
