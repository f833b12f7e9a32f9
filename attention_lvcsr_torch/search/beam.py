"""Batched beam search: the whole-loop decode kernel or the module-driven
decode.

Counterpart of ``attention_lvcsr_tpu/search/beam.py``.  ``search`` routes
as the JAX package does on its accelerator:

* no language model, no constraint, no validator, ``use_pallas`` not
  ``"never"``, and a decode the loop kernel holds (:func:`loop_route`,
  decided from the config and the shapes before anything runs, as JAX's
  ``_loop_kernel_mode``): encoder + one ``beam_search_loop`` launch per
  batch (``_search_loop``, the JAX ``_search_loop_kernel``);
* otherwise the module-driven decode ``_search_core``: a PyTorch loop on
  the model's device whose step is the recognizer's ``decode_score`` (the
  attention energies through ``beam_attention_energies``, or the whole
  score step through ``fused_decode_score`` under ``use_pallas:
  fused``), candidate selection, and ``decode_advance`` (the GRU stack
  and the LM); the carry's lane-stacked states of every layer are
  reordered by the chosen source rows with the rest of the carry.

Both return the same arrays (``done_out``, ``done_cost``,
``done_adjusted``, ``done_len``, ``done_valid``, ``steps``) with the JAX
package's semantics: char_discount, round_to_inf, ignore_first_eol,
patience and optimistic_future_cost stopping, EOS retirement, and ties
to the lowest flat index (stable sorts, never ``torch.topk``).  As in the
JAX ``_search_core``, its ``done_out`` is (U, K, T_frames), ``steps`` is
one number for the batch, and stopped utterances are not frozen: their
retired beams can add nothing to the done set.

``validate_solution_function`` is the reference's dictionary-constrained
decoding hook, taken two ways:

* a :class:`DecodeConstraint` (dense deterministic acceptor over the
  output alphabet) masks forbidden symbols out of each expansion and
  allows EOS only from accepting states;
* a Python callable ``fn(utterance_inputs, symbols) -> bool`` runs at
  insertion time on each finishing candidate (``symbols`` ends with the
  EOL, no BOS); a rejected one never enters the done set.

Not ported yet, and raising ``NotImplementedError``: the bf16
``compute_dtype`` and the model variants listed in
``models/recognizer.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from attention_lvcsr_torch.ops.beam_loop import INF as LOOP_INF
from attention_lvcsr_torch.ops.beam_loop import (beam_search_loop,
                                                 unported_loop)

INF = 1e9
PATIENCE = 30
NOT_STATE = -1
MAX_LOOP_BEAM = 512     # JAX BeamSearch.MAX_LOOP_BEAM
LOOP_VMEM_BUDGET = 64 << 20     # JAX BeamSearch.LOOP_VMEM_BUDGET


def loop_bytes(beam, attended_len, n_filters):
    """JAX ``BeamSearch._loop_bytes``'s (fixed, per-utterance base) bytes
    of its loop kernel's VMEM budget, its arithmetic copied: the (1 +
    filters) L x L tables, and an utterance's alignment-sized rows (K x L
    x (8 + filters)) and K x K permutations."""
    K, L = beam, attended_len
    fixed = (1 + n_filters) * L * L * 4
    per_utt_base = K * L * 4 * (8 + n_filters) + K * K * 4 * 3
    return fixed, per_utt_base


def loop_route(net_config, beam, num_frames):
    """Whether a decode without constraint or validator takes the
    whole-loop kernel: a pure function of the recognizer's net config
    (``RecognizerNet``'s keyword arguments), the beam and the input
    frames, JAX's ``_loop_kernel_mode`` (``search/beam.py:283-344``) rule
    for its decode of ``num_frames``: no LM, not ``use_pallas: never``,
    at most ``MAX_LOOP_BEAM``, a GRU decoder, exactly one post-merge
    layer, a configuration the kernel covers (``ops/beam_loop.py::
    unported_loop``: up to 16 filters and four decoder layers, a known
    activation, the task loss's costs without the WSJ variants or a
    stack, a stack under softmax), and one utterance's ``loop_bytes``
    within 1.5 times JAX's ``LOOP_VMEM_BUDGET``.  Every decode it passes
    runs on the card: its resident instance where an utterance fits a
    block's shared memory, else its workspace instance
    (``ops/beam_loop.py::route``)."""
    c = dict(net_config)
    if (c.get("lm") or {}).get("path") or c.get("use_pallas") == "never" \
            or beam > MAX_LOOP_BEAM \
            or len(c.get("post_merge_dims") or ()) != 1 \
            or str(c.get("dec_transition") or "gru").rsplit(".", 1)[-1] \
            not in ("gru", "GatedRecurrent"):
        return False
    content = c.get("attention_type", "content") == "content"
    prior = dict(c.get("prior") or {}).get("type", "expanding")
    normalizer = c.get("energy_normalizer") or "softmax"
    act = c.get("post_merge_activation") or "tanh"
    mse = dict(c.get("criterion") or {}).get(
        "name", "log_likelihood").startswith("mse")
    if unported_loop("expanding" if content else prior,
                     0 if content else c.get("conv_num_filters") or 1,
                     "softmax" if content else normalizer, content, act,
                     mse, c.get("dec_stack") or 1):
        return False
    subsample = int(np.prod([int(s) for s in c.get("subsample") or []]))
    attended_len = -(-int(num_frames) // max(subsample, 1))
    fixed, per_utt_base = loop_bytes(
        beam, attended_len, int(c.get("conv_num_filters") or 1))
    return fixed + per_utt_base <= 1.5 * LOOP_VMEM_BUDGET


class CandidateNotFoundError(Exception):
    """No finished hypothesis was produced (blocks/search.py:15)."""


@dataclasses.dataclass(frozen=True)
class DecodeConstraint:
    """Dense deterministic acceptor over the network's output alphabet.

    ``trans[s, v]`` is the successor of state ``s`` on symbol ``v`` (or
    ``NOT_STATE`` when ``v`` is not allowed); state 0 is the start;
    ``final[s]`` marks states where the hypothesis may end (emit EOS).
    """
    trans: np.ndarray   # (S, V) int32
    final: np.ndarray   # (S,) bool

    @classmethod
    def from_fst(cls, fst, num_symbols: int,
                 remap: Optional[dict] = None) -> "DecodeConstraint":
        """Densify an ``ops.fst.Fst`` acceptor, which must be
        input-deterministic and epsilon-free with start state 0; ``remap``
        maps network symbol ids to FST input labels (identity default)."""
        from attention_lvcsr_torch.ops.fst import EPSILON
        if fst.start != 0:
            raise ValueError("constraint FST start state must be 0")
        trans = np.full((fst.num_states, num_symbols), NOT_STATE, np.int32)
        for s in fst.arcs:
            seen = {}
            for a in fst.state_arcs(s):
                if a.ilabel == EPSILON:
                    raise ValueError(
                        "constraint FST has epsilon arcs; rm_epsilon first")
                if a.ilabel in seen and seen[a.ilabel] != a.nextstate:
                    raise ValueError(
                        f"constraint FST nondeterministic at state {s} "
                        f"label {a.ilabel}; determinize first")
                seen[a.ilabel] = a.nextstate
            for v in range(num_symbols):
                lab = remap.get(v) if remap is not None else v
                if lab in seen:
                    trans[s, v] = seen[lab]
        final = np.zeros((fst.num_states,), bool)
        for s in fst.finals:
            final[s] = True
        return cls(trans=trans, final=final)

    @classmethod
    def from_words(cls, words, char_map: dict, num_symbols: int,
                   spc: str = "<spc>") -> "DecodeConstraint":
        """Dictionary constraint: hypotheses must be ``<spc>``-separated
        sequences of the given words (``dict_char_lm_fst`` trie)."""
        from attention_lvcsr_torch.ops.fst import dict_char_lm_fst
        # labels shifted by one: network id 0 is the FST's epsilon label
        shifted = {ch: code + 1 for ch, code in char_map.items()}
        fst = dict_char_lm_fst(words, shifted, spc=spc)
        remap = {code: code + 1 for code in char_map.values()}
        return cls.from_fst(fst, num_symbols, remap=remap)


def _smallest(x, k):
    """The k smallest entries of each row, ties to the lowest index (the
    order of ``lax.top_k`` on the negated values)."""
    order = torch.sort(x, dim=1, stable=True).indices[:, :k]
    return x.gather(1, order), order


def _gather_rows(tree, idx):
    """Rows ``idx`` of every tensor in a nest of dicts."""
    if isinstance(tree, dict):
        return {k: _gather_rows(v, idx) for k, v in tree.items()}
    return tree[idx]


_CARRIED_GLIMPSES = ("weights", "step", "weighted_averages")


class BeamSearch:
    def __init__(self, recognizer, beam_size: int, compute_dtype=None):
        self.recognizer = recognizer
        self.net = recognizer.net
        self.beam_size = beam_size
        self.compute_dtype = compute_dtype
        self._tables = None          # (parameter token, tables)

    def _loop_tables(self):
        """Decode tables, rebuilt when any parameter was replaced or
        written in place (storage pointer and version counter)."""
        token = tuple((p.data_ptr(), p._version)
                      for p in self.net.parameters())
        if self._tables is None or self._tables[0] != token:
            self._tables = (token, self.net.decode_loop_tables())
        return self._tables[1]

    @torch.inference_mode()
    def search(self, inputs, inputs_mask, eol_symbol, max_length,
               ignore_first_eol=False, as_arrays=False, char_discount=0.0,
               round_to_inf=1e9, stop_on="patience",
               validate_solution_function=None):
        constraint = post_filter = None
        if isinstance(validate_solution_function, DecodeConstraint):
            constraint = validate_solution_function
        elif callable(validate_solution_function):
            post_filter = validate_solution_function
        elif validate_solution_function is not None:
            raise TypeError(
                "validate_solution_function must be a DecodeConstraint, "
                "a callable, or None")
        if self.compute_dtype is not None:
            raise NotImplementedError(
                f"compute_dtype {self.compute_dtype!r}: only float32 "
                "decoding is ported")
        device = self.recognizer.device
        inputs = torch.as_tensor(inputs, dtype=torch.float32, device=device)
        inputs_mask = torch.as_tensor(inputs_mask, dtype=torch.float32,
                                      device=device)
        kw = dict(eol=int(eol_symbol), stop_on=stop_on,
                  ignore_first_eol=bool(ignore_first_eol),
                  char_discount=float(char_discount),
                  round_to_inf=float(round_to_inf))
        if (constraint is None and post_filter is None
                and loop_route(self.recognizer.net_config, self.beam_size,
                               inputs.shape[1])):
            out = self._search_loop(inputs, inputs_mask,
                                    max_len=max(1, int(max_length)), **kw)
        else:
            out = self._search_core(inputs, inputs_mask, int(max_length),
                                    constraint=constraint,
                                    host_filter=post_filter, **kw)
        if as_arrays:
            return out
        return self._to_lists(out)

    @staticmethod
    def _to_lists(out):
        """Best-first outputs/costs for the first utterance (the reference
        API decodes one utterance at a time)."""
        valid = out["done_valid"][0]
        if not valid.any():
            raise CandidateNotFoundError()
        order = [i for i in np.argsort(out["done_adjusted"][0]) if valid[i]]
        outputs = [list(out["done_out"][0, i, :out["done_len"][0, i]])
                   for i in order]
        costs = [float(out["done_cost"][0, i]) for i in order]
        return outputs, costs

    def _search_loop(self, inputs, inputs_mask, *, max_len, eol, stop_on,
                     ignore_first_eol, char_discount, round_to_inf):
        """Encoder + the whole-loop decode kernel."""
        data = self.net.decode_loop(inputs, inputs_mask)
        attention = self.net.generator.attention
        # the conv attention's prior ignores the length; content
        # attention's window expands over every frame and one more (JAX
        # search/beam.py:411-414)
        prior = attention.prior_config(data["attended"].shape[1] + 1)
        done_out, done_meta, steps = beam_search_loop(
            data["pre"], data["attended"], data["attended_mask"],
            self._loop_tables(), beam=self.beam_size, max_len=max_len,
            eol=eol, stop_on=stop_on, ignore_first_eol=ignore_first_eol,
            char_discount=char_discount, round_to_inf=round_to_inf,
            prior=prior.get("type", "expanding"),
            before=float(prior.get("before", 0.0)),
            after=float(prior.get("after", 0.0)),
            initial_begin=float(prior.get("initial_begin", 0.0)),
            initial_end=float(prior.get("initial_end", 1e4)),
            min_speed=float(prior.get("min_speed", 0.0)),
            max_speed=float(prior.get("max_speed", 0.0)),
            content_attention=not attention.conv,
            normalizer=(attention.energy_normalizer if attention.conv
                        else "softmax"),
            mse_cost=self.net.generator.mse,
            post_act=self.net.generator.readout.activation)
        meta = done_meta.cpu().numpy()
        return {
            "done_out": done_out.cpu().numpy(),
            "done_cost": meta[:, :, 0],
            "done_adjusted": meta[:, :, 1],
            "done_len": meta[:, :, 2].astype(np.int32),
            "done_valid": meta[:, :, 1] < LOOP_INF / 2,
            "steps": steps.max().cpu().numpy(),
        }

    def _search_core(self, inputs, inputs_mask, max_length, *, eol, stop_on,
                     ignore_first_eol, char_discount, round_to_inf,
                     constraint=None, host_filter=None):
        """The module-driven decode, step by step on the model's device
        (``attention_lvcsr_tpu/search/beam.py::BeamSearch._search_core``)."""
        net, K = self.net, self.beam_size
        dev = inputs.device
        f32 = torch.float32
        U, L = inputs.shape[:2]          # L: output buffer bound (frames)
        V = self.recognizer.num_phonemes
        cd = torch.tensor(char_discount, dtype=f32, device=dev)
        max_len_f = torch.tensor(float(max_length), dtype=f32, device=dev)
        slots = torch.arange(K, device=dev)
        first = torch.arange(U, device=dev)[:, None] * K

        contexts = net.decode_contexts(inputs, inputs_mask)
        carry = net.decode_init(U * K, contexts)

        # fully masked rows are batch padding: they start retired
        row_dead = (inputs_mask.sum(dim=1) == 0)[:, None]
        alive_costs = torch.where(row_dead | (slots[None, :] != 0),
                                  INF, 0.0).to(f32)
        alive_out = torch.zeros(U, K, L, dtype=torch.int32, device=dev)
        done_out = torch.zeros(U, K, L, dtype=torch.int32, device=dev)
        done_meta = torch.tensor([INF, INF, 0.0], dtype=f32,
                                 device=dev).repeat(U, K, 1)
        patience = torch.full((U,), PATIENCE, dtype=torch.int32, device=dev)
        min_cost = torch.full((U,), 1000.0, device=dev)
        stopped = torch.zeros(U, dtype=torch.bool, device=dev)
        if constraint is not None:
            ctrans = torch.as_tensor(constraint.trans, device=dev).long()
            cfinal = torch.as_tensor(constraint.final, device=dev)
            cstate = torch.zeros(U, K, dtype=torch.long, device=dev)
            is_eol = torch.arange(V, device=dev) == eol

        i = 0
        while i < max_length and not bool(
                (stopped | (alive_costs >= INF).all(dim=1)).all()):
            done_adjusted = done_meta[:, :, 1]
            done_valid = done_adjusted < INF / 2
            # ---- stopping bookkeeping (reference search.py:306-332) -----
            has_done = done_valid.any(dim=1)
            best_adj = done_adjusted.min(dim=1).values
            if stop_on == "patience":
                improved = best_adj < min_cost
                new_min = torch.where(has_done & improved, best_adj, min_cost)
                new_patience = torch.where(
                    has_done, torch.where(improved, PATIENCE, patience - 1),
                    patience).to(torch.int32)
                newly_stopped = new_patience <= 0
            else:  # optimistic_future_cost
                new_min, new_patience = min_cost, patience
                kth_adj = torch.where(done_valid, done_adjusted,
                                      -INF).max(dim=1).values
                optimistic = alive_costs.min(dim=1).values - cd * max_len_f
                newly_stopped = done_valid.all(dim=1) & (kth_adj < optimistic)
            stopped = stopped | newly_stopped | (alive_costs >= INF).all(dim=1)

            # ---- expand ------------------------------------------------
            g_new, costs = net.decode_score(carry, contexts, beam=K)
            logprobs = costs.view(U, K, V)
            if constraint is not None:
                # forbidden symbols cost INF; EOS only from final states
                allowed = torch.where(is_eol[None, None, :],
                                      cfinal[cstate][:, :, None],
                                      ctrans[cstate] != NOT_STATE)
                logprobs = torch.where(allowed, logprobs, INF)
            flat = (alive_costs[:, :, None] + logprobs).view(U, K * V)
            chosen, flat_idx = _smallest(flat, K)
            beam_idx = flat_idx // V
            symbols = (flat_idx % V).to(torch.int32)

            # ---- gather hypotheses by source beam row ------------------
            gidx = (first + beam_idx).view(-1)
            # the old glimpses are replaced by the new ones below
            carry = _gather_rows({k: v for k, v in carry.items()
                                  if k != "glimpses"}, gidx)
            g_sel = _gather_rows({k: v for k, v in g_new.items()
                                  if k in _CARRIED_GLIMPSES}, gidx)
            alive_out = alive_out.gather(
                1, beam_idx[:, :, None].expand(U, K, L))
            prev_costs = alive_costs.gather(1, beam_idx)

            # ---- record the symbol (every alive row has length i+1) -----
            alive_out[:, :, min(i, L - 1)] = symbols
            alive_len = torch.tensor(float(i + 1), dtype=f32, device=dev)
            step_costs = chosen - prev_costs

            # ---- advance decoder states and the LM ---------------------
            carry = net.decode_advance(carry, g_sel,
                                       symbols.view(-1).long())

            # ---- EOS retirement ----------------------------------------
            is_eos = symbols == eol
            if ignore_first_eol and i == 0:
                is_eos = torch.zeros_like(is_eos)
            # a stop decided at the top of this step admits nothing more
            finishing = (is_eos & (step_costs < round_to_inf)
                         & (prev_costs < INF / 2) & ~stopped[:, None])
            if host_filter is not None and bool(finishing.any()):
                finishing = self._host_validate(host_filter, finishing,
                                                alive_out, i, inputs)
            adjusted = chosen - cd * (alive_len + 1.0)

            # ---- merge finishing hyps into the done set: 2K -> K --------
            new_meta = torch.stack(
                [chosen, torch.where(finishing, adjusted, INF),
                 alive_len.expand(U, K)], dim=-1)
            cand_meta = torch.cat([done_meta, new_meta], dim=1)
            cand_out = torch.cat([done_out, alive_out], dim=1)
            _, keep = _smallest(cand_meta[:, :, 1], K)
            done_meta = cand_meta.gather(1, keep[:, :, None].expand(U, K, 3))
            done_out = cand_out.gather(1, keep[:, :, None].expand(U, K, L))

            # finished rows leave the beam
            alive_costs = torch.where(is_eos, INF, chosen)
            if constraint is not None:
                cstate_sel = cstate.gather(1, beam_idx)
                nxt = ctrans[cstate_sel, symbols.long()]
                cstate = torch.where(is_eos, cstate_sel, nxt.clamp(min=0))
            patience, min_cost = new_patience, new_min
            i += 1

        meta = done_meta.cpu().numpy()
        return {
            "done_out": done_out.cpu().numpy(),
            "done_cost": meta[:, :, 0],
            "done_adjusted": meta[:, :, 1],
            "done_len": meta[:, :, 2].astype(np.int32),
            "done_valid": meta[:, :, 1] < INF / 2,
            "steps": np.int32(i),
        }

    @staticmethod
    def _host_validate(host_filter, finishing, alive_out, i, inputs):
        """Insertion-time validation (reference blocks/search.py:365-371):
        each finishing candidate, its symbols up to and including the EOL,
        goes through ``host_filter(utterance_inputs, symbols)``."""
        fin = finishing.cpu().numpy().copy()
        outs = alive_out.cpu().numpy()
        feats = inputs.cpu().numpy()
        n = min(i + 1, outs.shape[2])
        for u, k in zip(*np.nonzero(fin)):
            if not host_filter(feats[u], list(outs[u, k, :n])):
                fin[u, k] = False
        return torch.as_tensor(fin, device=finishing.device)
