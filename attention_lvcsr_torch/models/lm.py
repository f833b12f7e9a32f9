"""FST language model for shallow fusion, on the model's device.

Counterpart of ``attention_lvcsr_tpu/models/lm.py::FSTLanguageModel``.
The packed tables of ``ops/fst.py`` are buffers of the module (moved with
``.to(device)``, never in a checkpoint: they are rebuilt from the FST), and
one step is gathers and masked log-sum-exps:

* the live state set is ``(B, M)`` states and weights (``max_states``,
  7 by default);
* consuming a symbol gathers the epsilon-closed successor lists of all
  live states ``(B, M, K)``, merges duplicate successors by log-sum-exp
  (an (N, N) equality mask, the first occurrence kept) and keeps the best
  M, ties to the lowest index (a stable sort, never ``torch.topk``);
* the per-symbol cost vector ``add`` is
  ``-logsumexp_m(-(w_m + total_weight[s_m, :])) - total``;
* ``evaluate`` runs the steps over a teacher-forced label sequence and
  returns the ``add`` each step's readout sees (before it consumes its
  label), as the training cost and ``analyze`` read it.

Three runtimes, chosen as the JAX package chooses them: dense tables; a
CSR graph densified at load when its dense tables fit the byte budget
(``LVSR_LM_DENSIFY_BUDGET``, 2 GiB by default); and, beyond it, windowed
lookups into each live state's contiguous arc window of the CSR keys.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from attention_lvcsr_torch.ops.fst import (INF_COST, NOT_STATE, PackedFstCSR,
                                           load_packed, pack_fst_auto,
                                           read_fst_text, read_symbols)


def _neg_logsumexp_neg(costs, dim, valid):
    """combine_weights on tensors: ``-logsumexp(-costs)`` over the valid
    entries; +inf where none is valid."""
    x = torch.where(valid, -costs, torch.full((), -torch.inf,
                                              dtype=costs.dtype,
                                              device=costs.device))
    return -torch.logsumexp(x, dim=dim)


def _densify_budget_bytes() -> int:
    """Dense (S, V) total + (S, V, K) successor tables of a CSR graph below
    this many bytes are densified at load (the JAX package's rule)."""
    return int(os.environ.get("LVSR_LM_DENSIFY_BUDGET", 2 << 30))


def csr_runtime_meta(packed: PackedFstCSR) -> Dict[str, Any]:
    """The CSR runtime for ``packed`` ("densified" with dense tables, or
    "windowed" with row pointers), by the JAX package's budget rule
    (``attention_lvcsr_tpu/models/lm.py::_csr_runtime_meta``)."""
    S, V = packed.num_states, packed.num_symbols
    if S * V >= 2 ** 31:
        raise ValueError("CSR FST key space exceeds int32")
    K = packed.next_state.shape[1]
    if S * V * 4 * (1 + 2 * K) <= _densify_budget_bytes():
        s = (packed.keys // V).astype(np.int64)
        v = (packed.keys % V).astype(np.int64)
        tw = np.full((S, V), INF_COST, np.float32)
        tw[s, v] = packed.total_weight
        ns = np.full((S, V, K), NOT_STATE, np.int32)
        ns[s, v] = packed.next_state
        nw = np.full((S, V, K), INF_COST, np.float32)
        nw[s, v] = packed.next_weight
        return {"runtime": "densified", "tw": tw, "ns": ns, "nw": nw}
    row_ptr = np.searchsorted(packed.keys // V,
                              np.arange(S + 1)).astype(np.int64)
    window = max(int(np.diff(row_ptr).max(initial=1)), 1)
    return {"runtime": "windowed", "row_ptr": row_ptr, "window": window}


class FSTLanguageModel(nn.Module):
    """``states``, ``weights`` and ``add`` form the carry, as in JAX."""

    def __init__(self, packed, no_transition_cost: float):
        super().__init__()
        self.no_transition_cost = float(no_transition_cost)
        meta = None
        if isinstance(packed, PackedFstCSR):
            meta = csr_runtime_meta(packed)
            self.num_symbols = packed.num_symbols
        else:
            self.num_symbols = packed.total_weight.shape[1]
        self.runtime = meta["runtime"] if meta else "dense"
        if self.runtime == "densified":
            tables = {"next_state": meta["ns"], "next_weight": meta["nw"],
                      "total_weight": meta["tw"]}
        else:
            tables = {"next_state": packed.next_state,
                      "next_weight": packed.next_weight,
                      "total_weight": packed.total_weight}
        if self.runtime == "windowed":
            tables["keys"] = packed.keys.astype(np.int64)
            tables["row_ptr"] = meta["row_ptr"]
            self.window = meta["window"]
        tables["start_states"] = packed.start_states
        tables["start_weights"] = packed.start_weights
        for name, value in tables.items():
            value = np.asarray(value)
            dtype = (torch.float32 if value.dtype.kind == "f"
                     else torch.int64)
            self.register_buffer(name, torch.tensor(value, dtype=dtype),
                                 persistent=False)

    # -- table lookups ---------------------------------------------------
    def _window_gather(self, states):
        """Each live state's arc window: positions, symbols and validity,
        (..., M, window)."""
        idx = states.clamp(min=0)
        base = self.row_ptr[idx]
        deg = self.row_ptr[idx + 1] - base
        j = torch.arange(self.window, device=states.device)
        pos = torch.clamp(base[..., None] + j, max=self.keys.shape[0] - 1)
        valid = j < deg[..., None]
        sym = self.keys[pos] - idx[..., None] * self.num_symbols
        return pos, sym, valid

    def _lookup_total(self, states):
        """``total_weight[s, :]`` for the live set -> (B, M, V), INF_COST
        where (state, symbol) has no transition."""
        if self.runtime != "windowed":
            return self.total_weight[states.clamp(min=0)]
        pos, sym, valid = self._window_gather(states)
        w = self.total_weight[pos]
        hit = (sym[..., None] == torch.arange(
            self.num_symbols, device=states.device)) & valid[..., None]
        return torch.where(hit, w[..., None],
                           torch.full((), INF_COST, device=w.device)
                           ).amin(dim=-2)

    def _lookup_next(self, states, symbols):
        """Closed successors of consuming ``symbols``: (ns, nw) each
        (B, M, K), NOT_STATE / INF_COST padded."""
        idx = states.clamp(min=0)
        if self.runtime != "windowed":
            sym = symbols.long()[:, None].expand_as(idx)
            return self.next_state[idx, sym], self.next_weight[idx, sym]
        pos, sym, valid = self._window_gather(states)
        hit = (sym == symbols.long()[:, None, None]) & valid
        found = hit.any(dim=-1, keepdim=True)
        at = pos.gather(-1, hit.to(torch.int8).argmax(dim=-1,
                                                      keepdim=True))[..., 0]
        ns = torch.where(found, self.next_state[at],
                         torch.full((), NOT_STATE, device=at.device))
        nw = torch.where(found, self.next_weight[at],
                         torch.full((), INF_COST, device=at.device))
        return ns, nw

    # --------------------------------------------------------------------
    def _costs(self, states, weights):
        """Per-symbol transition costs (B, V)."""
        valid = states != NOT_STATE
        tw = self._lookup_total(states)
        nxt_total = _neg_logsumexp_neg(weights[..., None] + tw, 1,
                                       valid[..., None])
        total = _neg_logsumexp_neg(weights, 1, valid)
        costs = nxt_total - total[..., None]
        has_any = valid.any(dim=1, keepdim=True)
        # table padding is INF_COST (1e30), which is float-finite
        reachable = torch.isfinite(costs) & (nxt_total < 1e29) & has_any
        return torch.where(reachable, costs,
                           torch.full((), self.no_transition_cost,
                                      device=costs.device))

    def initial_states(self, batch_size):
        states = self.start_states[None].expand(batch_size, -1).clone()
        weights = self.start_weights[None].expand(batch_size, -1).clone()
        return {"states": states, "weights": weights,
                "add": self._costs(states, weights)}

    def one_step(self, carry, symbols, mask=None):
        """Consume ``symbols`` (B,) ints; returns the new carry.  Rows
        whose ``mask`` (B,) is 0 keep their states and weights."""
        states, weights = carry["states"], carry["weights"]
        B, M = states.shape
        valid = states != NOT_STATE
        ns, nw = self._lookup_next(states, symbols)            # (B, M, K)
        nw = weights[..., None] + nw
        cand_valid = valid[..., None] & (ns != NOT_STATE)
        N = ns.shape[1] * ns.shape[2]
        ns = torch.where(cand_valid, ns, NOT_STATE).reshape(B, N)
        nw = torch.where(cand_valid, nw, torch.inf).reshape(B, N)

        # merge duplicate successors: the combined weight on the first
        # occurrence of each state id, +inf on the others
        same = (ns[:, :, None] == ns[:, None, :]) & \
            (ns[:, None, :] != NOT_STATE)                      # (B, N, N)
        merged = _neg_logsumexp_neg(nw[:, None, :].expand(B, N, N), 2, same)
        n_idx = torch.arange(N, device=ns.device)
        earlier = same & (n_idx[None, None, :] < n_idx[None, :, None])
        is_first = ~earlier.any(dim=2) & (ns != NOT_STATE)
        merged = torch.where(is_first, merged, torch.inf)

        # the best M by weight, ties to the lowest index
        order = torch.sort(merged, dim=1, stable=True).indices[:, :M]
        new_weights = merged.gather(1, order)
        new_states = ns.gather(1, order)
        dead = ~torch.isfinite(new_weights)
        new_states = torch.where(dead, NOT_STATE, new_states)
        new_weights = torch.where(dead, 0.0, new_weights)
        if mask is not None:
            live = mask[:, None] > 0
            new_states = torch.where(live, new_states, states)
            new_weights = torch.where(live, new_weights, weights)
        return {"states": new_states, "weights": new_weights,
                "add": self._costs(new_states, new_weights)}

    def evaluate(self, outputs, mask=None):
        """The teacher-forced pass over ``outputs`` (T, B): ``{"add": (T,
        B, V)}``, the costs each step's readout sees, taken BEFORE the
        step consumes ``outputs[t]``.  Masked steps ((T, B) ``mask`` 0)
        carry the states and weights unchanged."""
        carry = self.initial_states(outputs.shape[1])
        adds = []
        for t in range(outputs.shape[0]):
            adds.append(carry["add"])
            carry = self.one_step(carry, outputs[t],
                                  mask=None if mask is None else mask[t])
        return {"add": torch.stack(adds)}


def make_language_model(lm_conf: Mapping[str, Any],
                        nn_char_map: Mapping[str, int]) -> FSTLanguageModel:
    """The LM of a ``net.lm`` config section (its ``path``,
    ``no_transition_cost`` and ``max_states`` keys), as the JAX package's
    ``make_language_model`` builds it: ``path`` is an FST text file (with
    ``path + '.syms'`` or an embedded symbol table), whose symbols are
    mapped to network ids through ``nn_char_map``, or a packed ``.npz``."""
    lm_conf = dict(lm_conf)
    path = lm_conf.pop("path")
    no_transition_cost = float(lm_conf.pop("no_transition_cost", 1e12))
    max_states = int(lm_conf.pop("max_states", 7))
    if path.endswith(".npz"):
        packed = load_packed(path, no_transition_cost, max_states)
    else:
        syms_path = path + ".syms"
        isyms = read_symbols(syms_path) if os.path.exists(syms_path) else None
        fst = read_fst_text(path, isyms=isyms)
        fst_char_map = dict(fst.isyms or {})
        fst_char_map.pop("<eps>", None)
        if len(fst_char_map) != len(nn_char_map):
            raise ValueError(
                f"LM symbols ({len(fst_char_map)}) do not match the "
                f"network alphabet ({len(nn_char_map)})")
        remap = {nn_char_map[ch]: code for ch, code in fst_char_map.items()}
        packed = pack_fst_auto(
            fst, remap, num_nn_symbols=max(nn_char_map.values()) + 1,
            max_states=max_states, no_transition_cost=no_transition_cost)
    return FSTLanguageModel(packed, no_transition_cost)
