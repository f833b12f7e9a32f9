"""Weighted FSTs for LM shallow fusion: the host core, the writers and the
packing.

A numpy copy of ``attention_lvcsr_tpu/ops/fst.py``: the host FST (text IO,
symbol tables, epsilon closure, state-set transition, ``explain``), ARPA
parsing and ``arpa_to_fst``, the character-trie dictionary FST, the dense
and CSR packings with their ``.npz`` archives, and ``host_costs``, the
host reference of the per-symbol LM costs.  The code, the text format and
the archive format are those of the JAX package, so both packages write
the same bytes and pack the same graph into the same tables; it is copied
rather than imported because ``attention_lvcsr_tpu/ops/__init__.py``
imports JAX.  The graph builders are in :mod:`attention_lvcsr_torch.ops.
fst_algo` and :mod:`attention_lvcsr_torch.ops.lm_graph`.

Weights are tropical-semiring costs (``-ln p``); combination is
``-logsumexp(-costs)``.
"""
from __future__ import annotations

import math
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

EPSILON = 0
MAX_STATES = 7
NOT_STATE = -1
INF_COST = 1e30


def combine_weights(costs: Iterable[float]) -> float:
    """Log-semiring sum of tropical costs: ``-log(sum(exp(-c)))``."""
    costs = [c for c in costs if c is not None and c < INF_COST]
    if not costs:
        return INF_COST
    m = min(costs)
    return m - math.log(sum(math.exp(m - c) for c in costs))


@dataclass
class Arc:
    ilabel: int
    olabel: int
    weight: float
    nextstate: int


@dataclass
class Fst:
    """A weighted FST over integer symbols."""
    start: int = 0
    arcs: Dict[int, List[Arc]] = field(default_factory=dict)
    finals: Dict[int, float] = field(default_factory=dict)
    isyms: Optional[Dict[str, int]] = None
    osyms: Optional[Dict[str, int]] = None

    def add_arc(self, state, ilabel, olabel, weight, nextstate):
        self.arcs.setdefault(state, []).append(
            Arc(ilabel, olabel, float(weight), int(nextstate)))
        self.arcs.setdefault(nextstate, self.arcs.get(nextstate, []))

    def set_final(self, state, weight=0.0):
        self.finals[state] = float(weight)
        self.arcs.setdefault(state, self.arcs.get(state, []))

    @property
    def num_states(self):
        states = set(self.arcs) | set(self.finals) | {self.start}
        for arcs in self.arcs.values():
            states.update(a.nextstate for a in arcs)
        return max(states) + 1 if states else 0

    def state_arcs(self, state) -> List[Arc]:
        return self.arcs.get(state, [])

    def get_arcs(self, state, ilabel) -> List[Tuple[int, int, int, float]]:
        return [(state, a.nextstate, a.ilabel, a.weight)
                for a in self.state_arcs(state) if a.ilabel == ilabel]

    # -- runtime reference semantics (lvsr/ops.py:60-97) -------------------
    def transition(self, states: Dict[int, float], ilabel: int,
                   combine=combine_weights) -> Dict[int, float]:
        """Consume ``ilabel`` from a weighted state set (no closure)."""
        incoming: Dict[int, List[float]] = defaultdict(list)
        for state, weight in states.items():
            for a in self.state_arcs(state):
                if a.ilabel == ilabel:
                    incoming[a.nextstate].append(weight + a.weight)
        return {s: combine(ws) for s, ws in incoming.items()}

    def expand(self, states: Dict[int, float],
               combine=combine_weights) -> Dict[int, float]:
        """Epsilon closure with log-sum weight combination.

        Processes the epsilon DAG in topological order (Kahn); epsilon
        cycles would make the closure infinite-sum and raise.
        """
        # collect the reachable epsilon subgraph
        seen = set(states)
        queue = deque(states)
        eps_edges: Dict[int, List[Tuple[int, float]]] = defaultdict(list)
        indeg: Dict[int, int] = defaultdict(int)
        while queue:
            state = queue.popleft()
            for a in self.state_arcs(state):
                if a.ilabel != EPSILON:
                    continue
                eps_edges[state].append((a.nextstate, a.weight))
                indeg[a.nextstate] += 1
                if a.nextstate not in seen:
                    seen.add(a.nextstate)
                    queue.append(a.nextstate)

        result = dict(states)
        ready = deque(s for s in seen if indeg[s] == 0)
        processed = 0
        while ready:
            state = ready.popleft()
            processed += 1
            w = result.get(state)
            for nxt, ew in eps_edges.get(state, []):
                if w is not None and w < INF_COST:
                    result[nxt] = combine(
                        [x for x in (result.get(nxt), w + ew)
                         if x is not None])
                indeg[nxt] -= 1
                if indeg[nxt] == 0:
                    ready.append(nxt)
        if processed != len(seen):
            raise ValueError("epsilon cycle in FST; cannot expand")
        return {s: w for s, w in result.items() if w < INF_COST}

    def explain(self, symbols: Sequence[int], verbose=False,
                tropical=False) -> float:
        """Cost of an input symbol sequence (lvsr explain,
        lvsr/ops.py:99-121).  Log semiring sums over all paths (what the
        shallow-fusion runtime does); ``tropical=True`` gives the best
        single path (Viterbi) instead."""
        combine = (lambda ws: min(ws) if ws else INF_COST) if tropical \
            else combine_weights
        states = self.expand({self.start: 0.0}, combine=combine)
        for sym in symbols:
            states = self.expand(self.transition(states, sym,
                                                 combine=combine),
                                 combine=combine)
            if verbose:
                print(f"consumed {sym}: {states}")
            if not states:
                return INF_COST
        return combine([w + self.finals[s] for s, w in states.items()
                        if s in self.finals])


# ---------------------------------------------------------------------------
# IO: AT&T text format + symbol tables
# ---------------------------------------------------------------------------

def read_symbols(path_or_lines) -> Dict[str, int]:
    """Read an OpenFST symbol table (symbol<TAB>id lines)."""
    if isinstance(path_or_lines, str):
        with open(path_or_lines) as f:
            lines = f.readlines()
    else:
        lines = list(path_or_lines)
    syms = {}
    for line in lines:
        parts = line.split()
        if len(parts) >= 2:
            syms[parts[0]] = int(parts[1])
    return syms


def write_symbols(path, syms: Dict[str, int]):
    with open(path, "w") as f:
        for s, i in sorted(syms.items(), key=lambda kv: kv[1]):
            f.write(f"{s} {i}\n")


def read_fst_text(path_or_lines, isyms=None, osyms=None) -> Fst:
    """Parse fstprint-style text: ``src dst ilabel olabel [weight]`` arcs
    and ``state [weight]`` final lines; the first line's source is the
    start state."""
    if isinstance(path_or_lines, str):
        with open(path_or_lines) as f:
            lines = f.readlines()
    else:
        lines = list(path_or_lines)

    def lab(token, table):
        if table and token in table:
            return table[token]
        return int(token)

    fst = Fst(isyms=isyms, osyms=osyms)
    start = None
    for line in lines:
        parts = line.split()
        if not parts:
            continue
        if start is None:
            start = int(parts[0])
        if len(parts) >= 4:
            src, dst = int(parts[0]), int(parts[1])
            il = lab(parts[2], isyms)
            ol = lab(parts[3], osyms)
            w = float(parts[4]) if len(parts) > 4 else 0.0
            fst.add_arc(src, il, ol, w, dst)
        elif len(parts) <= 2:
            fst.set_final(int(parts[0]),
                          float(parts[1]) if len(parts) == 2 else 0.0)
    fst.start = start if start is not None else 0
    return fst


def write_fst_text(fst: Fst, path, isyms=None, osyms=None):
    inv_i = {v: k for k, v in (isyms or {}).items()}
    inv_o = {v: k for k, v in (osyms or {}).items()}
    with open(path, "w") as f:
        states = [fst.start] + [s for s in sorted(fst.arcs)
                                if s != fst.start]
        for s in states:
            for a in fst.state_arcs(s):
                il = inv_i.get(a.ilabel, a.ilabel)
                ol = inv_o.get(a.olabel, a.olabel)
                f.write(f"{s}\t{a.nextstate}\t{il}\t{ol}\t{a.weight}\n")
        for s, w in sorted(fst.finals.items()):
            f.write(f"{s}\t{w}\n")


# ---------------------------------------------------------------------------
# ARPA n-gram LMs
# ---------------------------------------------------------------------------

LN10 = math.log(10.0)


def read_arpa(path_or_lines):
    """Parse an ARPA LM: {order: {ngram_tuple: (log10p, log10backoff)}}."""
    if isinstance(path_or_lines, str):
        with open(path_or_lines) as f:
            lines = f.readlines()
    else:
        lines = [l if isinstance(l, str) else l.decode()
                 for l in path_or_lines]
    ngrams: Dict[int, Dict[tuple, Tuple[float, float]]] = {}
    order = None
    for line in lines:
        line = line.strip()
        if not line or line.startswith("\\data\\") or \
                line.startswith("ngram "):
            continue
        if line.startswith("\\end\\"):
            break
        if line.startswith("\\") and line.endswith("-grams:"):
            order = int(line[1:].split("-")[0])
            ngrams[order] = {}
            continue
        if order is None:
            continue
        parts = line.split()
        logp = float(parts[0])
        if len(parts) == order + 2:
            words = tuple(parts[1:-1])
            backoff = float(parts[-1])
        else:
            words = tuple(parts[1:order + 1])
            backoff = 0.0
        ngrams[order][words] = (logp, backoff)
    return ngrams


def arpa_to_fst(arpa, symbols: Dict[str, int], bos="<s>", eos="</s>"
                ) -> Fst:
    """Backoff n-gram automaton (the ``arpa2fst`` role).

    States are histories; token arcs carry ``-ln P(w|h)``, epsilon backoff
    arcs carry ``-ln alpha(h)``; ``</s>`` probabilities become final
    weights.  ``symbols`` maps tokens to input labels (epsilon is 0).
    """
    if isinstance(arpa, (str, list)):
        arpa = read_arpa(arpa)
    max_order = max(arpa)
    state_of: Dict[tuple, int] = {}
    fst = Fst(isyms=dict(symbols))

    def get_state(hist: tuple) -> int:
        # back off to a shorter history if this one has no continuation
        while len(hist) >= max_order or (hist and hist not in
                                         _hists_with_continuation):
            hist = hist[1:]
        if hist not in state_of:
            state_of[hist] = len(state_of)
        return state_of[hist]

    # histories that can condition something (appear as n-gram prefixes or
    # have a backoff weight)
    _hists_with_continuation = set()
    for order, grams in arpa.items():
        for words in grams:
            _hists_with_continuation.add(tuple(words[:-1]))
            if order < max_order:
                _hists_with_continuation.add(tuple(words))
    _hists_with_continuation.add(())

    get_state(())  # unigram state = 0 unless <s> exists
    start_hist = (bos,) if (bos,) in _hists_with_continuation else ()
    fst.start = get_state(start_hist)

    for order in sorted(arpa):
        for words, (logp, backoff) in arpa[order].items():
            hist, word = tuple(words[:-1]), words[-1]
            if word == bos:
                # <s> is never consumed; its backoff creates the start
                # state's escape arc below.
                pass
            src = get_state(hist)
            w = -logp * LN10
            if word == eos:
                prev = fst.finals.get(src)
                fst.set_final(src, w if prev is None
                              else combine_weights([prev, w]))
            elif word != bos:
                if word not in symbols:
                    raise KeyError(f"token {word!r} missing from symbols")
                dst = get_state(tuple(words))
                fst.add_arc(src, symbols[word], symbols[word], w, dst)
            # backoff arc from the *full* n-gram state
            if order < max_order and tuple(words) in \
                    _hists_with_continuation and word != eos:
                src_full = get_state(tuple(words))
                dst_bo = get_state(tuple(words[1:]))
                if src_full != dst_bo:
                    fst.add_arc(src_full, EPSILON, EPSILON,
                                -backoff * LN10, dst_bo)
    return fst


def dict_char_lm_fst(words: Iterable[str], char_symbols: Dict[str, int],
                     spc="<spc>", weights: Optional[Dict[str, float]] = None
                     ) -> Fst:
    """Character-trie dictionary LM (arpa_lm_to_dict_lm + char lexicon
    pipeline): words spelled as character paths from the root, word end
    loops back to the root through a ``<spc>`` arc; optional per-word
    costs are placed on the first character arc."""
    fst = Fst(isyms=dict(char_symbols))
    root = 0
    fst.arcs[root] = []
    fst.start = root
    next_state = [1]
    trie: Dict[Tuple[int, int], int] = {}

    for word in words:
        cost = (weights or {}).get(word, 0.0)
        state = root
        for i, ch in enumerate(word):
            if ch not in char_symbols:
                raise KeyError(f"character {ch!r} missing from symbols")
            sym = char_symbols[ch]
            key = (state, sym)
            if key in trie:
                state = trie[key]
                cost = 0.0  # weight already placed
            else:
                dst = next_state[0]
                next_state[0] += 1
                fst.add_arc(state, sym, sym, cost, dst)
                trie[key] = dst
                state = dst
                cost = 0.0
        # word end: space back to root, and acceptable as sentence end
        fst.add_arc(state, char_symbols[spc], char_symbols[spc], 0.0, root)
        fst.set_final(state, 0.0)
    fst.set_final(root, 0.0)
    return fst


# ---------------------------------------------------------------------------
# Packing for the on-device runtime (dense tables / CSR lookup tables)
# ---------------------------------------------------------------------------

def all_closures(fst: Fst) -> List[Dict[int, float]]:
    """Epsilon closures (identity included) of EVERY state at once.

    One reverse-topological DP over the epsilon DAG —
    ``closure(s) = {s: 0} + sum over eps arcs (s->u, w) of
    w + closure(u)`` with log-semiring combination — instead of a BFS per
    state, which is quadratic on backoff-chain automata (an n-gram LM's
    epsilon skeleton is exactly such a chain).  Raises on epsilon cycles
    like :meth:`Fst.expand`.
    """
    S = fst.num_states
    eps: List[List[Tuple[int, float]]] = [[] for _ in range(S)]
    indeg = [0] * S
    for s in range(S):
        for a in fst.state_arcs(s):
            if a.ilabel == EPSILON:
                eps[s].append((a.nextstate, a.weight))
                indeg[a.nextstate] += 1
    ready = deque(s for s in range(S) if indeg[s] == 0)
    order = []
    while ready:
        s = ready.popleft()
        order.append(s)
        for u, _ in eps[s]:
            indeg[u] -= 1
            if indeg[u] == 0:
                ready.append(u)
    if len(order) != S:
        raise ValueError("epsilon cycle in FST; cannot expand")
    closures: List[Optional[Dict[int, float]]] = [None] * S
    for s in reversed(order):
        c: Dict[int, float] = {s: 0.0}
        for u, w in eps[s]:
            for t, wt in closures[u].items():  # type: ignore[union-attr]
                prev = c.get(t)
                nw = w + wt
                c[t] = nw if prev is None else combine_weights([prev, nw])
        closures[s] = c
    return closures  # type: ignore[return-value]


def _closed_successors(fst: Fst, closures, remap_table: Dict[int, int]):
    """Iterate ``(state, nn_symbol) -> sorted [(succ, weight), ...]`` for
    every pair that HAS at least one closed successor (sparse: only
    symbols with arcs are visited)."""
    by_label: Dict[int, List[int]] = defaultdict(list)
    for v, lab in remap_table.items():
        if lab is not None:
            by_label[lab].append(v)
    for s in range(fst.num_states):
        arcs_by_label: Dict[int, List[Arc]] = defaultdict(list)
        for a in fst.state_arcs(s):
            if a.ilabel != EPSILON and a.ilabel in by_label:
                arcs_by_label[a.ilabel].append(a)
        for ilabel, arcs in arcs_by_label.items():
            merged: Dict[int, List[float]] = defaultdict(list)
            for a in arcs:
                for u, cw in closures[a.nextstate].items():
                    merged[u].append(a.weight + cw)
            lst = sorted(((u, combine_weights(ws))
                          for u, ws in merged.items()),
                         key=lambda t: t[1])
            for v in by_label[ilabel]:
                yield s, v, lst


@dataclass
class PackedFst:
    """Dense epsilon-closed transition tables.

    ``next_state``/``next_weight``: (S, V, K) — successors of consuming nn
    symbol v in state s, epsilon-closure applied, best-K by weight,
    padded with NOT_STATE / INF_COST.
    ``total_weight``: (S, V) — log-sum over *all* closed successors
    (drives the per-symbol cost vector without needing identities).
    ``start_states``/``start_weights``: (max_states,) — closed start set.
    """
    next_state: np.ndarray
    next_weight: np.ndarray
    total_weight: np.ndarray
    start_states: np.ndarray
    start_weights: np.ndarray
    no_transition_cost: float
    max_states: int


@dataclass
class PackedFstCSR:
    """Sparse epsilon-closed transition tables for production-size graphs.

    A dense ``(S, V, K)`` layout is quadratic in alphabet coverage and
    cannot hold a real trigram ``LG_pushed`` (~1e6 states -> multi-GB
    tables); here only the ``(state, symbol)`` pairs that HAVE a
    transition are stored, sorted by key for on-device binary search
    (``jnp.searchsorted``, the XLA-native sparse lookup):

    ``keys``: (P,) int64 sorted, ``state * num_symbols + nn_symbol``;
    ``next_state``/``next_weight``: (P, K) closed successor rows (best-K
    by weight, NOT_STATE / INF_COST padded);
    ``total_weight``: (P,) log-sum over all closed successors;
    ``start_states``/``start_weights``: (max_states,) closed start set.
    """
    keys: np.ndarray
    next_state: np.ndarray
    next_weight: np.ndarray
    total_weight: np.ndarray
    start_states: np.ndarray
    start_weights: np.ndarray
    no_transition_cost: float
    max_states: int
    num_symbols: int
    num_states: int

    @property
    def nbytes(self):
        return (self.keys.nbytes + self.next_state.nbytes
                + self.next_weight.nbytes + self.total_weight.nbytes)


def _pack_start(fst: Fst, max_states: int):
    start = fst.expand({fst.start: 0.0})
    start_items = sorted(start.items(), key=lambda t: t[1])[:max_states]
    start_states = np.full((max_states,), NOT_STATE, np.int32)
    start_weights = np.zeros((max_states,), np.float32)
    for i, (s, w) in enumerate(start_items):
        start_states[i] = s
        start_weights[i] = w
    return start_states, start_weights


def pack_fst(fst: Fst, remap_table: Dict[int, int], num_nn_symbols: int,
             max_states: int = MAX_STATES, max_arcs: Optional[int] = None,
             no_transition_cost: float = 1e12) -> PackedFst:
    """Precompute the dense tables.

    ``remap_table`` maps nn symbol ids -> FST input labels
    (lvsr/bricks/language_models.py:117-118).
    """
    S = fst.num_states
    V = num_nn_symbols
    closures = all_closures(fst)

    pairs = [(s, v, lst) for s, v, lst in
             _closed_successors(fst, closures, remap_table) if lst]
    K = max_arcs or max((len(lst) for _, _, lst in pairs), default=1) or 1
    next_state = np.full((S, V, K), NOT_STATE, np.int32)
    next_weight = np.full((S, V, K), INF_COST, np.float32)
    total_weight = np.full((S, V), INF_COST, np.float32)
    for s, v, lst in pairs:
        total_weight[s, v] = combine_weights([w for _, w in lst])
        for k, (u, w) in enumerate(lst[:K]):
            next_state[s, v, k] = u
            next_weight[s, v, k] = w

    start_states, start_weights = _pack_start(fst, max_states)
    return PackedFst(next_state, next_weight, total_weight,
                     start_states, start_weights,
                     float(no_transition_cost), max_states)


def pack_fst_csr(fst: Fst, remap_table: Dict[int, int],
                 num_nn_symbols: int, max_states: int = MAX_STATES,
                 max_arcs: Optional[int] = None,
                 no_transition_cost: float = 1e12) -> PackedFstCSR:
    """Sparse packing: same closed-successor semantics as :func:`pack_fst`
    but storing only present ``(state, symbol)`` pairs — linear in arc
    count, so arbitrary-size LG graphs pack (the reference's host pyfst
    traversal handles arbitrary sizes too, lvsr/ops.py:124-233)."""
    S = fst.num_states
    V = num_nn_symbols
    closures = all_closures(fst)

    pairs = [(s, v, lst) for s, v, lst in
             _closed_successors(fst, closures, remap_table) if lst]
    pairs.sort(key=lambda t: (t[0], t[1]))
    P = len(pairs)
    K = max_arcs or max((len(lst) for _, _, lst in pairs), default=1) or 1
    keys = np.empty((P,), np.int64)
    next_state = np.full((P, K), NOT_STATE, np.int32)
    next_weight = np.full((P, K), INF_COST, np.float32)
    total_weight = np.full((P,), INF_COST, np.float32)
    for i, (s, v, lst) in enumerate(pairs):
        keys[i] = s * V + v
        total_weight[i] = combine_weights([w for _, w in lst])
        for k, (u, w) in enumerate(lst[:K]):
            next_state[i, k] = u
            next_weight[i, k] = w

    start_states, start_weights = _pack_start(fst, max_states)
    return PackedFstCSR(keys, next_state, next_weight, total_weight,
                        start_states, start_weights,
                        float(no_transition_cost), max_states, V, S)


# dense tables beyond this many (S * V) cells auto-switch to CSR
DENSE_PACK_CELL_LIMIT = 2_000_000


def pack_fst_auto(fst: Fst, remap_table: Dict[int, int],
                  num_nn_symbols: int, max_states: int = MAX_STATES,
                  max_arcs: Optional[int] = None,
                  no_transition_cost: float = 1e12):
    """Dense tables for small graphs (fastest device lookup, and the
    whole-loop decode kernel can take them to VMEM); CSR beyond
    :data:`DENSE_PACK_CELL_LIMIT` cells."""
    if fst.num_states * num_nn_symbols > DENSE_PACK_CELL_LIMIT:
        return pack_fst_csr(fst, remap_table, num_nn_symbols,
                            max_states=max_states, max_arcs=max_arcs,
                            no_transition_cost=no_transition_cost)
    return pack_fst(fst, remap_table, num_nn_symbols,
                    max_states=max_states, max_arcs=max_arcs,
                    no_transition_cost=no_transition_cost)


def save_packed(path: str, packed):
    """Serialize a packed FST (dense or CSR) to ``.npz``."""
    common = dict(next_state=packed.next_state,
                  next_weight=packed.next_weight,
                  total_weight=packed.total_weight,
                  start_states=packed.start_states,
                  start_weights=packed.start_weights)
    if isinstance(packed, PackedFstCSR):
        np.savez(path, format=np.asarray("csr"), keys=packed.keys,
                 num_symbols=np.asarray(packed.num_symbols),
                 num_states=np.asarray(packed.num_states), **common)
    else:
        np.savez(path, format=np.asarray("dense"), **common)


def load_packed(path: str, no_transition_cost: float = 1e12,
                max_states: int = MAX_STATES):
    """Load a packed FST written by :func:`save_packed` (legacy archives
    without a ``format`` marker are dense)."""
    data = np.load(path)
    fmt = str(data["format"]) if "format" in data.files else "dense"
    if fmt == "csr":
        return PackedFstCSR(
            data["keys"], data["next_state"], data["next_weight"],
            data["total_weight"], data["start_states"],
            data["start_weights"], no_transition_cost, max_states,
            int(data["num_symbols"]), int(data["num_states"]))
    return PackedFst(
        data["next_state"], data["next_weight"], data["total_weight"],
        data["start_states"], data["start_weights"],
        no_transition_cost, max_states)


def host_costs(fst: Fst, remap_table: Dict[int, int], num_nn_symbols: int,
               states: Dict[int, float],
               no_transition_cost: float = 1e12) -> np.ndarray:
    """Host reference of FSTCostsOp (lvsr/ops.py:206-225)."""
    costs = np.full((num_nn_symbols,), no_transition_cost, np.float64)
    if not states:
        return costs
    total = combine_weights(states.values())
    for v in range(num_nn_symbols):
        ilabel = remap_table.get(v)
        if ilabel is None:
            continue
        nxt = fst.expand(fst.transition(states, ilabel))
        if nxt:
            costs[v] = combine_weights(nxt.values()) - total
    return costs
