"""FST graph-construction algorithms: compose / determinize / minimize / push.

OpenFST-free reimplementations of the graph-building operations the
reference drives through OpenFST/Kaldi CLI binaries in
``bin/lm2fst.sh:43-139`` (``fsttablecompose``, ``fstdeterminizestar
--use-log=true``, ``fstrmsymbols``, ``fstrmepslocal``,
``fstminimizeencoded``, ``fstpush --push_weights=true``,
``fstrmepsilon``, ``fstaddselfloops``) plus the Kaldi helper scripts
(``eps2disambig.pl``, ``add_lex_disambig.pl``, ``make_lexicon_fst.pl``).
These are what the repo needs to build the character-level decoding
graph ``LG_pushed`` (lexicon composed with the n-gram word LM,
determinized in the log semiring, minimized, weight-pushed) that the
reference's WSJ WER-parity recipe decodes with
(``exp/wsj/create_character_decoding_graph.sh``, ``exp/wsj/decode.sh``).
The port's copy of ``attention_lvcsr_tpu/ops/fst_algo.py``, code for code,
so that both packages build the same graphs, state for state.

Everything operates on the host :class:`attention_lvcsr_torch.ops.fst.Fst`
(graph building is offline, one-time work; the runtime traversal is the
dense on-device path in :mod:`attention_lvcsr_torch.models.lm`).

Weights are tropical costs (``-ln p``).  Where the reference passes
``--use-log=true`` the *combination* of weights uses the log semiring
(``-logaddexp``) while the result is still stored as plain costs, which
is exactly what Kaldi's determinize-star does with ``--use-log``.
"""
from __future__ import annotations

import math
from collections import defaultdict, deque
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from attention_lvcsr_torch.ops.fst import (EPSILON, Fst, INF_COST)


def _plus_tropical(a: float, b: float) -> float:
    return a if a < b else b


def _plus_log(a: float, b: float) -> float:
    if a >= INF_COST:
        return b
    if b >= INF_COST:
        return a
    m = a if a < b else b
    return m - math.log1p(math.exp(m - max(a, b)))


def _plus(use_log: bool):
    return _plus_log if use_log else _plus_tropical


# ---------------------------------------------------------------------------
# connect (trim): keep accessible + coaccessible states
# ---------------------------------------------------------------------------

def connect(fst: Fst) -> Fst:
    """Remove states not on a start->final path (OpenFST Connect)."""
    # forward reachability
    fwd: Set[int] = set()
    queue = deque([fst.start])
    fwd.add(fst.start)
    while queue:
        s = queue.popleft()
        for a in fst.state_arcs(s):
            if a.nextstate not in fwd:
                fwd.add(a.nextstate)
                queue.append(a.nextstate)
    # backward reachability from finals
    back_edges: Dict[int, List[int]] = defaultdict(list)
    for s in fwd:
        for a in fst.state_arcs(s):
            if a.nextstate in fwd:
                back_edges[a.nextstate].append(s)
    bwd: Set[int] = set(f for f in fst.finals if f in fwd)
    queue = deque(bwd)
    while queue:
        s = queue.popleft()
        for p in back_edges.get(s, []):
            if p not in bwd:
                bwd.add(p)
                queue.append(p)
    keep = fwd & bwd
    remap = {}
    if fst.start in keep:
        remap[fst.start] = 0
    for s in sorted(keep):
        remap.setdefault(s, len(remap))
    out = Fst(isyms=fst.isyms, osyms=fst.osyms)
    out.start = 0
    out.arcs[0] = []
    for s in keep:
        out.arcs.setdefault(remap[s], [])
        for a in fst.state_arcs(s):
            if a.nextstate in keep:
                out.add_arc(remap[s], a.ilabel, a.olabel, a.weight,
                            remap[a.nextstate])
    for s, w in fst.finals.items():
        if s in keep:
            out.set_final(remap[s], w)
    return out


# ---------------------------------------------------------------------------
# composition (fsttablecompose role) with the epsilon-sequencing filter
# ---------------------------------------------------------------------------

def compose(a: Fst, b: Fst) -> Fst:
    """Compose two FSTs: output labels of ``a`` match input labels of
    ``b``.  Uses the standard 3-state epsilon filter so parallel epsilon
    paths are not double-counted (Mohri's epsilon-sequencing filter; the
    ``fsttablecompose`` role in ``bin/lm2fst.sh:76,119``)."""
    out = Fst(isyms=a.isyms, osyms=b.osyms)
    # filter states: 0 = free, 1 = just moved on a's eps-output,
    # 2 = just moved on b's eps-input
    start = (a.start, b.start, 0)
    state_id: Dict[Tuple[int, int, int], int] = {start: 0}
    out.start = 0
    out.arcs[0] = []
    queue = deque([start])

    b_arcs_by_ilabel: Dict[int, Dict[int, list]] = {}

    def b_arcs(s2, ilabel):
        if s2 not in b_arcs_by_ilabel:
            d = defaultdict(list)
            for arc in b.state_arcs(s2):
                d[arc.ilabel].append(arc)
            b_arcs_by_ilabel[s2] = d
        return b_arcs_by_ilabel[s2].get(ilabel, ())

    def get_id(key):
        if key not in state_id:
            state_id[key] = len(state_id)
            queue.append(key)
        return state_id[key]

    while queue:
        key = queue.popleft()
        s1, s2, f = key
        src = state_id[key]
        out.arcs.setdefault(src, [])
        for arc1 in a.state_arcs(s1):
            if arc1.olabel == EPSILON:
                # move in a only (eps_L): allowed from filter 0 or 1
                if f != 2:
                    dst = get_id((arc1.nextstate, s2, 1))
                    out.add_arc(src, arc1.ilabel, EPSILON, arc1.weight, dst)
                # joint eps move (a's eps output matched with b's eps
                # input): only from the free filter state, so each
                # interleaving of epsilon moves is counted exactly once
                if f == 0:
                    for arc2 in b_arcs(s2, EPSILON):
                        dst = get_id((arc1.nextstate, arc2.nextstate, 0))
                        out.add_arc(src, arc1.ilabel, arc2.olabel,
                                    arc1.weight + arc2.weight, dst)
            else:
                for arc2 in b_arcs(s2, arc1.olabel):
                    dst = get_id((arc1.nextstate, arc2.nextstate, 0))
                    out.add_arc(src, arc1.ilabel, arc2.olabel,
                                arc1.weight + arc2.weight, dst)
        # move in b only (eps_R): allowed from filter 0 or 2
        if f != 1:
            for arc2 in b_arcs(s2, EPSILON):
                dst = get_id((s1, arc2.nextstate, 2))
                out.add_arc(src, EPSILON, arc2.olabel, arc2.weight, dst)
        if s1 in a.finals and s2 in b.finals:
            out.set_final(src, a.finals[s1] + b.finals[s2])
    return connect(out)


# ---------------------------------------------------------------------------
# determinize-star (fstdeterminizestar --use-log=true role)
# ---------------------------------------------------------------------------

class DeterminizeError(ValueError):
    pass


def determinize_star(fst: Fst, use_log: bool = True,
                     max_states: int = 2_000_000) -> Fst:
    """Epsilon-removing functional-transducer determinization.

    Kaldi's ``fstdeterminizestar``: subset construction where subset
    elements carry a residual weight and a residual output string;
    input epsilons are closed over; arcs whose common output string is
    longer than one symbol are expanded into chains of epsilon-input
    states.  ``use_log`` selects log-semiring weight combination when
    merging elements / factoring the common weight (what the reference
    passes in ``bin/lm2fst.sh:77,120``); the best-path semantics of the
    result are tropical either way.
    """
    plus = _plus(use_log)

    def closure(elements: Dict[Tuple[int, tuple], float]
                ) -> Dict[Tuple[int, tuple], float]:
        """Close over input-epsilon arcs (appending their output labels)."""
        result = dict(elements)
        queue = deque(elements.items())
        pops = 0
        limit = 1000 * (len(elements) + 10) + 100_000
        while queue:
            (s, ostr), w = queue.popleft()
            pops += 1
            if pops > limit:
                raise DeterminizeError(
                    "epsilon cycle detected during determinization")
            cur = result.get((s, ostr))
            if cur is None or cur < w - 1e-12:
                continue  # stale entry
            for arc in fst.state_arcs(s):
                if arc.ilabel != EPSILON:
                    continue
                key = (arc.nextstate,
                       ostr + ((arc.olabel,) if arc.olabel != EPSILON
                               else ()))
                nw = w + arc.weight
                old = result.get(key)
                merged = nw if old is None else plus(old, nw)
                if old is None or merged < old - 1e-12:
                    result[key] = merged
                    queue.append((key, merged))
        return result

    def normalize(elements: Dict[Tuple[int, tuple], float]
                  ) -> Tuple[float, tuple, frozenset]:
        total = INF_COST
        for w in elements.values():
            total = plus(total, w)
        ostrings = [o for (_, o) in elements]
        prefix = ostrings[0]
        for o in ostrings[1:]:
            n = 0
            for x, y in zip(prefix, o):
                if x != y:
                    break
                n += 1
            prefix = prefix[:n]
            if not prefix:
                break
        plen = len(prefix)
        norm = frozenset(
            ((s, o[plen:]), round(w - total, 9))
            for (s, o), w in elements.items())
        return total, prefix, norm

    out = Fst(isyms=fst.isyms, osyms=fst.osyms)
    subset_id: Dict[frozenset, int] = {}
    next_state = [0]

    def new_state() -> int:
        s = next_state[0]
        next_state[0] += 1
        out.arcs.setdefault(s, [])
        if s > max_states:
            raise DeterminizeError(
                f"determinization exceeded {max_states} states "
                f"(input may not be determinizable)")
        return s

    def get_subset_state(norm: frozenset) -> Tuple[int, bool]:
        if norm in subset_id:
            return subset_id[norm], False
        subset_id[norm] = new_state()
        return subset_id[norm], True

    def emit_chain(src: int, ilabel: int, ostr: tuple, weight: float,
                   dst: Optional[int], final_weight: Optional[float]):
        """Arc(s) from src emitting ``ostr``; first arc carries ``ilabel``
        and ``weight``; ends at ``dst`` or at a fresh final state."""
        labels = list(ostr) if ostr else [EPSILON]
        cur = src
        for i, ol in enumerate(labels):
            last = i == len(labels) - 1
            if last and dst is not None:
                nxt = dst
            else:
                nxt = new_state()
            out.add_arc(cur, ilabel if i == 0 else EPSILON, ol,
                        weight if i == 0 else 0.0, nxt)
            cur = nxt
        if dst is None:
            out.set_final(cur, final_weight or 0.0)

    init = closure({(fst.start, ()): 0.0})
    if not init:
        return out
    total0, prefix0, norm0 = normalize(init)
    start_id, _ = get_subset_state(norm0)
    out.start = start_id
    # a non-trivial initial common weight/output cannot be attached to the
    # start state of an FST; re-inject it by NOT factoring it out at init.
    if total0 != 0.0 or prefix0:
        norm0 = frozenset(((s, prefix0 + o), round(w + total0, 9))
                          for (s, o), w in normalize(init)[2])
        subset_id.clear()
        next_state[0] = 0
        out = Fst(isyms=fst.isyms, osyms=fst.osyms)
        start_id, _ = get_subset_state(norm0)
        out.start = start_id

    queue = deque([norm0])
    seen = {norm0}
    while queue:
        norm = queue.popleft()
        src = subset_id[norm]
        elements = {key: w for key, w in norm}

        # final handling: elements whose state is final
        final_by_ostr: Dict[tuple, float] = {}
        for (s, ostr), w in elements.items():
            if s in fst.finals:
                fw = w + fst.finals[s]
                old = final_by_ostr.get(ostr)
                final_by_ostr[ostr] = fw if old is None else plus(old, fw)
        for ostr, fw in sorted(final_by_ostr.items()):
            if not ostr:
                prev = out.finals.get(src)
                out.set_final(src, fw if prev is None else plus(prev, fw))
            else:
                emit_chain(src, EPSILON, ostr, fw, None, 0.0)

        # group moves by input label
        by_label: Dict[int, Dict[Tuple[int, tuple], float]] = \
            defaultdict(dict)
        for (s, ostr), w in elements.items():
            for arc in fst.state_arcs(s):
                if arc.ilabel == EPSILON:
                    continue
                key = (arc.nextstate,
                       ostr + ((arc.olabel,) if arc.olabel != EPSILON
                               else ()))
                nw = w + arc.weight
                old = by_label[arc.ilabel].get(key)
                by_label[arc.ilabel][key] = \
                    nw if old is None else plus(old, nw)

        for ilabel in sorted(by_label):
            nxt = closure(by_label[ilabel])
            total, prefix, nnorm = normalize(nxt)
            dst, is_new = get_subset_state(nnorm)
            if is_new and nnorm not in seen:
                seen.add(nnorm)
                queue.append(nnorm)
            emit_chain(src, ilabel, prefix, total, dst, None)

    return connect(out)


# ---------------------------------------------------------------------------
# label surgery (fstrmsymbols / eps2disambig / fstaddselfloops roles)
# ---------------------------------------------------------------------------

def remove_input_symbols(fst: Fst, labels: Iterable[int]) -> Fst:
    """Replace the given input labels with epsilon (``fstrmsymbols``)."""
    labels = set(labels)
    out = Fst(start=fst.start, isyms=fst.isyms, osyms=fst.osyms)
    for s in fst.arcs:
        out.arcs.setdefault(s, [])
        for a in fst.state_arcs(s):
            il = EPSILON if a.ilabel in labels else a.ilabel
            out.add_arc(s, il, a.olabel, a.weight, a.nextstate)
    out.finals = dict(fst.finals)
    return out


def eps_to_disambig(fst: Fst, disambig_label: int) -> Fst:
    """Input-side epsilons -> ``#0`` (Kaldi ``eps2disambig.pl``): makes
    the LM's backoff arcs visible to composition so the determinization
    result stays correct."""
    out = Fst(start=fst.start, isyms=fst.isyms, osyms=fst.osyms)
    for s in fst.arcs:
        out.arcs.setdefault(s, [])
        for a in fst.state_arcs(s):
            il = disambig_label if a.ilabel == EPSILON else a.ilabel
            out.add_arc(s, il, a.olabel, a.weight, a.nextstate)
    out.finals = dict(fst.finals)
    return out


def add_self_loops(fst: Fst, ilabel: int, olabel: int) -> Fst:
    """Kaldi ``fstaddselfloops``: add an ``ilabel:olabel/0`` self-loop to
    the start state, every final state, and every state with a non-eps
    output label on some outgoing arc — propagates the ``#0`` backoff
    symbol through the lexicon."""
    out = Fst(start=fst.start, isyms=fst.isyms, osyms=fst.osyms)
    loop_states = {fst.start} | set(fst.finals)
    for s in fst.arcs:
        if any(a.olabel != EPSILON for a in fst.state_arcs(s)):
            loop_states.add(s)
    for s in fst.arcs:
        out.arcs.setdefault(s, [])
        for a in fst.state_arcs(s):
            out.add_arc(s, a.ilabel, a.olabel, a.weight, a.nextstate)
    for s in loop_states:
        out.add_arc(s, ilabel, olabel, 0.0, s)
    out.finals = dict(fst.finals)
    return out


# ---------------------------------------------------------------------------
# epsilon removal (fstrmepsilon / fstrmepslocal roles)
# ---------------------------------------------------------------------------

def rm_epsilon(fst: Fst, use_log: bool = False) -> Fst:
    """Remove arcs that are epsilon on BOTH tapes by closure.

    Covers both ``fstrmepslocal`` (a size-conscious variant of the same
    semantics) and the final ``fstrmepsilon`` in ``bin/lm2fst.sh:129``.
    """
    plus = _plus(use_log)

    def eps_closure(start: int) -> Dict[int, float]:
        dist = {start: 0.0}
        queue = deque([start])
        pops, limit = 0, 1000 * fst.num_states + 100_000
        while queue:
            s = queue.popleft()
            pops += 1
            if pops > limit:
                raise ValueError("epsilon cycle in rm_epsilon")
            for a in fst.state_arcs(s):
                if a.ilabel == EPSILON and a.olabel == EPSILON:
                    nw = dist[s] + a.weight
                    old = dist.get(a.nextstate)
                    merged = nw if old is None else plus(old, nw)
                    if old is None or merged < old - 1e-12:
                        dist[a.nextstate] = merged
                        queue.append(a.nextstate)
        return dist

    out = Fst(start=fst.start, isyms=fst.isyms, osyms=fst.osyms)
    for s in fst.arcs:
        out.arcs.setdefault(s, [])
        closure_s = eps_closure(s)
        final_w: Optional[float] = None
        for u, cw in closure_s.items():
            for a in fst.state_arcs(u):
                if a.ilabel == EPSILON and a.olabel == EPSILON:
                    continue
                out.add_arc(s, a.ilabel, a.olabel, cw + a.weight,
                            a.nextstate)
            if u in fst.finals:
                fw = cw + fst.finals[u]
                final_w = fw if final_w is None else plus(final_w, fw)
        if final_w is not None:
            out.set_final(s, final_w)
    return connect(out)


# ---------------------------------------------------------------------------
# minimization (fstminimizeencoded role)
# ---------------------------------------------------------------------------

def minimize_encoded(fst: Fst) -> Fst:
    """Minimize treating (ilabel, olabel, weight) as an opaque encoded
    label (Kaldi ``fstminimizeencoded``: minimization without weight
    pushing, valid for the deterministic graphs determinize-star emits).
    Moore partition refinement."""
    fst = connect(fst)
    states = sorted(fst.arcs.keys() | fst.finals.keys() | {fst.start})
    if not states:
        return fst

    def final_sig(s):
        w = fst.finals.get(s)
        return None if w is None else round(w, 9)

    block: Dict[int, int] = {}
    sig_to_block: Dict[object, int] = {}
    for s in states:
        sig = final_sig(s)
        if sig not in sig_to_block:
            sig_to_block[sig] = len(sig_to_block)
        block[s] = sig_to_block[sig]

    while True:
        sig_to_new: Dict[object, int] = {}
        new_block: Dict[int, int] = {}
        for s in states:
            arcsig = tuple(sorted(
                (a.ilabel, a.olabel, round(a.weight, 9), block[a.nextstate])
                for a in fst.state_arcs(s)))
            sig = (block[s], arcsig)
            if sig not in sig_to_new:
                sig_to_new[sig] = len(sig_to_new)
            new_block[s] = sig_to_new[sig]
        if len(sig_to_new) == len(set(block.values())):
            block = new_block
            break
        block = new_block

    # rebuild with one representative per block, start's block first
    rep: Dict[int, int] = {}
    order = [fst.start] + [s for s in states if s != fst.start]
    remap: Dict[int, int] = {}
    for s in order:
        b = block[s]
        if b not in rep:
            rep[b] = len(rep)
        remap[s] = rep[b]
    out = Fst(isyms=fst.isyms, osyms=fst.osyms)
    out.start = remap[fst.start]
    done: Set[int] = set()
    for s in order:
        d = remap[s]
        if d in done:
            continue
        done.add(d)
        out.arcs.setdefault(d, [])
        for a in fst.state_arcs(s):
            out.add_arc(d, a.ilabel, a.olabel, a.weight,
                        remap[a.nextstate])
        if s in fst.finals:
            out.set_final(d, fst.finals[s])
    return out


# ---------------------------------------------------------------------------
# weight pushing (fstpush --push_weights=true role)
# ---------------------------------------------------------------------------

def push_weights(fst: Fst, use_log: bool = False,
                 max_iters: int = 10_000) -> Fst:
    """Push weights toward the initial state, preserving path weights.

    Potentials are shortest distances to a final state (tropical ``min``
    by default, matching OpenFST's ``fstpush --push_weights=true`` on
    StdArc FSTs, which ``bin/lm2fst.sh:126`` uses); each arc is
    reweighted ``w + d(next) - d(src)`` and the residual total weight
    ``d(start)`` is re-applied at the start state so path weights are
    unchanged (OpenFST keeps the total weight by default).
    """
    plus = _plus(use_log)
    fst = connect(fst)
    states = sorted(fst.arcs.keys() | fst.finals.keys() | {fst.start})
    # reverse adjacency for distance-to-final relaxation
    rev: Dict[int, List[Tuple[int, float]]] = defaultdict(list)
    for s in states:
        for a in fst.state_arcs(s):
            rev[a.nextstate].append((s, a.weight))

    dist: Dict[int, float] = {s: INF_COST for s in states}
    queue = deque()
    in_queue = set()
    for s, w in fst.finals.items():
        dist[s] = w
        queue.append(s)
        in_queue.add(s)
    iters = 0
    while queue:
        iters += 1
        if iters > max_iters * max(len(states), 1):
            raise ValueError("push_weights failed to converge "
                             "(negative-weight cycle?)")
        t = queue.popleft()
        in_queue.discard(t)
        dt = dist[t]
        for s, w in rev.get(t, ()):  # relax s -> t
            cand = plus(dist[s], w + dt) if use_log else \
                _plus_tropical(dist[s], w + dt)
            if cand < dist[s] - 1e-12:
                dist[s] = cand
                if s not in in_queue:
                    queue.append(s)
                    in_queue.add(s)

    d0 = dist[fst.start]
    out = Fst(start=fst.start, isyms=fst.isyms, osyms=fst.osyms)
    for s in states:
        out.arcs.setdefault(s, [])
        ds = dist[s]
        for a in fst.state_arcs(s):
            w = a.weight + dist[a.nextstate] - ds
            if s == fst.start:
                w += d0  # keep the total weight at the start
            out.add_arc(s, a.ilabel, a.olabel, w, a.nextstate)
    for s, w in fst.finals.items():
        fw = w - dist[s]
        if s == fst.start:
            fw += d0
        out.set_final(s, fw)
    return out


# ---------------------------------------------------------------------------
# lexicon pipeline (add_lex_disambig.pl / make_lexicon_fst.pl roles)
# ---------------------------------------------------------------------------

def add_lex_disambig(entries: Sequence[Tuple[str, Tuple[str, ...]]]
                     ) -> Tuple[List[Tuple[str, Tuple[str, ...]]], int]:
    """Append ``#k`` disambiguation symbols to pronunciations that are
    duplicated or prefixes of other pronunciations (Kaldi
    ``add_lex_disambig.pl``).  Returns (new entries, max k used)."""
    counts: Dict[tuple, int] = defaultdict(int)
    prefixes: Set[tuple] = set()
    for _, pron in entries:
        counts[tuple(pron)] += 1
        for i in range(1, len(pron)):
            prefixes.add(tuple(pron[:i]))

    last_used: Dict[tuple, int] = defaultdict(int)
    max_disambig = 0
    out: List[Tuple[str, Tuple[str, ...]]] = []
    for word, pron in entries:
        pron = tuple(pron)
        if counts[pron] > 1 or pron in prefixes:
            k = last_used[pron] + 1
            last_used[pron] = k
            max_disambig = max(max_disambig, k)
            out.append((word, pron + (f"#{k}",)))
        else:
            out.append((word, pron))
    return out, max_disambig


def make_lexicon_fst(entries: Sequence[Tuple[str, Sequence[str]]],
                     char_syms: Dict[str, int],
                     word_syms: Dict[str, int]) -> Fst:
    """Lexicon transducer (Kaldi ``make_lexicon_fst.pl``, no silence):
    a loop state with one character path per word; the word label rides
    the first arc, the path returns to the loop state."""
    fst = Fst(isyms=dict(char_syms), osyms=dict(word_syms))
    loop = 0
    fst.start = loop
    fst.arcs[loop] = []
    fst.set_final(loop, 0.0)
    next_state = [1]
    for word, pron in entries:
        if word not in word_syms:
            raise KeyError(f"word {word!r} missing from word symbols")
        state = loop
        for i, ch in enumerate(pron):
            if ch not in char_syms:
                raise KeyError(f"char {ch!r} missing from char symbols")
            olabel = word_syms[word] if i == 0 else EPSILON
            dst = loop if i == len(pron) - 1 else next_state[0]
            if dst != loop:
                next_state[0] += 1
            fst.add_arc(state, char_syms[ch], olabel, 0.0, dst)
            state = dst
        if len(pron) == 0:
            raise ValueError(f"empty pronunciation for {word!r}")
    return fst


# ---------------------------------------------------------------------------
# equivalence testing helper (for parity tests)
# ---------------------------------------------------------------------------

def path_cost(fst: Fst, ilabels: Sequence[int], tropical: bool = True,
              ignore_labels: Iterable[int] = ()) -> float:
    """Cost of accepting ``ilabels`` (best path if tropical, else
    log-sum over paths), treating ``ignore_labels`` like epsilon.
    Host-side oracle used to check construction steps preserve
    weighted-language semantics."""
    plus = _plus(not tropical)
    ignore = set(ignore_labels) | {EPSILON}

    def expand_free(states: Dict[int, float]) -> Dict[int, float]:
        result = dict(states)
        queue = deque(states.items())
        pops, limit = 0, 1000 * fst.num_states + 100_000
        while queue:
            s, w = queue.popleft()
            pops += 1
            if pops > limit:
                raise ValueError("free-label cycle in path_cost")
            if result.get(s, INF_COST) < w - 1e-12:
                continue
            for a in fst.state_arcs(s):
                if a.ilabel in ignore:
                    nw = w + a.weight
                    old = result.get(a.nextstate)
                    merged = nw if old is None else plus(old, nw)
                    if old is None or merged < old - 1e-12:
                        result[a.nextstate] = merged
                        queue.append((a.nextstate, merged))
        return result

    states = expand_free({fst.start: 0.0})
    for sym in ilabels:
        nxt: Dict[int, float] = {}
        for s, w in states.items():
            for a in fst.state_arcs(s):
                if a.ilabel == sym:
                    nw = w + a.weight
                    old = nxt.get(a.nextstate)
                    nxt[a.nextstate] = nw if old is None else plus(old, nw)
        states = expand_free(nxt)
        if not states:
            return INF_COST
    total = INF_COST
    for s, w in states.items():
        if s in fst.finals:
            total = plus(total, w + fst.finals[s])
    return total
