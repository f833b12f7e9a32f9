"""Character-level decoding-graph builder: ARPA + lexicon -> LG_pushed.

OpenFST-free, in-process equivalent of the reference's
``exp/wsj/create_character_decoding_graph.sh`` =
``create_character_lexicon.sh`` + ``bin/lm2fst.sh``:

1. symbol tables: ``chars.txt`` (<eps> + the network alphabet),
   ``words.txt`` (<eps> + LM unigrams + #0 + <s> + </s>)
   (``create_character_lexicon.sh``);
2. lexicon: every LM word spelled in allowed characters, terminated by
   ``<spc>``; ``<UNK>`` pronounced ``<noise> <spc>``;
3. ``G``: backoff word n-gram acceptor with ``#0`` on backoff arcs
   (``arpa2fst | eps2disambig.pl | s2eps.pl`` — ``</s>`` becomes final
   weights, which is the s2eps-compiled semantics);
4. ``L_disambig``: lexicon transducer with ``add_lex_disambig`` symbols
   and ``#0:#0`` self-loops;
5. ``LG_no_eol = minimize(rmeps(rmsymbols(det_log(L o G))))``
   (``bin/lm2fst.sh:76-82``);
6. the ``eol_to_spc`` adapter (the network emits ``<eol>`` where the
   graph wants a final ``<spc>``) composed on the left, optionally
   determinized (``bin/lm2fst.sh:85-124``);
7. ``LG_pushed = rmeps(push_weights(LG))`` (``bin/lm2fst.sh:126-129``),
   plus dense device tables for the on-device shallow-fusion runtime.

The port's copy of ``attention_lvcsr_tpu/ops/lm_graph.py``, code for code:
both packages write the same files from the same ARPA.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from attention_lvcsr_torch.ops import fst as F
from attention_lvcsr_torch.ops import fst_algo as FA

BAD_NGRAM_PAIRS = {("<s>", "<s>"), ("</s>", "<s>"), ("</s>", "</s>")}


def filter_arpa(arpa: dict) -> dict:
    """Drop malformed n-grams (the ``grep -v`` prefilter in
    ``bin/lm2fst.sh:38-41``)."""
    out = {}
    for order, grams in arpa.items():
        kept = {}
        for words, v in grams.items():
            pairs = set(zip(words, words[1:]))
            if pairs & BAD_NGRAM_PAIRS:
                continue
            kept[words] = v
        out[order] = kept
    return out


def build_symbol_tables(arpa: dict, net_chars: Dict[str, int]
                        ) -> Tuple[Dict[str, int], Dict[str, int]]:
    """chars.txt / words.txt of ``create_character_lexicon.sh``."""
    chars = {"<eps>": 0}
    for ch, _ in sorted(net_chars.items(), key=lambda kv: kv[1]):
        chars[ch] = len(chars)
    words = {"<eps>": 0}
    for (word,) in arpa.get(1, {}):
        if word in ("<s>", "</s>"):
            continue
        words[word] = len(words)
    for special in ("#0", "<s>", "</s>"):
        words[special] = len(words)
    return chars, words


def build_lexicon(words: Dict[str, int], net_chars: Dict[str, int],
                  spc: str = "<spc>", noise: str = "<noise>"
                  ) -> List[Tuple[str, Tuple[str, ...]]]:
    """word -> character pronunciation (+ terminating <spc>); unknown
    characters are dropped like the ``tr -c -d`` filter."""
    allowed = {ch for ch in net_chars
               if not (ch.startswith("<") and ch.endswith(">"))}
    entries: List[Tuple[str, Tuple[str, ...]]] = []
    if noise in net_chars:
        entries.append(("<UNK>", (noise, spc)))
    for word in words:
        if word.startswith("<") or word.startswith("#") or word == "<eps>":
            continue
        pron = tuple(ch for ch in word if ch in allowed)
        if not pron:
            continue
        entries.append((word, pron + (spc,)))
    return entries


def build_eol_adapter(chars: Dict[str, int], use_bol: bool = False,
                      eol: str = "<eol>", bol: str = "<bol>",
                      spc: str = "<spc>") -> F.Fst:
    """The ``eol_to_spc`` FST of ``bin/lm2fst.sh:91-112``: pass regular
    characters through, map the terminating ``<eol>`` to ``<spc>``.
    With ``use_bol`` the initial ``<bol>`` readout(s) are consumed."""
    fst = F.Fst(isyms=dict(chars), osyms=dict(chars))
    if use_bol:
        if bol not in chars:
            raise KeyError(f"{bol} missing from character table")
        fst.start = 0
        fst.add_arc(0, chars[bol], F.EPSILON, 0.0, 1)
        # dead-end faithful to the reference's `0 0 <bol> <bol>` line:
        # emitting <bol> into LG never completes, connect() prunes it.
        fst.add_arc(0, chars[bol], chars[bol], 0.0, 0)
        loop = 1
    else:
        # the reference writes `0 1 <eps> <eps>` + an eps self-loop; both
        # are no-ops, so start directly at the loop state.
        fst.start = 0
        loop = 0
    for ch, code in chars.items():
        if ch in ("<eps>", eol, bol) or ch.startswith("#"):
            continue
        fst.add_arc(loop, code, code, 0.0, loop)
    if eol not in chars or spc not in chars:
        raise KeyError(f"{eol}/{spc} missing from character table")
    final = loop + 1
    fst.add_arc(loop, chars[eol], chars[spc], 0.0, final)
    fst.set_final(final, 0.0)
    return fst


def build_decoding_graph(arpa, net_chars: Dict[str, int],
                         out_dir: Optional[str] = None,
                         use_bol: bool = False,
                         deterministic: bool = False,
                         max_states: int = 7,
                         no_transition_cost: float = 1e12,
                         spc: str = "<spc>", eol: str = "<eol>"):
    """Build the full character decoding graph; returns a dict with the
    intermediate FSTs, symbol tables, and the packed device tables.

    ``arpa`` is a path or parsed dict; ``net_chars`` maps the network's
    characters to output ids (the dataset ``value_map``).
    """
    if not isinstance(arpa, dict):
        arpa = F.read_arpa(arpa)
    arpa = filter_arpa(arpa)
    chars, words = build_symbol_tables(arpa, net_chars)

    # --- G: word n-gram acceptor with #0 backoff arcs
    g = F.arpa_to_fst(arpa, words)
    g = FA.eps_to_disambig(g, words["#0"])

    # --- L_disambig
    entries = build_lexicon(words, net_chars, spc=spc)
    entries_disambig, ndisambig = FA.add_lex_disambig(entries)
    chars_disambig = dict(chars)
    for k in range(0, ndisambig + 2):
        chars_disambig[f"#{k}"] = len(chars_disambig)
    l_fst = FA.make_lexicon_fst(entries_disambig, chars_disambig, words)
    l_fst = FA.add_self_loops(l_fst, chars_disambig["#0"], words["#0"])

    # --- LG_no_eol = min(rmeps(rmsyms(det_log(L o G))))
    lg = FA.compose(l_fst, g)
    lg = FA.determinize_star(lg, use_log=True)
    disambig_ids = [v for k, v in chars_disambig.items()
                    if k.startswith("#")]
    lg = FA.remove_input_symbols(lg, disambig_ids)
    lg = FA.rm_epsilon(lg)
    lg_no_eol = FA.minimize_encoded(lg)

    # --- eol adapter, LG, LG_pushed
    adapter = build_eol_adapter(chars_disambig, use_bol=use_bol,
                                eol=eol, spc=spc)
    lg = FA.compose(adapter, lg_no_eol)
    if deterministic:
        lg = FA.determinize_star(lg, use_log=True)
    lg = FA.minimize_encoded(lg)
    lg_pushed = FA.rm_epsilon(FA.push_weights(lg))

    # --- device tables: nn symbol id -> chars.txt label (dense for small
    # graphs, CSR beyond the dense cell budget — production trigram LGs)
    remap = {nn_id: chars[ch] for ch, nn_id in net_chars.items()
             if ch in chars}
    packed = F.pack_fst_auto(lg_pushed, remap,
                             num_nn_symbols=max(net_chars.values()) + 1,
                             max_states=max_states,
                             no_transition_cost=no_transition_cost)

    result = {
        "chars": chars, "chars_disambig": chars_disambig, "words": words,
        "lexicon": entries_disambig, "G": g, "L_disambig": l_fst,
        "LG_no_eol": lg_no_eol, "LG": lg, "LG_pushed": lg_pushed,
        "packed": packed,
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

        def path(name):
            return os.path.join(out_dir, name)

        F.write_symbols(path("chars.txt"), chars)
        F.write_symbols(path("chars_disambig.txt"), chars_disambig)
        F.write_symbols(path("words.txt"), words)
        with open(path("lexicon_disambig.txt"), "w") as f:
            for word, pron in entries_disambig:
                f.write(f"{word} {' '.join(pron)}\n")
        F.write_fst_text(g, path("G.fst.txt"))
        F.write_fst_text(l_fst, path("L_disambig.fst.txt"))
        for name, f_obj in (("LG_no_eol.fst.txt", lg_no_eol),
                            ("LG.fst.txt", lg),
                            ("LG_pushed.fst.txt", lg_pushed)):
            # numeric labels for machine reload (+ .syms char table), and
            # a *_withsyms variant for inspection (the reference's
            # LG_pushed_withsyms.fst role)
            F.write_fst_text(f_obj, path(name))
            F.write_symbols(path(name + ".syms"), chars)
            F.write_fst_text(f_obj, path(name.replace(".fst.txt",
                                                      "_withsyms.fst.txt")),
                             isyms=chars, osyms=words)
        F.save_packed(path("LG_pushed.npz"), packed)
    return result
