"""LM graph toolbox: the bin/*-LM utilities of the reference as one CLI.

Subcommands (reference counterparts):

* ``arpa2fst``       — ARPA -> text-format G.fst + symbol table
                       (``bin/lm2fst.sh:1-139`` arpa2fst stage)
* ``arpa-to-unigram``— keep the unigram section
                       (``bin/arpa_lm_to_unigram_lm.py``)
* ``arpa-to-dict``   — unigram section with weights removed
                       (``bin/arpa_lm_to_dict_lm.py``)
* ``dict-fst``       — word list -> char-trie dictionary FST
                       (``create_character_lexicon.sh`` role)
* ``create-lexicon`` — words.txt / characters.txt / lexicon.txt from ARPA
                       (``bin/create_lexicon.py``)
* ``explain``        — cost of a symbol sequence through an FST
                       (``bin/explain_lm.py``)
* ``check-zero``     — all arcs weight-free?
                       (``bin/check_all_fst_weights_are_zero.py``)
* ``strip-weights``  — zero out all weights (``bin/remove_fst_weights.py``)
* ``pack``           — precompute dense device tables -> .npz

The port's copy of ``tools/lm_tools.py`` over the port's ``ops/fst.py``,
``ops/fst_algo.py`` and ``ops/lm_graph.py``: the same subcommands,
arguments, files and standard output, with no JAX::

    python -m attention_lvcsr_torch.cli.lm_tools arpa2fst lm.arpa G.fst.txt
    python -m attention_lvcsr_torch.cli.lm_tools build-lg lm.arpa \\
        net_chars.txt out_dir
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from attention_lvcsr_torch.ops import fst as F
from attention_lvcsr_torch.ops import fst_algo as FA


def cmd_arpa2fst(args):
    arpa = F.read_arpa(args.arpa)
    tokens = sorted({w for grams in arpa.values() for ng in grams
                     for w in ng if w not in ("<s>", "</s>")})
    syms = {"<eps>": 0}
    for t in tokens:
        syms[t] = len(syms)
    fst = F.arpa_to_fst(arpa, syms)
    F.write_fst_text(fst, args.out)
    F.write_symbols(args.out + ".syms", syms)
    print(f"wrote {args.out} ({fst.num_states} states) + .syms")


def _unigram_lines(path, strip_weights):
    out = ["\\data\\"]
    with open(path) as f:
        lines = f.readlines()
    n1 = next(l.strip() for l in lines if l.strip().startswith("ngram 1="))
    out.append(n1)
    out.append("\\1-grams:")
    in_uni = False
    for line in lines:
        s = line.strip()
        if s.startswith("\\1-grams"):
            in_uni = True
            continue
        if in_uni:
            if s.startswith("\\"):
                break
            if not s:
                continue
            parts = s.split()
            if strip_weights:
                out.append(f"0 {parts[1]}")
            else:
                out.append(" ".join(parts[:2]))
    out.append("\\end\\")
    return out


def cmd_arpa_to_unigram(args):
    out = args_outfile(args)
    for line in _unigram_lines(args.arpa, strip_weights=False):
        print(line, file=out)


def cmd_arpa_to_dict(args):
    out = args_outfile(args)
    for line in _unigram_lines(args.arpa, strip_weights=True):
        print(line, file=out)


def cmd_dict_lm_from_text(args):
    """Uniform dictionary "LM" over every word of a transcript file
    (reference bin/create_dict_lm_from_text.sh): lines are
    ``uttid w1 w2 ...``; all words get log-prob 0."""
    words = set()
    with open(args.text) as f:
        for line in f:
            words.update(line.split()[1:])
    words.discard("<UNK>")
    out = args_outfile(args)
    print("\\data\\", file=out)
    print(f"ngram 1={len(words) + 3}", file=out)
    print("\\1-grams:", file=out)
    for w in ("<UNK>", "</s>", "<s>"):
        print(f"0 {w}", file=out)
    for w in sorted(words):
        print(f"0 {w}", file=out)
    print("\\end\\", file=out)


def args_outfile(args):
    return open(args.out, "w") if args.out != "-" else sys.stdout


def cmd_dict_fst(args):
    with open(args.words) as f:
        words = [l.split()[0] for l in f if l.strip()]
    chars = {"<eps>": 0, "<spc>": 1}
    for w in words:
        for ch in w:
            chars.setdefault(ch, len(chars))
    fst = F.dict_char_lm_fst(words, chars)
    F.write_fst_text(fst, args.out)
    F.write_symbols(args.out + ".syms", chars)
    print(f"wrote {args.out} ({fst.num_states} states) + .syms")


def cmd_create_lexicon(args):
    arpa = F.read_arpa(args.arpa)
    chars = {"<eps>": 0, "<spc>": 1, "#0": 2}
    words = {"<eps>": 0, "<UNK>": 1, "</s>": 2, "<s>": 3, "<spc>": 4,
             "#0": 5}
    with open("lexicon.txt", "w") as fl:
        for (word,) in arpa.get(1, {}):
            if word.startswith("<") or word.startswith("#"):
                continue
            words[word] = len(words)
            fl.write(f"{word} {' '.join(word)}\n")
            for ch in word:
                chars.setdefault(ch, len(chars))
    F.write_symbols("words.txt", words)
    F.write_symbols("characters.txt", chars)
    print(f"wrote lexicon.txt, words.txt ({len(words)}), "
          f"characters.txt ({len(chars)})")


def _load(args):
    import os
    isyms = None
    if os.path.exists(args.fst + ".syms"):
        isyms = F.read_symbols(args.fst + ".syms")
    return F.read_fst_text(args.fst, isyms=isyms), isyms


def cmd_explain(args):
    fst, isyms = _load(args)
    tokens = args.symbols
    if isyms:
        seq = [isyms[t] if t in isyms else int(t) for t in tokens]
    else:
        seq = [int(t) for t in tokens]
    cost = fst.explain(seq, verbose=args.verbose, tropical=args.tropical)
    print(f"total cost: {cost}")


def cmd_check_zero(args):
    fst, _ = _load(args)
    bad = [(s, a) for s, arcs in fst.arcs.items() for a in arcs
           if abs(a.weight) > 1e-9]
    bad += [(s, w) for s, w in fst.finals.items() if abs(w) > 1e-9]
    if bad:
        print(f"NOT weight-free: {len(bad)} weighted arcs/finals")
        sys.exit(1)
    print("all weights are zero")


def cmd_add_eol(args):
    """Make word ends accept ``<eol>`` (the ``eol_to_spc`` adapter role in
    bin/lm2fst.sh: the network emits <eol> where the LM graph expects a
    final <spc>/end): every state with a <spc> arc also gets an <eol> arc
    into a final sink state."""
    fst, isyms = _load(args)
    if not isyms or "<spc>" not in isyms:
        raise SystemExit("add-eol requires a .syms table with <spc>")
    isyms = dict(isyms)
    if "<eol>" not in isyms:
        isyms["<eol>"] = max(isyms.values()) + 1
    eol = isyms["<eol>"]
    spc = isyms["<spc>"]
    sink = fst.num_states
    for s in list(fst.arcs):
        for a in list(fst.state_arcs(s)):
            if a.ilabel == spc:
                fst.add_arc(s, eol, eol, a.weight, sink)
    fst.set_final(sink, 0.0)
    F.write_fst_text(fst, args.out)
    F.write_symbols(args.out + ".syms", isyms)
    print(f"wrote {args.out} (+<eol> arcs into a final sink)")


def cmd_check_deterministic(args):
    """Extended-determinism check (bin/check_ext_deterministic.py role):
    no state may have two non-epsilon arcs with the same input label, and
    at most one epsilon arc."""
    fst, _ = _load(args)
    problems = 0
    for s, arcs in fst.arcs.items():
        seen = {}
        eps = 0
        for a in arcs:
            if a.ilabel == F.EPSILON:
                eps += 1
                continue
            if a.ilabel in seen:
                problems += 1
                if problems <= 10:
                    print(f"state {s}: duplicate arcs for label {a.ilabel}")
            seen[a.ilabel] = a
        if eps > 1:
            problems += 1
            if problems <= 10:
                print(f"state {s}: {eps} epsilon arcs")
    if problems:
        print(f"NOT ext-deterministic: {problems} problems")
        sys.exit(1)
    print("ext-deterministic")


def cmd_strip_weights(args):
    fst, isyms = _load(args)
    for arcs in fst.arcs.values():
        for a in arcs:
            a.weight = 0.0
    fst.finals = {s: 0.0 for s in fst.finals}
    F.write_fst_text(fst, args.out)
    print(f"wrote {args.out}")


def _load_two(a_path, b_path):
    fa, _ = _load(argparse.Namespace(fst=a_path))
    fb, _ = _load(argparse.Namespace(fst=b_path))
    return fa, fb


def cmd_compose(args):
    fa, fb = _load_two(args.a, args.b)
    out = FA.compose(fa, fb)
    F.write_fst_text(out, args.out)
    print(f"composed -> {args.out} ({out.num_states} states)")


def cmd_determinize(args):
    fst, isyms = _load(args)
    out = FA.determinize_star(fst, use_log=not args.tropical)
    F.write_fst_text(out, args.out)
    if isyms:
        F.write_symbols(args.out + ".syms", isyms)
    print(f"determinized -> {args.out} ({out.num_states} states)")


def cmd_minimize(args):
    fst, isyms = _load(args)
    out = FA.minimize_encoded(fst)
    F.write_fst_text(out, args.out)
    if isyms:
        F.write_symbols(args.out + ".syms", isyms)
    print(f"minimized {fst.num_states} -> {out.num_states} states")


def cmd_push(args):
    fst, isyms = _load(args)
    out = FA.push_weights(fst)
    F.write_fst_text(out, args.out)
    if isyms:
        F.write_symbols(args.out + ".syms", isyms)
    print(f"pushed -> {args.out}")


def cmd_rmepsilon(args):
    fst, isyms = _load(args)
    out = FA.rm_epsilon(fst, use_log=args.log)
    F.write_fst_text(out, args.out)
    if isyms:
        F.write_symbols(args.out + ".syms", isyms)
    print(f"rmepsilon -> {args.out} ({out.num_states} states)")


def cmd_build_lg(args):
    """Full character decoding-graph pipeline (ARPA + net chars ->
    LG_pushed + dense tables), the create_character_decoding_graph.sh
    role, OpenFST-free."""
    from attention_lvcsr_torch.ops.lm_graph import build_decoding_graph
    net_chars = F.read_symbols(args.net_chars)
    result = build_decoding_graph(
        args.arpa, net_chars, out_dir=args.out_dir,
        use_bol=args.use_bol, deterministic=args.deterministic,
        max_states=args.max_states,
        no_transition_cost=args.no_transition_cost)
    lg = result["LG_pushed"]
    print(f"built decoding graph in {args.out_dir}: "
          f"G={result['G'].num_states} L={result['L_disambig'].num_states} "
          f"LG_pushed={lg.num_states} states; "
          f"packed tables {result['packed'].next_state.shape}")


def cmd_pack(args):
    fst, isyms = _load(args)
    if not isyms:
        raise SystemExit("pack requires a .syms symbol table")
    nn_map = {}
    if args.char_map:
        nn_map = F.read_symbols(args.char_map)
    else:
        nn_map = {s: i for i, (s, _) in enumerate(
            sorted(isyms.items(), key=lambda kv: kv[1])) if s != "<eps>"}
    remap = {nn: isyms[ch] for ch, nn in nn_map.items() if ch in isyms}
    packed = F.pack_fst(fst, remap,
                        num_nn_symbols=max(nn_map.values()) + 1,
                        max_states=args.max_states,
                        no_transition_cost=args.no_transition_cost)
    np.savez(args.out, next_state=packed.next_state,
             next_weight=packed.next_weight,
             total_weight=packed.total_weight,
             start_states=packed.start_states,
             start_weights=packed.start_weights)
    print(f"packed {args.fst} -> {args.out} "
          f"tables {packed.next_state.shape}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("arpa2fst")
    a.add_argument("arpa"); a.add_argument("out")
    a.set_defaults(fn=cmd_arpa2fst)

    a = sub.add_parser("arpa-to-unigram")
    a.add_argument("arpa"); a.add_argument("out", default="-", nargs="?")
    a.set_defaults(fn=cmd_arpa_to_unigram)

    a = sub.add_parser("arpa-to-dict")
    a.add_argument("arpa"); a.add_argument("out", default="-", nargs="?")
    a.set_defaults(fn=cmd_arpa_to_dict)

    a = sub.add_parser("dict-fst")
    a.add_argument("words"); a.add_argument("out")
    a.set_defaults(fn=cmd_dict_fst)

    a = sub.add_parser("dict-lm-from-text")
    a.add_argument("text"); a.add_argument("out", default="-", nargs="?")
    a.set_defaults(fn=cmd_dict_lm_from_text)

    a = sub.add_parser("create-lexicon")
    a.add_argument("arpa")
    a.set_defaults(fn=cmd_create_lexicon)

    a = sub.add_parser("explain")
    a.add_argument("fst"); a.add_argument("symbols", nargs="+")
    a.add_argument("--verbose", action="store_true")
    a.add_argument("--tropical", action="store_true")
    a.set_defaults(fn=cmd_explain)

    a = sub.add_parser("check-zero")
    a.add_argument("fst")
    a.set_defaults(fn=cmd_check_zero)

    a = sub.add_parser("add-eol")
    a.add_argument("fst"); a.add_argument("out")
    a.set_defaults(fn=cmd_add_eol)

    a = sub.add_parser("check-deterministic")
    a.add_argument("fst")
    a.set_defaults(fn=cmd_check_deterministic)

    a = sub.add_parser("strip-weights")
    a.add_argument("fst"); a.add_argument("out")
    a.set_defaults(fn=cmd_strip_weights)

    a = sub.add_parser("compose")
    a.add_argument("a"); a.add_argument("b"); a.add_argument("out")
    a.set_defaults(fn=cmd_compose)

    a = sub.add_parser("determinize")
    a.add_argument("fst"); a.add_argument("out")
    a.add_argument("--tropical", action="store_true",
                   help="combine weights tropically instead of log")
    a.set_defaults(fn=cmd_determinize)

    a = sub.add_parser("minimize")
    a.add_argument("fst"); a.add_argument("out")
    a.set_defaults(fn=cmd_minimize)

    a = sub.add_parser("push")
    a.add_argument("fst"); a.add_argument("out")
    a.set_defaults(fn=cmd_push)

    a = sub.add_parser("rmepsilon")
    a.add_argument("fst"); a.add_argument("out")
    a.add_argument("--log", action="store_true")
    a.set_defaults(fn=cmd_rmepsilon)

    a = sub.add_parser("build-lg", help="ARPA + net chars -> LG_pushed "
                       "decoding graph + packed device tables")
    a.add_argument("arpa"); a.add_argument("net_chars")
    a.add_argument("out_dir")
    a.add_argument("--use-bol", action="store_true")
    a.add_argument("--deterministic", action="store_true",
                   help="determinize after the eol adapter (the reference's "
                        "lm2fst.sh --deterministic flag; default off: "
                        "log-semiring determinization there can explode "
                        "state counts)")
    a.add_argument("--max-states", type=int, default=7)
    a.add_argument("--no-transition-cost", type=float, default=1e12)
    a.set_defaults(fn=cmd_build_lg)

    a = sub.add_parser("pack")
    a.add_argument("fst"); a.add_argument("out")
    a.add_argument("--char-map", default=None)
    a.add_argument("--max-states", type=int, default=7)
    a.add_argument("--no-transition-cost", type=float, default=1e12)
    a.set_defaults(fn=cmd_pack)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
