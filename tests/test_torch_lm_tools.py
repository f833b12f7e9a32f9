"""The port's LM-graph tools against the JAX package's: every subcommand of
``python -m attention_lvcsr_torch.cli.lm_tools`` writes the bytes (for
``.npz`` archives, the arrays) and prints the lines of ``tools/lm_tools.py``
on the same inputs; ``build_decoding_graph``'s intermediates and each
``fst_algo`` construction are equal, state for state and arc for arc; a
build does not depend on ``PYTHONHASHSEED``; and an LM-fused beam search
on the graph the port built decodes what JAX's search decodes on the graph
JAX built.

Inputs: ``tests/test_fst_algo.py``'s toy bigram (``TOY_ARPA``) and
``chip_smoke.py``'s seeded 60-word trigram (``word_trigram_arpa``), the
ARPA that the on-card phase builds its graph from."""
import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from attention_lvcsr_tpu.ops import fst as jax_fst
from attention_lvcsr_tpu.ops import fst_algo as jax_fa
from attention_lvcsr_tpu.ops import lm_graph as jax_graph
from attention_lvcsr_torch.cli import lm_tools as port_tools
from attention_lvcsr_torch.ops import fst as port_fst
from attention_lvcsr_torch.ops import fst_algo as port_fa
from attention_lvcsr_torch.ops import lm_graph as port_graph
from chip_smoke import CHAR_MAP, word_trigram_arpa
from test_fst_algo import NET_CHARS, TOY_ARPA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tools():
    spec = importlib.util.spec_from_file_location(
        "jax_lm_tools", os.path.join(ROOT, "tools", "lm_tools.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_TOOLS = _jax_tools()


def _symbols(path, syms):
    with open(path, "w") as f:
        f.write("".join(f"{s} {i}\n" for s, i in syms.items()))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Per ARPA ("toy", "words60"): the ARPA, the network's characters
    (with ``<bol>`` for ``--use-bol``), a word list, a transcript, and the
    FST files the other subcommands read, written by the JAX tool."""
    out = {}
    for name, text, chars in (
            ("toy", "\n".join(TOY_ARPA), dict(NET_CHARS, **{"<bol>": 9})),
            ("words60", word_trigram_arpa()[0], CHAR_MAP)):
        d = tmp_path_factory.mktemp(name)
        (d / "lm.arpa").write_text(text)
        _symbols(str(d / "net_chars.txt"), chars)
        arpa = jax_fst.read_arpa(str(d / "lm.arpa"))
        words = sorted(w for (w,) in arpa[1] if not w.startswith("<"))
        (d / "words.list").write_text("".join(f"{w}\n" for w in words))
        rng = np.random.RandomState(len(words))
        (d / "text.txt").write_text("".join(
            f"utt{i} " + " ".join(rng.choice(words, size=4)) + "\n"
            for i in range(5)))
        with contextlib.redirect_stdout(io.StringIO()), \
                _cwd(str(d)):
            JAX_TOOLS.main(["arpa2fst", "lm.arpa", "G.fst.txt"])
            JAX_TOOLS.main(["dict-fst", "words.list", "dict.fst.txt"])
            JAX_TOOLS.main(["build-lg", "lm.arpa", "net_chars.txt", "lg"])
            JAX_TOOLS.main(["compose", "lg/L_disambig.fst.txt",
                            "lg/G.fst.txt", "LoG.fst.txt"])
        out[name] = (str(d), words)
    return out


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _run(main, argv, cwd):
    """stdout and exit code of ``main(argv)`` run in ``cwd``."""
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf), _cwd(cwd):
        try:
            main(argv)
        except SystemExit as exc:
            code = exc.code
    return buf.getvalue(), code


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


def _same_files(got_dir, ref_dir):
    names = _files(ref_dir)
    assert _files(got_dir) == names
    for name in names:
        got, ref = (os.path.join(d, name) for d in (got_dir, ref_dir))
        if name.endswith(".npz"):
            with np.load(got) as a, np.load(ref) as b:
                assert a.files == b.files, name
                for key in b.files:
                    np.testing.assert_array_equal(a[key], b[key],
                                                  err_msg=f"{name}:{key}")
        else:
            with open(got, "rb") as a, open(ref, "rb") as b:
                assert a.read() == b.read(), name


LG = "lg/LG.fst.txt"
PUSHED = "lg/LG_pushed.fst.txt"
BOTH, TOY = ("toy", "words60"), ("toy",)

# (case, argv, ARPAs): every one of the 18 subcommands, some in more than
# one form; ``{d}`` is the input directory, ``{spell}`` the letters of the
# first word.  The toy ARPA alone takes the forms whose 60-word inputs
# would cost seconds each (L o G determinized, LG's epsilons removed, the
# <bol> graph)
CASES = [
    ("arpa2fst", ["arpa2fst", "{d}/lm.arpa", "G.fst.txt"], BOTH),
    ("arpa-to-unigram", ["arpa-to-unigram", "{d}/lm.arpa", "uni.arpa"],
     BOTH),
    ("arpa-to-unigram-stdout", ["arpa-to-unigram", "{d}/lm.arpa"], BOTH),
    ("arpa-to-dict", ["arpa-to-dict", "{d}/lm.arpa", "dict.arpa"], BOTH),
    ("dict-fst", ["dict-fst", "{d}/words.list", "dict.fst.txt"], BOTH),
    ("dict-lm-from-text", ["dict-lm-from-text", "{d}/text.txt", "d.arpa"],
     BOTH),
    ("create-lexicon", ["create-lexicon", "{d}/lm.arpa"], BOTH),
    ("explain", ["explain", "{d}/" + PUSHED, "{spell}", "<eol>"], BOTH),
    ("explain-tropical-verbose", ["explain", "{d}/" + PUSHED, "{spell}",
                                  "<eol>", "--tropical", "--verbose"], BOTH),
    ("check-zero-weighted", ["check-zero", "{d}/G.fst.txt"], BOTH),
    ("check-zero-free", ["check-zero", "{d}/lg/L_disambig.fst.txt"], BOTH),
    ("add-eol", ["add-eol", "{d}/dict.fst.txt", "eol.fst.txt"], BOTH),
    ("check-deterministic-LG", ["check-deterministic", "{d}/" + LG], BOTH),
    ("check-deterministic-LoG", ["check-deterministic", "{d}/LoG.fst.txt"],
     BOTH),
    ("strip-weights", ["strip-weights", "{d}/" + PUSHED, "s.fst.txt"], BOTH),
    ("compose", ["compose", "{d}/lg/L_disambig.fst.txt", "{d}/lg/G.fst.txt",
                 "LoG.fst.txt"], BOTH),
    ("determinize-LoG", ["determinize", "{d}/LoG.fst.txt", "det.fst.txt"],
     TOY),
    ("determinize-LoG-tropical", ["determinize", "{d}/LoG.fst.txt",
                                  "det.fst.txt", "--tropical"], TOY),
    ("determinize-G", ["determinize", "{d}/lg/G.fst.txt", "det.fst.txt"],
     BOTH),
    ("minimize", ["minimize", "{d}/" + LG, "min.fst.txt"], BOTH),
    ("push", ["push", "{d}/" + LG, "pushed.fst.txt"], BOTH),
    ("rmepsilon", ["rmepsilon", "{d}/" + LG, "rmeps.fst.txt"], TOY),
    ("rmepsilon-log", ["rmepsilon", "{d}/lg/G.fst.txt", "rmeps.fst.txt",
                       "--log"], BOTH),
    ("build-lg", ["build-lg", "{d}/lm.arpa", "{d}/net_chars.txt", "out"],
     BOTH),
    ("build-lg-bol-deterministic", [
        "build-lg", "{d}/lm.arpa", "{d}/net_chars.txt", "out", "--use-bol",
        "--deterministic", "--max-states", "5", "--no-transition-cost",
        "30"], TOY),
    ("pack", ["pack", "{d}/G.fst.txt", "G.packed.npz"], BOTH),
    ("pack-char-map", ["pack", "{d}/" + PUSHED, "LG.npz", "--char-map",
                       "{d}/net_chars.txt", "--no-transition-cost", "20"],
     BOTH),
]
SUBCOMMANDS = {
    "arpa2fst", "arpa-to-unigram", "arpa-to-dict", "dict-fst",
    "dict-lm-from-text", "create-lexicon", "explain", "check-zero",
    "add-eol", "check-deterministic", "strip-weights", "compose",
    "determinize", "minimize", "push", "rmepsilon", "build-lg", "pack"}


def test_cases_cover_every_subcommand():
    """The cases run each of the 18 subcommands, and both tools define
    exactly those."""
    assert {argv[0] for _, argv, _ in CASES} == SUBCOMMANDS
    for path in (os.path.join(ROOT, "tools", "lm_tools.py"),
                 port_tools.__file__):
        with open(path) as f:
            defined = set(re.findall(r'add_parser\(\s*"([a-z0-9-]+)"',
                                     f.read()))
        assert defined == SUBCOMMANDS, path


@pytest.mark.parametrize("case,argv,arpa", [
    (case, argv, arpa) for case, argv, arpas in CASES for arpa in arpas],
    ids=[f"{case}-{arpa}" for case, _, arpas in CASES for arpa in arpas])
def test_subcommand_writes_what_jax_writes(case, argv, arpa, inputs,
                                           tmp_path):
    d, words = inputs[arpa]
    args = []
    for a in argv:
        args += list(words[0]) if a == "{spell}" else [a.format(d=d)]
    outs = {}
    for name, main in (("port", port_tools.main), ("jax", JAX_TOOLS.main)):
        cwd = tmp_path / name
        cwd.mkdir()
        outs[name] = _run(main, args, str(cwd))
    assert outs["port"] == outs["jax"]
    assert outs["jax"][0] or _files(str(tmp_path / "jax")), \
        "vacuous: the JAX tool printed and wrote nothing"
    if case.startswith("explain"):
        assert "total cost: 1e+30" not in outs["jax"][0], \
            "vacuous: the graph refused the word"
    _same_files(str(tmp_path / "port"), str(tmp_path / "jax"))


def _fst_tuple(fst):
    return (fst.start,
            {s: [(a.ilabel, a.olabel, a.weight, a.nextstate) for a in arcs]
             for s, arcs in fst.arcs.items()},
            dict(fst.finals))


@pytest.mark.parametrize("deterministic", [False, True],
                         ids=["nondet", "det"])
@pytest.mark.parametrize("use_bol", [False, True], ids=["no_bol", "bol"])
def test_build_decoding_graph_intermediates_match_jax(deterministic,
                                                      use_bol, tmp_path):
    net_chars = dict(NET_CHARS, **{"<bol>": 9})
    results = {}
    for name, module in (("port", port_graph), ("jax", jax_graph)):
        out_dir = str(tmp_path / name)
        results[name] = module.build_decoding_graph(
            list(TOY_ARPA), net_chars, out_dir=out_dir, use_bol=use_bol,
            deterministic=deterministic, no_transition_cost=20.0)
    got, ref = results["port"], results["jax"]
    assert sorted(got) == sorted(ref)
    for key in ("chars", "chars_disambig", "words", "lexicon"):
        assert got[key] == ref[key], key
    for key in ("G", "L_disambig", "LG_no_eol", "LG", "LG_pushed"):
        assert _fst_tuple(got[key]) == _fst_tuple(ref[key]), key
    assert ref["LG_pushed"].num_states > 3
    for name in ("next_state", "next_weight", "total_weight",
                 "start_states", "start_weights"):
        np.testing.assert_array_equal(getattr(got["packed"], name),
                                      getattr(ref["packed"], name))
    _same_files(str(tmp_path / "port"), str(tmp_path / "jax"))


def _relabeler(module, seed, n_labels=3):
    """Two states, both final, that map each label to another with a
    seeded weight and emit a label on an epsilon input between them: the
    right operand of ``compose``, which keeps every path of the left."""
    rng = np.random.RandomState(seed)
    fst = module.Fst()
    fst.start = 0
    for s in (0, 1):
        for label in range(1, n_labels + 1):
            fst.add_arc(s, label, label % n_labels + 1,
                        round(float(rng.rand()), 3), s)
        fst.set_final(s, round(float(rng.rand()), 3))
    fst.add_arc(0, 0, 2, 0.25, 1)
    return fst


def _random_fst(module, seed, acyclic=True, n_states=7, n_labels=3):
    """A seeded transducer with epsilon arcs on both sides; acyclic (arcs
    to higher states) where the algorithm needs it, else with loops."""
    rng = np.random.RandomState(seed)
    fst = module.Fst()
    fst.start = 0
    for s in range(n_states):
        for _ in range(rng.randint(1, 4)):
            if acyclic:
                if s == n_states - 1:
                    break
                dst = rng.randint(s + 1, n_states)
            else:
                dst = rng.randint(n_states)
            il = int(rng.randint(n_labels + 1)) if acyclic or dst > s \
                else int(rng.randint(1, n_labels + 1))
            fst.add_arc(s, il, int(rng.randint(n_labels + 1)),
                        round(float(rng.rand()), 3), dst)
        if rng.rand() < 0.4 or s == n_states - 1:
            fst.set_final(s, round(float(rng.rand()), 3))
    return fst


FA_CASES = {
    "compose": lambda fa, f, g: fa.compose(f, g),
    "determinize_log": lambda fa, f, g: fa.determinize_star(f, use_log=True),
    "determinize_tropical": lambda fa, f, g: fa.determinize_star(
        f, use_log=False),
    "rm_epsilon": lambda fa, f, g: fa.rm_epsilon(f),
    "rm_epsilon_log": lambda fa, f, g: fa.rm_epsilon(f, use_log=True),
    "minimize_encoded": lambda fa, f, g: fa.minimize_encoded(
        fa.determinize_star(f, use_log=True)),
    "push_weights": lambda fa, f, g: fa.push_weights(f),
    "push_weights_log": lambda fa, f, g: fa.push_weights(f, use_log=True),
    "connect": lambda fa, f, g: fa.connect(f),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(FA_CASES))
def test_fst_algo_matches_jax_on_random_fsts(case, seed):
    acyclic = case.startswith(("determinize", "minimize", "push"))
    outs = {}
    for name, module, fa in (("port", port_fst, port_fa),
                             ("jax", jax_fst, jax_fa)):
        f = _random_fst(module, seed, acyclic=acyclic)
        g = _relabeler(module, seed)
        outs[name] = FA_CASES[case](fa, f, g)
    got, ref = outs["port"], outs["jax"]
    assert _fst_tuple(got) == _fst_tuple(ref)
    assert ref.num_states > 1, "vacuous: the result is empty"
    rng = np.random.RandomState(seed)
    for length in range(5):
        labels = [int(x) for x in rng.randint(1, 4, size=length)]
        for tropical in (True, False):
            assert port_fa.path_cost(got, labels, tropical=tropical) == \
                jax_fa.path_cost(ref, labels, tropical=tropical)


def test_builds_do_not_depend_on_the_hash_seed(inputs, tmp_path):
    """Two builds of the 60-word graph by the port's command line, in
    processes under PYTHONHASHSEED 1 and 2, write the same bytes."""
    d, _ = inputs["words60"]
    procs = []
    for seed in ("1", "2"):
        out = str(tmp_path / seed)
        procs.append((out, subprocess.Popen(
            [sys.executable, "-m", "attention_lvcsr_torch.cli.lm_tools",
             "build-lg", f"{d}/lm.arpa", f"{d}/net_chars.txt", out],
            cwd=ROOT, env=dict(os.environ, PYTHONHASHSEED=seed),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for _, proc in procs:
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stderr[-2000:]
        assert "LG_pushed=" in stdout
    names = _files(procs[0][0])
    assert names == _files(procs[1][0]) and "LG_pushed.npz" in names
    for name in names:
        with open(os.path.join(procs[0][0], name), "rb") as a, \
                open(os.path.join(procs[1][0], name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.fixture(scope="module")
def search_graphs(inputs, tmp_path_factory):
    """The 60-word trigram's LG_pushed.npz over ``chip_smoke.py``'s 32
    network characters, built by each package's command line."""
    d, _ = inputs["words60"]
    out = tmp_path_factory.mktemp("search_lm")
    _run(port_tools.main, ["build-lg", f"{d}/lm.arpa", f"{d}/net_chars.txt",
                           "port"], str(out))
    return {"port": str(out / "port" / "LG_pushed.npz"),
            "jax": f"{d}/lg/LG_pushed.npz"}


def test_lm_search_on_the_port_built_graph_matches_jax(search_graphs):
    """``use_pallas: never`` on both (``tests/test_torch_lm.py`` holds the
    port's search to JAX's interpret route on another graph)."""
    from __graft_entry__ import _tiny_net_config
    from attention_lvcsr_tpu.models.recognizer import \
        SpeechRecognizer as JaxRecognizer
    from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
    from test_torch_lm import EOS, INIT, _assert_same, _batch
    assert EOS == CHAR_MAP["<eol>"]
    lm = {"weight": 0.5, "no_transition_cost": 20.0}
    cfg = dict(_tiny_net_config(), use_pallas="never")
    jax_rec = JaxRecognizer(
        dict(cfg, lm=dict(lm, path=search_graphs["jax"])),
        init_config=INIT, seed=7)
    p = jax_rec.params["params"]["generator"]["readout"]["post_merge_0"]
    p["bias"] = p["bias"].at[EOS].add(3.0)
    port = SpeechRecognizer(dict(cfg, lm=dict(lm, path=search_graphs["port"])),
                            init_config=INIT, seed=7, device="cpu")
    port.net.generator.readout.post_merge_0.bias.data[EOS] += 3.0
    jax_rec.init_beam_search(4)
    port.init_beam_search(4)
    x, m = _batch()
    got = port.beam_search(x, m, as_arrays=True, char_discount=1.0)
    ref = jax_rec.beam_search(x, m, as_arrays=True, char_discount=1.0)
    _assert_same(got, ref)


@pytest.mark.parametrize("arpa", ["toy", "words60"])
def test_host_costs_match_jax(arpa, inputs):
    """``host_costs`` (the host reference of the per-symbol LM costs) over
    the live sets of a walk through LG_pushed, read by each package."""
    d, words = inputs[arpa]
    chars = port_fst.read_symbols(f"{d}/net_chars.txt")
    got_fst, ref_fst = (module.read_fst_text(
        f"{d}/{PUSHED}", isyms=module.read_symbols(f"{d}/{PUSHED}.syms"))
        for module in (port_fst, jax_fst))
    syms = port_fst.read_symbols(f"{d}/{PUSHED}.syms")
    remap = {nn: syms[ch] for ch, nn in chars.items() if ch in syms}
    got_states = ref_states = {got_fst.start: 0.0}
    for ch in words[0] + "\0":
        label = syms["<eol>" if ch == "\0" else ch]
        got = port_fst.host_costs(got_fst, remap, len(chars), got_states,
                                  20.0)
        ref = jax_fst.host_costs(ref_fst, remap, len(chars), ref_states,
                                 20.0)
        np.testing.assert_array_equal(got, ref)
        assert (ref < 20.0).any(), "vacuous: every symbol is refused"
        got_states = got_fst.expand(got_fst.transition(got_states, label))
        ref_states = ref_fst.expand(ref_fst.transition(ref_states, label))
        assert got_states == ref_states
