"""Dictionary-constrained decoding in the port against the JAX package: a
``DecodeConstraint`` built from words (the same acceptor tables), decoded
through the module path (``use_pallas: never``) and through the fused
score step (``use_pallas: interpret`` in JAX, the TPU kernel in interpret
mode; the port's ``fused_decode_score`` plain version), and a host
``validate_solution_function`` called at insertion time."""
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_net_config
from attention_lvcsr_tpu.models.recognizer import \
    SpeechRecognizer as JaxRecognizer
from attention_lvcsr_tpu.search.beam import \
    DecodeConstraint as JaxDecodeConstraint
from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
from attention_lvcsr_torch.search.beam import DecodeConstraint

INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.5],
                        "biases_init": ["constant", 0.0],
                        "rec_weights_init": ["orthogonal"]}}
EOS = 31
CHARS = [chr(ord("a") + i) for i in range(26)] + [
    "<spc>", "'", ".", "-", "<bol>", "<eol>"]
CHAR_MAP = {c: i for i, c in enumerate(CHARS)}
_CACHE = {}


def _words(seed=0, n=12):
    rng = np.random.RandomState(seed)
    return sorted({"".join(rng.choice(list("abcdefgh"),
                                      size=rng.randint(1, 4)))
                   for _ in range(n)})


def _recognizers(mode):
    if mode not in _CACHE:
        cfg = _tiny_net_config()
        jax_rec = JaxRecognizer(dict(cfg, use_pallas=mode), init_config=INIT,
                                seed=5)
        p = jax_rec.params["params"]["generator"]["readout"]["post_merge_0"]
        p["bias"] = p["bias"].at[EOS].add(3.0)
        port = SpeechRecognizer(dict(cfg, use_pallas=mode), init_config=INIT,
                                seed=5, device="cpu")
        port.net.generator.readout.post_merge_0.bias.data[EOS] += 3.0
        _CACHE[mode] = (jax_rec, port)
    return _CACHE[mode]


def _batch():
    rng = np.random.RandomState(4)
    x = rng.randn(3, 41, 12).astype(np.float32)
    m = (np.arange(41)[None] < np.array([[41], [33], [19]])).astype("f")
    return x, m


def _finished(out, rows=3):
    return {(u, k): (tuple(int(t) for t in
                           out["done_out"][u, k, :out["done_len"][u, k]]),
                     float(out["done_cost"][u, k]))
            for u, k in zip(*np.nonzero(out["done_valid"])) if u < rows}


def _assert_same(got, ref):
    assert int(got["steps"]) == int(ref["steps"])
    ref_f, got_f = _finished(ref), _finished(got)
    assert ref_f, "vacuous: nothing finished"
    assert sorted(got_f) == sorted(ref_f)
    for key, (tokens, cost) in ref_f.items():
        assert got_f[key][0] == tokens, key
        np.testing.assert_allclose(got_f[key][1], cost, rtol=1e-5, atol=1e-5)


def _accepted(constraint, tokens):
    """Host walk: every symbol but the final EOS has a transition (a
    leading EOS is the ignored BOS), and the EOS leaves a final state."""
    body = list(tokens[:-1])
    if body and body[0] == EOS:
        body = body[1:]
    state = 0
    for t in body:
        state = int(constraint.trans[state, t])
        if state < 0:
            return False
    return tokens[-1] == EOS and bool(constraint.final[state])


def test_constraint_tables_match_jax():
    words = _words()
    got = DecodeConstraint.from_words(words, CHAR_MAP, 32)
    ref = JaxDecodeConstraint.from_words(words, CHAR_MAP, 32)
    np.testing.assert_array_equal(got.trans, ref.trans)
    np.testing.assert_array_equal(got.final, ref.final)


@pytest.mark.parametrize("mode", ["never", "interpret"])
@pytest.mark.parametrize("search", [
    dict(char_discount=0.1),
    dict(char_discount=0.5, stop_on="optimistic_future_cost")],
    ids=["patience", "optimistic"])
def test_constrained_beam_search_matches_jax(mode, search):
    jax_rec, port = _recognizers(mode)
    jax_rec.init_beam_search(4)
    port.init_beam_search(4)
    words = _words()
    x, m = _batch()
    ref = jax_rec.beam_search(
        x, m, as_arrays=True, **search,
        validate_solution_function=JaxDecodeConstraint.from_words(
            words, CHAR_MAP, 32))
    constraint = DecodeConstraint.from_words(words, CHAR_MAP, 32)
    got = port.beam_search(x, m, as_arrays=True, **search,
                           validate_solution_function=constraint)
    _assert_same(got, ref)
    for tokens, _ in _finished(got).values():
        assert _accepted(constraint, tokens), tokens


def test_fused_route_is_taken_only_when_asked():
    """``use_pallas`` "fused"/"interpret" adds the fused score tables to
    the contexts; "never" leaves the module path."""
    x, m = (torch.tensor(a) for a in _batch())
    for mode, fused in (("interpret", True), ("never", False)):
        _, port = _recognizers(mode)
        with torch.inference_mode():
            ctx = port.net.decode_contexts(x, m)
        assert ("fused_tables" in ctx) == fused, mode


@pytest.mark.parametrize("mode", ["never", "interpret"])
def test_host_validator_matches_jax(mode):
    """Candidates whose length (EOL included) is odd are rejected; both
    packages see the same candidates and keep the same survivors."""
    jax_rec, port = _recognizers(mode)
    jax_rec.init_beam_search(3)
    port.init_beam_search(3)
    x, m = _batch()
    seen = {"jax": [], "port": []}

    def validator(who):
        def fn(feats, symbols):
            assert feats.shape == (100, 12)
            seen[who].append((round(float(np.abs(feats).sum()), 3),
                              tuple(int(s) for s in symbols)))
            return len(symbols) % 2 == 0
        return fn

    ref = jax_rec.beam_search(x, m, as_arrays=True, char_discount=0.1,
                              validate_solution_function=validator("jax"))
    got = port.beam_search(x, m, as_arrays=True, char_discount=0.1,
                           validate_solution_function=validator("port"))
    _assert_same(got, ref)
    assert sorted(seen["port"]) == sorted(seen["jax"])
    assert any(len(s) % 2 for _, s in seen["port"]), "vacuous: none rejected"
    assert all(len(tokens) % 2 == 0 for tokens, _ in _finished(got).values())
