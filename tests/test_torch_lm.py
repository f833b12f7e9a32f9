"""LM shallow fusion in the port against the JAX package: the packed FST
tables, the FST language model in its three runtimes (dense, CSR
densified at load, windowed CSR) step by step and teacher-forced over
ragged masks, the LM-fused beam search on a padded
batch through both JAX routes (``use_pallas`` "never" and "interpret"),
and ``run.py serve`` with an ``net.lm`` section."""
import io
import json
import os
import socketserver
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_net_config
from attention_lvcsr_tpu.models import lm as jax_lm
from attention_lvcsr_tpu.models.recognizer import \
    SpeechRecognizer as JaxRecognizer
from attention_lvcsr_tpu.ops import fst as jax_fst
from attention_lvcsr_torch.models import lm as port_lm
from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
from attention_lvcsr_torch.ops import fst as port_fst

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.5],
                        "biases_init": ["constant", 0.0],
                        "rec_weights_init": ["orthogonal"]}}
EOS = 31
_CACHE = {}


def _arpa(num_tokens, seed):
    """A random bigram ARPA model over ``c0 .. c{n-1}``, with backoff."""
    rng = np.random.RandomState(seed)
    toks = [f"c{i}" for i in range(num_tokens)]
    uni = {("<s>",): (-99.0, -0.4), ("</s>",): (-1.5, 0.0)}
    for t in toks:
        uni[(t,)] = (float(-1.2 - rng.rand()), float(-0.2 - rng.rand()))
    bi = {}
    for a in toks:
        for c in rng.choice(num_tokens, size=min(4, num_tokens),
                            replace=False):
            bi[(a, toks[c])] = (float(-0.3 - rng.rand()), 0.0)
    return {1: uni, 2: bi}, {t: i + 1 for i, t in enumerate(toks)}


def _packed(module, kind, num_tokens=32, seed=11):
    arpa, syms = _arpa(num_tokens, seed)
    fst = module.arpa_to_fst(arpa, syms)
    remap = {i: i + 1 for i in range(num_tokens)}
    pack = module.pack_fst if kind == "dense" else module.pack_fst_csr
    return pack(fst, remap, num_tokens, no_transition_cost=20.0)


def _post(address, features):
    host, port = address
    buf = io.BytesIO()
    np.save(buf, np.asarray(features, np.float32))
    req = urllib.request.Request(
        f"http://{host}:{port}/decode", data=buf.getvalue(),
        headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def _lm_npz(tmp_dir, kind="dense"):
    path = os.path.join(tmp_dir, f"lm_{kind}.npz")
    if not os.path.exists(path):
        port_fst.save_packed(path, _packed(port_fst, kind))
    return path


@pytest.mark.parametrize("kind", ["dense", "csr"])
def test_packed_tables_match_jax(kind, tmp_path):
    ref = _packed(jax_fst, kind)
    got = _packed(port_fst, kind)
    path = str(tmp_path / "lm.npz")
    port_fst.save_packed(path, got)
    loaded = jax_fst.load_packed(path, 20.0)
    assert type(loaded).__name__ == type(ref).__name__
    names = ["next_state", "next_weight", "total_weight", "start_states",
             "start_weights"] + (["keys"] if kind == "csr" else [])
    for name in names:
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name),
                                      err_msg=name)
        np.testing.assert_array_equal(getattr(loaded, name),
                                      getattr(ref, name), err_msg=name)


@pytest.mark.parametrize("kind,budget,runtime", [
    ("dense", None, "dense"), ("csr", None, "densified"),
    ("csr", "0", "windowed")])
def test_language_model_matches_jax(kind, budget, runtime, tmp_path,
                                    monkeypatch):
    """States, weights and per-symbol costs over six steps of random
    symbols; a zero budget forces the windowed CSR lookups on both."""
    if budget is not None:
        monkeypatch.setenv("LVSR_LM_DENSIFY_BUDGET", budget)
    conf = {"path": _lm_npz(str(tmp_path), kind), "no_transition_cost": 20.0}
    ref_lm = jax_lm.make_language_model(conf, {}, name="lm")
    B = 5
    variables = ref_lm.init(jax.random.PRNGKey(0), B,
                            method=ref_lm.initial_states)
    lm = port_lm.make_language_model(conf, {})
    assert lm.runtime == runtime
    ref = ref_lm.apply(variables, B, method=ref_lm.initial_states)
    got = lm.initial_states(B)
    rng = np.random.RandomState(0)
    for step in range(7):
        for key in ("states", "weights", "add"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{key} at step {step}")
        symbols = rng.randint(0, 32, size=B).astype(np.int32)
        ref = ref_lm.apply(variables, ref, jnp.asarray(symbols),
                           method=ref_lm.one_step)
        got = lm.one_step(got, torch.tensor(symbols))
    assert (got["states"] >= 0).any(), "vacuous: every live set died"


@pytest.mark.parametrize("kind,budget,runtime", [
    ("dense", None, "dense"), ("csr", None, "densified"),
    ("csr", "0", "windowed")])
def test_language_model_evaluate_matches_jax(kind, budget, runtime, tmp_path,
                                             monkeypatch):
    """The teacher-forced pass over ragged label masks: the pre-update
    ``add`` sequence within 1e-5, and the masked steps of ``one_step``
    keep states identical to JAX's (weights within 1e-5)."""
    if budget is not None:
        monkeypatch.setenv("LVSR_LM_DENSIFY_BUDGET", budget)
    conf = {"path": _lm_npz(str(tmp_path), kind), "no_transition_cost": 20.0}
    ref_lm = jax_lm.make_language_model(conf, {}, name="lm")
    B, T = 4, 6
    variables = ref_lm.init(jax.random.PRNGKey(0), B,
                            method=ref_lm.initial_states)
    lm = port_lm.make_language_model(conf, {})
    assert lm.runtime == runtime
    rng = np.random.RandomState(1)
    outputs = rng.randint(0, 32, size=(T, B)).astype(np.int32)
    mask = (np.arange(T)[:, None] < np.array([[6, 4, 1, 0]])).astype("f")
    mask[2, 0] = 0.0                      # a hole inside a live row
    ref = ref_lm.apply(variables, jnp.asarray(outputs), jnp.asarray(mask),
                       method=ref_lm.evaluate)
    got = lm.evaluate(torch.tensor(outputs), torch.tensor(mask))
    assert got["add"].shape == (T, B, 32)
    np.testing.assert_allclose(got["add"].numpy(), np.asarray(ref["add"]),
                               rtol=1e-5, atol=1e-5)
    ref_c = ref_lm.apply(variables, B, method=ref_lm.initial_states)
    got_c = lm.initial_states(B)
    for t in range(T):
        ref_c = ref_lm.apply(variables, ref_c, jnp.asarray(outputs[t]),
                             jnp.asarray(mask[t]), method=ref_lm.one_step)
        got_c = lm.one_step(got_c, torch.tensor(outputs[t]),
                            mask=torch.tensor(mask[t]))
        np.testing.assert_array_equal(got_c["states"].numpy(),
                                      np.asarray(ref_c["states"]))
        np.testing.assert_allclose(got_c["weights"].numpy(),
                                   np.asarray(ref_c["weights"]), rtol=1e-5,
                                   atol=1e-5)
    start = lm.initial_states(B)
    # the row masked throughout keeps its start state; the others moved
    np.testing.assert_array_equal(got_c["states"][3], start["states"][3])
    assert not torch.equal(got_c["states"][0], start["states"][0])


def test_text_fst_lm_matches_jax(tmp_path):
    """An FST text file with a ``.syms`` table, remapped through the
    network's character map (symbols in another order than the ids)."""
    arpa, syms = _arpa(5, seed=3)
    names = ["x", "y", "z", "w", "<eol>"]
    syms = {names[i]: code for i, (_, code) in enumerate(syms.items())}
    arpa = {order: {tuple(names[int(t[1:])] if t.startswith("c") else t
                          for t in gram): value
                    for gram, value in grams.items()}
            for order, grams in arpa.items()}
    path = str(tmp_path / "g.fst.txt")
    jax_fst.write_fst_text(jax_fst.arpa_to_fst(arpa, syms), path)
    jax_fst.write_symbols(path + ".syms", dict(syms, **{"<eps>": 0}))
    char_map = {"<eol>": 0, "w": 1, "z": 2, "y": 3, "x": 4}
    conf = {"path": path, "no_transition_cost": 9.0}
    ref_lm = jax_lm.make_language_model(conf, char_map, name="lm")
    variables = ref_lm.init(jax.random.PRNGKey(0), 2,
                            method=ref_lm.initial_states)
    lm = port_lm.make_language_model(conf, char_map)
    ref = ref_lm.apply(variables, 2, method=ref_lm.initial_states)
    got = lm.initial_states(2)
    for symbols in ([4, 3], [2, 0], [1, 1]):
        np.testing.assert_allclose(got["add"].numpy(), np.asarray(ref["add"]),
                                   rtol=1e-5, atol=1e-5)
        ref = ref_lm.apply(variables, ref, jnp.asarray(symbols, jnp.int32),
                           method=ref_lm.one_step)
        got = lm.one_step(got, torch.tensor(symbols))


def _recognizers(mode, tmp_dir, lm=True):
    key = (mode, lm)
    if key not in _CACHE:
        cfg = _tiny_net_config()
        if lm:
            cfg["lm"] = {"path": _lm_npz(tmp_dir), "weight": 0.5,
                         "no_transition_cost": 20.0}
        jax_rec = JaxRecognizer(dict(cfg, use_pallas=mode), init_config=INIT,
                                seed=7)
        p = jax_rec.params["params"]["generator"]["readout"]["post_merge_0"]
        p["bias"] = p["bias"].at[EOS].add(3.0)
        port = SpeechRecognizer(dict(cfg, use_pallas=mode), init_config=INIT,
                                seed=7, device="cpu")
        port.net.generator.readout.post_merge_0.bias.data[EOS] += 3.0
        _CACHE[key] = (jax_rec, port)
    return _CACHE[key]


@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("lm"))


def _batch():
    rng = np.random.RandomState(3)
    x = rng.randn(3, 37, 12).astype(np.float32)
    m = (np.arange(37)[None] < np.array([[37], [30], [21]])).astype("f")
    return x, m


def _finished(out):
    """{(utterance, slot): (tokens, cost)} over the valid done entries."""
    return {(u, k): (tuple(out["done_out"][u, k, :out["done_len"][u, k]]),
                     float(out["done_cost"][u, k]))
            for u, k in zip(*np.nonzero(out["done_valid"]))}


def _assert_same(got, ref):
    assert ref["done_out"].shape == got["done_out"].shape
    assert int(got["steps"]) == int(ref["steps"])
    ref_f, got_f = _finished(ref), _finished(got)
    assert ref_f, "vacuous: nothing finished"
    assert sorted(got_f) == sorted(ref_f)
    for key, (tokens, cost) in ref_f.items():
        assert got_f[key][0] == tokens, key
        np.testing.assert_allclose(got_f[key][1], cost, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["done_adjusted"][ref["done_valid"]],
                               ref["done_adjusted"][ref["done_valid"]],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["never", "interpret"])
@pytest.mark.parametrize("search", [
    dict(char_discount=0.1),
    dict(char_discount=0.5, stop_on="optimistic_future_cost")],
    ids=["patience", "optimistic"])
def test_lm_beam_search_matches_jax(mode, search, lm_dir):
    jax_rec, port = _recognizers(mode, lm_dir)
    jax_rec.init_beam_search(4)
    port.init_beam_search(4)
    x, m = _batch()
    _assert_same(port.beam_search(x, m, as_arrays=True, **search),
                 jax_rec.beam_search(x, m, as_arrays=True, **search))


def test_lm_changes_the_result(lm_dir):
    _, port = _recognizers("never", lm_dir)
    _, plain = _recognizers("never", lm_dir, lm=False)
    port.init_beam_search(4)
    plain.init_beam_search(4)
    x, m = _batch()
    with_lm = _finished(port.beam_search(x, m, as_arrays=True,
                                         char_discount=0.1))
    without = _finished(plain.beam_search(x, m, as_arrays=True,
                                          char_discount=0.1))
    assert with_lm != without


def test_module_decode_without_lm_matches_jax(lm_dir):
    """``use_pallas: never`` keeps a decode without LM off the loop kernel
    in both packages; the module-driven decodes agree."""
    jax_rec, port = _recognizers("never", lm_dir, lm=False)
    jax_rec.init_beam_search(3)
    port.init_beam_search(3)
    x, m = _batch()
    got = port.beam_search(x, m, as_arrays=True, char_discount=0.2)
    # (U, K, frames) on the module route, (U, K, max_len) on the loop's
    assert got["done_out"].shape == (8, 3, 100)   # batch padded to 8
    _assert_same(got, jax_rec.beam_search(x, m, as_arrays=True,
                                          char_discount=0.2))


def test_cli_serve_with_lm_matches_jax(tmp_path, monkeypatch):
    """``run.py serve`` with ``net.lm`` naming an FST text file over the
    data's characters answers what the JAX package's transcriber gives."""
    from attention_lvcsr_tpu.config import Configuration
    from attention_lvcsr_tpu.data import Data
    from attention_lvcsr_tpu.models.recognizer import param_path_dict
    from attention_lvcsr_tpu.serve import Transcriber as JaxTranscriber
    from attention_lvcsr_tpu.train.checkpoint import save_checkpoint
    from attention_lvcsr_tpu.train.driver import create_model
    from attention_lvcsr_torch.cli import run
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_toy_dataset import make_toy_dataset

    make_toy_dataset(str(tmp_path / "toy.h5"), num_examples=20,
                     num_chars=4, feat_dim=5, max_len=4, seed=5)
    cfg_text = open(os.path.join(ROOT, "tests", "configs",
                                 "toy.yaml")).read()
    (tmp_path / "toy.yaml").write_text(
        cfg_text.replace("/tmp/toy.h5", str(tmp_path / "toy.h5")))
    chars = ["a", "b", "c", "d", "<eol>"]
    arpa, _ = _arpa(5, seed=5)
    arpa = {order: {tuple(chars[int(t[1:])] if t.startswith("c") else t
                          for t in gram): value
                    for gram, value in grams.items()}
            for order, grams in arpa.items()}
    syms = {c: i + 1 for i, c in enumerate(chars)}
    lm_path = str(tmp_path / "g.fst.txt")
    jax_fst.write_fst_text(jax_fst.arpa_to_fst(arpa, syms), lm_path)
    jax_fst.write_symbols(lm_path + ".syms", dict(syms, **{"<eps>": 0}))
    overrides = ["net.dim_dec", "8", "net.dims_bidir", "[6]",
                 "net.dim_matcher", "8", "net.post_merge_dims", "[8]",
                 "net.lm.path", lm_path, "net.lm.weight", "0.5",
                 "net.lm.no_transition_cost", "20.0"]
    config = Configuration(str(tmp_path / "toy.yaml"),
                           config_changes=list(zip(overrides[::2],
                                                   overrides[1::2])))
    data = Data(**config["data"])
    jax_rec = create_model(config, data)
    post = jax_rec.params["params"]["generator"]["readout"]["post_merge_0"]
    post["bias"] = post["bias"].at[data.eos_label].add(2.0)
    ckpt = str(tmp_path / "model.zip")
    save_checkpoint(ckpt, param_path_dict(jax_rec.params))

    captured = {}
    serve_forever = socketserver.BaseServer.serve_forever
    monkeypatch.setattr(socketserver.BaseServer, "serve_forever",
                        lambda self, *a, **k: captured.setdefault("srv",
                                                                  self))
    run.main(["serve", str(tmp_path / "toy.yaml"), "--params", ckpt,
              "--port", "0", "--device", "cpu", "--beam-size", "3",
              *overrides])
    srv = captured["srv"]
    assert srv.batcher.transcriber.recognizer.net.generator \
        .language_model is not None
    thread = threading.Thread(target=serve_forever, args=(srv,),
                              daemon=True)
    thread.start()
    try:
        jax_transcriber = JaxTranscriber(
            jax_rec, char_map=data.character_map("labels"), beam_size=3)
        batch = next(data.get_stream("valid", batches=True))
        feats = [batch["recordings"][i][:int(batch["recordings_mask"][i]
                                             .sum())]
                 for i in range(len(batch["recordings"]))]
        finished = 0
        for f in feats[:2]:
            status, got = _post(srv.server_address, f)
            ref = jax_transcriber.transcribe_batch([f])[0]
            assert status == 200
            assert got["labels"] == ref["labels"]
            if ref["cost"] is not None:
                finished += 1
                assert got["cost"] == pytest.approx(ref["cost"], rel=1e-5)
        assert finished, "vacuous: nothing finished"
    finally:
        srv.batcher.close()
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
