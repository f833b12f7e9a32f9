"""Serving through the port: its HTTP endpoint answers like a direct
decode, keeps the JAX package's protocol, and the port's ``run.py serve``
builds from ``toy.yaml`` with a checkpoint written by the JAX package,
decoding what the JAX package decodes."""
import io
import json
import os
import socketserver
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from attention_lvcsr_torch.cli import run
from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
from attention_lvcsr_torch.serve import Batcher, Transcriber, make_server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EOS = 4
CHAR_MAP = {"a": 0, "b": 1, "c": 2, "<spc>": 3, "<eol>": EOS}
NET_CONFIG = dict(
    input_dims={"recordings": 6}, input_num_chars={}, eos_label=EOS,
    num_phonemes=5, dim_dec=8, dims_bidir=[7], enc_transition="gru",
    dec_transition="gru", attention_type="content_and_conv", conv_n=1,
    criterion={"name": "log_likelihood"},
    bottom={"bottom_class": "speech"}, subsample=[1],
    post_merge_dims=[10], max_decoded_length_scale=1.0,
    data_prepend_eos=False, character_map=CHAR_MAP)


def _post(address, payload, timeout=120):
    """POST a JSON payload, or a numpy array as a .npy body."""
    host, port = address
    if isinstance(payload, np.ndarray):
        buf = io.BytesIO()
        np.save(buf, payload)
        data, ctype = buf.getvalue(), "application/octet-stream"
    else:
        data, ctype = json.dumps(payload).encode(), "application/json"
    req = urllib.request.Request(f"http://{host}:{port}/decode", data=data,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


@pytest.fixture(scope="module")
def server():
    rec = SpeechRecognizer(NET_CONFIG, init_config={
        "/recognizer": {"weights_init": ["isotropic_gaussian", 0.5],
                        "biases_init": ["constant", 0.0],
                        "rec_weights_init": ["orthogonal"]}}, seed=7,
        device="cpu")
    rec.net.generator.readout.post_merge_0.bias.data[EOS] += 1.5
    transcriber = Transcriber(rec, beam_size=3,
                              search_kwargs={"char_discount": 0.1})
    srv = make_server(transcriber, port=0, max_batch=4, batch_wait_ms=30)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv, transcriber
    srv.batcher.close()
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def test_decode_endpoint_matches_direct(server):
    srv, transcriber = server
    rng = np.random.RandomState(5)
    feats = [rng.randn(12 + 2 * i, 6).astype(np.float32) for i in range(4)]
    results, errors = {}, []

    def client(i):
        try:
            results[i] = _post(srv.server_address,
                               {"features": feats[i].tolist()})
        except Exception as exc:       # reported by the assert below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and len(results) == 4
    finished = 0
    for i, f in enumerate(feats):
        status, result = results[i]
        direct = transcriber.transcribe_batch([f])[0]
        assert status == 200
        assert result["labels"] == direct["labels"]
        assert result["transcript"] == direct["transcript"]
        if direct["cost"] is not None:
            finished += 1
            assert result["cost"] == pytest.approx(direct["cost"], rel=1e-5)
    assert finished, "vacuous: nothing finished"


@pytest.mark.parametrize("payload,message", [
    ({"waveform": [0.1] * 399, "sample_rate": 16000}, "too short"),
    ({"waveform": [0.1] * 199, "sample_rate": 8000}, "too short"),
    ({"waveform": [0.1] * 4000}, "6-dim")])
def test_waveform_request_is_refused_cleanly(server, payload, message):
    """A waveform shorter than one frame, or one whose 123-dim features
    the model does not take, is answered 400."""
    srv, _ = server
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(srv.server_address, payload)
    assert err.value.code == 400
    assert message in json.loads(err.value.read())["error"]


def _speech_like(rng, seconds, sample_rate):
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    return (0.3 * np.sin(2 * np.pi * 440 * t)
            + 0.2 * np.sin(2 * np.pi * 1330 * t)
            + 0.05 * rng.randn(len(t))).astype(np.float32)


def test_waveform_requests_match_the_jax_package():
    """Waveforms to the port's server on the CPU (its frontend's plain
    version, then the decode) vs the JAX ``Transcriber`` on the same
    weights (its device frontend, then its decode): the same labels, the
    cost within 1e-4 relative (both frontends are f32, with the DFT in
    another form: matmul vs rFFT).  A too-short waveform gets 400 from
    both servers."""
    from attention_lvcsr_tpu.models.recognizer import \
        SpeechRecognizer as JaxRecognizer
    from attention_lvcsr_tpu.models.recognizer import param_path_dict
    from attention_lvcsr_tpu.serve import Transcriber as JaxTranscriber
    from attention_lvcsr_tpu.serve import make_server as jax_make_server
    from attention_lvcsr_torch.models.params import load_path_dict
    cfg = dict(NET_CONFIG, input_dims={"recordings": 123})
    init = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.2],
                            "biases_init": ["constant", 0.0],
                            "rec_weights_init": ["orthogonal"]}}
    jax_rec = JaxRecognizer(dict(cfg, input_num_chars={}), init_config=init,
                            seed=3)
    post = jax_rec.params["params"]["generator"]["readout"]["post_merge_0"]
    post["bias"] = post["bias"].at[EOS].add(1.5)
    port = SpeechRecognizer(cfg, device="cpu")
    load_path_dict(port.net, param_path_dict(jax_rec.params))
    search = {"char_discount": 0.1}
    jax_transcriber = JaxTranscriber(jax_rec, beam_size=3,
                                     search_kwargs=search)
    servers = [make_server(Transcriber(port, beam_size=3,
                                       search_kwargs=search), port=0,
                           max_batch=1, batch_wait_ms=5),
               jax_make_server(jax_transcriber, port=0, max_batch=1,
                               batch_wait_ms=5)]
    threads = [threading.Thread(target=srv.serve_forever, daemon=True)
               for srv in servers]
    for thread in threads:
        thread.start()
    try:
        rng = np.random.RandomState(6)
        finished = 0
        for seconds, rate in ((0.45, 16000), (0.3, 8000), (0.62, 16000)):
            wav = _speech_like(rng, seconds, rate)
            status, got = _post(servers[0].server_address,
                                {"waveform": wav.tolist(),
                                 "sample_rate": rate})
            feats = jax_transcriber.features_from_waveform(wav, rate)
            ref = jax_transcriber.transcribe_batch([feats])[0]
            assert status == 200
            assert got["labels"] == ref["labels"]
            assert got["transcript"] == ref["transcript"]
            if ref["cost"] is not None:
                finished += 1
                assert got["cost"] == pytest.approx(ref["cost"], rel=1e-4)
        assert finished, "vacuous: nothing finished"
        for srv in servers:
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(srv.server_address, {"waveform": [0.1] * 300})
            assert err.value.code == 400
            assert "too short" in json.loads(err.value.read())["error"]
    finally:
        for srv, thread in zip(servers, threads):
            srv.batcher.close()
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=30)
            assert not thread.is_alive()


def test_npy_body_decodes_like_json(server):
    srv, transcriber = server
    feats = np.random.RandomState(8).randn(15, 6).astype(np.float32)
    status, got = _post(srv.server_address, feats)
    assert status == 200
    assert got == _post(srv.server_address, {"features": feats.tolist()})[1]
    assert got["labels"] == transcriber.transcribe_batch([feats])[0]["labels"]


@pytest.mark.parametrize("payload,message", [
    ({"features": [[0.0] * 5] * 4}, "6-dim"),
    ({"features": [0.0] * 6}, "(T, F)"),
    ({"frames": []}, "'features' or 'waveform'")])
def test_bad_requests_get_400(server, payload, message):
    srv, _ = server
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(srv.server_address, payload)
    assert err.value.code == 400
    assert message in json.loads(err.value.read())["error"]


def test_healthz_counts_requests(server):
    srv, _ = server
    host, port = srv.server_address
    with urllib.request.urlopen(f"http://{host}:{port}/healthz",
                                timeout=30) as resp:
        health = json.loads(resp.read())
    assert health["status"] == "ok" and health["beam_size"] == 3
    assert health["requests"] >= health["errors"]


class _EchoTranscriber:
    """Records each batch it is given; answers with the row count."""

    def __init__(self):
        self.batches = []

    def transcribe_batch(self, features):
        self.batches.append([f.shape for f in features])
        return [{"rows": f.shape[0]} for f in features]


def test_batcher_groups_by_width_and_caps_the_batch():
    echo = _EchoTranscriber()
    batcher = Batcher(echo, max_batch=3, batch_wait_ms=200)
    shapes = [(2, 4), (3, 4), (4, 5), (5, 4), (6, 4), (7, 4)]
    answers = {}
    threads = [threading.Thread(
        target=lambda s=s: answers.setdefault(s, batcher.submit(
            np.zeros(s, np.float32)))) for s in shapes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    batcher.close()
    assert {s: a["rows"] for s, a in answers.items()} == {
        s: s[0] for s in shapes}
    assert all(len(b) <= 3 and len({w for _, w in b}) == 1
               for b in echo.batches)
    assert sorted(s for b in echo.batches for s in b) == sorted(shapes)


def test_cli_serve_builds_from_toy_yaml_with_jax_checkpoint(
        tmp_path, monkeypatch):
    from attention_lvcsr_tpu.config import Configuration
    from attention_lvcsr_tpu.data import Data
    from attention_lvcsr_tpu.models.recognizer import param_path_dict
    from attention_lvcsr_tpu.serve import Transcriber as JaxTranscriber
    from attention_lvcsr_tpu.train.checkpoint import save_checkpoint
    from attention_lvcsr_tpu.train.driver import create_model
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_toy_dataset import make_toy_dataset

    make_toy_dataset(str(tmp_path / "toy.h5"), num_examples=20,
                     num_chars=4, feat_dim=5, max_len=4, seed=5)
    cfg_text = open(os.path.join(ROOT, "tests", "configs",
                                 "toy.yaml")).read()
    (tmp_path / "toy.yaml").write_text(
        cfg_text.replace("/tmp/toy.h5", str(tmp_path / "toy.h5")))
    overrides = ["net.dim_dec", "8", "net.dims_bidir", "[6]",
                 "net.dim_matcher", "8", "net.post_merge_dims", "[8]"]
    config = Configuration(str(tmp_path / "toy.yaml"),
                           config_changes=list(zip(overrides[::2],
                                                   overrides[1::2])))
    data = Data(**config["data"])
    jax_rec = create_model(config, data)
    # stand-in for training: make hypotheses finish
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
            status, got = _post(srv.server_address,
                                {"features": f.tolist()})
            ref = jax_transcriber.transcribe_batch([f])[0]
            assert status == 200
            assert got["labels"] == ref["labels"]
            assert got["transcript"] == ref["transcript"]
            if ref["cost"] is not None:
                finished += 1
                assert got["cost"] == pytest.approx(ref["cost"], rel=1e-5)
        assert finished, "vacuous: nothing finished"
    finally:
        srv.batcher.close()
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
