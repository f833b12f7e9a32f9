"""HTTP decode serving over the port's recognizer, with micro-batching.

The protocol is that of ``attention_lvcsr_tpu/serve.py``, so clients of
one serve the other:

* ``POST /decode`` with a JSON body ``{"features": [[...], ...]}`` (a
  (T, F) float matrix) or a ``.npy`` (T, F) body sent as
  ``application/octet-stream``.  The answer is ``{"labels": [...],
  "transcript": "...", "cost": ...}``; ``cost`` is null when no
  hypothesis finished.  ``{"waveform": [...], "sample_rate": 16000}``
  runs the fbank+delta frontend (``data/features.py::device_frontend``,
  the CUDA ``fbank_deltas`` kernel on the card) on the recognizer's device
  in the handler's thread and decodes the features it gives; a waveform
  shorter than one frame is answered 400.
* ``GET /healthz``: status, beam size and request counters.

The batcher hands the recognizer up to ``max_batch`` waiting requests of
one feature width at a time.  A request waits at most ``batch_wait_ms``
for companions; under load the batch fills first and the wait costs
nothing.  This module imports nothing of the JAX package: a process that
serves on the card loads torch, numpy and the standard library only.
"""
from __future__ import annotations

import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List

import numpy as np
import torch

from attention_lvcsr_torch.data.features import device_frontend
from attention_lvcsr_torch.ops.frontend import frame_geometry

# seconds a request waits for its decode; the first decode of a new shape
# also builds the kernels
REQUEST_TIMEOUT = 600.0


class Transcriber:
    """A recognizer and its symbol table: feature matrices -> results."""

    def __init__(self, recognizer, char_map=None, normalization=None,
                 beam_size: int = 10, search_kwargs=None):
        self.recognizer = recognizer
        recognizer.init_beam_search(beam_size)
        char_map = char_map or dict(recognizer.character_map or {})
        self.num2char = {v: k for k, v in char_map.items()}
        self.normalization = normalization
        self.search_kwargs = dict(search_kwargs or {})
        dims = recognizer.net_config.get("input_dims") or {}
        self.expected_dim = dims.get("recordings")

    def features_from_waveform(self, wav, sample_rate: int = 16000):
        """(N,) waveform -> its (T, 123) float32 features, computed on the
        recognizer's device.  Unlike the JAX package, the waveform is not
        padded to a power-of-two bucket of seconds (a bound on XLA's
        compile cache): rows below the true frame count read no padded
        sample, so the features are the same.  The kernel runs on this
        thread's current stream, the device's default stream, which the
        batcher's decodes share; copying the result to the host waits for
        it before the features are handed over."""
        frame_length, hop, _ = frame_geometry(sample_rate)
        wav = np.asarray(wav, np.float32)
        if wav.ndim != 1:
            raise ValueError(f"waveform must be a list of samples, got "
                             f"shape {wav.shape}")
        if len(wav) < frame_length:
            raise ValueError(f"waveform too short: {len(wav)} samples < one "
                             f"{frame_length}-sample frame")
        feats = device_frontend(
            torch.tensor(wav, device=self.recognizer.device)[None],
            sample_rate=sample_rate)
        return feats[0].cpu().numpy()

    def text(self, labels) -> str:
        """Labels -> transcript: EOS and other ``<...>`` symbols dropped,
        ``<spc>`` read as a space."""
        chars = (self.num2char.get(int(l), "") for l in labels
                 if int(l) != self.recognizer.eos_label)
        return "".join(" " if c == "<spc>" else c for c in chars
                       if c == "<spc>" or not c.startswith("<")).strip()

    def transcribe_batch(self, features: List[np.ndarray]) -> List[dict]:
        """(T_i, F) feature matrices -> one result dict each, from the best
        finished hypothesis by length-adjusted cost."""
        if self.normalization is not None:
            features = [(np.asarray(f, np.float32) - self.normalization.mean)
                        / self.normalization.std for f in features]
        T = max(f.shape[0] for f in features)
        batch = np.zeros((len(features), T, features[0].shape[1]), np.float32)
        mask = np.zeros(batch.shape[:2], np.float32)
        for i, f in enumerate(features):
            batch[i, :len(f)] = f
            mask[i, :len(f)] = 1.0
        out = self.recognizer.beam_search(batch, mask, as_arrays=True,
                                          **self.search_kwargs)
        results = []
        for i in range(len(features)):
            valid = out["done_valid"][i]
            if not valid.any():
                results.append({"labels": [], "transcript": "", "cost": None})
                continue
            k = int(np.argmin(np.where(valid, out["done_adjusted"][i],
                                       np.inf)))
            labels = out["done_out"][i, k, :out["done_len"][i, k]].tolist()
            results.append({"labels": labels, "transcript": self.text(labels),
                            "cost": float(out["done_cost"][i, k])})
        return results


class _Request:
    def __init__(self, features):
        self.features = features
        self.done = threading.Event()
        self.abandoned = False
        self.result = None
        self.error = None


class Batcher:
    """One worker thread that decodes waiting requests in micro-batches."""

    def __init__(self, transcriber: Transcriber, max_batch: int = 8,
                 batch_wait_ms: float = 20.0):
        self.transcriber = transcriber
        self.max_batch = max_batch
        self.batch_wait = batch_wait_ms / 1000.0
        self._queue = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, features: np.ndarray):
        """Decode one (T, F) matrix with whatever else is waiting."""
        request = _Request(features)
        self._queue.put(request)
        if not request.done.wait(REQUEST_TIMEOUT):
            request.abandoned = True      # the worker skips it
            raise TimeoutError("decode timed out")
        if request.error is not None:
            raise RuntimeError(request.error)
        return request.result

    def close(self):
        """Stop the worker; requests still queued are failed."""
        self._queue.put(None)
        self._worker.join(timeout=60)

    def _run(self):
        waiting = []
        while True:
            if not waiting:
                request = self._queue.get()
                if request is None:
                    return
                waiting.append(request)
            deadline = time.monotonic() + self.batch_wait
            while len(waiting) < self.max_batch:
                try:
                    request = self._queue.get(
                        timeout=max(0.0, deadline - time.monotonic()))
                except queue.Empty:
                    break
                if request is None:
                    self._finish(waiting, error="server closed")
                    return
                waiting.append(request)
            # one feature width per batch: a client's odd width must not
            # fail the others; the rest wait for the next round
            width = waiting[0].features.shape[1]
            group = [r for r in waiting
                     if r.features.shape[1] == width][:self.max_batch]
            waiting = [r for r in waiting if r not in group]
            group = [r for r in group if not r.abandoned]
            if group:
                self._decode(group)

    def _decode(self, group):
        try:
            results = self.transcriber.transcribe_batch(
                [r.features for r in group])
        except Exception as exc:          # reported to every request
            self._finish(group, error=f"{type(exc).__name__}: {exc}")
            return
        for request, result in zip(group, results):
            request.result = result
            request.done.set()

    @staticmethod
    def _finish(requests, error):
        for request in requests:
            request.error = error
            request.done.set()


def _parse_request(body: bytes, content_type: str, transcriber) -> np.ndarray:
    """A request body -> its (T, F) float32 feature matrix."""
    if "octet-stream" in content_type:
        feats = np.load(io.BytesIO(body), allow_pickle=False)
    else:
        request = json.loads(body)
        if "features" in request:
            feats = request["features"]
        elif "waveform" in request:
            feats = transcriber.features_from_waveform(
                np.asarray(request["waveform"], np.float32),
                sample_rate=int(request.get("sample_rate", 16000)))
        else:
            raise ValueError("body needs 'features' or 'waveform'")
    feats = np.asarray(feats, np.float32)
    if feats.ndim != 2 or not len(feats):
        raise ValueError(f"features must be a non-empty (T, F) matrix, got "
                         f"shape {feats.shape}")
    expected = transcriber.expected_dim
    if expected is not None and feats.shape[1] != expected:
        raise ValueError(f"model expects {expected}-dim features, got "
                         f"{feats.shape[1]}")
    return feats


def make_server(transcriber: Transcriber, host: str = "127.0.0.1",
                port: int = 0, max_batch: int = 8,
                batch_wait_ms: float = 20.0) -> ThreadingHTTPServer:
    """The HTTP server, not started; ``server.server_address`` holds the
    bound port when ``port`` is 0, ``server.batcher`` the batcher."""
    batcher = Batcher(transcriber, max_batch, batch_wait_ms)
    stats = {"requests": 0, "errors": 0, "started": time.time()}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _reply(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._reply(404, {"error": "not found"})
            self._reply(200, {
                "status": "ok",
                "uptime_s": round(time.time() - stats["started"], 1),
                "requests": stats["requests"], "errors": stats["errors"],
                "beam_size": transcriber.recognizer.beam_size})

        def do_POST(self):
            if self.path != "/decode":
                return self._reply(404, {"error": "not found"})
            stats["requests"] += 1
            try:
                body = self.rfile.read(
                    int(self.headers.get("Content-Length", 0)))
                feats = _parse_request(
                    body, self.headers.get("Content-Type", ""), transcriber)
            except Exception as exc:      # malformed or unsupported request
                stats["errors"] += 1
                return self._reply(400, {"error":
                                         f"{type(exc).__name__}: {exc}"})
            try:
                self._reply(200, batcher.submit(feats))
            except Exception as exc:      # decode failure or timeout
                stats["errors"] += 1
                self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})

    server = ThreadingHTTPServer((host, port), Handler)
    server.batcher = batcher
    return server


def build_server(config, load_path, host="127.0.0.1", port=8000,
                 beam_size=None, max_batch=8, batch_wait_ms=20.0,
                 device="cuda"):
    """The (not yet started) HTTP server for a config and checkpoint."""
    from attention_lvcsr_torch.data import Data    # h5py: CLI path only
    from attention_lvcsr_torch.train.driver import create_model
    data = Data(**config["data"])
    recognizer = create_model(config, data, load_path, device=device)
    search_conf = config.get("monitoring", {}).get("search", {})
    transcriber = Transcriber(
        recognizer,
        char_map=data.character_map("labels"),
        normalization=data.normalization,
        beam_size=beam_size or search_conf.get("beam_size", 10),
        search_kwargs={
            "char_discount": search_conf.get("char_discount", 0.0),
            "round_to_inf": search_conf.get("round_to_inf", 1e9),
            "stop_on": search_conf.get("stop_on", "patience"),
        })
    return make_server(transcriber, host, port, max_batch, batch_wait_ms)


def serve(config, load_path, host="127.0.0.1", port=8000, beam_size=None,
          max_batch=8, batch_wait_ms=20.0, device="cuda"):
    """CLI entry (``run.py serve``): build the model and serve forever."""
    server = build_server(config, load_path, host, port, beam_size,
                          max_batch, batch_wait_ms, device)
    print(f"serving on http://{server.server_address[0]}:"
          f"{server.server_address[1]} (POST /decode, GET /healthz)")
    server.serve_forever()
