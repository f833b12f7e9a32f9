#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA GPU).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``attention_lvcsr_torch/csrc`` and
drives the flagship serving decode (the ``__graft_entry__.FLAGSHIP_NET``
shape: 4x250 BiGRU encoder, conv-attention GRU decoder, beam 10) with
random weights made from a seed.  Phases, each fatal on failure:

1. build the kernels (nvcc, sm_90a) and print the build time;
2. ``gru_scan`` kernel vs its plain PyTorch version at the encoder's
   first layer, T=800, B=64, D=250, both directions in one launch and one
   direction alone, masked with ragged lengths (max abs error <= 1e-4);
3. ``beam_search_loop`` kernel vs its plain version on flagship tables:
   U=8 at 400 frames, then the main path's U=64 at 800 frames, and U=64
   again with the EOS logit raised by 1.5 so that most utterances finish
   (at least 3/4 must).  Finished sets, lengths and step counts identical, costs
   within 1e-4 + 1e-5 relative; at most one utterance may differ, as a
   near tie (best costs within 1e-3 relative);
4. the full decode through ``SpeechRecognizer.beam_search`` at B=64, 800
   frames, beam 10: both kernels must launch; utt/s of the kernel path
   and of the plain path on the same card, whose outputs must agree as
   in phase 3;
5. serving: 8 concurrent ``/decode`` requests against the port's
   ``make_server`` and ``Transcriber`` equal the direct results.

Nothing of JAX or of the JAX package is imported; the script checks it.

The second line from the end is a JSON object describing each kernel;
the last is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository around it, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import io
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np


def log(msg):
    print(msg, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def cuda_ms(fn, repeats):
    """Mean device time of ``fn`` over ``repeats`` calls (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


FLAGSHIP_INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.1],
                                 "biases_init": ["constant", 0.0],
                                 "rec_weights_init": ["orthogonal"]}}


def best_hypotheses(out):
    """Per utterance: (labels tuple, cost) of the best valid hypothesis."""
    best = []
    for u in range(out["done_valid"].shape[0]):
        valid = out["done_valid"][u]
        if not valid.any():
            best.append(((), None))
            continue
        k = int(np.argmin(np.where(valid, out["done_adjusted"][u], np.inf)))
        n = int(out["done_len"][u, k])
        best.append((tuple(int(x) for x in out["done_out"][u, k, :n]),
                     float(out["done_cost"][u, k])))
    return best


def compare_outputs(name, got, ref):
    """Kernel vs plain decode outputs, utterance by utterance: finished
    hypotheses, lengths, validity and step counts identical, costs within
    1e-4 + 1e-5 relative.  At most one utterance may differ, and only as a
    near tie: the costs of the two best hypotheses within 1e-3 relative.
    ``steps`` is per utterance, or one number for the batch.  Returns the
    max abs cost error over the finished hypotheses that agree."""
    per_utt_steps = np.ndim(ref["steps"]) == 1
    best_g, best_r = best_hypotheses(got), best_hypotheses(ref)
    differ, err = [], 0.0
    for u in range(len(best_r)):
        valid = ref["done_valid"][u]
        cost_g = np.stack([got["done_cost"][u], got["done_adjusted"][u]])
        cost_r = np.stack([ref["done_cost"][u], ref["done_adjusted"][u]])
        if (np.array_equal(got["done_out"][u], ref["done_out"][u])
                and np.array_equal(got["done_len"][u], ref["done_len"][u])
                and np.array_equal(got["done_valid"][u], valid)
                and (not per_utt_steps or got["steps"][u] == ref["steps"][u])
                and np.all(np.abs(cost_g - cost_r)
                           <= 1e-4 + 1e-5 * np.abs(cost_r))):
            if valid.any():
                err = max(err, float(np.abs(cost_g - cost_r)[:, valid].max()))
            continue
        (lab_g, c_g), (lab_r, c_r) = best_g[u], best_r[u]
        if c_g is None or c_r is None or \
                abs(c_g - c_r) > 1e-3 * max(abs(c_r), 1.0):
            fail(f"{name}: utterance {u} differs: best {lab_g} ({c_g}) vs "
                 f"plain {lab_r} ({c_r})")
        differ.append(u)
        log(f"{name}: near tie at utterance {u}: costs {c_g} vs {c_r}; "
            f"labels {lab_g} vs {lab_r}")
    if len(differ) > 1:
        fail(f"{name}: {len(differ)} utterances differ (at most one near tie "
             f"allowed): {differ}")
    if not per_utt_steps and not differ and got["steps"] != ref["steps"]:
        fail(f"{name}: {got['steps']} steps vs plain {ref['steps']}")
    return err


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a GPU")
    try:
        from __graft_entry__ import FLAGSHIP_NET
        from attention_lvcsr_torch import _build
        from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
        from attention_lvcsr_torch.ops import beam_loop as bl
        from attention_lvcsr_torch.ops import gru_scan as gs
        from attention_lvcsr_torch.search import beam as beam_mod
        from attention_lvcsr_torch.models import encoder as encoder_mod
        from attention_lvcsr_torch.serve import Transcriber, make_server
    except ImportError as exc:
        fail(f"{exc}: run this script from the root of the repository")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip())     # the card's name and power limit
    dev = torch.device("cuda:0")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    results = {}

    # ---- 1. build --------------------------------------------------------
    lib = _build.load()
    log(f"phase 1 build: {lib.build_seconds:.1f} s -> {lib.path}")
    for line in lib.log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- 2. gru_scan -----------------------------------------------------
    # the encoder's first layer: both directions in one launch
    rng = np.random.RandomState(0)
    T, B, D = 800, 64, 250
    lengths = rng.randint(300, T + 1, size=B)
    lengths[0] = T
    t = lambda a: torch.tensor(a.astype(np.float32), device=dev)
    proj = t(rng.randn(T, B, 6 * D) * 0.5)
    mask = t((np.arange(T)[:, None] < lengths[None, :]).astype(np.float32))
    weights = [(t(rng.randn(B, D) * 0.1), t(rng.randn(D, D) / np.sqrt(D)),
                t(rng.randn(D, 2 * D) / np.sqrt(D))) for _ in range(2)]
    args = (proj, mask, *weights)
    got = gs.gru_scan(*args)
    ref = gs.gru_scan_reference(*args)
    one = gs.gru_scan(proj[..., :3 * D].contiguous(), mask, weights[0])
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    err_one = float((one - ref[..., :D]).abs().max())
    log(f"phase 2 gru_scan T={T} B={B} D={D}, both directions: max abs err "
        f"{err:.3e} (one direction alone: {err_one:.3e})")
    if not max(err, err_one) <= 1e-4:
        fail(f"gru_scan disagrees with its plain version: {err}, {err_one}")
    results["gru_scan"] = {
        "max_abs_err": max(err, err_one),
        "ms": cuda_ms(lambda: gs.gru_scan(*args), 5),
        "plain_ms": cuda_ms(lambda: gs.gru_scan_reference(*args), 2)}
    log(f"  kernel {results['gru_scan']['ms']:.3f} ms, plain "
        f"{results['gru_scan']['plain_ms']:.3f} ms")

    # ---- 3. beam_search_loop ---------------------------------------------
    net_config = dict(FLAGSHIP_NET, max_decoded_length_scale=8.0)
    rec = SpeechRecognizer(net_config, init_config=FLAGSHIP_INIT, seed=1234,
                           device=dev)
    rec.init_beam_search(10)
    prior = rec.net.generator.attention.prior_config()
    loop_err = 0.0
    for U, frames, eos_bias in ((8, 400, 0.0), (64, 800, 0.0),
                                (64, 800, 1.5)):
        feats = t(np.random.RandomState(1).randn(U, frames, 123))
        fmask = torch.ones(U, frames, device=dev)
        with torch.inference_mode():
            data = rec.net.decode_loop(feats, fmask)
            tables = dict(rec.net.decode_loop_tables())
        tables["post_b"] = tables["post_b"].clone()
        tables["post_b"][rec.eos_label] += eos_bias
        kw = dict(beam=10, max_len=int(frames / 8.0), eol=rec.eos_label,
                  ignore_first_eol=rec.data_prepend_eos,
                  prior=prior["type"], before=float(prior["before"]),
                  after=float(prior["after"]))
        loop_args = (data["pre"], data["attended"], data["attended_mask"],
                     tables)

        def as_out(res):
            out, meta, steps = (r.cpu().numpy() for r in res)
            return {"done_out": out, "done_cost": meta[:, :, 0],
                    "done_adjusted": meta[:, :, 1],
                    "done_len": meta[:, :, 2].astype(np.int32),
                    "done_valid": meta[:, :, 1] < bl.INF / 2,
                    "steps": steps}

        got = as_out(bl.beam_search_loop(*loop_args, **kw))
        ref = as_out(bl.beam_search_loop_reference(*loop_args, **kw))
        name = f"beam_search_loop U={U} eos_bias={eos_bias}"
        err = compare_outputs(name, got, ref)
        loop_err = max(loop_err, err)
        finished = int(got["done_valid"].any(axis=1).sum())
        log(f"phase 3 {name} frames={frames}: outputs agree; {finished}/{U} "
            f"utterances and {int(got['done_valid'].sum())}/{U * 10} slots "
            f"finished, steps {int(got['steps'].min())}.."
            f"{int(got['steps'].max())}, max abs cost err {err:.3e}")
        if eos_bias and finished < U * 3 // 4:
            fail(f"{name}: only {finished}/{U} utterances finished: the "
                 f"comparison is too weak")
        if (U, frames, eos_bias) == (64, 800, 0.0):
            results["beam_search_loop"] = {
                "ms": cuda_ms(lambda: bl.beam_search_loop(*loop_args, **kw),
                              3),
                "plain_ms": cuda_ms(
                    lambda: bl.beam_search_loop_reference(*loop_args, **kw),
                    1)}
    results["beam_search_loop"]["max_abs_err"] = loop_err
    log(f"  kernel {results['beam_search_loop']['ms']:.3f} ms, plain "
        f"{results['beam_search_loop']['plain_ms']:.3f} ms (U=64, main "
        f"path's tables)")

    # ---- 4. full decode through the recognizer -----------------------------
    Bd, Td = 64, 800
    feats_np = np.random.RandomState(2).randn(Bd, Td, 123).astype(np.float32)
    feats = torch.tensor(feats_np, device=dev)
    fmask = torch.ones(Bd, Td, device=dev)

    def decode():
        out = rec.beam_search(feats, fmask, as_arrays=True)
        torch.cuda.synchronize()
        return out

    gs.launches.reset()
    bl.launches.reset()
    out = decode()
    launches = {"gru_scan": gs.launches.count,
                "beam_search_loop": bl.launches.count}
    log(f"phase 4 launches in one decode: {launches}")
    if min(launches.values()) < 1:
        fail(f"a kernel of the main path never launched: {launches}")
    if out["done_out"].shape != (Bd, 10, Td // 8) or not np.isfinite(
            out["done_cost"][out["done_valid"]]).all():
        fail("decode output has the wrong shape or non-finite costs")
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        decode()
        times.append(time.perf_counter() - t0)
    kernel_utt_s = Bd / statistics.median(times)

    saved = (encoder_mod.gru_scan, beam_mod.beam_search_loop)
    encoder_mod.gru_scan = gs.gru_scan_reference
    beam_mod.beam_search_loop = bl.beam_search_loop_reference
    try:
        ptimes = []
        for _ in range(2):
            t0 = time.perf_counter()
            out_plain = decode()
            ptimes.append(time.perf_counter() - t0)
    finally:
        encoder_mod.gru_scan, beam_mod.beam_search_loop = saved
    plain_utt_s = Bd / statistics.median(ptimes)
    decode_err = compare_outputs("decode", out, out_plain)
    log(f"phase 4 decode B={Bd} frames={Td} beam=10 steps="
        f"{int(out['steps'])}: kernel path {kernel_utt_s:.2f} utt/s "
        f"(median of 5, {[round(x, 4) for x in times]} s), plain path "
        f"{plain_utt_s:.2f} utt/s; outputs agree (max abs cost err "
        f"{decode_err:.3e})")

    # ---- 5. serve -----------------------------------------------------------
    chars = [chr(ord("a") + i) for i in range(26)] + [
        "<spc>", "'", ".", "-", "<bol>", "<eol>"]
    transcriber = Transcriber(rec, char_map={c: i for i, c in
                                             enumerate(chars)},
                              beam_size=10)
    server = make_server(transcriber, "127.0.0.1", 0, max_batch=8,
                         batch_wait_ms=50.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        srng = np.random.RandomState(3)
        reqs = [srng.randn(int(n), 123).astype(np.float32)
                for n in srng.randint(300, 801, size=8)]
        host, port = server.server_address
        answers, errors = {}, []

        def client(i):
            buf = io.BytesIO()
            np.save(buf, reqs[i])
            req = urllib.request.Request(
                f"http://{host}:{port}/decode", data=buf.getvalue(),
                headers={"Content-Type": "application/octet-stream"})
            try:
                with urllib.request.urlopen(req, timeout=300) as resp:
                    answers[i] = json.loads(resp.read())
            except Exception as exc:     # reported below
                errors.append(f"request {i}: {exc}")

        gs.launches.reset()
        bl.launches.reset()
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=300)
        wall = time.perf_counter() - t0
        if errors or len(answers) != 8:
            fail(f"serve: {errors or 'missing answers'}")
        moved = {"gru_scan": gs.launches.count,
                 "beam_search_loop": bl.launches.count}
        if min(moved.values()) < 1:
            fail(f"serve: a kernel never launched: {moved}")
        for i, feats_i in enumerate(reqs):
            direct = transcriber.transcribe_batch([feats_i])[0]
            got = answers[i]
            costs = (got["cost"], direct["cost"])
            if got["labels"] != direct["labels"] or (
                    None in costs and costs[0] != costs[1]) or (
                    None not in costs and abs(costs[0] - costs[1])
                    > 1e-4 * max(1.0, abs(costs[1]))):
                fail(f"serve: request {i} answered {got} but the direct "
                     f"decode gives {direct}")
        finished = sum(a["cost"] is not None for a in answers.values())
        log(f"phase 5 serve: 8 concurrent requests answered in {wall:.3f} s,"
            f" equal to the direct decode ({finished} with a finished "
            f"hypothesis); launches {moved}")
    finally:
        server.batcher.close()
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)

    banned = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "attention_lvcsr_tpu"))
    if banned:
        fail(f"JAX or the JAX package was imported: {banned}")
    sources = {"gru_scan": ("attention_lvcsr_torch/csrc/gru_scan.cu",
                            "attention_lvcsr_tpu/ops/pallas/gru_scan.py:72"),
               "beam_search_loop": (
                   "attention_lvcsr_torch/csrc/beam_loop.cu",
                   "attention_lvcsr_tpu/ops/pallas/beam_loop.py:638")}
    kernels = [{"name": name, "route": "cuda", "source": sources[name][0],
                "replaces": sources[name][1], "launches": launches[name],
                "max_abs_err": results[name]["max_abs_err"],
                "ms": results[name]["ms"],
                "plain_ms": results[name]["plain_ms"]}
               for name in ("gru_scan", "beam_search_loop")]
    log(json.dumps({"decode_utt_per_s": kernel_utt_s,
                    "plain_decode_utt_per_s": plain_utt_s,
                    "build_s": lib.build_seconds}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
