#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA GPU).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``attention_lvcsr_torch/csrc`` and
drives the flagship decode (the ``__graft_entry__.FLAGSHIP_NET`` shape:
4x250 BiGRU encoder, conv-attention GRU decoder, beam 10) with random
weights made from a seed, without an LM, with the LM and under a
dictionary constraint.  Phases, each fatal on failure:

1. build the kernels (one nvcc per source, sm_90a) and print the time;
2. ``gru_scan`` kernel vs its plain PyTorch version at the encoder's
   first layer, T=800, B=64, D=250, both directions in one launch and one
   direction alone, masked with ragged lengths (max abs error <= 1e-4);
3. ``beam_search_loop`` kernel vs its plain version on flagship tables:
   U=8 at 400 frames, then the main path's U=64 at 800 frames, and U=64
   again with the EOS logit raised by 1.5 so that most utterances finish
   (at least 3/4 must).  Finished sets, lengths and step counts identical,
   costs within 1e-4 + 1e-5 relative; at most one utterance may differ, as
   a near tie (best costs within 1e-3 relative);
4. the full decode through ``SpeechRecognizer.beam_search`` at B=64, 800
   frames, beam 10: both kernels must launch; utt/s of the kernel path
   and of the plain path on the same card, whose outputs must agree as
   in phase 3;
5. serving: 8 concurrent ``/decode`` requests against the port's
   ``make_server`` and ``Transcriber`` equal the direct results;
6. ``beam_attention_energies`` kernel vs plain at U=64, K=10, L=200,
   M=250 (max abs error <= 1e-4);
7. ``fused_decode_score`` kernel vs plain on the flagship tables and
   encoder outputs, U=64, for both priors, from the initial glimpses and
   from a later step with softmax-normalised random weights: costs,
   weights, energies and weighted averages within 1e-4;
8. LM-fused decode: the character trigram of ``bench.py`` (seed 11, 32
   symbols, no_transition_cost 20) built with the port's ``ops/fst.py``,
   weight 0.5, B=64, 800 frames, beam 10, char_discount 1.0, 100-step
   cap: ``gru_scan`` and ``beam_attention_energies`` launch,
   ``beam_search_loop`` does not; utt/s of both paths, outputs agree as in
   phase 3, then again with the EOS logit raised by 1.5;
9. constrained decode: ``use_pallas: fused`` under
   ``DecodeConstraint.from_words`` over a seeded lexicon, same shape, EOS
   logit raised by 1.5: ``fused_decode_score`` launches, every finished
   hypothesis is accepted by the constraint (host walk), outputs agree
   with the plain path;
10. serving with the LM: as phase 5, through the LM recognizer, one
    request per batch (the LM path's attention window spans its batch);
11. ``gru_scan_train`` forward and backward kernels vs the plain version
    (autograd through the plain scan): T=800, B=32, D=250, one direction
    and both, ragged mask, random cotangent; states within 1e-5, every
    gradient (dx_in, dx_gate, dh0, dW_ss, dW_sg) within 1e-4 of its
    largest value;
12. ``decoder_scan_train`` forward and backward kernels vs plain at the
    flagship decoder's shapes (T=100, B=32, L=200, M=250, D=500, S=250,
    201 taps), both priors, ragged label and frame masks: outputs and
    every gradient within 1e-4 of their largest value;
    in both phases a second call's gradients equal the first's bit for bit;
13. the flagship training step: five steps of ``make_train_step`` through
    ``run_training`` (B=32, 800 frames, 100 labels, wsj_paper.yaml's clip
    100, adadelta 0.95/1e-8, max_norm 1.0) on the kernel route and on the
    plain route from the same parameters and batches: per-step train_cost
    and total_gradient_norm within 1e-4 relative, the training kernels
    launch, utt/s of both routes, the checkpoint reads back identical, a
    second run of the kernel route repeats its monitors exactly; then two steps with a one-directional encoder (the path of the
    one-direction kernel), compared the same way.

Nothing of JAX or of the JAX package is imported; the script checks it.

The second line from the end is a JSON object describing each kernel:
its times, its bound (``bound_ms``: the larger of its bytes over the
card's memory rate and its float32 operations over the card's peak,
computed from this run's shapes) and ``library_ms`` (null: no single
PyTorch call computes any of these functions); the last is ``{"ok":
true, "device": {...}}``.  Without a CUDA device, or without the
repository around it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
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


@contextlib.contextmanager
def swapped(pairs):
    """Replace ``module.name`` by ``value`` for each (module, name, value)
    inside the block: how the plain path is driven end to end."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in pairs]
    for m, n, v in pairs:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


FLAGSHIP_INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.1],
                                 "biases_init": ["constant", 0.0],
                                 "rec_weights_init": ["orthogonal"]}}
CHARS = [chr(ord("a") + i) for i in range(26)] + [
    "<spc>", "'", ".", "-", "<bol>", "<eol>"]
CHAR_MAP = {c: i for i, c in enumerate(CHARS)}


def bench_trigram(path):
    """The WSJ-shaped character trigram of ``bench.py`` (seed 11, 31
    characters + E over the 32 network ids), packed dense to ``path``."""
    from attention_lvcsr_torch.ops import fst as F
    rng = np.random.RandomState(11)
    toks = [f"c{i}" for i in range(31)] + ["E"]
    uni = {("<s>",): (-99.0, -0.4), ("</s>",): (-1.5, 0.0)}
    for t in toks:
        uni[(t,)] = (float(-1.2 - rng.rand()), -0.5)
    bi, tri = {}, {}
    for a in toks:
        for b in toks:
            bi[(a, b)] = (float(-0.8 - rng.rand()), -0.3)
    for a in toks:
        for b in toks:
            for c in rng.choice(len(toks), size=3, replace=False):
                tri[(a, b, toks[c])] = (float(-0.5 - rng.rand()), 0.0)
    graph = F.arpa_to_fst({1: uni, 2: bi, 3: tri},
                          {t: i + 1 for i, t in enumerate(toks)})
    packed = F.pack_fst(graph, {i: i + 1 for i in range(len(toks))},
                        num_nn_symbols=32, no_transition_cost=20.0)
    F.save_packed(path, packed)
    return graph.num_states


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


def counts(counters):
    return {name: c.count for name, c in counters.items()}


# Published peaks of one H100 SXM (NVIDIA's data sheet, at the 700 W
# limit): HBM3 bytes per second, and float32 operations per second outside
# the tensor cores, where every kernel of the port does its arithmetic.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


def bound(nbytes, ops):
    """The least time the card could take for a function: the larger of
    its bytes (each input read once, each output written once) over the
    memory rate and its float32 operations over the peak rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    if t_bytes >= t_ops:
        return {"bound_ms": t_bytes, "bound_by": "bytes"}
    return {"bound_ms": t_ops, "bound_by": "operations"}


def nbytes(*tensors):
    """Bytes of the tensors (dicts of tensors count their values)."""
    total = 0
    for x in tensors:
        if isinstance(x, dict):
            total += nbytes(*x.values())
        elif x is not None:
            total += x.numel() * x.element_size()
    return total


def gru_step_ops(D):
    """Operations of one GRU step of one row: the gate and candidate
    products (2 * 3D * D) and about a dozen elementwise ones per unit."""
    return 6 * D * D + 12 * D


def attention_step_ops(S, M, L, conv, D):
    """Operations of one attention step of one row: the state's keys
    (2SM), the convolution (2 * L * conv, conv = taps or L for a Toeplitz
    band), the match (add, handler, tanh, energy: 6LM), the softmax (4L)
    and the weighted average (2LD)."""
    return 2 * S * M + 2 * L * conv + 6 * L * M + 4 * L + 2 * L * D


def readout_ops(D, R, V):
    """Merge, tanh, post-merge layer and log-softmax of one row."""
    return 2 * D * R + R + 2 * R * V + 3 * V


def relative_errors(got, ref):
    """Per name: max abs error over the reference's max abs value."""
    return {name: float((got[name] - ref[name]).abs().max()
                        / ref[name].abs().max().clamp_min(1e-30))
            for name in ref}


def serve_check(phase, transcriber, launched, idle, max_batch=8):
    """8 concurrent requests against ``make_server``: each answer equals
    the direct decode of that request alone; every counter in
    ``launched`` moves, none in ``idle`` does."""
    from attention_lvcsr_torch.serve import make_server
    server = make_server(transcriber, "127.0.0.1", 0, max_batch=max_batch,
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

        for c in list(launched.values()) + list(idle.values()):
            c.reset()
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=300)
        wall = time.perf_counter() - t0
        if errors or len(answers) != 8:
            fail(f"{phase}: {errors or 'missing answers'}")
        moved, still = counts(launched), counts(idle)
        if min(moved.values()) < 1 or any(still.values()):
            fail(f"{phase}: launches {moved}, expected none of {still}")
        for i, feats_i in enumerate(reqs):
            direct = transcriber.transcribe_batch([feats_i])[0]
            got = answers[i]
            costs = (got["cost"], direct["cost"])
            if got["labels"] != direct["labels"] or (
                    None in costs and costs[0] != costs[1]) or (
                    None not in costs and abs(costs[0] - costs[1])
                    > 1e-4 * max(1.0, abs(costs[1]))):
                fail(f"{phase}: request {i} answered {got} but the direct "
                     f"decode gives {direct}")
        finished = sum(a["cost"] is not None for a in answers.values())
        log(f"{phase}: 8 concurrent requests answered in {wall:.3f} s, "
            f"equal to the direct decode ({finished} with a finished "
            f"hypothesis); launches {moved}")
    finally:
        server.batcher.close()
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def timed_decodes(decode, n):
    """(last output, per-call seconds) of ``n`` synchronised decodes."""
    times, out = [], None
    for _ in range(n):
        t0 = time.perf_counter()
        out = decode()
        times.append(time.perf_counter() - t0)
    return out, times


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a GPU")
    try:
        import __graft_entry__  # noqa: F401  (the flagship's shapes)
        from attention_lvcsr_torch import _build
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
    results, launches, rates = {}, {}, {}
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)

    # ---- 1. build --------------------------------------------------------
    lib = _build.load()
    log(f"phase 1 build: {lib.build_seconds:.1f} s -> {lib.path}")
    for line in lib.log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    decode_phases(t, dev, results, launches, rates)
    gru_train_phase(t, dev, results)
    decoder_train_phase(t, dev, results)
    train_step_phase(t, dev, launches, rates)

    banned = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "attention_lvcsr_tpu"))
    if banned:
        fail(f"JAX or the JAX package was imported: {banned}")
    pallas = "attention_lvcsr_tpu/ops/pallas/"
    sources = {
        "gru_scan": ("gru_scan.cu", "gru_scan.py:72"),
        "beam_search_loop": ("beam_loop.cu", "beam_loop.py:638"),
        "beam_attention_energies": ("attention_energy.cu",
                                    "attention_energy.py:59"),
        "fused_decode_score": ("decode_score.cu", "decode_score.py:168"),
        "gru_scan_train": ("gru_train.cu", "gru_train.py:291"),
        "gru_scan_train_bidir": ("gru_train.cu", "gru_train.py:570"),
        "decoder_scan_train": ("decoder_train.cu", "decoder_train.py:839")}
    kernels = [dict({"name": name, "route": "cuda",
                     "source": f"attention_lvcsr_torch/csrc/{src}",
                     "replaces": pallas + tpu, "launches": launches[name]},
                    **results[name])
               for name, (src, tpu) in sources.items()]
    log(json.dumps(dict(rates, build_s=lib.build_seconds)))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def decode_phases(t, dev, results, launches, rates):
    """Phases 2-10: the serving kernels and the three decodes."""
    import torch
    from __graft_entry__ import FLAGSHIP_NET
    from attention_lvcsr_torch.models import attention as attention_mod
    from attention_lvcsr_torch.models import encoder as encoder_mod
    from attention_lvcsr_torch.models import generator as generator_mod
    from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
    from attention_lvcsr_torch.ops import attention_energy as ae
    from attention_lvcsr_torch.ops import beam_loop as bl
    from attention_lvcsr_torch.ops import decode_score as ds
    from attention_lvcsr_torch.ops import gru_scan as gs
    from attention_lvcsr_torch.search import beam as beam_mod
    from attention_lvcsr_torch.search.beam import DecodeConstraint
    from attention_lvcsr_torch.serve import Transcriber

    # ---- 2. gru_scan -----------------------------------------------------
    # the encoder's first layer: both directions in one launch
    rng = np.random.RandomState(0)
    T, B, D = 800, 64, 250
    lengths = rng.randint(300, T + 1, size=B)
    lengths[0] = T
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
        "plain_ms": cuda_ms(lambda: gs.gru_scan_reference(*args), 2),
        **bound(nbytes(proj, mask, *[w for d in weights for w in d], got),
                2 * T * B * gru_step_ops(D)),
        "library_ms": None}
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
            # per hypothesis row and step: the attention step, the
            # readout, the GRU advance with its feedback fork and
            # distribute products, and the selection over the symbols
            S, L = rec.net.generator.dim_dec, data["pre"].shape[1]
            M, D = data["pre"].shape[2], data["attended"].shape[2]
            R, V = 250, rec.num_phonemes
            row_ops = (attention_step_ops(S, M, L, 2 * 100 + 1, D)
                       + readout_ops(D, R, V) + 2 * (D + S) * 3 * S
                       + gru_step_ops(S) + 3 * V)
            loop_out = bl.beam_search_loop(*loop_args, **kw)
            results["beam_search_loop"] = {
                "ms": cuda_ms(lambda: bl.beam_search_loop(*loop_args, **kw),
                              3),
                "plain_ms": cuda_ms(
                    lambda: bl.beam_search_loop_reference(*loop_args, **kw),
                    1),
                **bound(nbytes(*loop_args[:3], tables, *loop_out),
                        10 * int(got["steps"].sum()) * row_ops),
                "library_ms": None}
    results["beam_search_loop"]["max_abs_err"] = loop_err
    log(f"  kernel {results['beam_search_loop']['ms']:.3f} ms, plain "
        f"{results['beam_search_loop']['plain_ms']:.3f} ms (U=64, main "
        f"path's tables)")

    # ---- 4. full decode through the recognizer -----------------------------
    Bd, Td = 64, 800
    feats_np = np.random.RandomState(2).randn(Bd, Td, 123).astype(np.float32)
    feats = torch.tensor(feats_np, device=dev)
    fmask = torch.ones(Bd, Td, device=dev)
    plain_encoder = (encoder_mod, "gru_scan", gs.gru_scan_reference)

    def decoder(recognizer, **kwargs):
        def decode():
            out = recognizer.beam_search(feats, fmask, as_arrays=True,
                                         **kwargs)
            torch.cuda.synchronize()
            return out
        return decode

    decode = decoder(rec)
    gs.launches.reset()
    bl.launches.reset()
    out = decode()
    launches.update(gru_scan=gs.launches.count,
                    beam_search_loop=bl.launches.count)
    log(f"phase 4 launches in one decode: {launches}")
    if min(launches.values()) < 1:
        fail(f"a kernel of the main path never launched: {launches}")
    if out["done_out"].shape != (Bd, 10, Td // 8) or not np.isfinite(
            out["done_cost"][out["done_valid"]]).all():
        fail("decode output has the wrong shape or non-finite costs")
    _, times = timed_decodes(decode, 5)
    rates["decode_utt_per_s"] = Bd / statistics.median(times)
    with swapped([plain_encoder, (beam_mod, "beam_search_loop",
                                  bl.beam_search_loop_reference)]):
        out_plain, ptimes = timed_decodes(decode, 2)
    rates["plain_decode_utt_per_s"] = Bd / statistics.median(ptimes)
    decode_err = compare_outputs("decode", out, out_plain)
    log(f"phase 4 decode B={Bd} frames={Td} beam=10 steps="
        f"{int(out['steps'])}: kernel path {rates['decode_utt_per_s']:.2f} "
        f"utt/s (median of 5, {[round(x, 4) for x in times]} s), plain path "
        f"{rates['plain_decode_utt_per_s']:.2f} utt/s; outputs agree (max "
        f"abs cost err {decode_err:.3e})")

    # ---- 5. serve -----------------------------------------------------------
    serve_check("phase 5 serve",
                Transcriber(rec, char_map=CHAR_MAP, beam_size=10),
                {"gru_scan": gs.launches, "beam_search_loop": bl.launches},
                {})

    # ---- 6. beam_attention_energies ----------------------------------------
    U, K, L, M = 64, 10, 200, 250
    erng = np.random.RandomState(6)
    eargs = (t(erng.randn(U, L, M)), t(erng.randn(U * K, M)),
             t(erng.randn(U * K, L) * 0.1), t(erng.randn(M) * 0.1),
             t(erng.randn(M) * 0.1))
    got = ae.beam_attention_energies(*eargs, 0.0, beam=K)
    ref = ae.beam_attention_energies_reference(*eargs, 0.0, beam=K)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    log(f"phase 6 beam_attention_energies U={U} K={K} L={L} M={M}: max abs "
        f"err {err:.3e}")
    if not err <= 1e-4:
        fail(f"beam_attention_energies disagrees with its plain version: "
             f"{err}")
    results["beam_attention_energies"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: ae.beam_attention_energies(*eargs, 0.0,
                                                         beam=K), 50),
        "plain_ms": cuda_ms(lambda: ae.beam_attention_energies_reference(
            *eargs, 0.0, beam=K), 10),
        **bound(nbytes(*eargs, got), 6 * U * K * L * M),
        "library_ms": None}
    log(f"  kernel {results['beam_attention_energies']['ms']:.4f} ms, plain "
        f"{results['beam_attention_energies']['plain_ms']:.4f} ms")

    # ---- 7. fused_decode_score ----------------------------------------------
    srng = np.random.RandomState(7)
    slen = srng.randint(400, Td + 1, size=U)
    smask = t((np.arange(Td)[None] < slen[:, None]).astype(np.float32))
    with torch.inference_mode():
        ctx = rec.net.decode_contexts(feats[:U], smask)
        tables = rec.net.generator.fused_score_tables()
        start = rec.net.decode_init(U * K, ctx)
    L = ctx["attended"].shape[1]
    logits = srng.randn(U * K, L) * 3.0
    later_w = np.exp(logits - logits.max(axis=1, keepdims=True))
    later_w /= later_w.sum(axis=1, keepdims=True)
    states_later = {
        "initial": (start["glimpses"]["weights"], start["glimpses"]["step"],
                    start["states"]),
        "later": (t(later_w), torch.full((U * K,), 37, dtype=torch.int32,
                                         device=dev),
                  t(np.tanh(srng.randn(U * K, rec.net.generator.dim_dec))))}
    priors = {"window_around_median": dict(before=prior["before"],
                                           after=prior["after"]),
              "expanding": dict(initial_begin=10.0, initial_end=120.0,
                                min_speed=0.5, max_speed=1.5)}
    score_err = 0.0
    for pname, pkw in priors.items():
        kw = dict(beam=K, prior=pname,
                  **{k: float(v) for k, v in pkw.items()})
        for sname, (w0, step0, h0) in states_later.items():
            sargs = (ctx["preprocessed"], ctx["attended"],
                     ctx["attended_mask"], w0.contiguous(),
                     step0.contiguous(), h0.contiguous(), tables)
            got = ds.fused_decode_score(*sargs, **kw)
            ref = ds.fused_decode_score_reference(*sargs, **kw)
            torch.cuda.synchronize()
            errs = {n: float((g - r).abs().max()) for n, g, r in zip(
                ("costs", "weights", "energies", "wa"), got, ref)}
            log(f"phase 7 fused_decode_score {pname} from the {sname} "
                f"glimpses: max abs err {errs}")
            if not max(errs.values()) <= 1e-4:
                fail(f"fused_decode_score disagrees with its plain version: "
                     f"{pname} {sname} {errs}")
            score_err = max(score_err, *errs.values())
    sargs = (ctx["preprocessed"], ctx["attended"], ctx["attended_mask"],
             t(later_w), states_later["later"][1], states_later["later"][2],
             tables)
    skw = dict(beam=K, prior="window_around_median",
               before=float(prior["before"]), after=float(prior["after"]))
    results["fused_decode_score"] = {
        "max_abs_err": score_err,
        "ms": cuda_ms(lambda: ds.fused_decode_score(*sargs, **skw), 50),
        "plain_ms": cuda_ms(lambda: ds.fused_decode_score_reference(
            *sargs, **skw), 10),
        **bound(nbytes(*sargs[:6], tables,
                       *ds.fused_decode_score(*sargs, **skw)),
                U * K * (attention_step_ops(
                    rec.net.generator.dim_dec, ctx["preprocessed"].shape[2],
                    L, 2 * 100 + 1, ctx["attended"].shape[2])
                    + readout_ops(ctx["attended"].shape[2], 250,
                                  rec.num_phonemes))),
        "library_ms": None}
    log(f"  kernel {results['fused_decode_score']['ms']:.4f} ms, plain "
        f"{results['fused_decode_score']['plain_ms']:.4f} ms (U=64, later "
        f"step, median prior)")

    # ---- 8. LM-fused decode --------------------------------------------------
    counters = {"gru_scan": gs.launches, "beam_search_loop": bl.launches,
                "beam_attention_energies": ae.launches,
                "fused_decode_score": ds.launches}
    with tempfile.TemporaryDirectory() as tmp:
        lm_path = os.path.join(tmp, "lm_trigram.npz")
        n_states = bench_trigram(lm_path)
        rec_lm = SpeechRecognizer(
            dict(net_config, lm={"path": lm_path, "weight": 0.5,
                                 "no_transition_cost": 20.0}),
            init_config=FLAGSHIP_INIT, seed=1234, device=dev)
    rec_lm.init_beam_search(10)
    decode_lm = decoder(rec_lm, char_discount=1.0)
    for c in counters.values():
        c.reset()
    out = decode_lm()
    moved = counts(counters)
    launches["beam_attention_energies"] = moved["beam_attention_energies"]
    log(f"phase 8 LM trigram {n_states} states; launches in one LM-fused "
        f"decode: {moved}")
    if moved["gru_scan"] < 1 or moved["beam_attention_energies"] < 1 \
            or moved["beam_search_loop"]:
        fail(f"LM-fused decode did not run through its kernels: {moved}")
    if out["done_out"].shape != (Bd, 10, Td) or not np.isfinite(
            out["done_cost"][out["done_valid"]]).all():
        fail("LM decode output has the wrong shape or non-finite costs")
    _, times = timed_decodes(decode_lm, 3)
    rates["lm_decode_utt_per_s"] = Bd / statistics.median(times)
    plain_lm = [plain_encoder, (attention_mod, "beam_attention_energies",
                                ae.beam_attention_energies_reference)]
    with swapped(plain_lm):
        out_plain, ptimes = timed_decodes(decode_lm, 1)
    rates["plain_lm_decode_utt_per_s"] = Bd / statistics.median(ptimes)
    lm_err = compare_outputs("LM decode", out, out_plain)
    log(f"phase 8 LM decode B={Bd} frames={Td} beam=10 char_discount=1.0 "
        f"steps={int(out['steps'])}: kernel path "
        f"{rates['lm_decode_utt_per_s']:.2f} utt/s (median of 3, "
        f"{[round(x, 4) for x in times]} s), plain path "
        f"{rates['plain_lm_decode_utt_per_s']:.2f} utt/s; outputs agree, "
        f"{int(out['done_valid'].sum())} slots finished (max abs cost err "
        f"{lm_err:.3e})")
    post_b = rec_lm.net.generator.readout.post_merge_0.bias
    post_b.data[rec_lm.eos_label] += 1.5
    out = decode_lm()
    with swapped(plain_lm):
        out_plain = decode_lm()
    lm_err = max(lm_err, compare_outputs("LM decode, EOS +1.5", out,
                                         out_plain))
    finished = int(out["done_valid"].any(axis=1).sum())
    log(f"phase 8 LM decode with the EOS logit +1.5: outputs agree; "
        f"{finished}/{Bd} utterances finished, steps {int(out['steps'])}")
    if finished < 1:
        fail("LM decode with the EOS logit raised finished nothing: the "
             "comparison is too weak")
    post_b.data[rec_lm.eos_label] -= 1.5

    # ---- 9. constrained decode through fused_decode_score -------------------
    wrng = np.random.RandomState(9)
    words = sorted({"".join(wrng.choice(CHARS[:26], size=wrng.randint(2, 8)))
                    for _ in range(300)})
    constraint = DecodeConstraint.from_words(words, CHAR_MAP, 32)
    rec_c = SpeechRecognizer(dict(net_config, use_pallas="fused"),
                             init_config=FLAGSHIP_INIT, seed=1234, device=dev)
    rec_c.net.generator.readout.post_merge_0.bias.data[rec_c.eos_label] += 1.5
    rec_c.init_beam_search(10)
    decode_c = decoder(rec_c, char_discount=1.0,
                       validate_solution_function=constraint)
    for c in counters.values():
        c.reset()
    out = decode_c()
    moved = counts(counters)
    launches["fused_decode_score"] = moved["fused_decode_score"]
    log(f"phase 9 lexicon of {len(words)} words, constraint "
        f"{constraint.trans.shape[0]} states; launches in one constrained "
        f"decode: {moved}")
    if moved["fused_decode_score"] < 1 or moved["gru_scan"] < 1:
        fail(f"constrained decode did not run through its kernels: {moved}")
    n_checked = 0
    for u, k in zip(*np.nonzero(out["done_valid"])):
        tokens = [int(x) for x in out["done_out"][u, k, :out["done_len"][u, k]]]
        body = tokens[:-1]
        if rec_c.data_prepend_eos and body and body[0] == rec_c.eos_label:
            body = body[1:]
        state = 0
        for sym in body:
            state = int(constraint.trans[state, sym])
            if state < 0:
                break
        if state < 0 or tokens[-1] != rec_c.eos_label \
                or not constraint.final[state]:
            fail(f"constrained decode: utterance {u} slot {k} finished with "
                 f"{tokens}, which the constraint rejects")
        n_checked += 1
    if n_checked < 1:
        fail("constrained decode finished nothing: the check is too weak")
    _, times = timed_decodes(decode_c, 3)
    rates["constrained_decode_utt_per_s"] = Bd / statistics.median(times)
    with swapped([plain_encoder, (generator_mod, "fused_decode_score",
                                  ds.fused_decode_score_reference)]):
        out_plain, ptimes = timed_decodes(decode_c, 1)
    rates["plain_constrained_decode_utt_per_s"] = Bd / statistics.median(
        ptimes)
    c_err = compare_outputs("constrained decode", out, out_plain)
    log(f"phase 9 constrained decode B={Bd} frames={Td} beam=10 "
        f"steps={int(out['steps'])}: {n_checked} finished hypotheses, all "
        f"accepted by the constraint; kernel path "
        f"{rates['constrained_decode_utt_per_s']:.2f} utt/s (median of 3), "
        f"plain path {rates['plain_constrained_decode_utt_per_s']:.2f} "
        f"utt/s; outputs agree (max abs cost err {c_err:.3e})")

    # ---- 10. serve with the LM ----------------------------------------------
    # one request per batch: the module-driven decode takes its attention
    # window over the whole batch (as the JAX package's does), so a
    # request's answer equals its direct decode only when it decodes alone
    serve_check("phase 10 serve with the LM",
                Transcriber(rec_lm, char_map=CHAR_MAP, beam_size=10,
                            search_kwargs={"char_discount": 1.0}),
                {"gru_scan": gs.launches,
                 "beam_attention_energies": ae.launches},
                {"beam_search_loop": bl.launches}, max_batch=1)

    rates["lm_decode_max_abs_cost_err"] = lm_err


def grads_of(fn, leaves, cots):
    """Outputs of ``fn(*leaves)`` and the gradients of every leaf under
    the cotangents ``cots`` (one per differentiable output)."""
    import torch
    xs = [x.detach().requires_grad_() for x in leaves]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = torch.autograd.grad(outs[:len(cots)], xs, cots)
    return [o.detach() for o in outs], grads


def repeat(name, grads, again):
    """The kernels' gradients of a second call equal the first's bit for
    bit: every sum in them is taken in a fixed order."""
    import torch
    if not all(torch.equal(g, h) for g, h in zip(grads, again[1])):
        fail(f"{name}: a second call gave other gradients")


def backward_ms(fn, leaves, cots, repeats):
    """Device time of the backward pass alone: the graph is built once and
    its gradient taken ``repeats`` times."""
    import torch
    xs = [x.detach().requires_grad_() for x in leaves]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return cuda_ms(lambda: torch.autograd.grad(
        outs[:len(cots)], xs, cots, retain_graph=True), repeats)


def gru_train_phase(t, dev, results):
    """Phase 11: gru_scan_train's forward and backward kernels vs the plain
    version (autograd through the plain scan), the flagship encoder's
    first layer: T=800, B=32, D=250, ragged mask, random cotangent."""
    from attention_lvcsr_torch.ops import gru_train as gt
    rng = np.random.RandomState(11)
    T, B, D = 800, 32, 250
    lengths = rng.randint(300, T + 1, size=B)
    lengths[0] = T
    mask = t((np.arange(T)[:, None] < lengths[None, :]).astype(np.float32))
    for ndir, name in ((1, "gru_scan_train"), (2, "gru_scan_train_bidir")):
        proj = t(rng.randn(T, B, 3 * D * ndir) * 0.5)
        dirs = [(t(rng.randn(B, D) * 0.1), t(rng.randn(D, D) / np.sqrt(D)),
                 t(rng.randn(D, 2 * D) / np.sqrt(D))) for _ in range(ndir)]
        cots = [t(rng.randn(T, B, D * ndir))]
        leaves = [proj] + [w for d in dirs for w in d]

        def scan(fn):
            return lambda p, *w: fn(p, mask, tuple(w[:3]),
                                    tuple(w[3:]) if ndir == 2 else None)

        (got,), ggot = grads_of(scan(gt.gru_scan_train), leaves, cots)
        (ref,), gref = grads_of(scan(gt.gru_scan_train_reference), leaves,
                                cots)
        named = lambda out, g: dict(
            {"states": out},
            **{f"{part}[{i}]": g[0][..., 3 * D * i + a:3 * D * i + b]
               for i in range(ndir)
               for part, a, b in (("dx_in", 0, D), ("dx_gate", D, 3 * D))},
            **{f"{part}[{i}]": g[1 + 3 * i + k] for i in range(ndir)
               for k, part in enumerate(("dh0", "dW_ss", "dW_sg"))})
        errs = relative_errors(named(got, ggot), named(ref, gref))
        state_err = float((got - ref).abs().max())
        log(f"phase 11 {name} T={T} B={B} D={D}: states max abs err "
            f"{state_err:.3e}; gradients, max abs err over max abs value: "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()
                        if k != "states"))
        # states: f32 in another summation order, |h| < 1 (1e-5 absolute);
        # gradients: sums over the reverse recurrence and, for the weights,
        # over T*B = 25600 rows in another order (1e-4 of their scale)
        if not (state_err <= 1e-5
                and max(v for k, v in errs.items() if k != "states")
                <= 1e-4):
            fail(f"{name} disagrees with its plain version")
        repeat(name, ggot, grads_of(scan(gt.gru_scan_train), leaves, cots))
        fwd = scan(gt.gru_scan_train)
        plain = scan(gt.gru_scan_train_reference)
        fwd_ms = cuda_ms(lambda: fwd(*leaves), 3)
        bwd_ms = backward_ms(fwd, leaves, cots, 3)
        plain_fwd = cuda_ms(lambda: plain(*leaves), 1)
        plain_bwd = backward_ms(plain, leaves, cots, 1)
        # forward: the projections, mask, weights in; states and the three
        # residuals out.  Backward: cotangent, states, residuals, mask and
        # weights in; the projections' and weights' gradients out; twice
        # the forward's products (state gradient, weight gradients)
        weights = [w for d in dirs for w in d]
        fwd_bytes = nbytes(proj, mask, *weights) + 4 * nbytes(got)
        bwd_bytes = 5 * nbytes(got) + nbytes(mask, *weights, proj) \
            + nbytes(*weights)
        ops = ndir * T * B * gru_step_ops(D)
        results[name] = {
            "max_abs_err": max(state_err, *[
                float((a - b).abs().max()) for a, b in zip(ggot, gref)]),
            "ms": fwd_ms + bwd_ms, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
            "plain_ms": plain_fwd + plain_bwd, "plain_fwd_ms": plain_fwd,
            "plain_bwd_ms": plain_bwd,
            **bound(fwd_bytes + bwd_bytes, 3 * ops),
            "fwd_bound_ms": bound(fwd_bytes, ops)["bound_ms"],
            "bwd_bound_ms": bound(bwd_bytes, 2 * ops)["bound_ms"],
            "library_ms": None}
        log(f"  kernels: forward {fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms; "
            f"plain: forward {plain_fwd:.3f} ms, backward {plain_bwd:.3f} "
            f"ms; bound {results[name]['bound_ms']:.3f} ms")


def decoder_operands(t, dev, rng, T=100, B=32, L=200, M=250, D=500, S=250,
                     taps=201):
    """Flagship-shaped operands of decoder_scan_train, ragged label and
    frame masks (row 0 full: the expanding prior counts its steps)."""
    import torch
    from attention_lvcsr_torch.ops.decoder_train import toeplitz_band
    f = lambda *s, scale=1.0: t(rng.randn(*s) * scale)
    labels = rng.randint(T // 2, T + 1, size=B)
    labels[0] = T
    frames = rng.randint(L // 2, L + 1, size=B)
    frames[0] = L
    w0 = torch.zeros(B, L, device=dev)
    w0[:, 0] = 1.0
    ops = dict(
        fx=f(T, B, S), fg=f(T, B, 2 * S), pre=f(B, L, M, scale=0.5),
        attended=f(B, L, D, scale=0.5), h0=f(B, S, scale=0.1),
        wa0=torch.zeros(B, D, device=dev),
        toep=toeplitz_band(f(1, taps, scale=0.1), L),
        st=f(S, M, scale=0.1), hand=f(1, M, scale=0.1),
        v=f(M, scale=0.1), wss=f(S, S, scale=1 / np.sqrt(S)),
        wsg=f(S, 2 * S, scale=1 / np.sqrt(S)), dxm=f(D, S, scale=0.05),
        dgm=f(D, 2 * S, scale=0.05))
    fixed = dict(
        mask=t((np.arange(T)[:, None] < labels[None]).astype(np.float32)),
        att_mask=t((np.arange(L)[None] < frames[:, None]).astype(
            np.float32)),
        w0=w0)
    cots = [f(T, B, S), f(T, B, L), f(T, B, D)]
    return ops, fixed, cots


def decoder_train_phase(t, dev, results):
    """Phase 12: decoder_scan_train's forward and backward kernels vs the
    plain version at the flagship decoder's shapes (T=100 labels, B=32,
    L=200 frames, M=250, D=500, S=250, 201 taps), both priors, ragged
    label and frame masks: the outputs and every gradient."""
    from attention_lvcsr_torch.ops import decoder_train as dt
    rng = np.random.RandomState(12)
    ops, fixed, cots = decoder_operands(t, dev, rng)
    names = list(ops)
    priors = {"expanding": {"type": "expanding", "initial_begin": 0,
                            "initial_end": 40, "min_speed": 1.2,
                            "max_speed": 2.2},
              "window_around_median": {"type": "window_around_median",
                                       "before": 100, "after": 100}}

    def scan(fn, prior):
        def call(*xs):
            d = dict(zip(names, xs))
            return fn(d["fx"], d["fg"], fixed["mask"], d["pre"],
                      d["attended"], fixed["att_mask"], d["h0"], fixed["w0"],
                      d["wa0"], d["toep"], d["st"], d["hand"], d["v"],
                      d["wss"], d["wsg"], d["dxm"], d["dgm"], prior=prior)
        return call

    leaves = [ops[n] for n in names]
    worst, abs_err = 0.0, 0.0
    for pname, prior in priors.items():
        got, ggot = grads_of(scan(dt.decoder_scan_train, prior), leaves,
                             cots)
        ref, gref = grads_of(scan(dt.decoder_scan_train_reference, prior),
                             leaves, cots)
        outs = ("h", "weights", "wa", "energies")
        errs = relative_errors(
            dict(zip(outs, got), **{f"d{n}": g for n, g in zip(names, ggot)}),
            dict(zip(outs, ref), **{f"d{n}": g for n, g in zip(names, gref)}))
        log(f"phase 12 decoder_scan_train {pname}: max abs err over max abs "
            f"value: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        # f32 in another summation order through 100 dependent steps; the
        # parameter gradients also sum over B*T rows (1e-4 of their scale)
        if not max(errs.values()) <= 1e-4:
            fail(f"decoder_scan_train disagrees with its plain version "
                 f"({pname})")
        repeat(f"decoder_scan_train ({pname})", ggot,
               grads_of(scan(dt.decoder_scan_train, prior), leaves, cots))
        worst = max(worst, *errs.values())
        abs_err = max(abs_err, *[float((a - b).abs().max()) for a, b in
                                 zip(list(got) + list(ggot),
                                     list(ref) + list(gref))])
    prior = priors["window_around_median"]
    fwd = scan(dt.decoder_scan_train, prior)
    plain = scan(dt.decoder_scan_train_reference, prior)
    fwd_ms = cuda_ms(lambda: fwd(*leaves), 3)
    bwd_ms = backward_ms(fwd, leaves, cots, 3)
    plain_fwd = cuda_ms(lambda: plain(*leaves), 1)
    plain_bwd = backward_ms(plain, leaves, cots, 1)
    T, B, S = ops["fx"].shape
    L, M, D = ops["pre"].shape[1], ops["pre"].shape[2], \
        ops["attended"].shape[2]
    # one step of one row: the attention step with its Toeplitz band
    # (2L^2), the distribute products (2 * D * 3S) and the GRU step; the
    # backward recomputes the attention step and does twice the products
    row_ops = attention_step_ops(S, M, L, L, D) + 2 * D * 3 * S \
        + gru_step_ops(S)
    n_ops = T * B * row_ops
    fwd_bytes = nbytes(*leaves, *fixed.values()) + nbytes(*got) \
        + 3 * nbytes(got[0])
    bwd_bytes = nbytes(*leaves, *fixed.values(), *cots, *got) \
        + 3 * nbytes(got[0]) + nbytes(*gref)
    results["decoder_scan_train"] = {
        "max_abs_err": abs_err, "max_rel_err": worst,
        "ms": fwd_ms + bwd_ms, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
        "plain_ms": plain_fwd + plain_bwd, "plain_fwd_ms": plain_fwd,
        "plain_bwd_ms": plain_bwd,
        **bound(fwd_bytes + bwd_bytes, 4 * n_ops),
        "fwd_bound_ms": bound(fwd_bytes, n_ops)["bound_ms"],
        "bwd_bound_ms": bound(bwd_bytes, 3 * n_ops)["bound_ms"],
        "library_ms": None}
    log(f"  kernels: forward {fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms; "
        f"plain: forward {plain_fwd:.3f} ms, backward {plain_bwd:.3f} ms; "
        f"bound {results['decoder_scan_train']['bound_ms']:.3f} ms "
        f"(median prior)")


def train_step_phase(t, dev, launches, rates):
    """Phase 13: the flagship training step, five steps of
    ``make_train_step`` through ``run_training`` with wsj_paper.yaml's rule
    chain (clip 100, adadelta 0.95 / 1e-8, max_norm 1.0), B=32, 800 frames,
    100 labels, ragged: on the kernel route and on the plain route from
    the same parameters and batches; then two steps of the same model with
    a one-directional encoder (the path of the one-direction kernel)."""
    import torch
    from __graft_entry__ import FLAGSHIP_NET
    from attention_lvcsr_torch.models import cells as cells_mod
    from attention_lvcsr_torch.models import encoder as encoder_mod
    from attention_lvcsr_torch.models import generator as generator_mod
    from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
    from attention_lvcsr_torch.ops import decoder_train as dt
    from attention_lvcsr_torch.ops import gru_scan as gs
    from attention_lvcsr_torch.ops import gru_train as gt
    from attention_lvcsr_torch.train.checkpoint import load_checkpoint
    from attention_lvcsr_torch.train.driver import run_training
    from attention_lvcsr_torch.train.rules import build_optimizer

    config = {"training": {"gradient_threshold": 100.0, "rules": ["adadelta"],
                           "decay_rate": 0.95, "epsilon": 1e-8},
              "regularization": {"max_norm": 1.0}}
    B, T, TL, V = 32, 800, 100, FLAGSHIP_NET["num_phonemes"]
    rng = np.random.RandomState(13)
    batches = []
    for _ in range(5):
        frames = rng.randint(T * 3 // 4, T + 1, size=B)
        labels = rng.randint(TL * 3 // 4, TL + 1, size=B)
        frames[0], labels[0] = T, TL
        batches.append({
            "recordings": t(rng.randn(B, T, 123)),
            "recordings_mask": t(np.arange(T)[None] < frames[:, None]),
            "labels": torch.tensor(rng.randint(0, V - 1, size=(B, TL)),
                                   device=dev),
            "labels_mask": t(np.arange(TL)[None] < labels[:, None])})
    counters = {"gru_scan_train": gt.launches,
                "gru_scan_train_bidir": gt.launches_bidir,
                "decoder_scan_train": dt.launches, "gru_scan": gs.launches}
    plain = [(encoder_mod, "gru_scan_train", gt.gru_scan_train_reference),
             (cells_mod, "gru_scan_train", gt.gru_scan_train_reference),
             (generator_mod, "decoder_scan_train",
              dt.decoder_scan_train_reference)]

    def train(net, n, save):
        rec = SpeechRecognizer(net, init_config=FLAGSHIP_INIT, seed=1234,
                               device=dev)
        opt = build_optimizer(config["training"], config["regularization"])
        for c in counters.values():
            c.reset()
        loop = run_training(rec, opt, lambda: batches[:n], save, config,
                            num_batches=n, printing=False)
        torch.cuda.synchronize()
        moved = counts(counters)
        log_ = loop.log
        return rec, loop, moved, {
            k: np.array(log_.channel(k)[1]) for k in (
                "train_cost", "total_gradient_norm", "time_train_this_batch")}

    def train_plain(net, n, save):
        """``train`` with every training scan swapped for its plain version;
        fails if a training kernel launched all the same."""
        with swapped(plain):
            _, _, pmoved, ref = train(net, n, save)
        if any(pmoved[k] for k in ("gru_scan_train", "gru_scan_train_bidir",
                                   "decoder_scan_train")):
            fail(f"the plain route launched kernels: {pmoved}")
        return ref

    def agree(name, got, ref):
        """Per step: train_cost and total_gradient_norm within 1e-4
        relative (f32 in another summation order through the encoder's
        800-step scans and the decoder's 100, carried over the steps)."""
        for key in ("train_cost", "total_gradient_norm"):
            rel = np.abs(got[key] - ref[key]) / np.abs(ref[key])
            log(f"phase 13 {name}: {key} per step {got[key].tolist()} vs "
                f"plain {ref[key].tolist()} (max rel err {rel.max():.2e})")
            if not (np.isfinite(got[key]).all() and rel.max() <= 1e-4):
                fail(f"{name}: {key} disagrees with the plain route")

    with tempfile.TemporaryDirectory() as tmp:
        save = os.path.join(tmp, "flagship.zip")
        rec, loop, moved, got = train(dict(FLAGSHIP_NET), 5, save)
        log(f"phase 13 launches in 5 flagship training steps: {moved}")
        if min(moved["gru_scan_train_bidir"], moved["decoder_scan_train"]) \
                < 1 or moved["gru_scan"]:
            fail(f"the training step did not run through its kernels: "
                 f"{moved}")
        launches.update(gru_scan_train_bidir=moved["gru_scan_train_bidir"],
                        decoder_scan_train=moved["decoder_scan_train"])
        state = load_checkpoint(save)
        same = all(np.array_equal(state["parameters"][k], v)
                   for k, v in rec.param_path_dict().items()) \
            and set(state["parameters"]) == set(rec.param_path_dict())
        saved = loop.algorithm.opt_state_arrays()
        same_opt = state["opt_state"] is not None and set(
            state["opt_state"]) == set(saved) and all(
            np.array_equal(state["opt_state"][k], v)
            for k, v in saved.items())
        if not (same and same_opt and state["meta"]["iterations_done"] == 5):
            fail("the checkpoint does not read back as it was trained")
        ref = train_plain(dict(FLAGSHIP_NET), 5,
                          os.path.join(tmp, "plain.zip"))
        agree("flagship", got, ref)
        _, _, _, again = train(dict(FLAGSHIP_NET), 5,
                               os.path.join(tmp, "again.zip"))
        if any(not np.array_equal(again[k], got[k])
               for k in ("train_cost", "total_gradient_norm")):
            fail("a second run of the kernel route gave other monitors")
        rates["train_step_utt_per_s"] = B / float(
            np.median(got["time_train_this_batch"]))
        rates["plain_train_step_utt_per_s"] = B / float(
            np.median(ref["time_train_this_batch"]))
        log(f"phase 13 flagship training step B={B} frames={T} labels={TL}: "
            f"kernel route {rates['train_step_utt_per_s']:.2f} utt/s (median "
            f"of 5 steps, "
            f"{[round(float(x), 4) for x in got['time_train_this_batch']]} s), "
            f"plain route {rates['plain_train_step_utt_per_s']:.2f} utt/s; "
            f"the checkpoint reads back identical (parameters and "
            f"optimizer state); a second kernel run repeats the per-step "
            f"train_cost and total_gradient_norm bit for bit")

        uni = dict(FLAGSHIP_NET, bidir=False)
        _, _, moved, got = train(uni, 2, os.path.join(tmp, "uni.zip"))
        log(f"phase 13 launches in 2 one-directional training steps: "
            f"{moved}")
        if moved["gru_scan_train"] < 1 or moved["decoder_scan_train"] < 1:
            fail(f"the one-directional step did not run through its "
                 f"kernels: {moved}")
        launches["gru_scan_train"] = moved["gru_scan_train"]
        ref = train_plain(uni, 2, os.path.join(tmp, "uni_plain.zip"))
        agree("one-directional encoder", got, ref)
        rates["uni_train_step_utt_per_s"] = B / float(
            np.median(got["time_train_this_batch"]))


if __name__ == "__main__":
    main()
