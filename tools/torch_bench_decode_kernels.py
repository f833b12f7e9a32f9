#!/usr/bin/env python3
"""Times the decode kernels on one NVIDIA GPU, each alone, and keeps the
whole-loop kernel's outputs for a bit-for-bit comparison with another
commit's.

    python3 tools/torch_bench_decode_kernels.py [--root DIR] [--out F.npz]
                                                [--repeats N]
                                                [--only loop|energy|score|
                                                        frontend]
                                                [--frontend-rows R,R]
    python3 tools/torch_bench_decode_kernels.py --beams 18,64,200,512
                                                [--root DIR] [--out F.npz]
    python3 tools/torch_bench_decode_kernels.py --compare A.npz B.npz

Run from the repository root on a machine with a CUDA device and nvcc.
On the flagship network (``__graft_entry__.FLAGSHIP_NET``, random weights
from seed 1234, the initialisation ``chip_smoke.py`` uses), for U = 64, 128
and 256 utterances of 800 frames of numpy-seeded features, the encoder's
outputs and the loop tables are made once; then ``beam_search_loop``
(``csrc/beam_loop.cu``: beam 10, a 100-step cap) is timed with CUDA events
around ``--repeats`` launches.  At U=64 it also runs with the EOS logit
raised by 1.5, so that most hypotheses finish, and calls the kernel a
second time to check that it repeats its bits.  ``--out`` writes each
run's ``done_out``, ``done_meta`` and ``steps`` to an ``.npz``.

``--only energy`` times the module path's energy kernel
(``beam_attention_energies``, ``csrc/attention_energy.cu``) at K=10,
L=200, M=250 on numpy-seeded operands, at U = 64, 128 and 256, and
``--only score`` the fused score step (``fused_decode_score``,
``csrc/decode_score.cu``) on the flagship network's encoder outputs and
tables, from a later step's softmax-normalised random weights, under both
priors, at U = 1, 8, 16, 33, 64, 128 and 256: on the size of cluster its
launch plan takes and, where the package has a plan, on each other size
forced; each with CUDA events around a CUDA graph of ``--repeats``
launches (100 unless given; the graph, ``chip_smoke.graph_ms``, keeps the
wrapper's host time out of a kernel of tens of microseconds), its max abs
error against the plain version and whether a second call repeats its
bits.  ``--only frontend`` times the waveform frontend (``fbank_deltas``,
``csrc/frontend.cu``) the same way at B=1 and B=64 rows of 8 s at 16 and
8 kHz (phase 14's speech-like audio, ragged true frame counts), with its
launch plan where the package has one, and with ``--frontend-rows`` on
each tile of output frames listed as well.  ``--only`` takes a
comma-separated list; ``loop`` is the default.

``--beams K,K`` times the whole-loop kernel's workspace instances
(``csrc/beam_loop_ws.cu``, named with ``instance="workspace"``, which
beams from 18 up take anyway) at those beams instead, on
``chip_smoke.py`` phase 25a's cases: the flagship's tables, U=64
utterances of 600-800 frames from seed 25 (U=8 at beam 512), the EOS
logit raised by 1.5, a 100-step cap, with
``--repeats`` launches (default 3; 1 from beam 200 up), and ``--out``
keeps each decode's outputs.  Run in turns on this tree and on an
unpacked copy of the parent commit (``--root``, below): parent, tree,
tree, parent, in one call; ``--compare`` then says whether the two gave
the same bits.

``--root DIR`` imports the ``attention_lvcsr_torch`` package found in DIR
instead of this checkout's and builds its kernels there: with DIR an
unpacked copy of another commit (``git archive <commit>
attention_lvcsr_torch __graft_entry__.py | tar -x -C DIR``), runs in turns
time two versions on the same card.  ``--compare`` reports, key by key,
whether two such files hold the same bits.  The last line is a JSON object
of the numbers.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.1],
                        "biases_init": ["constant", 0.0],
                        "rec_weights_init": ["orthogonal"]}}


def compare(path_a, path_b):
    a, b = np.load(path_a), np.load(path_b)
    same = {}
    for key in sorted(set(a.files) | set(b.files)):
        same[key] = (key in a.files and key in b.files
                     and a[key].dtype == b[key].dtype
                     and a[key].shape == b[key].shape
                     and a[key].tobytes() == b[key].tobytes())
        print(f"{key}: {'same bits' if same[key] else 'DIFFERENT'}")
    print(json.dumps({"a": path_a, "b": path_b, "all_same": all(same.values()),
                      "same": same}))
    return all(same.values())


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=ROOT,
                        help="directory holding the attention_lvcsr_torch "
                             "package to time")
    parser.add_argument("--out", default=None,
                        help="write the decodes' outputs to this .npz")
    parser.add_argument("--repeats", type=int, default=None,
                        help="launches timed (default 3 for the loop, 100 "
                             "for the energy, score and frontend kernels)")
    parser.add_argument("--only", default="loop",
                        help="comma-separated kernels to time: loop, "
                             "energy, score, frontend")
    parser.add_argument("--frontend-rows", default=None,
                        help="comma-separated tiles (output frames a "
                             "block) to force on the frontend kernel, "
                             "beside its plan's")
    parser.add_argument("--beams", default=None,
                        help="comma-separated beams: time phase 25a's "
                             "wide-beam decodes instead")
    parser.add_argument("--compare", nargs=2, metavar="NPZ")
    args = parser.parse_args()
    if args.compare:
        sys.exit(0 if compare(*args.compare) else 1)
    only = args.only.split(",")
    unknown = sorted(set(only) - {"loop", "energy", "score", "frontend"})
    if unknown:
        sys.exit(f"--only: unknown kernels {unknown}")
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, ROOT)
    from chip_smoke import graph_ms, speech_like
    sys.path.insert(0, os.path.abspath(args.root))
    from __graft_entry__ import FLAGSHIP_NET
    from attention_lvcsr_torch import _build
    from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
    from attention_lvcsr_torch.ops import beam_loop as bl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    print(f"package: {os.path.dirname(bl.__file__)}")
    lib = _build.load()
    names = {"loop": ("beam_loop", "product_rows"),
             "energy": ("attention_energy",), "score": ("decode_score",),
             "frontend": ("frontend",)}
    names = [n for key in only for n in names[key]]
    mine = False            # ptxas lines of the timed kernels
    for line in lib.log.splitlines():
        if "Compiling entry" in line:
            mine = any(n in line for n in names)
        if mine and ("Compiling entry" in line or "Used" in line
                     or "spill" in line):
            print(f"  ptxas: {line.strip()}")
    dev = torch.device("cuda:0")
    result = {"card": card, "root": os.path.abspath(args.root)}
    if "frontend" in only:
        forced = [int(r) for r in args.frontend_rows.split(",")] \
            if args.frontend_rows else []
        bench_frontend(dev, graph_ms, speech_like, args.repeats or 100,
                       result, forced)
        if only == ["frontend"]:           # no network to build
            print(json.dumps(result))
            return

    def cuda_ms(fn, repeats):
        for _ in range(max(1, min(20, repeats))):    # warm up the clocks
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

    rec = SpeechRecognizer(dict(FLAGSHIP_NET, max_decoded_length_scale=8.0),
                           init_config=INIT, seed=1234, device=dev)
    rec.init_beam_search(10)
    prior = rec.net.generator.attention.prior_config()
    if args.beams:
        bench_wide(rec, dev, cuda_ms, [int(k) for k in args.beams.split(",")],
                   args.repeats, result, args.out)
        print(json.dumps(result))
        return
    frames = 800
    kw = dict(beam=10, max_len=frames // 8, eol=rec.eos_label,
              ignore_first_eol=rec.data_prepend_eos, prior=prior["type"],
              before=float(prior["before"]), after=float(prior["after"]))
    if "energy" in only:
        bench_energy(dev, graph_ms, args.repeats or 100, result)
    if "score" in only:
        bench_score(rec, dev, graph_ms, args.repeats or 100, result)
    if "loop" in only:
        bench_loop(rec, dev, cuda_ms, args.repeats or 3, kw, frames, result,
                   args.out)
    print(json.dumps(result))


def bench_loop(rec, dev, cuda_ms, n_repeats, kw, frames, result, out_path):
    import torch
    from attention_lvcsr_torch.ops import beam_loop as bl
    arrays = {}
    for U in (64, 128, 256):
        feats = torch.tensor(np.random.RandomState(1).randn(U, frames, 123)
                             .astype(np.float32), device=dev)
        with torch.inference_mode():
            data = rec.net.decode_loop(feats, torch.ones(U, frames,
                                                         device=dev))
            tables = dict(rec.net.decode_loop_tables())
        loop_args = (data["pre"], data["attended"], data["attended_mask"])
        for eos_bias in ((0.0, 1.5) if U == 64 else (0.0,)):
            tab = dict(tables)
            tab["post_b"] = tables["post_b"].clone()
            tab["post_b"][rec.eos_label] += eos_bias
            out = [x.cpu().numpy()
                   for x in bl.beam_search_loop(*loop_args, tab, **kw)]
            tag = f"U{U}_eos{eos_bias}"
            for name, x in zip(("done_out", "done_meta", "steps"), out):
                arrays[f"{tag}_{name}"] = x
            if U == 64:
                again = [x.cpu().numpy()
                         for x in bl.beam_search_loop(*loop_args, tab, **kw)]
                result[f"{tag}_repeats_bits"] = all(
                    x.tobytes() == y.tobytes() for x, y in zip(out, again))
            if eos_bias == 0.0:
                ms = cuda_ms(lambda: bl.beam_search_loop(*loop_args, tab,
                                                         **kw), n_repeats)
                result[f"beam_search_loop_U{U}_ms"] = ms
                steps = out[2]
                print(f"beam_search_loop U={U} frames={frames} beam=10: "
                      f"{ms:.3f} ms (steps {int(steps.min())}.."
                      f"{int(steps.max())}, {ms * 1e3 / int(steps.max()):.1f}"
                      f" us a step)")
            finished = int((out[1][:, :, 1] < bl.INF / 2).any(axis=1).sum())
            repeats = result.get(f"{tag}_repeats_bits")
            print(f"  U={U} eos_bias={eos_bias}: {finished}/{U} utterances "
                  f"finished" + ("" if repeats is None else
                                 f"; a second call repeats its bits: "
                                 f"{repeats}"))
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        np.savez(out_path, **arrays)


def bench_wide(rec, dev, cuda_ms, beams, repeats, result, out_path):
    """The whole-loop kernel at each beam of ``beams`` on phase 25a's
    input (``chip_smoke.py::wide_beam_loops``): U=64 (8 at beam 512),
    600-800 frames from seed 25, the EOS logit raised by 1.5, a 100-step
    cap; ``repeats`` launches timed (default 3, 1 from beam 200 up)."""
    import torch
    from attention_lvcsr_torch.ops import beam_loop as bl
    frames = 800
    rng = np.random.RandomState(25)
    feats = torch.tensor(rng.randn(64, frames, 123).astype(np.float32),
                         device=dev)
    lengths = rng.randint(600, frames + 1, size=64)
    lengths[0] = frames
    fmask = torch.tensor((np.arange(frames)[None] < lengths[:, None])
                         .astype(np.float32), device=dev)
    with torch.inference_mode():
        data = rec.net.decode_loop(feats, fmask)
        tables = dict(rec.net.decode_loop_tables())
    tables["post_b"] = tables["post_b"].clone()
    tables["post_b"][rec.eos_label] += 1.5
    prior = rec.net.generator.attention.prior_config()
    kw = dict(max_len=frames // 8, eol=rec.eos_label, ignore_first_eol=True,
              prior=prior["type"], instance="workspace",
              **{k: float(v) for k, v in prior.items() if k != "type"})
    arrays = {}
    for K in beams:
        U = 8 if K >= 512 else 64
        args = (data["pre"][:U], data["attended"][:U],
                data["attended_mask"][:U], tables)
        bl.launches_ws.reset()
        out = [x.cpu().numpy() for x in bl.beam_search_loop(*args, beam=K,
                                                            **kw)]
        if bl.launches_ws.count != 1:
            sys.exit(f"beam {K}: the workspace instance did not launch")
        for name, x in zip(("done_out", "done_meta", "steps"), out):
            arrays[f"beam{K}_U{U}_{name}"] = x
        n = repeats or (1 if K >= 200 else 3)
        ms = cuda_ms(lambda: bl.beam_search_loop(*args, beam=K, **kw), n)
        result[f"beam_search_loop_beam{K}_U{U}_ms"] = ms
        steps = out[2]
        print(f"beam_search_loop (workspace) U={U} beam={K}: {ms:.3f} ms "
              f"(steps {int(steps.min())}..{int(steps.max())}, "
              f"{ms / max(int(steps.max()), 1):.3f} ms a step)", flush=True)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        np.savez(out_path, **arrays)


def bench_energy(dev, cuda_ms, repeats, result):
    """``beam_attention_energies`` alone at U = 64, 128, 256 (phase 6's
    operands at each U)."""
    import torch
    from attention_lvcsr_torch.ops import attention_energy as ae
    K, L, M = 10, 200, 250
    for U in (64, 128, 256):
        rng = np.random.RandomState(6)
        t = lambda a: torch.tensor(a.astype(np.float32), device=dev)
        eargs = (t(rng.randn(U, L, M)), t(rng.randn(U * K, M)),
                 t(rng.randn(U * K, L) * 0.1), t(rng.randn(M) * 0.1),
                 t(rng.randn(M) * 0.1))
        got = ae.beam_attention_energies(*eargs, 0.0, beam=K)
        again = ae.beam_attention_energies(*eargs, 0.0, beam=K)
        ref = ae.beam_attention_energies_reference(*eargs, 0.0, beam=K)
        err = float((got - ref).abs().max())
        same = bool(torch.equal(got, again))
        ms = cuda_ms(lambda: ae.beam_attention_energies(*eargs, 0.0, beam=K),
                     repeats)
        plan = getattr(ae, "launch_plan", None)
        plan = plan(U, K, L, M, dev) if plan else None
        result[f"attention_energy_U{U}_ms"] = ms
        print(f"beam_attention_energies U={U} K={K} L={L} M={M}: {ms:.4f} ms"
              f", max abs err {err:.3e}, a second call repeats its bits: "
              f"{same}" + (f", plan {plan}" if plan else ""))


@contextlib.contextmanager
def forced_rows(fe, rows):
    """Within the block, the frontend's launches take tiles of ``rows``
    output frames (at most what a block holds); ``None`` leaves its plan
    alone."""
    if rows is None:
        yield
        return
    planned = fe.plan

    def plan(B, T, sample_rate, num_bins=40, use_energy=True, order=2,
             sms=132, limit=fe.MAX_SMEM):
        r = min(rows, fe.max_rows(sample_rate, num_bins, use_energy, order,
                                  limit))
        return {"rows": r, "frames": r + 2 * order * fe.DELTA_WINDOW,
                "blocks": B * -(-T // r),
                "smem_bytes": fe.layout(sample_rate, num_bins, use_energy,
                                        order, r)["bytes"]}
    fe.plan = plan
    try:
        yield
    finally:
        fe.plan = planned


def bench_frontend(dev, cuda_ms, speech_like, repeats, result, forced=()):
    """``fbank_deltas`` alone at B = 1 and 64 rows of 8 s, 16 and 8 kHz,
    on its plan's tiles and on each tile of ``forced``."""
    import torch
    from attention_lvcsr_torch.ops import frontend as fe
    planned = hasattr(fe, "plan")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for rate in (16000, 8000):
        for B in (1, 64):
            rng = np.random.RandomState(14)
            N = 8 * rate
            frame_length, hop, _ = fe.frame_geometry(rate)
            T = 1 + (N - frame_length) // hop
            lengths = rng.randint(2 * rate, N + 1, size=B)
            lengths[0] = N
            wav_np = np.zeros((B, N), np.float32)
            for b, n in enumerate(lengths):
                wav_np[b, :n] = speech_like(rng, n, rate)
            wav = torch.tensor(wav_np, device=dev)
            counts = torch.tensor(1 + (lengths - frame_length) // hop,
                                  device=dev)
            run = lambda: fe.fbank_deltas(wav, counts, sample_rate=rate)
            ref = fe.fbank_deltas_plain(wav, counts, sample_rate=rate)
            valid = torch.arange(T, device=dev)[None] < counts[:, None]
            for rows in [None, *(forced if planned else ())]:
                with forced_rows(fe, rows):
                    got, again = run(), run()
                    ms = cuda_ms(run, repeats)
                    plan = fe.plan(B, T, rate, sms=sms) if planned else None
                err = float((got - ref).abs()[valid].max())
                same = bool(torch.equal(got, again))
                result[f"fbank_deltas_{rate}_B{B}"
                       + (f"_rows{rows}" if rows else "") + "_ms"] = ms
                print(f"fbank_deltas {rate} Hz B={B} T={T}: {ms:.4f} ms, "
                      f"max abs err {err:.3e} (log domain, valid rows), a "
                      f"second call repeats its bits: {same}"
                      + (f", plan {plan}" if plan else "")
                      + (" (forced)" if rows else ""))


@contextlib.contextmanager
def forced_cluster(ds, size):
    """Within the block, the score kernel's launcher takes clusters of
    ``size`` blocks (its occupancy query answered as if the card held no
    other size); ``None`` leaves its plan alone."""
    if size is None:
        yield
        return
    queried = ds.active_clusters
    ds.active_clusters = lambda shape, device: {
        c: 1024 if c == size else 0 for c in ds.CLUSTERS}
    try:
        yield
    finally:
        ds.active_clusters = queried


def bench_score(rec, dev, cuda_ms, repeats, result):
    """``fused_decode_score`` alone at U = 1-256 on the flagship network's
    contexts and tables, from a later step (phase 7's), on its plan's
    cluster size and on each other size forced."""
    import torch
    from attention_lvcsr_torch.ops import decode_score as ds
    K, frames = 10, 800
    prior = rec.net.generator.attention.prior_config()
    priors = {"median": dict(prior="window_around_median",
                             before=float(prior["before"]),
                             after=float(prior["after"])),
              "expanding": dict(prior="expanding", initial_begin=10.0,
                                initial_end=120.0, min_speed=0.5,
                                max_speed=1.5)}
    tables = rec.net.generator.fused_score_tables()
    planned = hasattr(ds, "launch_plan")
    for U in (1, 8, 16, 33, 64, 128, 256):
        rng = np.random.RandomState(7)
        t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
        feats = t(np.random.RandomState(1).randn(U, frames, 123))
        slen = rng.randint(400, frames + 1, size=U)
        smask = t((np.arange(frames)[None] < slen[:, None]))
        with torch.inference_mode():
            ctx = rec.net.decode_contexts(feats, smask)
        L = ctx["attended"].shape[1]
        logits = rng.randn(U * K, L) * 3.0
        w = np.exp(logits - logits.max(axis=1, keepdims=True))
        w /= w.sum(axis=1, keepdims=True)
        sargs = (ctx["preprocessed"], ctx["attended"], ctx["attended_mask"],
                 t(w), torch.full((U * K,), 37, dtype=torch.int32,
                                  device=dev),
                 t(np.tanh(rng.randn(U * K, rec.net.generator.dim_dec))),
                 tables)
        shape = dict(K=K, L=L, M=sargs[0].shape[2], D=sargs[1].shape[2],
                     S=sargs[5].shape[1], R=tables["merge_k"].shape[1],
                     V=tables["post_k"].shape[1],
                     n_taps=tables["conv_filters"].shape[-1])
        plan = ds.launch_plan(U, shape, dev) if planned else None
        sizes = [None] + ([c for c in ds.CLUSTERS if c != plan["cluster"]]
                          if planned else [])
        for size in sizes:
            with forced_cluster(ds, size):
                for pname, kw in priors.items():
                    got = ds.fused_decode_score(*sargs, beam=K, **kw)
                    again = ds.fused_decode_score(*sargs, beam=K, **kw)
                    ref = ds.fused_decode_score_reference(*sargs, beam=K,
                                                          **kw)
                    err = max(float((g - r).abs().max())
                              for g, r in zip(got, ref))
                    same = all(torch.equal(g, a) for g, a in zip(got, again))
                    ms = cuda_ms(lambda: ds.fused_decode_score(
                        *sargs, beam=K, **kw), repeats)
                    on = (f"cluster {size} (forced)" if size else
                          f"plan {plan}" if plan else "")
                    key = f"decode_score_{pname}_U{U}" + (
                        f"_C{size}" if size else "")
                    result[f"{key}_ms"] = ms
                    print(f"fused_decode_score {pname} U={U} K={K} L={L}: "
                          f"{ms:.4f} ms, max abs err {err:.3e}, a second "
                          f"call repeats its bits: {same}"
                          + (f", {on}" if on else ""))


if __name__ == "__main__":
    main()
