#!/usr/bin/env python3
"""Where the time goes in the port's flagship decode (one NVIDIA GPU).

    python3 tools/torch_profile_decode.py [--net gru|lstm]
        [--out profile_decode.txt]

Run from the repository root on a machine with a CUDA device and nvcc.
Drives the decode ``chip_smoke.py`` drives (``FLAGSHIP_NET``, random
weights from seed 1234, B=64, 800 frames, beam 10) and reports:

1. ``torch.profiler`` over one ``beam_search`` of each decode route:
   the whole-loop kernel (no LM), the LM-fused module-driven decode
   (``chip_smoke.py``'s trigram, weight 0.5, char_discount 1.0) and the
   dictionary-constrained decode under ``use_pallas: fused``
   (``chip_smoke.py`` phase 9): device time per kernel, the device's busy
   time and the window's wall time, hence its idle share.  With ``--net
   lstm`` the network has a 4x250 BiLSTM encoder and only the no-LM route
   runs (``chip_smoke.py`` phase 17's decode);
2. cycles per step inside each CUDA kernel, phase by phase.  The tool
   copies ``csrc/beam_loop_body.cuh`` (with ``beam_loop.cu``, its
   resident instances) and the encoder's scan,
   ``csrc/gru_scan.cu`` (or ``csrc/lstm_scan.cu``), into
   ``build/profile/``, puts a ``clock64()`` probe (after a
   ``__syncthreads``) before every ``// ---- <phase>`` comment inside
   each kernel's step loop and one after the loop, builds the copies into
   a separate library and runs the kernels from it: the scan's probe at
   the encoder's first layer (T=800, B=64, both directions), the
   beam_search_loop probe on the decode's own tables.  The probes add
   barriers, so per-phase shares are what they read; the kernels' times
   come from part 1.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOTS, BLOCKS = 32, 256
INIT = {"/recognizer": {"weights_init": ["isotropic_gaussian", 0.1],
                        "biases_init": ["constant", 0.0],
                        "rec_weights_init": ["orthogonal"]}}


def instrument(src, loop_header, tag, body=False):
    """``src`` with a probe before each ``// ---- name`` comment inside the
    loop that starts at ``loop_header`` and one after that loop; returns
    (source, phase names).  With ``body``, ``loop_header`` opens a
    kernel's body instead, whose phase comments sit at its top level, and
    the last probe goes before the body's end."""
    lines = src.split("\n")
    start = next(i for i, ln in enumerate(lines) if loop_header in ln)
    depth, end = 0, None
    for i in range(start, len(lines)):
        depth += lines[i].count("{") - lines[i].count("}")
        if depth == 0:
            end = i
            break
    indent = "  " if body else "    "
    names, out = [], []
    for i, ln in enumerate(lines):
        m = re.match(indent + r"// ---- (.*?)[ -]*$", ln)
        if i == start and not body:
            out.append("  long long prof_last = 0; int prof_cur = -1;")
        if m and start < i < end:
            out.append(f"{indent}PROF_MARK_{tag}({len(names)});")
            names.append(m.group(1).strip())
        if i == end and body:
            out.append(f"  PROF_MARK_{tag}({SLOTS - 1});")
        out.append(ln)
        if i == start and body:
            out.append("  long long prof_last = 0; int prof_cur = -1;")
        if i == end and not body:
            out.append(f"  PROF_MARK_{tag}({SLOTS - 1});")
    if not names:
        raise RuntimeError(f"no '// ---- ' phase comments in the {tag} loop")
    block = "(blockIdx.y * gridDim.x + blockIdx.x)"
    header = (
        f"__device__ unsigned long long prof_{tag}[{BLOCKS * SLOTS}];\n"
        f"#define PROF_MARK_{tag}(n) do {{ __syncthreads(); "
        f"if (threadIdx.x == 0 && {block} < {BLOCKS}) {{ "
        f"long long t_ = clock64(); if (prof_cur >= 0) "
        f"prof_{tag}[{block} * {SLOTS} + prof_cur] += t_ - prof_last; "
        f"prof_last = t_; prof_cur = (n); }} }} while (0)\n")
    footer = (
        f'\nextern "C" int prof_read_{tag}(void* host) {{ return (int)'
        f"cudaMemcpyFromSymbol(host, prof_{tag}, sizeof(prof_{tag})); }}\n"
        f'extern "C" int prof_reset_{tag}() {{ static unsigned long long '
        f"z[{BLOCKS * SLOTS}]; return (int)cudaMemcpyToSymbol(prof_{tag}, z, "
        f"sizeof(z)); }}\n")
    text = "\n".join(out).replace("#include <cuda_runtime.h>\n",
                                  "#include <cuda_runtime.h>\n" + header, 1)
    return text + footer, names


def phase_table(lib, tag, names, blocks, steps, out):
    buf = (ctypes.c_ulonglong * (BLOCKS * SLOTS))()
    if getattr(lib, f"prof_read_{tag}")(buf) != 0:
        raise RuntimeError(f"reading the {tag} probes failed")
    cycles = np.array(buf[:], np.float64).reshape(BLOCKS, SLOTS)[:blocks]
    total = cycles.sum()
    for i, name in enumerate(names):
        out(f"  {name[:60]:60s} {cycles[:, i].sum() / total * 100:6.2f} % "
            f"{cycles[:, i].sum() / blocks / steps:10.0f} cycles/step/block")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--net", choices=("gru", "lstm"), default="gru",
                        help="the encoder's transition")
    parser.add_argument("--out", default=None,
                        help="also write the report to this file")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, ROOT)
    from __graft_entry__ import FLAGSHIP_NET
    from attention_lvcsr_torch import _build
    from attention_lvcsr_torch.models.recognizer import SpeechRecognizer
    from attention_lvcsr_torch.ops import beam_loop as bl
    from attention_lvcsr_torch.ops import decode_score as ds
    from attention_lvcsr_torch.ops import gru_scan as gs
    from attention_lvcsr_torch.ops import lstm_scan as ls
    from torch.profiler import ProfilerActivity, profile

    lines = []

    def out(msg):
        print(msg, flush=True)
        lines.append(msg)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                        "clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                       capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda:0")
    lstm = args.net == "lstm"
    net_config = dict(FLAGSHIP_NET, max_decoded_length_scale=8.0,
                      **({"enc_transition": "LSTM"} if lstm else {}))
    rec = SpeechRecognizer(net_config, init_config=INIT, seed=1234,
                           device=dev)
    rec.init_beam_search(10)
    B, T = 64, 800
    feats = torch.tensor(np.random.RandomState(2).randn(B, T, 123)
                         .astype(np.float32), device=dev)
    mask = torch.ones(B, T, device=dev)

    # ---- 1. torch.profiler over one decode of each route -------------------
    def profile_decode(label, recognizer, **kwargs):
        for _ in range(2):
            recognizer.beam_search(feats, mask, as_arrays=True, **kwargs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            result = recognizer.beam_search(feats, mask, as_arrays=True,
                                            **kwargs)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if not kernels:
            out(f"{label}: torch.profiler saw no device activity: not "
                f"measured")
            return
        per_name, spans = {}, []
        for e in kernels:
            start, end = e.time_range.start, e.time_range.end
            ms, count = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (ms + (end - start) / 1e3, count + 1)
            spans.append((start, end))
        busy, reach = 0.0, -np.inf          # union of the kernel spans
        for start, end in sorted(spans):
            busy += max(0.0, end - max(start, reach)) / 1e3
            reach = max(reach, end)
        out(f"{label} decode B={B} frames={T} beam=10 steps="
            f"{int(result['steps'])}: device busy {busy:.3f} ms of a "
            f"{window_ms:.3f} ms window (idle "
            f"{100 * (1 - busy / window_ms):.1f} %), {len(kernels)} kernel "
            f"launches")
        for name, (ms, count) in sorted(per_name.items(),
                                        key=lambda kv: -kv[1][0])[:12]:
            out(f"  {ms:9.3f} ms {100 * ms / busy:5.1f} %  x{count:<5d} "
                f"{name[:70]}")

    from chip_smoke import CHAR_MAP, CHARS, bench_trigram
    from attention_lvcsr_torch.search.beam import DecodeConstraint
    profile_decode(f"{args.net} encoder, loop kernel (no LM)", rec)
    if not lstm:
        with tempfile.TemporaryDirectory() as tmp:
            lm_path = os.path.join(tmp, "lm_trigram.npz")
            bench_trigram(lm_path)
            rec_lm = SpeechRecognizer(
                dict(net_config, lm={"path": lm_path, "weight": 0.5,
                                     "no_transition_cost": 20.0}),
                init_config=INIT, seed=1234, device=dev)
        rec_lm.init_beam_search(10)
        profile_decode("LM-fused", rec_lm, char_discount=1.0)
        wrng = np.random.RandomState(9)
        words = sorted({"".join(wrng.choice(CHARS[:26],
                                            size=wrng.randint(2, 8)))
                        for _ in range(300)})
        rec_c = SpeechRecognizer(dict(net_config, use_pallas="fused"),
                                 init_config=INIT, seed=1234, device=dev)
        rec_c.net.generator.readout.post_merge_0.bias.data[
            rec_c.eos_label] += 1.5
        rec_c.init_beam_search(10)
        profile_decode("constrained (fused score, EOS +1.5)", rec_c,
                       char_discount=1.0,
                       validate_solution_function=DecodeConstraint.from_words(
                           words, CHAR_MAP, 32))

    # ---- 2. phase probes inside the kernels ---------------------------------
    with torch.inference_mode():
        data = rec.net.decode_loop(feats, mask)
        tables = rec.net.decode_loop_tables()
    os.makedirs(os.path.join(ROOT, "build", "profile"), exist_ok=True)
    paths, phases = [], {}
    scan_src = "lstm_scan.cu" if lstm else "gru_scan.cu"
    for name, header, tag in (
            ("beam_loop_body.cuh", "for (int i = 0; i < max_len; ++i) {",
             "beam"),
            (scan_src, "for (int step = 0; step < T; ++step) {", "scan"),
            ("decode_score.cu", "decode_score_kernel(DecodeScoreArgs a) {",
             "score")):
        src = open(os.path.join(_build.CSRC, name)).read()
        text, phases[tag] = instrument(src, header, tag, tag == "score")
        with open(os.path.join(ROOT, "build", "profile", name), "w") as f:
            f.write(text)
        # the loop's body is a header: its resident instances' source,
        # copied beside it, includes the probed copy
        unit = "beam_loop.cu" if name.endswith(".cuh") else name
        paths.append(os.path.join(ROOT, "build", "profile", unit))
        if unit != name:
            shutil.copy(os.path.join(_build.CSRC, unit), paths[-1])
    lib_path = os.path.join(ROOT, "build", "profile", "libprofile.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                           "-I", _build.CSRC, "-o", lib_path, *paths],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"probe build failed:\n{proc.stderr[-4000:]}")
    # the wrappers launch from whatever library _build has loaded
    _build._loaded = _build.KernelLibrary(lib_path, 0.0, proc.stderr)
    ds._entries = None
    ds._active.clear()
    lib = _build._loaded.lib

    prior = rec.net.generator.attention.prior_config()
    lib.prof_reset_beam()
    with torch.inference_mode():
        _, _, steps = bl.beam_search_loop(
            data["pre"], data["attended"], data["attended_mask"], tables,
            beam=10, max_len=T // 8, eol=rec.eos_label,
            ignore_first_eol=rec.data_prepend_eos, prior=prior["type"],
            before=float(prior["before"]), after=float(prior["after"]))
    torch.cuda.synchronize()
    n_steps = int(steps.max())
    out(f"beam_search_loop phases (U={B}, {n_steps} steps):")
    phase_table(lib, "beam", phases["beam"], B, n_steps, out)

    rng = np.random.RandomState(0)
    D = 250
    t = lambda a: torch.tensor(a.astype(np.float32), device=dev)
    if lstm:
        weights = [(t(rng.randn(B, D) * 0.1), t(rng.randn(B, D) * 0.1),
                    t(rng.randn(D, 4 * D) / np.sqrt(D)), t(rng.randn(D) * 0.1),
                    t(rng.randn(D) * 0.1), t(rng.randn(D) * 0.1))
                   for _ in range(2)]
        proj = t(rng.randn(T, B, 8 * D) * 0.5)
        scan, module = ls.lstm_scan, ls
    else:
        weights = [(t(rng.randn(B, D) * 0.1),
                    t(rng.randn(D, D) / np.sqrt(D)),
                    t(rng.randn(D, 2 * D) / np.sqrt(D))) for _ in range(2)]
        proj = t(rng.randn(T, B, 6 * D) * 0.5)
        scan, module = gs.gru_scan, gs
    lib.prof_reset_scan()
    scan(proj, mask.t().contiguous(), *weights)
    torch.cuda.synchronize()
    name = scan.__name__
    out(f"{name} phases (T={T}, B={B}, D={D}, both directions):")
    cluster = module.launch_plan(D, B, 2, dev)["cluster"]
    out(f"  ({cluster}-block clusters)")
    phase_table(lib, "scan", phases["scan"],
                2 * cluster * ((B + 15) // 16), T, out)

    if not lstm:
        score_phases(rec, dev, lib, phases["score"], T, out)

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


def score_phases(rec, dev, lib, names, frames, out):
    """Cycles of each phase of one ``fused_decode_score`` launch (the
    constrained decode's step) at U=64 and 128, from a later step: random
    softmax-normalised weights at step 37 and random states, the median
    prior, on the flagship's encoder outputs and tables."""
    import torch
    from attention_lvcsr_torch.ops import decode_score as ds
    K = 10
    prior = rec.net.generator.attention.prior_config()
    tables = rec.net.generator.fused_score_tables()
    for U in (64, 128):
        rng = np.random.RandomState(7)
        t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
        lengths = rng.randint(400, frames + 1, size=U)
        with torch.inference_mode():
            ctx = rec.net.decode_contexts(
                t(rng.randn(U, frames, 123)),
                t(np.arange(frames)[None] < lengths[:, None]))
        L = ctx["attended"].shape[1]
        logits = rng.randn(U * K, L) * 3.0
        w = np.exp(logits - logits.max(axis=1, keepdims=True))
        w /= w.sum(axis=1, keepdims=True)
        args = (ctx["preprocessed"], ctx["attended"], ctx["attended_mask"],
                t(w), torch.full((U * K,), 37, dtype=torch.int32, device=dev),
                t(np.tanh(rng.randn(U * K, rec.net.generator.dim_dec))),
                tables)
        kw = dict(beam=K, prior="window_around_median",
                  before=float(prior["before"]), after=float(prior["after"]))
        ds.fused_decode_score(*args, **kw)
        lib.prof_reset_score()
        ds.fused_decode_score(*args, **kw)
        torch.cuda.synchronize()
        cluster = ds.launch_plan(U, dict(
            K=K, L=L, M=args[0].shape[2], D=args[1].shape[2],
            S=args[5].shape[1], R=tables["merge_k"].shape[1],
            V=tables["post_k"].shape[1],
            n_taps=tables["conv_filters"].shape[-1]), dev)["cluster"]
        out(f"decode_score phases (U={U}, K={K}, L={L}, median prior, a "
            f"later step; {cluster}-block clusters), one launch:")
        phase_table(lib, "score", names, U * cluster, 1, out)


if __name__ == "__main__":
    main()
