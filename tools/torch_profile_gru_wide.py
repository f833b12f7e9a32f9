#!/usr/bin/env python3
"""Where the time goes inside the GRU kernels' wide instances (one NVIDIA
GPU).

    python3 tools/torch_profile_gru_wide.py [--root DIR] [--out FILE]

Run from the repository root on a machine with a CUDA device and nvcc.
Copies ``csrc/gru_scan.cu``, ``csrc/gru_train.cu``, ``csrc/outer_sum.cu``
and their headers into ``build/profile_wide/``, puts a ``clock64()``
probe (after a ``__syncthreads``, as ``tools/torch_profile_decode.py``
does) before each phase of the step loops of ``gru_wide_kernel`` and
``gru_bwd_wide_kernel`` and one after each loop, and times each warp's
waits on the weight ring inside the products; builds the copies into a
library of their own and runs from it, with inputs from one seed:

* the forward (``gru_scan``) at U=64, both directions, a ragged mask,
  D=500 over 800 frames and D=1000 over 400 (wsj_pyramide.yaml's wide
  layers at the serving batch), on the cluster size the launch plan takes;
* the backward kernel alone at B=32, both directions, the same widths,
  on the probed forward's states and residuals.

For each case it prints cycles a step and a block, phase by phase: the
products (their ring waits apart), the slice sums and the gate
arithmetic, the cluster barriers, the distributed-shared-memory pulls,
and the stores and prefetches; then the probed launch's time.  It also
prints how many clusters of 8 and of 16 blocks of the wide forward the
card holds at each width.  The probes add barriers, so the shares are
what they read; the kernels' own times come from
``tools/torch_bench_gru_ring.py``.

``--root DIR`` probes the package found in DIR instead (an unpacked copy
of another commit: ``git archive <commit> attention_lvcsr_torch | tar -x
-C DIR``); the phases are found by the statements that open them, which
both layouts of the kernels share.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOTS, BLOCKS, WARPS = 32, 256, 16
STEP_LOOP = "for (int step = 0; step < T; ++step) {"
PRODUCT = r"stream_partials\(|\.product\("

# (regex of the loop-level statement that opens the phase, phase name),
# in the order the step runs them
FORWARD = [
    (PRODUCT, "product: gates"),
    (r"__syncthreads\(\);", "slice sums, gate arithmetic"),
    (r"cluster_arrive\(\);", "cluster arrive"),
    (r"if \(d\.u != nullptr\)", "stores (u, r)"),
    (r"cluster_wait\(\);", "cluster wait"),
    (r"pull_peers<", "pull (r * h)"),
    (PRODUCT, "product: candidates"),
    (r"__syncthreads\(\);", "slice sums, candidate arithmetic"),
    (r"cluster_arrive\(\);", "cluster arrive"),
    (r"if \(step \+ 1 < T\) prefetch", "prefetch, stores (out, c)"),
    (r"cluster_wait\(\);", "cluster wait"),
    (r"if \(step \+ 1 < T\) \{", "pull (state)"),
]
BACKWARD = [
    (r"cp_async_wait<0>\(\);", "elementwise (du, da)"),
    (r"cluster\.sync\(\);", "cluster sync"),
    (r"pull_slices<", "pull (da)"),
    (PRODUCT, "product: da @ w_state^T"),
    (r"__syncthreads\(\);", "slice sums, gate gradients"),
    (r"cluster_arrive\(\);", "cluster arrive"),
    (r"if \(step \+ 1 < T\) prefetch", "prefetch, stores (dx, dg)"),
    (r"cluster_wait\(\);", "cluster wait"),
    (r"pull_slices<", "pull (du, dr)"),
    (PRODUCT, "product: dg @ w_gates^T"),
    (r"__syncthreads\(\);", "slice sums"),
]
# each warp's cycles inside the products (lane 0's clock), in either
# layout of the ring: (regex, counter, name); its waits for a tile (the
# cp.async ring's wait and block barrier, or a full barrier's wait) and
# its releases
TIMERS = [
    (r"( *)(cp_async_wait<kRingStages - 2>\(\);\n *__syncthreads\(\);)", 0,
     "ring waits (a warp's mean)"),
    (r"( *)(mbar_wait\(full[^;]*\);)", 0, "ring waits (a warp's mean)"),
    (r"( *)(release\([^;()\n]*\);)", 1, "releases (a warp's mean)"),
    (r"( *)(if \(\(tid & 31\) == 0\) claim\([^;()\n]*\);)", 2,
     "claims and copies (a warp's mean)"),
]


def header(tag):
    block = "(blockIdx.y * gridDim.x + blockIdx.x)"
    return (
        f"static __device__ unsigned long long prof_{tag}"
        f"[{BLOCKS * SLOTS}];\n"
        f"#define PROF_MARK_{tag}(n) do {{ __syncthreads(); "
        f"if (threadIdx.x == 0 && {block} < {BLOCKS}) {{ "
        f"long long t_ = clock64(); if (prof_cur >= 0) "
        f"prof_{tag}[{block} * {SLOTS} + prof_cur] += t_ - prof_last; "
        f"prof_last = t_; prof_cur = (n); }} }} while (0)\n")


def footer(tag):
    return (
        f'\nextern "C" int prof_read_{tag}(void* host) {{ return '
        f"(int)cudaMemcpyFromSymbol(host, prof_{tag}, sizeof(prof_{tag})); }}\n"
        f'extern "C" int prof_reset_{tag}() {{ static unsigned long '
        f"long z[{BLOCKS * SLOTS}]; return (int)cudaMemcpyToSymbol("
        f"prof_{tag}, z, sizeof(z)); }}\n")


def probe_loop(src, kernel, anchors, tag):
    """``src`` with a probe before each anchor's statement in the step loop
    of ``kernel`` (each searched after the one before, at the loop's own
    indentation) and one after the loop; the ring wait's counter and the
    reading entry points appended."""
    lines = src.split("\n")
    k = next(i for i, ln in enumerate(lines) if kernel in ln)
    start = next(i for i in range(k, len(lines)) if STEP_LOOP in lines[i])
    depth, end = 0, None
    for i in range(start, len(lines)):
        depth += lines[i].count("{") - lines[i].count("}")
        if depth == 0:
            end = i
            break
    marks, pos = {}, start + 1
    for n, (pattern, _) in enumerate(anchors):
        i = next((i for i in range(pos, end)
                  if re.match(r"    \S", lines[i])
                  and re.search(pattern, lines[i])), None)
        if i is None:
            raise RuntimeError(f"{kernel}: no statement {pattern!r} after "
                               f"line {pos}")
        marks[i] = n
        pos = i + 1
    out = []
    for i, ln in enumerate(lines):
        if i == start:
            out.append("  long long prof_last = 0; int prof_cur = -1;")
        if i in marks:
            out.append(f"    PROF_MARK_{tag}({marks[i]});")
        out.append(ln)
        if i == end:
            out.append(f"  PROF_MARK_{tag}({SLOTS - 1});")
    text = "\n".join(out)
    text = text.replace("#include <cuda_runtime.h>\n",
                        "#include <cuda_runtime.h>\n" + header(tag), 1)
    return text + footer(tag) + footer(f"wait_{tag}")


def probe_waits(header_src, tag):
    """The wide header with each warp's cycles in each of the TIMERS it has
    added to its counter of ``prof_wait_<tag>`` (counters a block; the
    header is included by both kernels' sources, each with its own tag);
    returns (text, {counter: name})."""
    block = "(blockIdx.y * gridDim.x + blockIdx.x)"
    text, names = header_src, {}
    for pattern, slot, name in TIMERS:
        if not re.search(pattern, text):
            continue
        timed = (r"\1{ long long pw_ = clock64();\n\1\2\n"
                 rf"\1if ((threadIdx.x & 31) == 0 && {block} < {BLOCKS}) "
                 rf"atomicAdd(&prof_wait_{tag}[{block} * {SLOTS} + {slot}], "
                 r"(unsigned long long)(clock64() - pw_)); }")
        text = re.sub(pattern, timed, text)
        names[slot] = name
    if 0 not in names:
        raise RuntimeError("no ring wait found in gru_wide.cuh")
    decl = (f"static __device__ unsigned long long prof_wait_{tag}"
            f"[{BLOCKS * SLOTS}];\n")
    return text.replace("namespace {\n", decl + "namespace {\n", 1), names


def build(csrc, out_dir, nvcc, flags):
    """The probed library: (path, ptxas log, {counter: name} of the
    timers inside the products)."""
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    for name in os.listdir(csrc):
        if name.endswith(".cuh"):
            shutil.copy(os.path.join(csrc, name), out_dir)
    wide = open(os.path.join(csrc, "gru_wide.cuh")).read()
    texts = {}
    for name, kernel, anchors, tag in (
            ("gru_scan.cu", "gru_wide_kernel(const", FORWARD, "fwd"),
            ("gru_train.cu", "gru_bwd_wide_kernel(const", BACKWARD, "bwd")):
        src = open(os.path.join(csrc, name)).read()
        # each source includes its own probed copy of the wide header
        with open(os.path.join(out_dir, f"gru_wide_{tag}.cuh"), "w") as f:
            text, timers = probe_waits(wide, tag)
            f.write(text)
        src = src.replace('#include "gru_wide.cuh"',
                          f'#include "gru_wide_{tag}.cuh"')
        texts[name] = probe_loop(src, kernel, anchors, tag)
    texts["outer_sum.cu"] = open(os.path.join(csrc, "outer_sum.cu")).read()
    paths = []
    for name, text in texts.items():
        paths.append(os.path.join(out_dir, name))
        with open(paths[-1], "w") as f:
            f.write(text)
    lib = os.path.join(out_dir, "libprofile_wide.so")
    proc = subprocess.run([nvcc, *flags, "-shared", "-o", lib, *paths],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"probe build failed:\n{proc.stderr[-4000:]}")
    return lib, proc.stderr, timers


def ptxas_report(log, names=("gru_wide_kernel", "gru_bwd_wide_kernel")):
    """ptxas's stack, spill and register lines of the kernels ``names``
    (of the unprobed build's log)."""
    found, keep = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            keep = any(name in ln for name in names)
            if keep:
                found.append(ln.split("'")[1] if "'" in ln else ln)
        elif keep and ("spill" in ln or "registers" in ln):
            found.append(ln.strip())
    return found


def table(lib, tag, anchors, timers, blocks, steps, out):
    buf = (ctypes.c_ulonglong * (BLOCKS * SLOTS))()
    wait = (ctypes.c_ulonglong * (BLOCKS * SLOTS))()
    for name, into in ((f"prof_read_{tag}", buf),
                       (f"prof_read_wait_{tag}", wait)):
        if getattr(lib, name)(into) != 0:
            raise RuntimeError(f"{name} failed")
    cycles = np.array(buf[:], np.float64).reshape(BLOCKS, SLOTS)[:blocks]
    inner = np.array(wait[:], np.float64).reshape(BLOCKS, SLOTS)[:blocks]
    per = cycles.sum(0) / blocks / steps
    inside = {name: inner[:, n].sum() / blocks / steps / WARPS
              for n, name in sorted(timers.items())}
    total = per.sum()
    rows = {}
    for n, (_, name) in enumerate(anchors):
        if name.startswith("product"):
            rows["products (FMAs, loads)"] = rows.get(
                "products (FMAs, loads)", 0.0) + per[n]
        else:
            group = re.sub(r" \(.*\)$", "", name) if name.startswith(
                ("cluster", "pull")) else name
            rows[group] = rows.get(group, 0.0) + per[n]
    rows["products (FMAs, loads)"] -= sum(inside.values())
    rows = {**inside, **rows}
    for name, c in rows.items():
        out(f"  {name[:52]:52s} {c:10.0f} cycles {100 * c / total:6.2f} %")
    out(f"  {'a step':52s} {total:10.0f} cycles")
    out("  phase by phase: " + "; ".join(
        f"{name} {per[n]:.0f}" for n, (_, name) in enumerate(anchors)))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=ROOT,
                        help="directory holding the attention_lvcsr_torch "
                             "package to probe")
    parser.add_argument("--out", default=None,
                        help="also write the report to this file")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path.insert(1, ROOT)
    from attention_lvcsr_torch import _build
    from attention_lvcsr_torch.ops import gru_scan as gs
    from attention_lvcsr_torch.ops import gru_train as gt

    lines = []

    def out(msg):
        print(msg, flush=True)
        lines.append(msg)

    torch.backends.cuda.matmul.allow_tf32 = False
    out(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                        "clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                       capture_output=True, text=True).stdout.strip())
    out(f"package: {os.path.dirname(_build.__file__)}")
    dev = torch.device("cuda:0")
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    _build.load()
    widths = ((500, 800), (1000, 400))
    for D, _ in widths:
        active = gs.max_active_clusters(D, dev)
        out(f"wide forward D={D}: the card holds {active[16]} clusters of "
            f"16 blocks and {active[8]} of 8")
    t0 = time.perf_counter()
    lib_path, log, timers = build(_build.CSRC, os.path.join(
        os.path.abspath(args.root), "build", "profile_wide"), _build._nvcc(),
        _build.NVCC_FLAGS)
    out(f"probed build {time.perf_counter() - t0:.1f} s")
    for ln in ptxas_report(_build.load().log):
        out(f"  {ln}")
    _build._loaded = _build.KernelLibrary(lib_path, 0.0, log)
    lib = _build._loaded.lib
    gs._active.clear()
    rng = np.random.RandomState(22)

    def operands(T, B, D):
        lengths = rng.randint(T * 3 // 8, T + 1, size=B)
        lengths[0] = T
        mask = t((np.arange(T)[:, None] < lengths[None, :]).astype(
            np.float32))
        dirs = [(t(rng.randn(B, D) * 0.1), t(rng.randn(D, D) / np.sqrt(D)),
                 t(rng.randn(D, 2 * D) / np.sqrt(D))) for _ in range(2)]
        return t(rng.randn(T, B, 6 * D) * 0.5), mask, dirs

    def timed(fn):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    for D, T in widths:
        U = 64
        proj, mask, dirs = operands(T, U, D)
        gs.gru_scan(proj, mask, *dirs)          # warm-up
        lib.prof_reset_fwd()
        lib.prof_reset_wait_fwd()
        ms = timed(lambda: gs.gru_scan(proj, mask, *dirs))
        plan = gs.launch_plan(D, U, 2, dev)
        blocks = plan["clusters"] * plan["cluster"]
        out(f"forward D={D} T={T} U={U}, both directions, {plan['clusters']}"
            f" clusters of {plan['cluster']} ({blocks} blocks), probed "
            f"launch {ms:.3f} ms; cycles a step and a block:")
        table(lib, "fwd", FORWARD, timers, blocks, T, out)
    for D, T in widths:
        B = 32
        proj, mask, dirs = operands(T, B, D)
        out_t = torch.empty(T, B, 2 * D, device=dev)
        res = [tuple(torch.empty(T, B, D, device=dev) for _ in range(3))
               for _ in range(2)]
        gs.launch(proj, mask, dirs, out_t, res, "gru_scan_train")
        cot = t(rng.randn(T, B, 2 * D))
        dproj = torch.empty(T, B, 6 * D, device=dev)
        dh0s = [torch.empty(B, D, device=dev) for _ in range(2)]
        stream = _build.stream_of(proj)
        run = lambda: gt.launch_backward(cot, out_t, mask, dirs, res, dproj,
                                         dh0s, stream)
        run()                                   # warm-up
        lib.prof_reset_bwd()
        lib.prof_reset_wait_bwd()
        ms = timed(run)
        blocks = 2 * gt.BWD_CLUSTER * ((B + 15) // 16)
        out(f"backward kernel D={D} T={T} B={B}, both directions, {blocks} "
            f"blocks, probed launch {ms:.3f} ms; cycles a step and a block:")
        table(lib, "bwd", BACKWARD, timers, blocks, T, out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
