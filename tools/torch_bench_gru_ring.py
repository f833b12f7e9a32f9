#!/usr/bin/env python3
"""Times the GRU kernels' wide instances on one NVIDIA GPU, beside
another commit's.

    python3 tools/torch_bench_gru_ring.py [--root DIR] [--repeats N]
        [--out FILE]

Run from the repository root on a machine with a CUDA device and nvcc.
Times, with CUDA events, the cases of wsj_pyramide.yaml's wide layers
(``csrc/gru_wide.cuh``): ``gru_scan`` at U=64, both directions, D=500
over 800 frames and D=1000 over 400 (with the states' max abs error
against the plain scan and the cluster size the launch plan took), and
at B=32, both directions, the same widths, the training forward with its
residuals and ``gru_train.cu``'s backward kernel alone
(``chip_smoke.py::gru_backward_kernel_ms``).  The inputs come from one
seed, so every run times the same work.

``--root DIR`` runs the same cases on the ``attention_lvcsr_torch``
package found in DIR, an unpacked copy of another commit (``git archive
<commit> attention_lvcsr_torch | tar -x -C DIR``), which builds its own
kernels under DIR: both builds start together, then each tree runs in a
process of its own, in turns (DIR, this checkout, this checkout, DIR),
and the table gives every case's times and this checkout's mean over
DIR's.  The last line is a JSON object of every time; ``--out`` writes it
to a file too.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(root, repeats, build_only):
    """Time the cases on the package under ``root``; print one JSON line."""
    sys.path.insert(0, os.path.abspath(root))
    sys.path.insert(1, ROOT)
    import torch
    from attention_lvcsr_torch import _build
    _build.load()
    if build_only:
        print(json.dumps({"build_s": _build.load().build_seconds}))
        return
    from attention_lvcsr_torch.ops import gru_scan as gs
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    rng = np.random.RandomState(5)

    def operands(T, B, D):
        lengths = rng.randint(T * 3 // 8, T + 1, size=B)
        lengths[0] = T
        mask = t((np.arange(T)[:, None] < lengths[None, :]).astype(
            np.float32))
        dirs = [(t(rng.randn(B, D) * 0.1), t(rng.randn(D, D) / np.sqrt(D)),
                 t(rng.randn(D, 2 * D) / np.sqrt(D))) for _ in range(2)]
        return t(rng.randn(T, B, 6 * D) * 0.5), mask, dirs

    times = {}
    for D, T in smoke.PYRAMIDE_WIDE:
        p, m, d = operands(T, 64, D)
        err = float((gs.gru_scan(p, m, *d)
                     - gs.gru_scan_reference(p, m, *d)).abs().max())
        times[f"scan D{D} T{T} U64"] = {
            "ms": smoke.cuda_ms(lambda: gs.gru_scan(p, m, *d), repeats),
            "max_abs_err": err,
            "cluster": gs.launch_plan(D, 64, 2, dev)["cluster"]}
    for D, T in smoke.PYRAMIDE_WIDE:
        p, m, d = operands(T, 32, D)
        out = torch.empty(T, 32, 2 * D, device=dev)
        res = [tuple(torch.empty(T, 32, D, device=dev) for _ in range(3))
               for _ in range(2)]
        times[f"train fwd D{D} T{T} B32"] = {"ms": smoke.cuda_ms(
            lambda: gs.launch(p, m, d, out, res), repeats)}
        times[f"bwd kernel D{D} T{T} B32"] = {
            "ms": smoke.gru_backward_kernel_ms(
                p, m, d, t(rng.randn(T, 32, 2 * D)), repeats)}
    print(json.dumps({"root": os.path.abspath(root), "times": times}))


def run_child(root, repeats, build_only=False):
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", root,
         "--repeats", str(repeats)] + (["--build-only"] if build_only
                                       else []),
        capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"the run on {root} failed:\n{proc.stdout[-3000:]}\n"
                 f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=None,
                        help="directory holding another commit's "
                             "attention_lvcsr_torch package")
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--out", default=None)
    parser.add_argument("--child", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--build-only", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        return child(args.child, args.repeats, args.build_only)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    roots = [ROOT] if args.root is None else [args.root, ROOT, ROOT,
                                              args.root]
    if args.root is not None:
        builds = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", root,
             "--build-only"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for root in (args.root, ROOT)]
        for proc in builds:
            log = proc.communicate()[0]
            if proc.returncode:
                sys.exit(f"a build failed:\n{log[-3000:]}")
    runs = []
    for root in roots:
        runs.append(run_child(root, args.repeats))
        label = "tree" if root == ROOT else "base"
        print(f"{label} {root}: " + ", ".join(
            f"{k} {v['ms']:.3f} ms" for k, v in runs[-1]["times"].items()),
            flush=True)
    mine = [r["times"] for r, root in zip(runs, roots) if root == ROOT]
    base = [r["times"] for r, root in zip(runs, roots) if root != ROOT]
    summary = {}
    for case in mine[0]:
        row = {"tree_ms": [m[case]["ms"] for m in mine]}
        if base:
            row["base_ms"] = [b[case]["ms"] for b in base]
            row["ratio"] = float(np.mean(row["tree_ms"])
                                 / np.mean(row["base_ms"]))
        for key in ("max_abs_err", "cluster"):
            if key in mine[0][case]:
                row[key] = [m[case][key] for m in mine]
        summary[case] = row
        print(f"{case}: tree {row['tree_ms']}"
              + (f", base {row['base_ms']}, tree / base {row['ratio']:.3f}"
                 if base else ""))
    line = json.dumps({"card": card, "root": args.root, "cases": summary,
                       "runs": runs})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
