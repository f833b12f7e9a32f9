#!/usr/bin/env python3
"""Times ring variants of the GRU kernels' wide instances on one NVIDIA GPU.

    python3 tools/torch_bench_gru_ring.py [--variants 4x2048,2x4096,...]

Run from the repository root on a machine with a CUDA device and nvcc.
Each variant copies ``csrc/gru_scan.cu``, ``gru_train.cu`` and
``outer_sum.cu`` with their headers under ``build/ring/<stages>_<floats>``
with ``gru_wide.cuh``'s ``kRingStages`` and ``kRingFloats`` replaced,
builds them into a library of their own (one nvcc per source, all at
once) and puts it in place of the package's (``_build._loaded``).  In
turns (the variants in order, then in reverse) it times, with CUDA
events: ``gru_scan`` at U=64, both directions, D=1000 over 400 frames and
D=500 over 800 (wsj_pyramide.yaml's wide layers, with their states'
max abs error against the plain scan), and at B=32 the training forward
with its residuals and ``gru_train.cu``'s backward kernel alone at the
same widths.  The last line is a JSON object of every time.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ["gru_scan.cu", "gru_train.cu", "outer_sum.cu"]
HEADERS = ["gru_pull.cuh", "gru_wide.cuh", "sm90_async.cuh"]


def build(_build, stages, floats):
    """Start the nvcc jobs of one variant: (directory, [processes])."""
    out = os.path.join(ROOT, "build", "ring", f"{stages}_{floats}")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    for name in SOURCES + HEADERS:
        text = open(os.path.join(_build.CSRC, name)).read()
        if name == "gru_wide.cuh":
            text = re.sub(r"constexpr int kRingStages = \d+;",
                          f"constexpr int kRingStages = {stages};", text)
            text = re.sub(r"constexpr int kRingFloats = \d+;",
                          f"constexpr int kRingFloats = {floats};", text)
        with open(os.path.join(out, name), "w") as f:
            f.write(text)
    return out, [subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-c", os.path.join(out, name),
         "-o", os.path.join(out, name[:-3] + ".o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in SOURCES]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variants",
                        default="4x2048,8x1024,5x2048,11x1024,2x4096,3x4000",
                        help="comma-separated stages x floats a tile")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, ROOT)
    from attention_lvcsr_torch import _build
    from attention_lvcsr_torch.ops import gru_scan as gs
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    variants = [tuple(int(x) for x in v.split("x"))
                for v in args.variants.split(",")]
    jobs = [(v, *build(_build, *v)) for v in variants]
    libs = {}
    for v, out, procs in jobs:
        for proc in procs:
            log = proc.communicate()[0]
            if proc.returncode:
                sys.exit(f"nvcc failed for {v}:\n{log[-3000:]}")
        lib = os.path.join(out, "libkernels.so")
        subprocess.run([_build._nvcc(), "-shared", "-o", lib] + [
            os.path.join(out, n[:-3] + ".o") for n in SOURCES], check=True)
        libs[v] = _build.KernelLibrary(lib, 0.0, "")
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

    cases = {"scan D1000 T400 U64": operands(400, 64, 1000),
             "scan D500 T800 U64": operands(800, 64, 500),
             "train D1000 T400 B32": operands(400, 32, 1000),
             "train D500 T800 B32": operands(800, 32, 500)}
    refs = {k: gs.gru_scan_reference(p, m, *d)
            for k, (p, m, d) in cases.items() if k.startswith("scan")}
    times = {}
    for order in (variants, variants[::-1]):
        for v in order:
            _build._loaded = libs[v]
            gs._active.clear()
            for k, (p, m, d) in cases.items():
                T, B, D = p.shape[0], p.shape[1], d[0][1].shape[0]
                if k.startswith("scan"):
                    err = float((gs.gru_scan(p, m, *d) - refs[k]).abs().max())
                    ms = smoke.cuda_ms(lambda: gs.gru_scan(p, m, *d), 3)
                    got = {"ms": ms, "max_abs_err": err}
                else:
                    out = torch.empty(T, B, 2 * D, device=dev)
                    res = [tuple(torch.empty(T, B, D, device=dev)
                                 for _ in range(3)) for _ in range(2)]
                    got = {"fwd_ms": smoke.cuda_ms(
                        lambda: gs.launch(p, m, d, out, res), 3),
                        "bwd_kernel_ms": smoke.gru_backward_kernel_ms(
                            p, m, d, t(rng.randn(T, B, 2 * D)), 3)}
                times.setdefault(f"{v[0]}x{v[1]} {k}", []).append(got)
                print(f"{v[0]}x{v[1]} {k}: {got}", flush=True)
    print(json.dumps(times))


if __name__ == "__main__":
    main()
