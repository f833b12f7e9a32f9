#!/usr/bin/env python3
"""Hashes and times the resident GRU routes, the wide GRU instances, or
the resident loop instances, on one NVIDIA GPU.

    python3 tools/torch_gru_bits.py [--wide | --loop] [--root DIR]
        [--out FILE]

Run from the repository root on a machine with a CUDA device and nvcc.
Calls ``chip_smoke.py::resident_gru_bits`` (this checkout's): the
resident instances of ``csrc/gru_scan.cu`` and ``csrc/gru_train.cu`` at
the flagship's D=250 with the cluster sizes their launch plans take on an
H100 forced, the sha256 of every output and gradient, and the times of
the decode's scan and of the training scan's forward and backward.  With
``--wide``, ``chip_smoke.py::wide_gru_bits`` instead: the wide instances
(``csrc/gru_wide.cuh``) at wsj_pyramide.yaml's wide layers, D=500 over
800 frames and D=1000 over 400, the sha256 of the forward's states at
U=64 and of the training scan's states and every gradient at B=32, both
directions, and the times of the forward and of the backward kernel
alone.  With ``--loop``, ``chip_smoke.py::resident_loop_bits`` instead:
the resident instances of the whole-loop decode kernel on the main paths of
``chip_smoke.py`` phases 3, 20b, 22a and 23a, each decode's sha256 and
time.

``--root DIR`` imports the ``attention_lvcsr_torch`` package found in DIR
instead of this checkout's, and builds its kernels there: with DIR an
unpacked copy of another commit (``git archive <commit>
attention_lvcsr_torch | tar -x -C DIR``), runs in turns (DIR, this
checkout, this checkout, DIR) in one call say whether the two commits
compute the same bits and time them on one card.  The last line is a JSON
object of the hashes, the times and the card; ``--out`` writes it to a
file too.
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=ROOT,
                        help="directory holding the attention_lvcsr_torch "
                             "package to run")
    parser.add_argument("--out", default=None)
    which = parser.add_mutually_exclusive_group()
    which.add_argument("--wide", action="store_true",
                       help="the wide GRU instances, not the resident "
                            "routes")
    which.add_argument("--loop", action="store_true",
                       help="the resident loop instances, not the GRU "
                            "routes")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path.insert(1, ROOT)        # __graft_entry__'s flagship shapes
    from attention_lvcsr_torch import _build
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    print(f"package: {os.path.dirname(_build.__file__)}")
    _build.load()
    dev = torch.device("cuda:0")
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    hashes, times = (smoke.resident_loop_bits if args.loop
                     else smoke.wide_gru_bits if args.wide
                     else smoke.resident_gru_bits)(t, dev)
    for name, ms in times.items():
        print(f"{name}: {ms:.3f} ms")
    line = json.dumps({"root": os.path.abspath(args.root), "card": card,
                       "hashes": hashes, "times_ms": times})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
