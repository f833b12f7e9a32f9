#!/usr/bin/env python3
"""Where the time goes in the port's flagship training step (one NVIDIA
GPU).

    python3 tools/torch_profile_train.py [--net gru|lstm]
        [--out profile_train.txt]

Run from the repository root on a machine with a CUDA device and nvcc.
Drives the training step ``chip_smoke.py`` phase 13 drives
(``FLAGSHIP_NET``, random weights from seed 1234, B=32, 800 frames, 100
labels, adadelta with clipping and max-norm), or with ``--net lstm``
phase 17's (the same network with a 4x250 BiLSTM encoder), and reports:

1. ``torch.profiler`` over one step after two warm-up steps: device time
   per kernel, the device's busy time and the step's wall time, hence its
   idle share, and the number of launches;
2. cycles per step inside the training kernels, phase by phase: probes
   (``clock64()`` after a ``__syncthreads``, as
   ``tools/torch_profile_decode.py`` puts them) before every
   ``// ---- <phase>`` comment of the step loops of ``decoder_train.cu``
   (forward and backward) and of the encoder's scans, ``gru_scan.cu``
   and ``gru_train.cu`` (or ``lstm_scan.cu`` and ``lstm_train.cu``), in
   copies built into a separate library; one more step runs from it.
   The probes add barriers, so the shares are what they read; the kernels' times
   come from part 1.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_profile_decode import INIT, instrument, phase_table  # noqa: E402


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
    from attention_lvcsr_torch.ops import decoder_train as dt
    from attention_lvcsr_torch.ops import gru_scan as gs
    from attention_lvcsr_torch.ops import lstm_scan as ls
    from attention_lvcsr_torch.ops import lstm_train as lt
    from attention_lvcsr_torch.train.driver import GradientDescent, \
        make_train_step
    from attention_lvcsr_torch.train.rules import build_optimizer
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
    config = {"training": {"gradient_threshold": 100.0, "rules": ["adadelta"],
                           "decay_rate": 0.95, "epsilon": 1e-8},
              "regularization": {"max_norm": 1.0}}
    lstm = args.net == "lstm"
    net = dict(FLAGSHIP_NET, enc_transition="LSTM") if lstm else FLAGSHIP_NET
    rec = SpeechRecognizer(net, init_config=INIT, seed=1234, device=dev)
    optimizer = build_optimizer(config["training"], config["regularization"])
    algorithm = GradientDescent(rec, optimizer,
                                make_train_step(rec, optimizer, config))
    B, T, TL = 32, 800, 100
    rng = np.random.RandomState(13)
    frames = rng.randint(T * 3 // 4, T + 1, size=B)
    labels = rng.randint(TL * 3 // 4, TL + 1, size=B)
    frames[0], labels[0] = T, TL
    batch = {"recordings": rng.randn(B, T, 123).astype(np.float32),
             "recordings_mask": (np.arange(T)[None] < frames[:, None]),
             "labels": rng.randint(0, 31, size=(B, TL)),
             "labels_mask": (np.arange(TL)[None] < labels[:, None])}

    # ---- 1. torch.profiler over one step -----------------------------------
    for _ in range(2):
        algorithm.process_batch(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        algorithm.process_batch(batch)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        out("torch.profiler saw no device activity: not measured")
    else:
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
        out(f"{args.net} training step B={B} frames={T} labels={TL}: device "
            f"busy {busy:.3f} ms of a {window_ms:.3f} ms window (idle "
            f"{100 * (1 - busy / window_ms):.1f} %), {len(kernels)} kernel "
            f"launches")
        for name, (ms, count) in sorted(per_name.items(),
                                        key=lambda kv: -kv[1][0])[:16]:
            out(f"  {ms:9.3f} ms {100 * ms / busy:5.1f} %  x{count:<5d} "
                f"{name[:70]}")

    # ---- 2. phase probes inside the training kernels -------------------------
    os.makedirs(os.path.join(ROOT, "build", "profile"), exist_ok=True)
    step_loop = "for (int step = 0; step < T; ++step) {"
    enc_fwd, enc_bwd = ("lstm_scan.cu", "lstm_train.cu") if lstm \
        else ("gru_scan.cu", "gru_train.cu")
    loops = {"decoder_train.cu": (("for (int t = 0; t < a.T; ++t) {", "dfwd"),
                                  ("for (int t = a.T - 1; t >= 0; --t) {",
                                   "dbwd")),
             enc_fwd: ((step_loop, "efwd"),), enc_bwd: ((step_loop, "ebwd"),)}
    paths, phases = [], {}
    for name in ("decoder_train.cu", enc_fwd, enc_bwd, "outer_sum.cu"):
        text = open(os.path.join(_build.CSRC, name)).read()
        for header, tag in loops.get(name, ()):
            text, phases[tag] = instrument(text, header, tag)
        paths.append(os.path.join(ROOT, "build", "profile", name))
        with open(paths[-1], "w") as f:
            f.write(text)
    lib_path = os.path.join(ROOT, "build", "profile", "libprofile_train.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                           "-I", _build.CSRC, "-o", lib_path, *paths],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"probe build failed:\n{proc.stderr[-4000:]}")
    # the wrappers launch from whatever library _build has loaded
    _build._loaded = _build.KernelLibrary(lib_path, 0.0, proc.stderr)
    lib = _build._loaded.lib
    for tag in phases:
        getattr(lib, f"prof_reset_{tag}")()
    algorithm.process_batch(batch)
    torch.cuda.synchronize()
    enc_steps = 3 * T + T // 2          # the four layers: 800/800/800/400
    groups = (B + 15) // 16
    cluster = (ls if lstm else gs).launch_plan(250, B, 2, dev)["cluster"]
    bwd_cluster = lt.BWD_CLUSTER if lstm else 16
    scan = "lstm_scan_train" if lstm else "gru_scan_train"
    decoder = {kind: B for kind in ("forward", "backward")}
    if hasattr(dt, "launch_plan"):      # the grid of each decoder kernel
        decoder = {kind: dt.launch_plan(kind, B, T // 4, 250, 500, 250,
                                        dev)["blocks"] for kind in dt.KINDS}
    for tag, what, blocks, steps in (
            ("dfwd", "decoder_scan_train forward", decoder["forward"], TL),
            ("dbwd", "decoder_scan_train backward", decoder["backward"],
             TL),
            ("efwd", f"{scan} forward, both directions, 4 layers "
                     f"({cluster}-block clusters)", 2 * cluster * groups,
             enc_steps),
            ("ebwd", f"{scan} backward, both directions, 4 layers "
                     f"({bwd_cluster}-block clusters)",
             2 * bwd_cluster * groups, enc_steps)):
        out(f"{what} phases ({blocks} blocks, {steps} steps a block):")
        phase_table(lib, tag, phases[tag], blocks, steps, out)

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
