#!/usr/bin/env python3
"""Where the time goes inside the waveform frontend kernel (one NVIDIA GPU).

    python3 tools/torch_profile_frontend.py [--out profile_frontend.txt]

Run from the repository root on a machine with a CUDA device and nvcc.
Copies ``csrc/frontend.cu`` into ``build/profile_frontend/``, puts a
``clock64()`` probe before every ``// ---- <phase>`` comment inside
``frontend_kernel``'s body (those inside the warps' frame loop too) and
one at its end (the time before the first probe counts to the first
phase), builds the copy into a separate library and runs
``fbank_deltas`` from it on 8 s of ``chip_smoke.py``'s speech-like audio:
one request at 16 kHz, and B=64 at 16, 8 and 48 kHz.  Each thread adds
the cycles since the last probe to the phase it was in; lane 0 of each
warp adds its sums to a device array.  The probes take no barrier, so a
phase's cycles are a warp's wall time in it, other warps' issue
included: read them as shares, and the kernel's time from
``tools/torch_bench_decode_kernels.py --only frontend``.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOTS = 16


def instrument(src):
    """``src`` with the probes; returns (source, phase names)."""
    lines = src.split("\n")
    start = next(i for i, ln in enumerate(lines)
                 if "frontend_kernel(FrontendArgs a) {" in ln)
    end = next(i for i in range(start, len(lines)) if lines[i] == "}")
    names, out = [], []
    for i, ln in enumerate(lines):
        m = re.match(r"(\s*)// ---- (.*?)[:,]", ln + ":")
        if m and start < i < end:
            out.append(f"{m.group(1)}PROBE({len(names)});")
            names.append(m.group(2).strip())
        if i == end:
            out.append(f"  PROBE({SLOTS - 1});")
            out.append("  if (threadIdx.x % 32 == 0) for (int k = 0; k < "
                       f"{SLOTS}; ++k) atomicAdd(&g_prof[k], "
                       "(unsigned long long)prof_acc[k]);")
        out.append(ln)
        if i == start:
            out.append(f"  long long prof_last = clock64(), prof_acc[{SLOTS}]"
                       " = {}; int prof_cur = 0;")
    header = (
        f"__device__ unsigned long long g_prof[{SLOTS}];\n"
        "#define PROBE(n) do { long long t_ = clock64(); "
        "prof_acc[prof_cur] += t_ - prof_last; prof_last = t_; "
        "prof_cur = (n); } while (0)\n")
    footer = (
        '\nextern "C" int prof_read(void* host) { return (int)'
        "cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof)); }\n"
        'extern "C" int prof_reset() { static unsigned long long '
        f"z[{SLOTS}]; return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z)); "
        "}\n")
    text = "\n".join(out).replace("#include <cuda_runtime.h>\n",
                                  "#include <cuda_runtime.h>\n" + header, 1)
    return text + footer, names


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, ROOT)
    from chip_smoke import speech_like
    from attention_lvcsr_torch import _build
    from attention_lvcsr_torch.ops import frontend as fe

    lines = []

    def out(msg):
        print(msg, flush=True)
        lines.append(msg)

    out(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip())
    text, names = instrument(open(os.path.join(_build.CSRC,
                                               "frontend.cu")).read())
    work = os.path.join(ROOT, "build", "profile_frontend")
    os.makedirs(work, exist_ok=True)
    src = os.path.join(work, "frontend.cu")
    with open(src, "w") as f:
        f.write(text)
    lib_path = os.path.join(work, "libfrontend_probe.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                           "-I", _build.CSRC, "-o", lib_path, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"probe build failed:\n{proc.stderr[-4000:]}")
    # the wrapper launches from whatever library _build has loaded
    _build._loaded = _build.KernelLibrary(lib_path, 0.0, proc.stderr)
    fe._entry = None
    lib = _build._loaded.lib
    dev = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for rate, B in ((16000, 1), (16000, 64), (8000, 64), (48000, 64)):
        rng = np.random.RandomState(14)
        N = 8 * rate
        wav = torch.tensor(np.stack([speech_like(rng, N, rate)
                                     for _ in range(B)]), device=dev)
        fe.fbank_deltas(wav, sample_rate=rate)
        torch.cuda.synchronize()
        lib.prof_reset()
        fe.fbank_deltas(wav, sample_rate=rate)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * SLOTS)()
        if lib.prof_read(buf) != 0:
            sys.exit("reading the probes failed")
        cycles = np.array(buf[:], np.float64)
        frame_length, hop, _ = fe.frame_geometry(rate)
        plan = fe.plan(B, 1 + (N - frame_length) // hop, rate, sms=sms)
        warps = plan["blocks"] * fe.WARPS
        out(f"{rate} Hz, B={B}, plan {plan}: cycles a warp")
        total = cycles.sum()
        for i, name in enumerate(names):
            out(f"  {name[:58]:58s} {cycles[i] / total * 100:6.2f} % "
                f"{cycles[i] / warps:9.0f}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
