#!/usr/bin/env python3
"""The issue floor that accurate ``tanhf`` sets on one NVIDIA GPU.

    python3 tools/torch_tanh_floor.py [--elements N ...]

Run from the repository root on a machine with a CUDA device and nvcc.
The attention energies (``csrc/attention_energy.cu``, and the energy phase
of ``csrc/decode_score.cu``) are a ``tanhf`` of every (row, frame, match
column) plus four float32 operations around it (two adds, the handler's
multiply and the energy vector's fused multiply-add).  No kernel that
keeps ``tanhf`` can issue fewer instructions than those, so their count
over the card's issue rate is a floor that the byte and operation bound
of ``chip_smoke.py`` (six operations an element) does not see.

The script compiles a probe kernel (``y[i] = tanhf(x[i])``) for sm_90a
with the package's own nvcc flags, counts the SASS instructions between
its load and its store and the MUFU (special function unit) operations
among them (``cuobjdump -sass``), and reads the card's SM count and
highest SM clock.  Floors, for E elements:

    issue  = E * (tanhf instructions + 4) / (32 lanes * 4 schedulers
             * SMs * clock)
    mufu   = E * MUFU operations / (16 a clock * SMs * clock)

It also finds the inner loop of the built energy kernel
(``attention_energy_kernel``, the loop whose body holds the MUFU
operations) and gives the floor of its own instruction count an element.
The last line is a JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PROBE = r"""
extern "C" __global__ void tanh_map(const float* x, float* y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  y[i] = tanhf(x[i]);
}
"""


def sass_of(cubin, name):
    """SASS lines of one function in a cubin."""
    out = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                          "-fun", name, cubin], capture_output=True,
                         text=True, check=True).stdout
    return [line for line in out.splitlines()
            if re.match(r"\s+/\*[0-9a-f]{4}\*/", line)]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--elements", type=float, nargs="*",
                        default=[64 * 10 * 200 * 250, 128 * 10 * 200 * 250,
                                 256 * 10 * 200 * 250],
                        help="tanh elements to give the floor of (default: "
                             "the energy kernel at U=64, 128, 256, K=10, "
                             "L=200, M=250)")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from attention_lvcsr_torch import _build
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True).stdout.strip()
    print(card)
    mhz = float(clock.splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        src = os.path.join(tmp, "probe.cu")
        with open(src, "w") as f:
            f.write(PROBE)
        cubin = os.path.join(tmp, "probe.cubin")
        flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler",
                                                           "-fPIC")]
        subprocess.run([_build._nvcc(), *flags, "-cubin", "-o", cubin, src],
                       check=True, capture_output=True)
        sass = sass_of(cubin, "tanh_map")
    body = []
    inside = False
    for line in sass:
        if "LDG" in line:
            inside = True
            continue
        if "STG" in line:
            break
        if inside:
            body.append(line)
    instr = len(body)
    mufu = sum("MUFU" in line for line in body)
    rate_issue = 32 * 4 * sms * mhz * 1e6        # thread-instructions a s
    rate_mufu = 16 * sms * mhz * 1e6             # MUFU lanes a s
    print(f"SMs {sms}, highest SM clock {mhz:.0f} MHz")
    print(f"tanhf: {instr} SASS instructions between the load and the "
          f"store, {mufu} MUFU; with the energy's 4 operations "
          f"{instr + 4} an element")
    for line in body:
        print(f"  {line.strip()}")
    loop, loop_mufu = energy_loop(_build.load().path)
    per = loop / (loop_mufu / mufu)          # instructions an element
    print(f"attention_energy_kernel's inner loop: {loop} instructions, "
          f"{loop_mufu} MUFU: {loop_mufu // mufu} elements a step, {per:.2f} "
          f"instructions an element")
    result = {"card": card, "sms": sms, "clock_mhz": mhz,
              "tanhf_instructions": instr, "tanhf_mufu": mufu,
              "energy_loop_instructions_per_element": per, "floors": {}}
    for e in args.elements:
        issue = e * (instr + 4) / rate_issue * 1e3
        loop_ms = e * per / rate_issue * 1e3
        mufu_ms = e * mufu / rate_mufu * 1e3
        result["floors"][f"{int(e)}"] = {
            "issue_ms": issue, "loop_issue_ms": loop_ms, "mufu_ms": mufu_ms}
        print(f"{int(e)} elements: issue floor {issue:.4f} ms (the "
              f"kernel's loop: {loop_ms:.4f} ms), MUFU floor {mufu_ms:.4f} ms")
    print(json.dumps(result))


def energy_loop(library):
    """(instructions, MUFU operations) of the inner loop of the energy
    kernel (2-row instance) in the built library: the backward branch's
    body that holds MUFU operations."""
    out = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", library],
                         capture_output=True, text=True, check=True).stdout
    fn = next(part for part in out.split("Function : ")[1:]
              if "attention_energy_kernelILi2" in part.split()[0])
    lines = [line for line in fn.splitlines()
             if re.match(r"\s+/\*[0-9a-f]{4}\*/", line)]
    addr = [int(re.match(r"\s+/\*([0-9a-f]{4})\*/", line).group(1), 16)
            for line in lines]
    best = (0, 0)
    for i, line in enumerate(lines):
        m = re.search(r"BRA (0x[0-9a-f]+)", line)
        if m and int(m.group(1), 16) < addr[i]:
            start = addr.index(int(m.group(1), 16))
            body = lines[start:i + 1]
            mufu = sum("MUFU" in b for b in body)
            if mufu > best[1]:
                best = (len(body), mufu)
    return best


if __name__ == "__main__":
    main()
