#!/usr/bin/env python3
"""Times the kernel library's nvcc build, source by source.

    python3 tools/torch_nvcc_times.py [--variants SRC [SRC ...]]

Run from the repository root on a machine with nvcc.  First compiles
every ``csrc/*.cu`` as ``attention_lvcsr_torch/_build.py`` does (all
started together, its ``NVCC_FLAGS``) and prints when each source ended,
counted from the common start.  With ``--variants``, then compiles each
named source alone three ways: without ptxas's ``--split-compile``
(``base``), with it (``ptxas_split8``, the build's flags), and with
nvcc's own ``-split-compile=8`` in its place (``nvcc_split8``); for each
it prints the wall time, the seconds nvcc's ``--time`` gives cicc and
ptxas, and whether the SASS (``cuobjdump -sass``) equals ``base``'s.
Objects and timing files go to ``build/nvcc_times/``.
"""
from __future__ import annotations

import argparse
import csv
import glob
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "nvcc_times")
PTXAS_SPLIT = ("-Xptxas", "--split-compile=8")


def compile_one(nvcc, flags, src, tag):
    """(wall seconds, {tool: seconds} from nvcc's --time, object path)."""
    name = os.path.basename(src)
    obj = os.path.join(OUT, f"{name}.{tag}.o")
    times = os.path.join(OUT, f"{name}.{tag}.csv")
    if os.path.exists(times):
        os.remove(times)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *flags, "--time", times, "-c", src, "-o",
                           obj], capture_output=True, text=True)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        sys.exit(f"nvcc failed on {name} ({tag}):\n{proc.stderr[-2000:]}")
    tools = {}
    with open(times) as f:
        for row in csv.reader(f):
            if len(row) >= 8 and row[-1].strip() == "ms":
                tool = row[1].strip()
                tools[tool] = tools.get(tool, 0.0) + float(row[-2]) / 1e3
    return wall, tools, obj


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--variants", nargs="*", default=[],
                        help="csrc/*.cu names to compile under each variant")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    from attention_lvcsr_torch import _build
    nvcc = _build._nvcc()
    os.makedirs(OUT, exist_ok=True)
    print(subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True).stdout.strip().splitlines()[-1])
    print(f"cores {os.cpu_count()}")

    ended = {}
    start = time.perf_counter()

    def run(src):
        compile_one(nvcc, _build.NVCC_FLAGS, src, "together")
        ended[os.path.basename(src)] = time.perf_counter() - start

    threads = [threading.Thread(target=run, args=(src,))
               for src in sorted(glob.glob(os.path.join(_build.CSRC,
                                                        "*.cu")))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for name, s in sorted(ended.items(), key=lambda kv: -kv[1]):
        print(f"together {name}: ended at {s:.1f} s")

    base = [f for i, f in enumerate(_build.NVCC_FLAGS)
            if tuple(_build.NVCC_FLAGS[i:i + 2]) != PTXAS_SPLIT
            and tuple(_build.NVCC_FLAGS[i - 1:i + 1]) != PTXAS_SPLIT]
    variants = {"base": base, "ptxas_split8": [*base, *PTXAS_SPLIT],
                "nvcc_split8": [*base, "-split-compile=8"]}
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    for name in args.variants:
        src = os.path.join(_build.CSRC, name)
        sass = {}
        for tag, flags in variants.items():
            wall, tools, obj = compile_one(nvcc, flags, src, tag)
            sass[tag] = subprocess.run([cuobjdump, "-sass", obj],
                                       capture_output=True, text=True).stdout
            print(f"alone {name} {tag}: {wall:.1f} s (cicc "
                  f"{tools.get('cicc', 0.0):.1f} s, ptxas "
                  f"{tools.get('ptxas', 0.0):.1f} s); SASS equal to base's: "
                  f"{sass[tag] == sass['base']}")


if __name__ == "__main__":
    main()
