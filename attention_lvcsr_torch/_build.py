"""Compile the package's CUDA sources with nvcc and load them with ctypes.

All of ``csrc/*.cu`` goes into ONE shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes).
Each source compiles in its own ``nvcc`` process, all started together,
and one more links them:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu -o <name>.o   (each)
    nvcc -shared -o libkernels.so *.o

``--fmad=false`` keeps nvcc from contracting ``a * b + c`` into one fused
multiply-add outside the explicit ``fmaf`` dot products, so elementwise
bookkeeping (costs, gates, blends) rounds like the plain PyTorch version
it is compared with.  The library lands in ``build/torch_kernels/<hash>/``
at the repository root, keyed by a hash of the sources and flags, and is
built at first use — never at import, so the CPU tests import every
module without a compiler.  Wrappers pass pointers and the stream as
``c_void_p``; every C entry point returns ``cudaGetLastError()``.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class LaunchCounter:
    """Number of kernel launches a wrapper made (one per launch)."""

    def __init__(self):
        self.count = 0

    def reset(self):
        self.count = 0


class KernelLibrary:
    """The loaded shared library plus what its build reported."""

    def __init__(self, path, build_seconds, log):
        self.path = path
        self.build_seconds = build_seconds   # 0.0 when found built
        self.log = log                       # nvcc/ptxas output
        self.lib = ctypes.CDLL(path)


_lock = threading.Lock()
_loaded = None


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built here")
    return found


def _build(nvcc):
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            digest.update(f.read())
    out_dir = os.path.join(BUILD_ROOT, digest.hexdigest()[:16])
    lib_path = os.path.join(out_dir, "libkernels.so")
    log_path = os.path.join(out_dir, "build.log")
    if os.path.exists(lib_path):
        log = open(log_path).read() if os.path.exists(log_path) else ""
        return lib_path, 0.0, log
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in (s for s in _sources() if s.endswith(".cu")):
        stem = os.path.join(out_dir, os.path.basename(src)[:-3])
        with open(f"{stem}.{tag}.log", "w") as out:
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", src, "-o", f"{stem}.{tag}.o"],
                stdout=out, stderr=subprocess.STDOUT)
        jobs.append((src, stem, proc))
    log, failed = "", []
    for src, stem, proc in jobs:
        rc = proc.wait()
        with open(f"{stem}.{tag}.log") as f:
            log += f"== {os.path.basename(src)}\n{f.read()}"
        if rc != 0:
            failed.append(f"{os.path.basename(src)} (rc={rc})")
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{log}")
    tmp = f"{lib_path}.{tag}"
    link = subprocess.run([nvcc, "-shared", "-o", tmp,
                           *[f"{stem}.{tag}.o" for _, stem, _ in jobs]],
                          capture_output=True, text=True)
    log += link.stdout + link.stderr
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed (rc={link.returncode}):\n"
                           f"{log}")
    seconds = time.perf_counter() - t0
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, lib_path)
    return lib_path, seconds, log


def load() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library."""
    global _loaded
    with _lock:
        if _loaded is None:
            _loaded = KernelLibrary(*_build(_nvcc()))
        return _loaded


def check(status: int, name: str):
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")


def stream_of(tensor):
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(tensor.device)
                           .cuda_stream)
