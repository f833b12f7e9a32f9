"""ctypes bindings of the native host DP (``csrc/host/lvsr_native.cpp``).

Counterpart of ``attention_lvcsr_tpu/ops/native.py``.  The library is
built at first use, never at import:

    g++ -O3 -fPIC -shared -std=c++17 -o liblvsr_native.so lvsr_native.cpp

into ``build/host/<hash>/`` at the repository root (the hash of the
source and the flags, so an edited source builds anew), next to the CUDA
kernels' ``build/torch_kernels/``.  Every entry point has a numpy path in
:mod:`attention_lvcsr_torch.ops.error_rate`: where no compiler exists
(``$CXX``, else ``g++``) the native path is skipped, as in the JAX
package; it is a speedup of host code, not a dependency.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "host", "lvsr_native.cpp")
BUILD_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "host")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
# how the library came to be: its path, the seconds the build took (0.0
# when found built), and why it is missing when it is
build_info = {"path": None, "build_seconds": None, "error": None}


def _compiler():
    return shutil.which(os.environ.get("CXX") or "g++")


def _build() -> str:
    """The library's path, building it when no build of this source and
    these flags exists; raises where it cannot be built."""
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler ($CXX or g++) on PATH")
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    out_dir = os.path.join(BUILD_ROOT, digest.hexdigest()[:16])
    path = os.path.join(out_dir, "liblvsr_native.so")
    if os.path.exists(path):
        build_info["build_seconds"] = 0.0
        return path
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed (rc={proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    build_info["build_seconds"] = time.perf_counter() - t0
    return path


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, or None where it cannot be built or loaded
    (``build_info["error"]`` says why).  Tried once a process."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = _build()
            lib = ctypes.CDLL(path)
        except Exception as exc:
            build_info["error"] = str(exc)
            return None
        I64 = ctypes.POINTER(ctypes.c_int64)
        lib.lvsr_edit_distances.argtypes = [I64, I64, I64, I64,
                                            ctypes.c_int64, ctypes.c_int64,
                                            ctypes.c_int64, I64]
        lib.lvsr_batch_reward_gain.argtypes = [
            I64, I64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, I64, I64]
        build_info["path"] = path
        _lib = lib
        return _lib


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def available() -> bool:
    return get_lib() is not None


def batch_reward_and_gain_native(groundtruth, recognized, alphabet_size,
                                 eos_label):
    """The batch's rewards and gains ((T, B) -> (T, B, A) each, int64)
    from the library, or None without it.  Every groundtruth column must
    hold EOS (``error_rate.batch_reward_and_gain`` checks)."""
    lib = get_lib()
    if lib is None:
        return None
    gt = np.ascontiguousarray(groundtruth, np.int64)
    rec = np.ascontiguousarray(recognized, np.int64)
    T_g, B = gt.shape
    T_r, B2 = rec.shape
    if B != B2:
        raise ValueError("batch mismatch")
    rewards = np.empty((T_r, B, alphabet_size), np.int64)
    gains = np.empty((T_r, B, alphabet_size), np.int64)
    lib.lvsr_batch_reward_gain(_i64(gt), _i64(rec), T_g, T_r, B,
                               alphabet_size, eos_label, _i64(rewards),
                               _i64(gains))
    return rewards, gains


def edit_distances_native(a_seqs, b_seqs):
    """The edit distances of two lists of int sequences, pair by pair
    (int64 (n,)), or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(a_seqs)
    max_a = max((len(s) for s in a_seqs), default=0)
    max_b = max((len(s) for s in b_seqs), default=0)
    a = np.zeros((n, max(max_a, 1)), np.int64)
    b = np.zeros((n, max(max_b, 1)), np.int64)
    a_lens = np.asarray([len(s) for s in a_seqs], np.int64)
    b_lens = np.asarray([len(s) for s in b_seqs], np.int64)
    for i, s in enumerate(a_seqs):
        a[i, :len(s)] = s
    for i, s in enumerate(b_seqs):
        b[i, :len(s)] = s
    out = np.empty((n,), np.int64)
    lib.lvsr_edit_distances(_i64(a), _i64(a_lens), _i64(b), _i64(b_lens),
                            n, a.shape[1], b.shape[1], _i64(out))
    return out
