"""Sums of outer products of rows, the weight gradients of the training
scans: the wrapper of ``csrc/outer_sum.cu``.

``outer_sum(jobs)`` adds, for each job ``(a, a2, b, c)``,
``sum_row (a * a2)[row, :, None] * b[row, None, :]`` into ``c``: the
(I, J) gradient of a weight matrix from the (rows, I) inputs it multiplied
and the (rows, J) output gradients.  ``a``, ``a2`` and ``b`` may be column
slices of a wider contiguous tensor (their row stride is read from them).
A launch belongs to the backward of the scan that calls it, which counts
it; this module keeps no count of its own, and its plain version is the
scans' own plain backward (autograd through their plain forward).
"""
from __future__ import annotations

import ctypes

import torch

from attention_lvcsr_torch import _build

MAX_JOBS = 8


class _Job(ctypes.Structure):
    """Mirror of ``struct OuterJob`` in csrc/outer_sum.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("a", "a2", "b", "c", "ws")]
                + [(n, ctypes.c_int) for n in (
                    "rows", "I", "J", "lda", "lda2", "ldb")])


class _Args(ctypes.Structure):
    """Mirror of ``struct OuterArgs`` in csrc/outer_sum.cu."""
    _fields_ = [("job", _Job * MAX_JOBS), ("njobs", ctypes.c_int)]


def _rows(t):
    """(rows, width, row stride) of a 2-D or 3-D row-strided view."""
    width = t.shape[-1]
    rows = t.numel() // width if width else 0
    if t.stride(-1) != 1:
        raise ValueError("outer_sum: operands must be unit-stride in columns")
    ld = t.stride(-2)
    if t.dim() == 3 and t.stride(0) != t.shape[1] * ld:
        raise ValueError("outer_sum: rows must be evenly strided")
    return rows, width, ld


def outer_sum(jobs, stream_of):
    """Launch ``csrc/outer_sum.cu`` over up to MAX_JOBS jobs on the stream
    of ``stream_of``.  ``c`` must be contiguous and float32.  The sums are
    taken in an order fixed by the shapes alone, so they repeat bit for
    bit."""
    if not 0 < len(jobs) <= MAX_JOBS:
        raise ValueError(f"outer_sum: 1..{MAX_JOBS} jobs, got {len(jobs)}")
    shapes = []
    for k, (a, a2, b, c) in enumerate(jobs):
        rows, I, lda = _rows(a)
        rows_b, J, ldb = _rows(b)
        lda2 = _rows(a2)[2] if a2 is not None else 0
        if rows_b != rows or tuple(c.shape) != (I, J) \
                or not c.is_contiguous():
            raise ValueError(f"outer_sum: job {k} has mismatched shapes")
        shapes.append((rows, I, J, lda, lda2, ldb))
    tiles = sum(-(-I // 64) * -(-J // 64) for _, I, J, *_ in shapes)
    total_rows = max(rows for rows, *_ in shapes)
    # about four blocks per SM over all jobs, at least 64 rows a block
    splits = max(1, min(total_rows // 64, -(-528 // max(tiles, 1))))
    ws = torch.empty(splits * sum(I * J for _, I, J, *_ in shapes),
                     dtype=torch.float32, device=stream_of.device)
    args = _Args(njobs=len(jobs))
    offset = 0
    for k, ((a, a2, b, c), shape) in enumerate(zip(jobs, shapes)):
        args.job[k] = _Job(a.data_ptr(),
                           a2.data_ptr() if a2 is not None else None,
                           b.data_ptr(), c.data_ptr(),
                           ws[offset:].data_ptr(), *shape)
        offset += splits * shape[1] * shape[2]
    lib = _build.load().lib
    lib.outer_sum_f32.argtypes = [ctypes.POINTER(_Args), ctypes.c_int,
                                  ctypes.c_void_p]
    lib.outer_sum_f32.restype = ctypes.c_int
    with torch.cuda.device(stream_of.device):
        status = lib.outer_sum_f32(ctypes.byref(args), splits,
                                   _build.stream_of(stream_of))
    _build.check(status, "outer_sum_f32")
