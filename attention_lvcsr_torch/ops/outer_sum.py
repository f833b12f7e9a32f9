"""Sums of outer products of rows, the weight gradients of the training
scans: the wrapper of ``csrc/outer_sum.cu``.

``outer_sum(jobs)`` adds, for each job ``(a, a2, b, c)``,
``sum_row (a * a2)[row, :, None] * b[row, None, :]`` into ``c``: the
(I, J) gradient of a weight matrix from the (rows, I) inputs it multiplied
and the (rows, J) output gradients.  ``a``, ``a2`` and ``b`` may be column
slices of a wider contiguous tensor (their row stride is read from them).

On CUDA tensors a call starts two kernels, the products over the blocks of
:func:`launch_plan` and then the fixed-order sum of their row splits, and
``launches`` counts both.  On CPU tensors it runs :func:`outer_sum_plain`,
one matrix product per job.
"""
from __future__ import annotations

import ctypes

import torch

from attention_lvcsr_torch import _build

MAX_JOBS = 8
TILE_I, TILE_J = 128, 256   # C tile of a block (csrc/outer_sum.cu kBM, kBN)
CHUNK = 16             # split rows are a multiple of this
# One block fits on each of an H100's 132 SMs: the plan aims at one wave.
# A constant, not the card's count, so the splits, and with them the bits
# of every sum, depend on the shapes alone.
TARGET_BLOCKS = 132
MIN_SPLIT_ROWS = 64

launches = _build.LaunchCounter()     # two a call: products, then the sum


class _Job(ctypes.Structure):
    """Mirror of ``struct OuterJob`` in csrc/outer_sum.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("a", "a2", "b", "c")]
                + [(n, ctypes.c_int) for n in (
                    "rows", "I", "J", "lda", "lda2", "ldb", "block0",
                    "tile0", "tiles_j", "splits", "split_rows")])


class _Args(ctypes.Structure):
    """Mirror of ``struct OuterArgs`` in csrc/outer_sum.cu."""
    _fields_ = [("job", _Job * MAX_JOBS), ("ws", ctypes.c_void_p),
                ("njobs", ctypes.c_int), ("blocks", ctypes.c_int),
                ("tiles", ctypes.c_int)]


def _cdiv(a, b):
    return -(-a // b)


def launch_plan(shapes):
    """The grid of ``csrc/outer_sum.cu`` for jobs of ``(rows, I, J)``.

    Every job gets ceil(I/TILE_I) * ceil(J/TILE_J) tiles, and each tile's
    rows are cut into ``splits`` runs of ``split_rows`` rows (a multiple of
    CHUNK; the last run may be shorter), one block each, with about the
    same rows x tiles in every block of the call.  A tile's splits are
    consecutive blocks, in row order; the second kernel adds them into C
    in that order.  Returns (per job: dict of block0, tile0, tiles_j,
    splits, split_rows; blocks; tiles); the workspace holds one TILE_I x
    TILE_J partial tile per block."""
    tiles = [_cdiv(I, TILE_I) * _cdiv(J, TILE_J) for _, I, J in shapes]
    work = sum(t * rows for t, (rows, _, _) in zip(tiles, shapes))
    per_block = max(MIN_SPLIT_ROWS, _cdiv(work, TARGET_BLOCKS))
    plan, block0, tile0 = [], 0, 0
    for t, (rows, _, J) in zip(tiles, shapes):
        n = max(rows, 1)
        split_rows = _cdiv(_cdiv(n, _cdiv(n, per_block)), CHUNK) * CHUNK
        splits = _cdiv(n, split_rows)
        plan.append({"block0": block0, "tile0": tile0,
                     "tiles_j": _cdiv(J, TILE_J), "splits": splits,
                     "split_rows": split_rows})
        block0 += t * splits
        tile0 += t
    return plan, block0, tile0


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


def outer_sum_plain(jobs):
    """Plain version of :func:`outer_sum`: ``c += (a * a2)^T b`` per job,
    in PyTorch operations."""
    for a, a2, b, c in jobs:
        left = a if a2 is None else a * a2
        c += left.reshape(-1, left.shape[-1]).T @ b.reshape(-1, b.shape[-1])


def outer_sum(jobs, stream_of):
    """Launch ``csrc/outer_sum.cu`` over up to MAX_JOBS jobs on the stream
    of ``stream_of``, or run the plain version when ``stream_of`` lies on
    the CPU.  ``c`` must be contiguous and float32.  The kernel's sums are
    taken in an order fixed by the shapes alone, so they repeat bit for
    bit."""
    if not 0 < len(jobs) <= MAX_JOBS:
        raise ValueError(f"outer_sum: 1..{MAX_JOBS} jobs, got {len(jobs)}")
    if stream_of.device.type == "cpu":
        return outer_sum_plain(jobs)
    if stream_of.device.type != "cuda":
        raise ValueError(f"outer_sum: no kernel for device {stream_of.device}")
    shapes = []
    for k, (a, a2, b, c) in enumerate(jobs):
        rows, I, lda = _rows(a)
        rows_b, J, ldb = _rows(b)
        lda2 = _rows(a2)[2] if a2 is not None else 0
        if rows_b != rows or tuple(c.shape) != (I, J) \
                or not c.is_contiguous():
            raise ValueError(f"outer_sum: job {k} has mismatched shapes")
        shapes.append((rows, I, J, lda, lda2, ldb))
    plan, blocks, tiles = launch_plan([s[:3] for s in shapes])
    if blocks == 0:             # every C is empty
        return
    with torch.cuda.device(stream_of.device):
        stream = _build.stream_of(stream_of)
        launch(jobs, shapes, plan,
               _workspace(stream_of.device, stream.value,
                          blocks * TILE_I * TILE_J),
               blocks, tiles, stream)
    launches.count += 2


_workspaces = {}


def _workspace(device, stream, numel):
    """The partial tiles' buffer, kept per (device, stream) and grown when
    a call needs more: calls on one stream run in order, so they can share
    it, and the products kernel never waits on an allocation."""
    key = (device, stream)
    ws = _workspaces.get(key)
    if ws is None or ws.numel() < numel:
        ws = _workspaces[key] = torch.empty(numel, dtype=torch.float32,
                                            device=device)
    return ws


def launch(jobs, shapes, plan, ws, blocks, tiles, stream):
    """Fill the argument struct and start both kernels on ``stream``."""
    args = _Args(njobs=len(jobs), ws=ws.data_ptr(), blocks=blocks,
                 tiles=tiles)
    for k, ((a, a2, b, c), shape, p) in enumerate(zip(jobs, shapes, plan)):
        args.job[k] = _Job(a.data_ptr(),
                           a2.data_ptr() if a2 is not None else None,
                           b.data_ptr(), c.data_ptr(), *shape, **p)
    lib = _build.load().lib
    lib.outer_sum_f32.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    lib.outer_sum_f32.restype = ctypes.c_int
    _build.check(lib.outer_sum_f32(ctypes.byref(args), stream),
                 "outer_sum_f32")
