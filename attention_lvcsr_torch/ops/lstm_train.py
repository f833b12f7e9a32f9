"""Differentiable peephole-LSTM scan of the training path: the CUDA
kernels' wrapper and its plain version.

Counterpart of ``attention_lvcsr_tpu/ops/pallas/lstm_train.py::
lstm_scan_train`` (:374).  Same arguments as
:func:`attention_lvcsr_torch.ops.lstm_scan.lstm_scan`: one direction, or
both directions of a bidirectional layer, the backward one in reverse time
(the JAX package's flip / scan / flip back), so the two directions run in
one launch of each kernel.

On a CUDA tensor the scan is a ``torch.autograd.Function``:

* forward: ``csrc/lstm_scan.cu``'s kernel with its residual outputs set
  (the in, forget, cell and out gates of every step, as the TPU kernel
  stores them), one launch;
* backward: ``csrc/lstm_train.cu`` walks the steps in reverse with the
  state and cell gradients on chip and writes the input-projection
  gradients and per-row peephole sums, then ``csrc/outer_sum.cu`` reduces
  them into the recurrent-weight and peephole gradients (its two kernels
  count on ``outer_sum.launches``).
  A cotangent of None for the cells (the encoder's case: only the states
  go downstream) counts as zeros, as the JAX VJP takes it.

On the CPU it is the plain version, the forward scan written with PyTorch
operations (:func:`lstm_scan_train_reference`), whose gradient autograd
takes.  The mask gets no gradient; a masked step passes the state and cell
gradients through.

The backward kernel runs 16-block clusters; :func:`bwd_layout` mirrors its
shared-memory layout (``csrc/lstm_train.cu::bwd_layout``).
"""
from __future__ import annotations

import ctypes

import torch

from attention_lvcsr_torch import _build
from attention_lvcsr_torch.ops import gru_scan as gs
from attention_lvcsr_torch.ops import lstm_scan as ls
from attention_lvcsr_torch.ops.gru_scan import GROUP_ROWS, MAX_SLICES, \
    MAX_SMEM, THREADS
from attention_lvcsr_torch.ops.gru_train import _previous_states
from attention_lvcsr_torch.ops.outer_sum import outer_sum

launches = _build.LaunchCounter()   # forward + backward; outer_sum has its own

lstm_scan_train_reference = ls.lstm_scan_reference

_WEIGHTS = 6          # h0, c0, w_state, pci, pcf, pco per direction

# csrc/lstm_train.cu's constants: blocks a cluster, operands staged per item
BWD_CLUSTER, BWD_OPERANDS = 16, 8


def bwd_layout(D):
    """The backward kernel's layout at width D: owned columns ``n``, padded
    width ``Dp``, the k slices of its product and the shared memory of a
    block in bytes."""
    n = gs.owned_columns(D, BWD_CLUSTER)
    Dp = BWD_CLUSTER * n
    # transposed weights (4n x Dp), own da (4n rows), the double-buffered
    # partials (16 x Dp), the stage
    fixed = (4 * n * Dp + 4 * n * GROUP_ROWS + 2 * GROUP_ROWS * Dp
             + BWD_OPERANDS * GROUP_ROWS * n)
    cap = MAX_SLICES
    while True:
        slices = gs.tile_slices(Dp, cap)
        total = fixed + slices * GROUP_ROWS * Dp
        if total <= MAX_SMEM // 4 or cap == 1:
            break
        cap //= 2
    return {"n": n, "Dp": Dp, "slices": slices, "smem_bytes": 4 * total}


def bwd_fits(D, max_smem=MAX_SMEM):
    """Whether the backward layout covers width D: one item per thread and
    the shared memory."""
    o = bwd_layout(D)
    return GROUP_ROWS * o["n"] <= THREADS and o["smem_bytes"] <= max_smem


class _BwdDir(ctypes.Structure):
    """Mirror of ``struct LstmBwdDir`` in csrc/lstm_train.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "dh", "dc", "cs", "c0", "gi", "gf", "gz", "go", "w_state", "pci",
        "pcf", "pco", "dx", "dh0", "dc0", "dpeep")]
        + [("reverse", ctypes.c_int)])


class _BwdArgs(ctypes.Structure):
    """Mirror of ``struct LstmBwdArgs`` in csrc/lstm_train.cu."""
    _fields_ = ([("dir", _BwdDir * 2), ("mask", ctypes.c_void_p)]
                + [(n, ctypes.c_int) for n in (
                    "T", "B", "D", "ld_dout", "ld_states", "ld_dx")])


def launch_backward(dstates, dcells, cells, mask, dirs, residuals, dproj,
                    grads, dpeep, stream):
    """Start ``csrc/lstm_train.cu`` on ``stream``: from the cotangents
    ``dstates`` and ``dcells`` (or None), the forward's ``cells`` (T, B,
    D * ndir) and gate residuals, write the projections' gradient ``dproj``
    (T, B, 4D * ndir), each direction's dh0 and dc0 (``grads[i][0:2]``)
    and its per-row peephole sums ``dpeep[i]`` (B, 3D)."""
    T, B, width = cells.shape
    ndir = len(dirs)
    D = width // ndir
    lib = _build.load().lib
    lib.lstm_train_bwd_f32.argtypes = [ctypes.POINTER(_BwdArgs),
                                       ctypes.c_int, ctypes.c_void_p]
    lib.lstm_train_bwd_f32.restype = ctypes.c_int
    args = _BwdArgs(mask=mask.data_ptr() if mask is not None else None,
                    T=T, B=B, D=D, ld_dout=width, ld_states=width,
                    ld_dx=4 * D * ndir)
    for i, ((_, c0, ws, pci, pcf, pco), gates, g, pp) in enumerate(
            zip(dirs, residuals, grads, dpeep)):
        args.dir[i] = _BwdDir(
            dstates[..., D * i:].data_ptr(),
            dcells[..., D * i:].data_ptr() if dcells is not None else None,
            cells[..., D * i:].data_ptr(), c0.data_ptr(),
            *(r.data_ptr() for r in gates), ws.data_ptr(), pci.data_ptr(),
            pcf.data_ptr(), pco.data_ptr(), dproj[..., 4 * D * i:].data_ptr(),
            g[0].data_ptr(), g[1].data_ptr(), pp.data_ptr(), reverse=i)
    _build.check(lib.lstm_train_bwd_f32(ctypes.byref(args), ndir, stream),
                 "lstm_train_bwd_f32")


def _directions(weights, ndir):
    return [tuple(weights[_WEIGHTS * i:_WEIGHTS * (i + 1)])
            for i in range(ndir)]


class _LstmScanTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, proj, mask, ndir, *weights):
        ctx.set_materialize_grads(False)
        dirs = _directions(weights, ndir)
        T, B, _ = proj.shape
        D = dirs[0][0].shape[1]
        lib = _build.load().lib
        with torch.cuda.device(proj.device):
            ls.require_width(lib, "lstm_train_supported", "lstm_scan_train",
                             D, bwd_fits)
        new = lambda *s: torch.empty(*s, dtype=proj.dtype, device=proj.device)
        states, cells = new(T, B, D * ndir), new(T, B, D * ndir)
        residuals = [tuple(new(T, B, D) for _ in range(4))
                     for _ in range(ndir)]
        if ls.launch(proj, mask, dirs, states, cells, residuals,
                     "lstm_scan_train"):
            launches.count += 1
        ctx.ndir = ndir
        ctx.has_mask = mask is not None
        ctx.save_for_backward(
            states, cells, mask if mask is not None else states.new_empty(0),
            *[g for res in residuals for g in res], *weights)
        return states, cells

    @staticmethod
    def backward(ctx, dstates, dcells):
        ndir = ctx.ndir
        states, cells, mask, *rest = ctx.saved_tensors
        residuals = [rest[4 * i:4 * i + 4] for i in range(ndir)]
        dirs = _directions(rest[4 * ndir:], ndir)
        mask = mask if ctx.has_mask else None
        T, B, width = states.shape
        D = width // ndir
        new = lambda *s: torch.zeros(*s, dtype=states.dtype,
                                     device=states.device)
        dproj = new(T, B, 4 * D * ndir)
        grads = [[new(B, D), new(B, D), new(D, 4 * D), new(D), new(D),
                  new(D)] for _ in range(ndir)]
        if not (T and B) or (dstates is None and dcells is None):
            return (dproj, None, None, *[g for six in grads for g in six])
        dstates = (dstates.contiguous() if dstates is not None
                   else torch.zeros_like(states))
        dcells = dcells.contiguous() if dcells is not None else None
        dpeep = [new(B, 3 * D) for _ in range(ndir)]
        with torch.cuda.device(states.device):
            launch_backward(dstates, dcells, cells, mask, dirs, residuals,
                            dproj, grads, dpeep, _build.stream_of(states))
        launches.count += 1
        ones = states.new_ones(B, 1)        # the rows' peephole sums over B
        jobs, peeps = [], []
        for i, ((h0, *_), g, pp) in enumerate(zip(dirs, grads, dpeep)):
            h_prev = _previous_states(states[..., D * i:D * (i + 1)], h0,
                                      reverse=bool(i))
            peep = new(1, 3 * D)
            jobs += [(h_prev, None, dproj[..., 4 * D * i:4 * D * (i + 1)],
                      g[2]),
                     (ones, None, pp, peep)]
            peeps.append(peep)
        outer_sum(jobs, states)
        for g, peep in zip(grads, peeps):
            g[3:] = peep.view(3, D).unbind(0)
        return (dproj, None, None, *[g for six in grads for g in six])


def lstm_scan_train(proj, mask, fwd, bwd=None):
    """Differentiable peephole-LSTM recurrence over time, one direction or
    both.

    ``proj`` (T, B, 4D) or (T, B, 8D), ``mask`` (T, B) or None, ``fwd`` and
    ``bwd`` (h0, c0 (B, D), w_state (D, 4D), pci, pcf, pco (D,)) as for
    :func:`~attention_lvcsr_torch.ops.lstm_scan.lstm_scan`; returns the
    states and the cells, (T, B, D) or (T, B, 2D) each, differentiable in
    ``proj`` and in every tensor of ``fwd`` and ``bwd``."""
    device = proj.device
    if device.type == "cpu":
        return lstm_scan_train_reference(proj, mask, fwd, bwd)
    if device.type != "cuda":
        raise ValueError(f"lstm_scan_train: no kernel for device {device}")
    dirs = (fwd,) if bwd is None else (fwd, bwd)
    return _LstmScanTrain.apply(proj, mask, len(dirs),
                                *[t for six in dirs for t in six])
