"""Differentiable GRU scan of the training path: the CUDA kernels' wrapper
and its plain version.

Counterpart of ``attention_lvcsr_tpu/ops/pallas/gru_train.py``
(``gru_scan_train`` :291 and ``gru_scan_train_bidir`` :570).  Same
arguments as :func:`attention_lvcsr_torch.ops.gru_scan.gru_scan`: one
direction, or both directions of a bidirectional layer, the backward one
in reverse time (the JAX package's flip / scan / flip back), so the two
directions run in one launch of each kernel.

On a CUDA tensor the scan is a ``torch.autograd.Function``:

* forward: ``csrc/gru_scan.cu``'s kernel with its residual outputs set
  (update gate, reset gate and candidate of every step), one launch;
* backward: ``csrc/gru_train.cu`` walks the steps in reverse with the
  state gradient on chip and writes the input-projection gradients, then
  ``csrc/outer_sum.cu`` reduces them into the recurrent-weight gradients
  (two launches).

On the CPU it is the plain version, the forward scan written with PyTorch
operations (:func:`gru_scan_reference`), whose gradient autograd takes.
The mask gets no gradient; a masked step passes the state gradient through.
"""
from __future__ import annotations

import ctypes

import torch

from attention_lvcsr_torch import _build
from attention_lvcsr_torch.ops import gru_scan as gs
from attention_lvcsr_torch.ops.outer_sum import outer_sum

launches = _build.LaunchCounter()         # one direction: forward + backward
launches_bidir = _build.LaunchCounter()   # both directions in one launch

gru_scan_train_reference = gs.gru_scan_reference


class _BwdDir(ctypes.Structure):
    """Mirror of ``struct GruBwdDir`` in csrc/gru_train.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "dout", "states", "h0", "u", "r", "c", "w_state", "w_gates", "dx",
        "dg", "dh0")] + [("reverse", ctypes.c_int)])


class _BwdArgs(ctypes.Structure):
    """Mirror of ``struct GruBwdArgs`` in csrc/gru_train.cu."""
    _fields_ = ([("dir", _BwdDir * 2), ("mask", ctypes.c_void_p)]
                + [(n, ctypes.c_int) for n in (
                    "T", "B", "D", "ld_dout", "ld_states", "ld_dproj")])


def _counter(ndir):
    return launches if ndir == 1 else launches_bidir


def _supported(lib, D):
    lib.gru_train_supported.argtypes = [ctypes.c_int]
    lib.gru_train_supported.restype = ctypes.c_int
    supported = lib.gru_train_supported(D)
    _build.check(max(0, -supported), "gru_train_supported")
    if supported == 0:
        raise NotImplementedError(
            f"gru_scan_train: width D={D} is not ported yet (the backward "
            f"kernel keeps each direction's recurrent weights and gradient "
            f"buffers in one 8-block cluster's shared memory, which holds "
            f"up to about D=310)")


def _previous_states(states, h0, reverse):
    """h_prev of every step: [h0, states[:-1]], or the reverse direction's
    [states[1:], h0]."""
    if reverse:
        return torch.cat([states[1:], h0[None]])
    return torch.cat([h0[None], states[:-1]])


class _GruScanTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, proj, mask, ndir, *weights):
        dirs = [tuple(weights[3 * i:3 * i + 3]) for i in range(ndir)]
        T, B, _ = proj.shape
        D = dirs[0][1].shape[0]
        lib = _build.load().lib
        with torch.cuda.device(proj.device):
            _supported(lib, D)
        out = torch.empty(T, B, D * ndir, dtype=proj.dtype,
                          device=proj.device)
        residuals = [tuple(torch.empty(T, B, D, dtype=proj.dtype,
                                       device=proj.device)
                           for _ in range(3)) for _ in range(ndir)]
        if gs.launch(proj, mask, dirs, out, residuals, "gru_scan_train"):
            _counter(ndir).count += 1
        ctx.ndir = ndir
        ctx.has_mask = mask is not None
        ctx.save_for_backward(
            out, mask if mask is not None else out.new_empty(0),
            *[t for res in residuals for t in res], *weights)
        return out

    @staticmethod
    def backward(ctx, dout):
        ndir = ctx.ndir
        out, mask, *rest = ctx.saved_tensors
        residuals = [rest[3 * i:3 * i + 3] for i in range(ndir)]
        weights = rest[3 * ndir:]
        dirs = [tuple(weights[3 * i:3 * i + 3]) for i in range(ndir)]
        mask = mask if ctx.has_mask else None
        T, B, width = out.shape
        D = width // ndir
        dout = dout.contiguous()
        dproj = torch.empty(T, B, 3 * D * ndir, dtype=out.dtype,
                            device=out.device)
        grads = [(torch.empty(B, D, dtype=out.dtype, device=out.device),
                  torch.zeros(D, D, dtype=out.dtype, device=out.device),
                  torch.zeros(D, 2 * D, dtype=out.dtype, device=out.device))
                 for _ in range(ndir)]
        if T and B:
            lib = _build.load().lib
            lib.gru_train_bwd_f32.argtypes = [ctypes.POINTER(_BwdArgs),
                                              ctypes.c_int, ctypes.c_void_p]
            lib.gru_train_bwd_f32.restype = ctypes.c_int
            args = _BwdArgs(
                mask=mask.data_ptr() if mask is not None else None, T=T, B=B,
                D=D, ld_dout=width, ld_states=width, ld_dproj=3 * D * ndir)
            for i, ((h0, ws, wg), (u, r, c), (dh0, _, _)) in enumerate(
                    zip(dirs, residuals, grads)):
                args.dir[i] = _BwdDir(
                    dout[..., D * i:].data_ptr(), out[..., D * i:].data_ptr(),
                    h0.data_ptr(), u.data_ptr(), r.data_ptr(), c.data_ptr(),
                    ws.data_ptr(), wg.data_ptr(),
                    dproj[..., 3 * D * i:].data_ptr(),
                    dproj[..., 3 * D * i + D:].data_ptr(), dh0.data_ptr(),
                    reverse=i)
            with torch.cuda.device(out.device):
                status = lib.gru_train_bwd_f32(ctypes.byref(args), ndir,
                                               _build.stream_of(out))
            _build.check(status, "gru_train_bwd_f32")
            jobs = []
            for i, ((h0, _, _), (_, r, _), (_, dws, dwg)) in enumerate(
                    zip(dirs, residuals, grads)):
                h_prev = _previous_states(out[..., D * i:D * (i + 1)], h0,
                                          reverse=bool(i))
                jobs.append((h_prev, r, dproj[..., 3 * D * i:3 * D * i + D],
                             dws))
                jobs.append((h_prev, None,
                             dproj[..., 3 * D * i + D:3 * D * (i + 1)], dwg))
            outer_sum(jobs, out)
            _counter(ndir).count += 2
        else:
            dproj.zero_()
            for dh0, _, _ in grads:
                dh0.zero_()
        return (dproj, None, None, *[g for trio in grads for g in trio])


def gru_scan_train(proj, mask, fwd, bwd=None):
    """Differentiable GRU recurrence over time, one direction or both.

    ``proj`` (T, B, 3D) or (T, B, 6D), ``mask`` (T, B) or None, ``fwd`` and
    ``bwd`` (h0 (B, D), w_state (D, D), w_gates (D, 2D)) as for
    :func:`~attention_lvcsr_torch.ops.gru_scan.gru_scan`; returns the
    states (T, B, D) or (T, B, 2D), differentiable in ``proj`` and in every
    tensor of ``fwd`` and ``bwd``."""
    device = proj.device
    if device.type == "cpu":
        return gru_scan_train_reference(proj, mask, fwd, bwd)
    if device.type != "cuda":
        raise ValueError(f"gru_scan_train: no kernel for device {device}")
    dirs = (fwd,) if bwd is None else (fwd, bwd)
    return _GruScanTrain.apply(proj, mask, len(dirs),
                               *[t for trio in dirs for t in trio])
