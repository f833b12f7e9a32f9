"""Forward GRU scan: the CUDA kernel's wrapper and its plain version.

Counterpart of ``attention_lvcsr_tpu/ops/pallas/gru_scan.py::gru_scan``.
``gru_scan`` runs one direction, like the JAX function, or both
directions of a bidirectional layer in one launch, the backward one in
reverse time.  It takes the plain PyTorch version for tensors on the CPU
and launches ``csrc/gru_scan.cu`` for tensors on a CUDA device; any
other device raises, and so does a width the kernel does not cover.
There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from attention_lvcsr_torch import _build

launches = _build.LaunchCounter()


def _scan_reference(x_proj, gate_proj, mask, h0, w_state, w_gates,
                    reverse):
    """One direction: x_proj (T, B, D), gate_proj (T, B, 2D) -> (T, B, D).
    ``reverse`` visits t = T-1 .. 0 (the JAX package's backward direction:
    flip inputs and mask, scan, flip the states back)."""
    T, _, D = x_proj.shape
    h = h0
    out = [None] * T
    for t in (reversed(range(T)) if reverse else range(T)):
        gates = torch.sigmoid(h @ w_gates + gate_proj[t])
        update, reset = gates[:, :D], gates[:, D:]
        cand = torch.tanh((h * reset) @ w_state + x_proj[t])
        new_h = update * cand + (1.0 - update) * h
        if mask is not None:
            m = mask[t][:, None]
            new_h = m * new_h + (1.0 - m) * h
        out[t] = new_h
        h = new_h
    if not out:
        return x_proj.new_zeros(x_proj.shape)
    return torch.stack(out)


def gru_scan_reference(proj, mask, fwd, bwd=None):
    """Plain version of :func:`gru_scan`, same arguments."""
    D = fwd[1].shape[0]
    states = _scan_reference(proj[..., :D], proj[..., D:3 * D], mask, *fwd,
                             reverse=False)
    if bwd is None:
        return states
    states_b = _scan_reference(proj[..., 3 * D:4 * D], proj[..., 4 * D:],
                               mask, *bwd, reverse=True)
    return torch.cat([states, states_b], dim=-1)


class _Dir(ctypes.Structure):
    """Mirror of ``struct GruDir`` in csrc/gru_scan.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "x", "g", "h0", "w_state", "w_gates", "out")]
        + [("reverse", ctypes.c_int)])


class _Args(ctypes.Structure):
    """Mirror of ``struct GruArgs`` in csrc/gru_scan.cu."""
    _fields_ = ([("dir", _Dir * 2), ("mask", ctypes.c_void_p)]
                + [(n, ctypes.c_int) for n in (
                    "T", "B", "D", "ldx", "ldg", "ldo")])


def _check(name, t, shape, device):
    if t.dtype != torch.float32:
        raise TypeError(f"gru_scan: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"gru_scan: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"gru_scan: {name} must be contiguous")
    if t.device != device:
        raise ValueError(f"gru_scan: {name} is on {t.device}, expected "
                         f"{device}")


def gru_scan(proj, mask, fwd, bwd=None):
    """GRU recurrence over time, one direction or both.

    ``proj`` (T, B, 3D) holds [inputs | gates] (D and 2D columns, gate
    order update then reset) of the forward direction; with ``bwd`` it is
    (T, B, 6D) = [inputs_fwd | gates_fwd | inputs_bwd | gates_bwd].
    ``mask`` (T, B) or None; a masked step keeps the state.  ``fwd`` and
    ``bwd`` are (h0 (B, D), w_state (D, D), w_gates (D, 2D)).  Returns the
    states (T, B, D), or (T, B, 2D) = [forward | backward] with the
    backward direction run in reverse time."""
    device = proj.device
    if device.type == "cpu":
        return gru_scan_reference(proj, mask, fwd, bwd)
    if device.type != "cuda":
        raise ValueError(f"gru_scan: no kernel for device {device}")
    dirs = (fwd,) if bwd is None else (fwd, bwd)
    T, B, width = proj.shape
    D = fwd[1].shape[0]
    _check("proj", proj, (T, B, 3 * D * len(dirs)), device)
    if mask is not None:
        _check("mask", mask, (T, B), device)
    for name, (h0, ws, wg) in zip(("fwd", "bwd"), dirs):
        _check(f"{name} h0", h0, (B, D), device)
        _check(f"{name} w_state", ws, (D, D), device)
        _check(f"{name} w_gates", wg, (D, 2 * D), device)
    out = torch.empty(T, B, D * len(dirs), dtype=proj.dtype, device=device)
    if not (T and B):
        return out
    lib = _build.load().lib
    lib.gru_scan_supported.argtypes = [ctypes.c_int]
    lib.gru_scan_supported.restype = ctypes.c_int
    lib.gru_scan_f32.argtypes = [ctypes.POINTER(_Args), ctypes.c_int,
                                 ctypes.c_void_p]
    lib.gru_scan_f32.restype = ctypes.c_int
    with torch.cuda.device(device):
        supported = lib.gru_scan_supported(D)
        _build.check(max(0, -supported), "gru_scan_supported")
        if supported == 0:
            raise NotImplementedError(
                f"gru_scan: width D={D} is not ported yet (the kernel keeps "
                f"each direction's recurrent weights in one 8-block "
                f"cluster's shared memory, which holds up to about D=330)")
        args = _Args(mask=mask.data_ptr() if mask is not None else None,
                     T=T, B=B, D=D, ldx=width, ldg=width, ldo=out.shape[-1])
        for i, (h0, ws, wg) in enumerate(dirs):
            args.dir[i] = _Dir(proj[..., 3 * D * i:].data_ptr(),
                               proj[..., 3 * D * i + D:].data_ptr(),
                               h0.data_ptr(), ws.data_ptr(), wg.data_ptr(),
                               out[..., D * i:].data_ptr(), i)
        status = lib.gru_scan_f32(ctypes.byref(args), len(dirs),
                                  _build.stream_of(proj))
    _build.check(status, "gru_scan_f32")
    launches.count += 1
    return out
