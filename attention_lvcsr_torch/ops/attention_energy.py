"""Beam attention energies: the CUDA kernel's wrapper and its plain version.

Counterpart of ``attention_lvcsr_tpu/ops/pallas/attention_energy.py::
beam_attention_energies``: per hypothesis row ``uk`` and frame ``l``,

    energies[uk, l] = v . tanh(pre[u, l] + state_sum[uk] + conv[uk, l] * handler)
                      + bias

with one utterance's keys ``pre[u]`` shared by its K hypotheses and the
(U*K, L, M) match tensor never stored.  ``beam_attention_energies`` takes
the plain PyTorch version for tensors on the CPU and launches
``csrc/attention_energy.cu`` for tensors on a CUDA device; any other
device raises.  Float32 in, float32 math, as the module path of the JAX
package computes it.
"""
from __future__ import annotations

import ctypes

import torch

from attention_lvcsr_torch import _build

launches = _build.LaunchCounter()


def beam_attention_energies_reference(pre, state_sum, conv, handler, v, bias,
                                      *, beam):
    """Plain version: pre (U, L, M), state_sum (U*K, M), conv (U*K, L),
    handler (M,), v (M,), bias float -> energies (U*K, L)."""
    U, L, M = pre.shape
    match = torch.tanh(pre[:, None, :, :] + state_sum.view(U, beam, 1, M)
                       + conv.view(U, beam, L, 1) * handler)
    return (match @ v).view(U * beam, L) + bias


class _Args(ctypes.Structure):
    """Mirror of ``struct AttentionEnergyArgs`` in csrc/attention_energy.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "pre", "state_sum", "conv", "handler", "v", "out")]
        + [("bias", ctypes.c_float)]
        + [(n, ctypes.c_int) for n in ("U", "K", "L", "M")])


def _check(name, t, shape, device):
    if t.dtype != torch.float32:
        raise TypeError(f"beam_attention_energies: {name} must be float32, "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"beam_attention_energies: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"beam_attention_energies: {name} must be "
                         "contiguous")
    if t.device != device:
        raise ValueError(f"beam_attention_energies: {name} is on "
                         f"{t.device}, expected {device}")


def _launch(pre, state_sum, conv, handler, v, bias, beam):
    device = pre.device
    U, L, M = pre.shape
    K = int(beam)
    _check("pre", pre, (U, L, M), device)
    _check("state_sum", state_sum, (U * K, M), device)
    _check("conv", conv, (U * K, L), device)
    _check("handler", handler, (M,), device)
    _check("v", v, (M,), device)
    out = torch.empty(U * K, L, dtype=torch.float32, device=device)
    if not (U and K and L):
        return out
    lib = _build.load().lib
    fn = lib.attention_energy_f32
    fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    args = _Args(pre=pre.data_ptr(), state_sum=state_sum.data_ptr(),
                 conv=conv.data_ptr(), handler=handler.data_ptr(),
                 v=v.data_ptr(), out=out.data_ptr(), bias=float(bias),
                 U=U, K=K, L=L, M=M)
    with torch.cuda.device(device):
        status = fn(ctypes.byref(args), _build.stream_of(pre))
    _build.check(status, "attention_energy_f32")
    launches.count += 1
    return out


def beam_attention_energies(pre, state_sum, conv, handler, v, bias, *, beam):
    """Energies (U*K, L) of every hypothesis over its utterance's frames;
    same arguments as the plain version."""
    device = pre.device.type
    if device == "cpu":
        return beam_attention_energies_reference(pre, state_sum, conv,
                                                 handler, v, bias, beam=beam)
    if device == "cuda":
        return _launch(pre, state_sum, conv, handler, v, bias, beam)
    raise ValueError(f"beam_attention_energies: no kernel for device "
                     f"{pre.device}")
