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

The kernel runs a block per utterance and tile of frames; :func:`plan`
picks the tile so that the blocks spread over the card's SMs in balanced
waves, and mirrors the kernel's thread and shared-memory layout.
"""
from __future__ import annotations

import ctypes

import torch

from attention_lvcsr_torch import _build

launches = _build.LaunchCounter()

# csrc/attention_energy.cu's constants
MAX_THREADS = 256
MAX_SLICES = 8
MAX_SMEM = 232448          # the opt-in shared memory of a block on sm_90
TILES = tuple(range(2, 33, 2))


def plan(U, K, L, M, sms, max_smem=MAX_SMEM):
    """The launch of the kernel for U utterances, beam K, L frames and M
    match columns on a card of ``sms`` SMs: frames a block (``tile``), M
    slices a thread tile takes (``slices``), threads and shared memory of
    a block, blocks.  A thread owns 2 rows (1 at K=1) x 2 frames; the
    tile is the one whose blocks give the least work to the busiest SM,
    ``ceil(blocks / sms) * (tile + 1)`` (a block's staging and sums
    count about one frame), the larger on a tie."""
    rk = 1 if K == 1 else 2
    groups = -(-K // rk)
    Mp = M | 1
    best = None
    for tile in sorted({min(t, L + L % 2) for t in TILES}):
        tiles = groups * -(-min(tile, L) // 2)
        if tiles > MAX_THREADS:
            continue
        slices = max(1, min(MAX_SLICES, MAX_THREADS // tiles, M))
        smem = 4 * ((tile + K + 2) * Mp + slices * K * tile)
        if smem > max_smem:
            continue
        blocks = U * -(-L // tile)
        cost = (-(-blocks // sms) * (tile + 1), -tile)
        if best is None or cost < best[0]:
            best = (cost, {"tile": tile, "slices": slices,
                           "threads": -(-tiles * slices // 32) * 32,
                           "blocks": blocks, "smem_bytes": smem})
    if best is None:
        raise NotImplementedError(
            f"beam_attention_energies: beam {K} at M={M} does not fit a "
            f"block's shared memory ({max_smem} bytes)")
    return best[1]


_sms = {}


def launch_plan(U, K, L, M, device):
    """:func:`plan` on the device's SM count (queried once a device)."""
    if device.index not in _sms:
        _sms[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return plan(U, K, L, M, _sms[device.index])


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
        + [(n, ctypes.c_int) for n in ("U", "K", "L", "M", "tile",
                                       "slices")])


_entry = None


def _kernel():
    """The C entry point, its ctypes signature set once."""
    global _entry
    if _entry is None:
        fn = _build.load().lib.attention_energy_f32
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


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
    p = launch_plan(U, K, L, M, device)
    fn = _kernel()
    args = _Args(pre=pre.data_ptr(), state_sum=state_sum.data_ptr(),
                 conv=conv.data_ptr(), handler=handler.data_ptr(),
                 v=v.data_ptr(), out=out.data_ptr(), bias=float(bias),
                 U=U, K=K, L=L, M=M, tile=p["tile"], slices=p["slices"])
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
