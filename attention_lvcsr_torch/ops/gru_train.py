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
  (its two kernels count on ``outer_sum.launches``).

On the CPU it is the plain version, the forward scan written with PyTorch
operations (:func:`gru_scan_reference`), whose gradient autograd takes.
The mask gets no gradient; a masked step passes the state gradient through.

Each kernel takes the instance of its width before any launch: the
forward :func:`~attention_lvcsr_torch.ops.gru_scan.route` (resident up to
D=448), the backward :func:`backward_route` (resident up to D=384, where
its weight slices fit a block's shared memory, :func:`bwd_layout`; the
wide instance, which keeps their leading tiles there and streams the
rest from L2, packed by :func:`pack_backward`, up to D=1024,
:func:`bwd_wide_layout`).
"""
from __future__ import annotations

import ctypes

import torch

from attention_lvcsr_torch import _build
from attention_lvcsr_torch.ops import gru_scan as gs
from attention_lvcsr_torch.ops.outer_sum import outer_sum

# forward + backward kernels (outer_sum counts its own launches), the
# resident instances and the wide ones
launches = _build.LaunchCounter()         # one direction
launches_bidir = _build.LaunchCounter()   # both directions in one launch
launches_wide = _build.LaunchCounter()
launches_bidir_wide = _build.LaunchCounter()

BWD_CLUSTER = 16               # csrc/gru_train.cu's kBwdCluster

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


class _BwdWideArgs(ctypes.Structure):
    """Mirror of ``struct GruBwdWideArgs`` in csrc/gru_train.cu."""
    _fields_ = [("a", _BwdArgs), ("pack", ctypes.c_void_p * 2)]


def _counter(ndir, which):
    if which == "wide":
        return launches_wide if ndir == 1 else launches_bidir_wide
    return launches if ndir == 1 else launches_bidir


def bwd_layout(D):
    """The resident backward's layout at width D (``gru_train.cu::
    bwd_layout``): owned columns ``n``, padded width ``Dp``, k slices and
    the shared memory of a block in bytes."""
    n = gs.owned_columns(D, BWD_CLUSTER)
    Dp = BWD_CLUSTER * n
    slices = gs.tile_slices(n, gs.MAX_SLICES)
    # weights (3 Dp n), da and [du | dr] (3 Dp rows), stage, partial sums
    total = (3 * Dp * n + 3 * Dp * gs.GROUP_ROWS + 6 * gs.GROUP_ROWS * n
             + slices * gs.GROUP_ROWS * n)
    return {"n": n, "Dp": Dp, "slices": slices, "smem_bytes": 4 * total}


def bwd_fits(D, max_smem=gs.MAX_SMEM):
    """Whether the resident backward covers width D: two items a thread
    and the shared memory (``gru_train.cu::bwd_fits``)."""
    o = bwd_layout(D)
    return (gs.GROUP_ROWS * o["n"] <= 2 * gs.THREADS
            and o["smem_bytes"] <= max_smem)


def bwd_wide_layout(D):
    """The wide backward's layout at width D (``gru_wide.cuh::
    bwd_wide_layout``): the slices halve while the layout with a ring of
    RING_MIN_TILES would not fit; the weight ring (the reset path's
    product 0 over Dp rows, the gate path's product 1 over 2 Dp) under
    ``"ring"``, the other buffers' offsets in floats under
    ``"offsets"``."""
    n = gs.owned_columns(D, BWD_CLUSTER)
    Dp = BWD_CLUSTER * n
    # the gathered gradients (2 Dp rows), own da and [du | dr] slices,
    # stage, then partial sums and the ring
    fixed = 2 * Dp * gs.GROUP_ROWS + 3 * n * gs.GROUP_ROWS \
        + 6 * gs.GROUP_ROWS * n
    cap = gs.MAX_SLICES
    while True:
        slices = gs.tile_slices(n, cap)
        if (fixed + slices * gs.GROUP_ROWS * n
                + gs.RING_MIN_TILES * gs.RING_FLOATS <= gs.MAX_SMEM // 4
                or cap == 1):
            break
        cap //= 2
    kt = gs.ring_rows(n, slices)
    ring = gs.ring_layout(fixed + slices * gs.GROUP_ROWS * n, Dp, n, kt,
                          2 * Dp, n, kt)
    big = 0
    oa = big + 2 * Dp * gs.GROUP_ROWS
    og = oa + n * gs.GROUP_ROWS
    stage = og + 2 * n * gs.GROUP_ROWS
    part = stage + 6 * gs.GROUP_ROWS * n
    return {"n": n, "Dp": Dp, "slices": slices, "kt": kt, "ring": ring,
            "offsets": {"big": big, "oa": oa, "og": og, "stage": stage,
                        "part": part},
            "smem_bytes": 4 * ring["total"]}


def bwd_wide_fits(D, max_smem=gs.MAX_SMEM):
    """Whether the wide backward covers width D (``gru_wide.cuh::
    bwd_wide_fits``)."""
    if not 1 <= D <= gs.WIDE_MAX_D:
        return False
    o = bwd_wide_layout(D)
    return (gs.GROUP_ROWS * o["n"] <= 2 * gs.THREADS
            and o["ring"]["slots"] * gs.RING_CHUNK >= gs.RING_MIN_TILES
            and o["smem_bytes"] <= max_smem)


def backward_route(D):
    """The backward instance that runs width D: "resident" up to 384,
    "wide" up to WIDE_MAX_D; wider raises."""
    if bwd_fits(D):
        return "resident"
    if bwd_wide_fits(D):
        return "wide"
    raise NotImplementedError(
        f"gru_scan_train: width D={D} is not ported yet (the kernels cover "
        f"D up to {gs.WIDE_MAX_D}: the backward keeps each direction's "
        f"recurrent weights in one 16-block cluster's shared memory up to "
        f"384 and streams them from L2 above that)")


def pack_backward(w_state, w_gates):
    """The wide backward's weights of one direction, packed per block of
    its 16-block cluster (``struct GruBwdWideArgs``): (16, 3 Dp n), block
    j's owned rows of w_state transposed (Dp, n), then those of w_gates
    (2 Dp, n: the update k, then the reset k), zero past D."""
    D = w_state.shape[0]
    o = bwd_wide_layout(D)
    n, Dp = o["n"], o["Dp"]
    pad = Dp - D
    # state[k, c] = w_state[c, k]; gates[g, k, c] = w_gates[c, g * D + k]
    state = torch.nn.functional.pad(w_state.T, (0, pad, 0, pad))
    state = state.view(Dp, BWD_CLUSTER, n).permute(1, 0, 2)
    gates = torch.nn.functional.pad(w_gates.view(D, 2, D),
                                    (0, pad, 0, 0, 0, pad))
    gates = gates.permute(1, 2, 0).reshape(2, Dp, BWD_CLUSTER, n)
    gates = gates.permute(2, 0, 1, 3)
    return torch.cat([state.reshape(BWD_CLUSTER, Dp * n),
                      gates.reshape(BWD_CLUSTER, 2 * Dp * n)],
                     dim=1).contiguous()


def launch_backward(dout, out, mask, dirs, residuals, dproj, dh0s, stream):
    """Start ``csrc/gru_train.cu``'s instance for the width
    (:func:`backward_route`) on ``stream``: from the cotangent ``dout`` and
    the forward's states ``out`` (T, B, D * ndir) and residuals, write the
    projections' gradient ``dproj`` (T, B, 3D * ndir) and each direction's
    ``dh0``.  Returns the route."""
    T, B, width = out.shape
    ndir = len(dirs)
    D = width // ndir
    which = backward_route(D)
    entry = "gru_train_bwd_f32" if which == "resident" \
        else "gru_train_wide_bwd_f32"
    fn = getattr(_build.load().lib, entry)
    fn.argtypes = [ctypes.POINTER(_BwdArgs if which == "resident"
                                  else _BwdWideArgs),
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    args = _BwdArgs(
        mask=mask.data_ptr() if mask is not None else None, T=T, B=B, D=D,
        ld_dout=width, ld_states=width, ld_dproj=3 * D * ndir)
    for i, ((h0, ws, wg), (u, r, c), dh0) in enumerate(
            zip(dirs, residuals, dh0s)):
        args.dir[i] = _BwdDir(
            dout[..., D * i:].data_ptr(), out[..., D * i:].data_ptr(),
            h0.data_ptr(), u.data_ptr(), r.data_ptr(), c.data_ptr(),
            ws.data_ptr(), wg.data_ptr(), dproj[..., 3 * D * i:].data_ptr(),
            dproj[..., 3 * D * i + D:].data_ptr(), dh0.data_ptr(), reverse=i)
    if which == "wide":
        packs = [pack_backward(ws, wg) for _, ws, wg in dirs]
        args = _BwdWideArgs(a=args, pack=(ctypes.c_void_p * 2)(
            *[p.data_ptr() for p in packs]))
    _build.check(fn(ctypes.byref(args), ndir, stream), entry)
    return which


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
        backward_route(D)        # the width's backward, before any launch
        out = torch.empty(T, B, D * ndir, dtype=proj.dtype,
                          device=proj.device)
        residuals = [tuple(torch.empty(T, B, D, dtype=proj.dtype,
                                       device=proj.device)
                           for _ in range(3)) for _ in range(ndir)]
        launched = gs.launch(proj, mask, dirs, out, residuals,
                             "gru_scan_train")
        if launched:
            _counter(ndir, launched).count += 1
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
            with torch.cuda.device(out.device):
                launched = launch_backward(
                    dout, out, mask, dirs, residuals, dproj,
                    [dh0 for dh0, _, _ in grads], _build.stream_of(out))
            _counter(ndir, launched).count += 1
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
