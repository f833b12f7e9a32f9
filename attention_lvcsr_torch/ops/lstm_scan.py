"""Forward peephole-LSTM scan: the CUDA kernel's wrapper and its plain
version.

Counterpart of ``attention_lvcsr_tpu/ops/pallas/lstm_train.py::lstm_scan``
(the LSTM encoder's inference scan).  ``lstm_scan`` runs one direction,
like the JAX function, or both directions of a bidirectional layer in one
launch, the backward one in reverse time, with the interface of
:func:`attention_lvcsr_torch.ops.gru_scan.gru_scan`.  It takes the plain
PyTorch version for tensors on the CPU and launches ``csrc/lstm_scan.cu``
for tensors on a CUDA device; any other device raises, and so does a width
the kernel does not cover.  There is no fallback from one to the other.

The kernel runs each direction's 16-row groups on thread-block clusters of
16 blocks, or 8 (:func:`launch_plan`), chosen as the GRU forward chooses
them (:func:`~attention_lvcsr_torch.ops.gru_scan.choose_cluster`);
:func:`fwd_layout` mirrors its shared-memory layout
(``csrc/lstm_scan.cu::lstm_layout``).
"""
from __future__ import annotations

import ctypes

import torch

from attention_lvcsr_torch import _build
from attention_lvcsr_torch.ops import gru_scan as gs
from attention_lvcsr_torch.ops.gru_scan import GROUP_ROWS, MAX_SLICES, \
    MAX_SMEM, THREADS, _check

launches = _build.LaunchCounter()

OPERANDS = 5        # csrc/lstm_scan.cu's kOperands: staged per item


def fwd_layout(D, cluster):
    """The forward kernel's layout at width D with ``cluster`` blocks a
    cluster: owned columns ``n``, padded width ``Dp``, the k slices of the
    gate product and the shared memory of a block in bytes."""
    n = gs.owned_columns(D, cluster)
    Dp = cluster * n
    # weights (4 Dp n), the double-buffered state, the stage
    fixed = 4 * Dp * n + 2 * Dp * GROUP_ROWS + OPERANDS * GROUP_ROWS * n
    cap = MAX_SLICES
    while True:
        slices = gs.tile_slices(4 * n, cap)
        total = fixed + slices * GROUP_ROWS * 4 * n
        if total <= MAX_SMEM // 4 or cap == 1:
            break
        cap //= 2
    return {"n": n, "Dp": Dp, "slices": slices, "smem_bytes": 4 * total}


def fits(D, cluster, max_smem=MAX_SMEM):
    """Whether the forward layout covers width D: one item per thread and
    the shared memory."""
    o = fwd_layout(D, cluster)
    return GROUP_ROWS * o["n"] <= THREADS and o["smem_bytes"] <= max_smem


def widest(covers):
    """The widest width D that ``covers(D)`` accepts, with every narrower
    one."""
    D = 1
    while covers(D + 1):
        D += 1
    return D


def max_active_clusters(D, device):
    """{cluster size: clusters of the forward kernel the device holds at
    once} at width D (0 where the layout does not fit)."""
    return gs.query_active_clusters("lstm_scan", D, device)


def launch_plan(D, B, ndir, device):
    """The cluster size a forward launch at width D over B rows and
    ``ndir`` directions takes, the clusters it needs and what the device
    holds."""
    clusters = -(-B // GROUP_ROWS) * ndir
    active = max_active_clusters(D, device)
    return {"cluster": gs.choose_cluster(clusters, active, "lstm_scan"),
            "clusters": clusters, "active": active}


def _scan_reference(x_proj, mask, h0, c0, w_state, pci, pcf, pco, reverse):
    """One direction: x_proj (T, B, 4D) -> states, cells (T, B, D).
    ``reverse`` visits t = T-1 .. 0 (the JAX package's backward direction:
    flip inputs and mask, scan, flip the outputs back).  A masked step
    keeps h and c, by selection."""
    T, B, D4 = x_proj.shape
    D = D4 // 4
    h, c = h0, c0
    hs, cs = [None] * T, [None] * T
    for t in (reversed(range(T)) if reverse else range(T)):
        acts = h @ w_state + x_proj[t]
        i = torch.sigmoid(acts[:, :D] + c * pci)
        f = torch.sigmoid(acts[:, D:2 * D] + c * pcf)
        z = torch.tanh(acts[:, 2 * D:3 * D])
        new_c = f * c + i * z
        o = torch.sigmoid(acts[:, 3 * D:] + new_c * pco)
        new_h = o * torch.tanh(new_c)
        if mask is not None:
            keep = (mask[t] != 0)[:, None]
            new_h = torch.where(keep, new_h, h)
            new_c = torch.where(keep, new_c, c)
        hs[t], cs[t] = new_h, new_c
        h, c = new_h, new_c
    if not T:
        empty = x_proj.new_zeros(0, B, D)
        return empty, empty
    return torch.stack(hs), torch.stack(cs)


def lstm_scan_reference(proj, mask, fwd, bwd=None):
    """Plain version of :func:`lstm_scan`, same arguments."""
    D = fwd[0].shape[1]
    states, cells = _scan_reference(proj[..., :4 * D], mask, *fwd,
                                    reverse=False)
    if bwd is None:
        return states, cells
    states_b, cells_b = _scan_reference(proj[..., 4 * D:], mask, *bwd,
                                        reverse=True)
    return (torch.cat([states, states_b], dim=-1),
            torch.cat([cells, cells_b], dim=-1))


class _Dir(ctypes.Structure):
    """Mirror of ``struct LstmDir`` in csrc/lstm_scan.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "x", "h0", "c0", "w_state", "pci", "pcf", "pco", "hs", "cs", "gi",
        "gf", "gz", "go")] + [("reverse", ctypes.c_int)])


class _Args(ctypes.Structure):
    """Mirror of ``struct LstmArgs`` in csrc/lstm_scan.cu."""
    _fields_ = ([("dir", _Dir * 2), ("mask", ctypes.c_void_p)]
                + [(n, ctypes.c_int) for n in ("T", "B", "D", "ldx", "ldo")])


def lstm_scan(proj, mask, fwd, bwd=None):
    """Peephole-LSTM recurrence over time, one direction or both.

    ``proj`` (T, B, 4D) holds the input projections of the four gates (in,
    forget, cell, out) of the forward direction; with ``bwd`` it is (T, B,
    8D) = [forward | backward].  ``mask`` (T, B) or None; a masked step
    keeps the state and the cell.  ``fwd`` and ``bwd`` are (h0 (B, D), c0
    (B, D), w_state (D, 4D), pci, pcf, pco (D,)).  Returns the states and
    the cells, each (T, B, D), or (T, B, 2D) = [forward | backward] with
    the backward direction run in reverse time."""
    device = proj.device
    if device.type == "cpu":
        return lstm_scan_reference(proj, mask, fwd, bwd)
    if device.type != "cuda":
        raise ValueError(f"lstm_scan: no kernel for device {device}")
    dirs = (fwd,) if bwd is None else (fwd, bwd)
    T, B, _ = proj.shape
    D = fwd[0].shape[1]
    states = torch.empty(T, B, D * len(dirs), dtype=proj.dtype, device=device)
    cells = torch.empty_like(states)
    if launch(proj, mask, dirs, states, cells):
        launches.count += 1
    return states, cells


def check_operands(name, proj, mask, dirs):
    """Device, type, shape and contiguity of a scan's operands."""
    device = proj.device
    T, B, _ = proj.shape
    D = dirs[0][0].shape[1]
    _check(f"{name}: proj", proj, (T, B, 4 * D * len(dirs)), device)
    if mask is not None:
        _check(f"{name}: mask", mask, (T, B), device)
    for side, (h0, c0, ws, pci, pcf, pco) in zip(("fwd", "bwd"), dirs):
        _check(f"{name}: {side} h0", h0, (B, D), device)
        _check(f"{name}: {side} c0", c0, (B, D), device)
        _check(f"{name}: {side} w_state", ws, (D, 4 * D), device)
        for pname, p in (("pci", pci), ("pcf", pcf), ("pco", pco)):
            _check(f"{name}: {side} {pname}", p, (D,), device)


def require_width(lib, query, name, D, covers):
    """Raise NotImplementedError naming ``name``, the width and the widest
    width covered when ``lib.<query>(D)`` says the kernel does not cover D
    on the current device (``covers``: the layout mirror's test of a width
    in an H100's 227 KB of shared memory a block)."""
    fn = getattr(lib, query)
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    status = fn(D)
    _build.check(max(0, -status), query)
    if status == 0:
        raise NotImplementedError(
            f"{name}: width D={D} is not ported yet (the kernel keeps each "
            f"direction's recurrent weights, sliced over a 16-block "
            f"cluster, and its exchange buffers in the blocks' shared "
            f"memory, which holds them up to D={widest(covers)})")


def launch(proj, mask, dirs, states, cells, residuals=None,
           name="lstm_scan"):
    """Check the operands (errors name ``name``) and launch
    ``csrc/lstm_scan.cu`` into ``states`` and ``cells``; ``residuals``: per
    direction (in, forget, cell, out) gate tensors (T, B, D) to fill, as
    the training forward does.  Returns False when there is nothing to
    run."""
    check_operands(name, proj, mask, dirs)
    T, B, width = proj.shape
    D = dirs[0][0].shape[1]
    if not (T and B):
        return False
    lib = _build.load().lib
    lib.lstm_scan_f32.argtypes = [ctypes.POINTER(_Args), ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p]
    lib.lstm_scan_f32.restype = ctypes.c_int
    with torch.cuda.device(proj.device):
        require_width(lib, "lstm_scan_supported", name, D,
                      lambda w: fits(w, 16))
        cluster = launch_plan(D, B, len(dirs), proj.device)["cluster"]
        args = _Args(mask=mask.data_ptr() if mask is not None else None,
                     T=T, B=B, D=D, ldx=width, ldo=states.shape[-1])
        for i, weights in enumerate(dirs):
            gates = [g.data_ptr() for g in residuals[i]] \
                if residuals is not None else [None] * 4
            args.dir[i] = _Dir(proj[..., 4 * D * i:].data_ptr(),
                               *(w.data_ptr() for w in weights),
                               states[..., D * i:].data_ptr(),
                               cells[..., D * i:].data_ptr(), *gates,
                               reverse=i)
        status = lib.lstm_scan_f32(ctypes.byref(args), len(dirs), cluster,
                                   _build.stream_of(proj))
    _build.check(status, "lstm_scan_f32")
    return True
