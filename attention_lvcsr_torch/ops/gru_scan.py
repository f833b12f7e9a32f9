"""Forward GRU scan: the CUDA kernel's wrapper and its plain version.

Counterpart of ``attention_lvcsr_tpu/ops/pallas/gru_scan.py::gru_scan``.
``gru_scan`` runs one direction, like the JAX function, or both
directions of a bidirectional layer in one launch, the backward one in
reverse time.  It takes the plain PyTorch version for tensors on the CPU
and launches ``csrc/gru_scan.cu`` for tensors on a CUDA device; any
other device raises, and so does a width the kernel does not cover.
There is no fallback from one to the other.

The kernel runs each direction's 16-row groups on thread-block clusters of
16 blocks, or 8 (:func:`choose_cluster`): the size whose clusters the card
holds in the fewest waves, by ``cudaOccupancyMaxActiveClusters``; 16 on a
tie.  :func:`fwd_layout` mirrors the kernel's shared-memory layout
(``csrc/gru_pull.cuh::fwd_layout``).

The width picks one of two instances before any launch (:func:`route`):
the resident one keeps each block's recurrent weight slice in shared
memory (D <= 448), the wide one (``gru_wide_kernel``, D up to 1024)
keeps the slice's leading tiles there and streams the rest from L2 every
step through a TMA ring, packed per block by :func:`pack_forward`;
:func:`wide_layout` mirrors its layout (``csrc/gru_wide.cuh``).  Wider
layers raise ``NotImplementedError``.
"""
from __future__ import annotations

import ctypes

import torch

from attention_lvcsr_torch import _build

launches = _build.LaunchCounter()        # the resident instance
launches_wide = _build.LaunchCounter()   # the wide instance

# csrc/gru_pull.cuh's constants
GROUP_ROWS, THREADS, TILE_ROWS, TILE_COLS, MAX_SLICES = 16, 512, 8, 2, 8
MAX_SMEM = 232448          # the opt-in shared memory of a block on sm_90
CLUSTERS = (16, 8)
# csrc/gru_wide.cuh's constants
WIDE_MAX_D, WIDE_MAX_8 = 1024, 992
RING_FLOATS, RING_MIN_TILES, RING_MAX_TILES = 2048, 4, 6
RING_CHUNK, RING_BAR_FLOATS = 2, 64


def owned_columns(D, cluster):
    """The state columns a block of a ``cluster``-block cluster owns at
    width D (``gru_pull.cuh::owned_columns``)."""
    return ((D + cluster - 1) // cluster + 1) // 2 * 2


def tile_slices(cols, cap):
    """The k slices of a product of ``cols`` columns, at most ``cap``
    (``gru_pull.cuh::tile_slices``)."""
    tiles = (GROUP_ROWS // TILE_ROWS) * (cols // TILE_COLS)
    return max(1, min(cap, THREADS // tiles))


def fwd_layout(D, cluster):
    """The forward kernel's layout at width D with ``cluster`` blocks a
    cluster: owned columns ``n``, padded width ``Dp``, the k slices of the
    gate and candidate products and the shared memory of a block in
    bytes."""
    n = owned_columns(D, cluster)
    Dp = cluster * n
    # weights (3 Dp n), state and r * state, update gates, stage
    fixed = 3 * Dp * n + 2 * Dp * GROUP_ROWS + 5 * GROUP_ROWS * n
    cap = MAX_SLICES
    while True:
        sg, sc = tile_slices(2 * n, cap), tile_slices(n, cap)
        total = fixed + max(2 * sg, sc) * GROUP_ROWS * n
        if total <= MAX_SMEM // 4 or cap == 1:
            break
        cap //= 2
    return {"n": n, "Dp": Dp, "slices_g": sg, "slices_c": sc,
            "smem_bytes": 4 * total}


def fits(D, cluster, max_smem=MAX_SMEM):
    """Whether the layout covers width D: one candidate item per thread,
    two gate items, and the shared memory."""
    o = fwd_layout(D, cluster)
    return GROUP_ROWS * o["n"] <= THREADS and o["smem_bytes"] <= max_smem


def ring_rows(cols, slices):
    """The k rows of a ring tile of a ``cols``-column product over
    ``slices`` k slices (``gru_wide.cuh::ring_rows``)."""
    per = max(1, RING_FLOATS // (cols * slices))
    if cols % 4 and per * slices % 2:
        per = per - 1 if per > 1 else 2
    return per * slices


def wide_gate_items(cluster):
    """Gate items a thread of the wide instance finishes; half as many
    candidate items (``gru_wide.cuh::wide_gate_items``)."""
    return GROUP_ROWS * 2 * (WIDE_MAX_D // cluster) // THREADS


def resident_tiles(room, t0, f0, t1, f1):
    """The tiles of a step's two products (t0 and t1 tiles of f0 and f1
    floats) resident in ``room`` floats: one at a time to the product whose
    resident share is the smaller, the first on a tie, while it fits
    (``gru_wide.cuh::resident_tiles``)."""
    r0 = r1 = 0
    while True:
        first = r1 == t1 or (r0 < t0 and r0 * t1 <= r1 * t0)
        if (r0 == t0) if first else (r1 == t1):
            return r0, r1
        f = f0 if first else f1
        if f > room:
            return r0, r1
        room -= f
        if first:
            r0 += 1
        else:
            r1 += 1


def ring_layout(end, K0, c0, kt0, K1, c1, kt1):
    """The weight ring's part of a wide layout after ``end`` floats of
    other buffers (``gru_wide.cuh::ring_layout``): the stream, mbarriers
    (``bar``), ``slots`` ring slots of RING_CHUNK tiles (``ring``), then
    the leading ``res0``
    tiles of product 0 (K0 rows of c0 floats, tiles of kt0 rows) at
    ``res`` and ``res1`` of product 1 at ``res2``; offsets in floats,
    ``total`` the end."""
    bar = end
    ring = bar + RING_BAR_FLOATS
    slots = min(RING_MAX_TILES * RING_FLOATS, MAX_SMEM // 4 - ring) \
        // (RING_CHUNK * RING_FLOATS)
    res = ring + max(slots, 0) * RING_CHUNK * RING_FLOATS
    r0, r1 = resident_tiles(MAX_SMEM // 4 - res, -(-K0 // kt0), kt0 * c0,
                            -(-K1 // kt1), kt1 * c1)
    res2 = res + min(r0 * kt0, K0) * c0
    total = res2 + min(r1 * kt1, K1) * c1
    return {"slots": slots, "res0": r0, "res1": r1, "bar": bar,
            "ring": ring, "res": res, "res2": res2, "total": total}


def ring_stream(K0, kt0, r0, K1, kt1, r1):
    """The chunks a wide kernel's weight ring copies a step, in order
    (``gru_wide.cuh::WeightRing::issue``): (product, first tile, tiles),
    up to RING_CHUNK tiles of product 0 (K0 rows in tiles of kt0, the
    first r0 resident), then of product 1."""
    chunks = []
    for which, (K, kt, r) in enumerate(((K0, kt0, r0), (K1, kt1, r1))):
        tiles = -(-K // kt)
        chunks += [(which, t0, min(RING_CHUNK, tiles - t0))
                   for t0 in range(r, tiles, RING_CHUNK)]
    return chunks


def wide_layout(D, cluster):
    """The wide instance's layout at width D with ``cluster`` blocks a
    cluster (``gru_wide.cuh::wide_layout``): owned columns ``n``, padded
    width ``Dp``, the products' k slices and tiles (k rows), the weight
    ring (:func:`ring_layout`, the gate product 0 and the candidate
    product 1, under ``"ring"``), the other buffers' offsets in floats
    (``"offsets"``) and the shared memory of a block in bytes."""
    n = owned_columns(D, cluster)
    Dp = cluster * n
    sg, sc = tile_slices(2 * n, MAX_SLICES), tile_slices(n, MAX_SLICES)
    kt_g, kt_c = ring_rows(2 * n, sg), ring_rows(n, sc)
    # state and r * state, update gates, stage (two steps' masks a row),
    # partial sums, the ring
    end = (2 * Dp * GROUP_ROWS + 4 * GROUP_ROWS * n + 2 * GROUP_ROWS
           + max(2 * sg, sc) * GROUP_ROWS * n)
    ring = ring_layout(end, Dp, 2 * n, kt_g, Dp, n, kt_c)
    h = 0
    rh = h + Dp * GROUP_ROWS
    z = rh + Dp * GROUP_ROWS
    stage = z + GROUP_ROWS * n
    part = stage + 3 * GROUP_ROWS * n + 2 * GROUP_ROWS
    return {"n": n, "Dp": Dp, "slices_g": sg, "slices_c": sc,
            "kt_g": kt_g, "kt_c": kt_c, "ring": ring,
            "offsets": {"h": h, "rh": rh, "z": z, "stage": stage,
                        "part": part},
            "smem_bytes": 4 * ring["total"]}


def wide_fits(D, cluster, max_smem=MAX_SMEM):
    """Whether the wide layout covers width D: D <= WIDE_MAX_D (WIDE_MAX_8
    on 8 blocks), an item for every thread's share, and the shared memory
    with a ring of at least RING_MIN_TILES tiles."""
    if cluster not in CLUSTERS or not 1 <= D <= (
            WIDE_MAX_8 if cluster == 8 else WIDE_MAX_D):
        return False
    o = wide_layout(D, cluster)
    return (GROUP_ROWS * 2 * o["n"] <= wide_gate_items(cluster) * THREADS
            and o["ring"]["slots"] * RING_CHUNK >= RING_MIN_TILES
            and o["smem_bytes"] <= max_smem)


def route(D, name="gru_scan"):
    """The instance that runs width D: "resident" where the weights fit
    the shared memory of 16-block clusters (D <= 448), "wide" up to
    WIDE_MAX_D; wider raises (errors name ``name``)."""
    if fits(D, 16):
        return "resident"
    if wide_fits(D, 16):
        return "wide"
    raise NotImplementedError(
        f"{name}: width D={D} is not ported yet (the kernels cover D up to "
        f"{WIDE_MAX_D}: up to 448 with each direction's recurrent weights "
        f"in one 16-block cluster's shared memory, above that streamed "
        f"from L2)")


def kernel_name(D):
    """The C prefix of the instance that runs width D."""
    return "gru_scan" if route(D) == "resident" else "gru_scan_wide"


def pack_forward(w_state, w_gates, cluster):
    """The wide instance's weights of one direction, packed per block of
    a ``cluster``-block cluster (``struct GruWideArgs``): (cluster, 3 Dp
    n), block j's owned [update | reset] gate columns (Dp, 2n) then its
    owned candidate columns (Dp, n), k-major, zero past D."""
    D = w_state.shape[0]
    o = wide_layout(D, cluster)
    n, Dp = o["n"], o["Dp"]
    pad = Dp - D
    gates = torch.nn.functional.pad(w_gates.view(D, 2, D), (0, pad, 0, 0,
                                                            0, pad))
    gates = gates.view(Dp, 2, cluster, n).permute(2, 0, 1, 3)
    state = torch.nn.functional.pad(w_state, (0, pad, 0, pad))
    state = state.view(Dp, cluster, n).permute(1, 0, 2)
    return torch.cat([gates.reshape(cluster, Dp * 2 * n),
                      state.reshape(cluster, Dp * n)], dim=1).contiguous()


def choose_cluster(clusters, active, name="gru_scan"):
    """The cluster size for a launch of ``clusters`` clusters, given how
    many clusters of each size the card holds at once (``active``: {size:
    count}, 0 where the layout does not fit): the fewest waves, then the
    larger size."""
    waves = {size: -(-clusters // count)
             for size, count in active.items() if count > 0}
    if not waves:
        raise NotImplementedError(f"{name}: no cluster size fits")
    return min(waves, key=lambda size: (waves[size], -size))


_active = {}


def query_active_clusters(kernel, D, device):
    """{cluster size: clusters the device holds at once} of the kernel
    whose C entry points are ``<kernel>_fits`` and
    ``<kernel>_max_clusters``, at width D (0 where the layout does not
    fit), queried once per kernel, device and width."""
    key = (kernel, device.index, D)
    if key not in _active:
        lib = _build.load().lib
        fits_fn = getattr(lib, f"{kernel}_fits")
        fits_fn.argtypes = [ctypes.c_int, ctypes.c_int]
        fits_fn.restype = ctypes.c_int
        count_fn = getattr(lib, f"{kernel}_max_clusters")
        count_fn.argtypes = [ctypes.c_int, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_int)]
        count_fn.restype = ctypes.c_int
        active = {}
        with torch.cuda.device(device):
            for size in CLUSTERS:
                fit = fits_fn(D, size)
                _build.check(max(0, -fit), f"{kernel}_fits")
                count = ctypes.c_int(0)
                if fit:
                    _build.check(count_fn(D, size, ctypes.byref(count)),
                                 f"{kernel}_max_clusters")
                active[size] = count.value
        _active[key] = active
    return _active[key]


def max_active_clusters(D, device):
    """{cluster size: clusters of the instance that runs width D the
    device holds at once} (:func:`query_active_clusters`)."""
    return query_active_clusters(kernel_name(D), D, device)


def launch_plan(D, B, ndir, device):
    """The cluster size a launch at width D over B rows and ``ndir``
    directions takes, the clusters it needs and what the device holds."""
    clusters = -(-B // GROUP_ROWS) * ndir
    active = max_active_clusters(D, device)
    return {"cluster": choose_cluster(clusters, active),
            "clusters": clusters, "active": active}


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
        "x", "g", "h0", "w_state", "w_gates", "out", "u", "r", "c")]
        + [("reverse", ctypes.c_int)])


class _Args(ctypes.Structure):
    """Mirror of ``struct GruArgs`` in csrc/gru_scan.cu."""
    _fields_ = ([("dir", _Dir * 2), ("mask", ctypes.c_void_p)]
                + [(n, ctypes.c_int) for n in (
                    "T", "B", "D", "ldx", "ldg", "ldo")])


class _WideArgs(ctypes.Structure):
    """Mirror of ``struct GruWideArgs`` in csrc/gru_scan.cu."""
    _fields_ = [("a", _Args), ("pack", ctypes.c_void_p * 2)]


def _check(name, t, shape, device):
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


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
    T, B, _ = proj.shape
    out = torch.empty(T, B, fwd[1].shape[0] * len(dirs), dtype=proj.dtype,
                      device=device)
    launched = launch(proj, mask, dirs, out)
    if launched:
        (launches_wide if launched == "wide" else launches).count += 1
    return out


def check_operands(name, proj, mask, dirs):
    """Device, type, shape and contiguity of a scan's operands."""
    device = proj.device
    T, B, _ = proj.shape
    D = dirs[0][1].shape[0]
    _check(f"{name}: proj", proj, (T, B, 3 * D * len(dirs)), device)
    if mask is not None:
        _check(f"{name}: mask", mask, (T, B), device)
    for side, (h0, ws, wg) in zip(("fwd", "bwd"), dirs):
        _check(f"{name}: {side} h0", h0, (B, D), device)
        _check(f"{name}: {side} w_state", ws, (D, D), device)
        _check(f"{name}: {side} w_gates", wg, (D, 2 * D), device)


def launch(proj, mask, dirs, out, residuals=None, name="gru_scan"):
    """Check the operands (errors name ``name``) and launch
    ``csrc/gru_scan.cu``'s instance for the width (:func:`route`) into
    ``out``; ``residuals``: per direction (update, reset, candidate)
    tensors (T, B, D) to fill, as the training forward does.  Returns the
    route launched, or None when there is nothing to run."""
    check_operands(name, proj, mask, dirs)
    device = proj.device
    T, B, width = proj.shape
    D = dirs[0][1].shape[0]
    which = route(D, name)
    if not (T and B):
        return None
    entry = f"{kernel_name(D)}_f32"
    fn = getattr(_build.load().lib, entry)
    fn.argtypes = [ctypes.POINTER(_Args if which == "resident"
                                  else _WideArgs),
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    args = _Args(mask=mask.data_ptr() if mask is not None else None,
                 T=T, B=B, D=D, ldx=width, ldg=width, ldo=out.shape[-1])
    for i, (h0, ws, wg) in enumerate(dirs):
        u, r, c = (t.data_ptr() for t in residuals[i]) \
            if residuals is not None else (None, None, None)
        args.dir[i] = _Dir(proj[..., 3 * D * i:].data_ptr(),
                           proj[..., 3 * D * i + D:].data_ptr(),
                           h0.data_ptr(), ws.data_ptr(), wg.data_ptr(),
                           out[..., D * i:].data_ptr(), u, r, c, reverse=i)
    with torch.cuda.device(device):
        cluster = launch_plan(D, B, len(dirs), device)["cluster"]
        if which == "wide":
            # freed when this returns: the caching allocator hands their
            # memory only to work queued after the kernel on this stream
            packs = [pack_forward(ws, wg, cluster) for _, ws, wg in dirs]
            args = _WideArgs(a=args, pack=(ctypes.c_void_p * 2)(
                *[p.data_ptr() for p in packs]))
        status = fn(ctypes.byref(args), len(dirs), cluster,
                    _build.stream_of(proj))
    _build.check(status, entry)
    return which
