"""One fused decode score step: the CUDA kernel's wrapper and its plain
version.

Counterpart of ``attention_lvcsr_tpu/ops/pallas/decode_score.py::
fused_decode_score``: for each utterance and its K hypothesis rows, the
prior's window, the alignment convolution, the energies, the masked
softmax, the weighted average and the readout with log-softmax costs, in
one launch (``csrc/decode_score.cu``).  ``fused_decode_score`` takes the
plain PyTorch version for tensors on the CPU and launches the kernel for
tensors on a CUDA device; any other device raises.

The kernel runs each utterance on a thread-block cluster of 1, 2, 4 or 8
blocks that split the columns of the state projection, the energies, the
weighted average and the merge layer.  :func:`launch_plan` takes the size
whose clusters the card holds in the fewest waves
(``cudaOccupancyMaxActiveClusters``), the larger on a tie, among those
whose layout fits a block's shared memory; :func:`smem_layout` mirrors
that layout.

Semantics of the TPU kernel, which both versions keep:

* the window is taken per utterance over its K rows (the module path of
  ``models/attention.py`` takes it over the whole batch);
* the median is ``max(0, #(cumsum < 0.5) - 1)``, which gives L - 1 for a
  row of zero weights (the module path gives 0); the mean is the weights'
  sum of frame indices;
* the expanding prior reads the step of each utterance's first row;
* the Toeplitz band of the TPU kernel is the filter itself here (a true
  convolution, trimmed 'full' mode), and the cumulative sum a prefix sum.

``tables`` holds ``state_trans`` (S, M), ``handler`` (M,), ``v`` (M,),
``merge_k`` (D, R), ``merge_b`` (R,), ``post_k`` (R, V), ``post_b`` (V,)
and ``conv_filters`` (1, 2n+1): ``SequenceGenerator.fused_score_tables``.
"""
from __future__ import annotations

import ctypes

import torch

from attention_lvcsr_torch import _build
from attention_lvcsr_torch.ops.attention_energy import \
    beam_attention_energies_reference
from attention_lvcsr_torch.ops.expressions import conv1d_full
from attention_lvcsr_torch.ops.gru_scan import choose_cluster

NEG = -1e30
PRIORS = ("expanding", "window_around_median", "window_around_mean")

launches = _build.LaunchCounter()

# csrc/decode_score.cu's constants
ZONE = 10240               # floats: a product's slices' partial sums, at most
CLUSTERS = (8, 4, 2, 1)
MAX_SMEM = 232448          # the opt-in shared memory of a block on sm_90

# table name -> shape in terms of the dimension letters of _launch
_TABLE_SHAPES = {"state_trans": "SM", "handler": "M", "v": "M",
                 "merge_k": "DR", "merge_b": "R", "post_k": "RV",
                 "post_b": "V", "conv_filters": "1T"}


def _check_prior(prior):
    if prior not in PRIORS:
        raise NotImplementedError(
            f"fused_decode_score: prior {prior!r} is not ported "
            f"(supported: {PRIORS})")


def fused_decode_score_reference(pre, attended, att_mask, weights, step,
                                 states, tables, *, beam,
                                 prior="window_around_median", before=100.0,
                                 after=100.0, initial_begin=0.0,
                                 initial_end=1e4, min_speed=0.0,
                                 max_speed=0.0):
    """Plain version.  pre (U, L, M), attended (U, L, D), att_mask (U, L),
    weights (U*K, L), step (U*K,) ints, states (U*K, S) -> costs (U*K, V),
    new weights (U*K, L), windowed energies (U*K, L), weighted averages
    (U*K, D)."""
    _check_prior(prior)
    f32 = torch.float32
    U, L, M = pre.shape
    D = attended.shape[-1]
    K = beam
    t = tables
    taps = t["conv_filters"]
    n = (taps.shape[-1] - 1) // 2
    pos = torch.arange(L, device=pre.device, dtype=f32)
    w = weights.view(U, K, L)
    if prior == "expanding":
        step0 = step.view(U, K)[:, 0].to(f32)
        begin = torch.floor(torch.clamp(
            initial_begin + step0 * min_speed, max=float(L - 1)).clamp(min=0))
        end = torch.ceil(torch.clamp(
            initial_end + step0 * max_speed, max=float(L)).clamp(min=0))
        gmask = ((pos >= begin[:, None]) & (pos < end[:, None])).to(f32)
        additional = torch.ones(U, K, L, device=pre.device)
    else:
        if prior == "window_around_mean":
            expected = (w * pos).sum(dim=2)                       # (U, K)
        else:
            below = (torch.cumsum(w, dim=2) < 0.5).sum(dim=2).to(f32)
            expected = torch.clamp(below - 1.0, min=0.0)
        begins = torch.floor(expected - before)
        ends = torch.ceil(expected + after)
        gb = torch.floor(begins.min(dim=1).values.clamp(min=0.0))
        ge = torch.ceil(ends.max(dim=1).values.clamp(max=float(L)))
        gmask = ((pos >= gb[:, None]) & (pos < ge[:, None])).to(f32)
        additional = ((pos > begins[..., None])
                      & (pos < ends[..., None])).to(f32)
    combined = (gmask[:, None, :] * additional
                * att_mask[:, None, :]).view(U * K, L)
    gmask_rows = gmask.repeat_interleave(K, dim=0)               # (U*K, L)

    conv = conv1d_full(weights * gmask_rows, taps)[:, 0, n:n + L]
    sp = states @ t["state_trans"]
    energies = beam_attention_energies_reference(
        pre, sp, conv, t["handler"], t["v"], 0.0, beam=K)

    masked = torch.where(gmask_rows > 0, energies, NEG)
    mx = masked.max(dim=1, keepdim=True).values
    mx = torch.where(mx > NEG / 2, mx, 0.0)
    unnorm = torch.exp(energies - mx) * combined
    denom = unnorm.sum(dim=1, keepdim=True) + (
        combined.sum(dim=1, keepdim=True) == 0).to(f32)
    wnew = unnorm / denom

    wa = torch.bmm(wnew.view(U, K, L), attended).view(U * K, D)
    act = torch.tanh(wa @ t["merge_k"] + t["merge_b"])
    logits = act @ t["post_k"] + t["post_b"]
    costs = torch.logsumexp(logits, dim=1, keepdim=True) - logits
    return costs, wnew, energies * gmask_rows, wa


def plan(U, active):
    """The cluster size of a launch over U utterances, given how many
    clusters of each size the card holds at once (``active``: {size:
    count}, 0 where the layout does not fit): the fewest waves, then the
    larger size (``gru_scan.choose_cluster``)."""
    return choose_cluster(U, active, "fused_decode_score")


def _round4(x):
    return (x + 3) // 4 * 4


def rows_block(K):
    """Rows a product of the kernel keeps in registers
    (``decode_score.cu::rows_block``)."""
    return 4 if K <= 4 else 8 if K <= 8 else 10 if K <= 10 else \
        16 if K <= 16 else 8


def smem_layout(K, L, M, D, S, R, V, n_taps, cluster):
    """The kernel's shared memory (``decode_score.cu::score_layout``):
    offsets in floats of its buffers, each on a 16-byte boundary, the
    early ones (until the energies) and the late ones sharing memory;
    ``zone``'s floats, ``ZONE`` or what a block's shared memory has left,
    as ``zone_floats``; and ``bytes``."""
    # the widest share of the M and D columns (shares start on
    # multiples of 4)
    mc = 4 * -(-(-(-M // 4)) // cluster)
    dc = 4 * -(-(-(-D // 4)) // cluster)
    lde, ldh, ldsp, ldwa, ldact = (_round4(L), _round4(S), mc | 1, dc,
                                   _round4(R))
    kp = rows_block(K) * -(-K // rows_block(K))   # whole row blocks

    def place(nzone):
        whole = ([("mask", L), ("taps", n_taps), ("hand", M), ("v", M),
                  ("begins", K), ("ends", K)]
                 + ([("pe", K * L)] if cluster > 1 else [])
                 + [("mp", K * R), ("e", K * L), ("zone", nzone)])
        early = [("wx", kp * lde), ("h", kp * ldh), ("conv", K * L),
                 ("sp", K * ldsp)]
        late = [("wt", kp * lde), ("wa", kp * ldwa), ("act", kp * ldact),
                ("costs", K * V)]
        out, at = {}, 0
        for name, n in whole:
            out[name] = at
            at += _round4(n)
        ends = []
        for region in (early, late):
            end = at
            for name, n in region:
                out[name] = end
                end += _round4(n)
            ends.append(end)
        out["pe"] = out.get("pe", out["e"])      # one block: e itself
        out["w"] = out["conv"]                   # until wx is made
        out["zone_floats"] = nzone
        out["bytes"] = 4 * max(ends)
        return out

    rest = place(0)["bytes"] // 4
    return place(max(0, min(ZONE, (MAX_SMEM // 4 - rest) & ~3)))


_smem_limits = {}


def _smem_limit(device):
    """The opt-in shared memory of a block on the device, queried once."""
    if device.index not in _smem_limits:
        props = torch.cuda.get_device_properties(device)
        _smem_limits[device.index] = getattr(
            props, "shared_memory_per_block_optin", MAX_SMEM)
    return _smem_limits[device.index]


def check_fits(K, L, M, D, S, R, V, n_taps, limit=MAX_SMEM):
    """The cluster sizes whose layout fits a block's shared memory; raise
    when none does."""
    sizes = {c: smem_layout(K, L, M, D, S, R, V, n_taps, c)["bytes"]
             for c in CLUSTERS}
    fit = [c for c in CLUSTERS if sizes[c] <= limit]
    if not fit:
        raise NotImplementedError(
            f"fused_decode_score: beam {K} at L={L}, D={D} needs "
            f"{min(sizes.values())} bytes of shared memory per utterance "
            f"(limit {limit})")
    return fit


_active = {}


def active_clusters(shape, device):
    """{cluster size: clusters of the kernel the device holds at once} at
    ``shape`` (K, L, M, D, S, R, V, n_taps), 0 where the layout does not
    fit; raises where none fits.  Queried once per device and shape."""
    key = (device.index, tuple(sorted(shape.items())))
    if key not in _active:
        fit = check_fits(**shape, limit=_smem_limit(device))
        fn = _entry_points()[1]
        active = {}
        with torch.cuda.device(device):
            for size in CLUSTERS:
                count = ctypes.c_int(0)
                if size in fit:
                    args = _Args(U=1, cluster=size, **shape)
                    _build.check(fn(ctypes.byref(args), ctypes.byref(count)),
                                 "decode_score_max_clusters")
                active[size] = count.value
        _active[key] = active
    return _active[key]


def launch_plan(U, shape, device):
    """The cluster size and blocks of a launch over U utterances at
    ``shape`` on the device, and what the device holds at once."""
    active = active_clusters(shape, device)
    cluster = plan(U, active)
    return {"cluster": cluster, "blocks": U * cluster, "active": active}


class _Args(ctypes.Structure):
    """Mirror of ``struct DecodeScoreArgs`` in csrc/decode_score.cu."""
    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "pre", "attended", "att_mask", "weights", "step", "states",
            "conv_taps", "state_trans", "handler", "v", "merge_k", "merge_b",
            "post_k", "post_b", "costs", "wnew", "energies", "wa")]
        + [(name, ctypes.c_int) for name in (
            "U", "L", "M", "D", "S", "R", "V", "K", "n_taps",
            "prior_median")]
        + [(name, ctypes.c_float) for name in (
            "before", "after", "initial_begin", "initial_end", "min_speed",
            "max_speed")]
        + [(name, ctypes.c_int) for name in ("prior_mean", "cluster")])


_entries = None


def _entry_points():
    """The C entry points (the launch, the occupancy query), their ctypes
    signatures set once."""
    global _entries
    if _entries is None:
        lib = _build.load().lib
        launch, count = lib.decode_score_f32, lib.decode_score_max_clusters
        launch.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        count.argtypes = [ctypes.POINTER(_Args), ctypes.POINTER(ctypes.c_int)]
        launch.restype = count.restype = ctypes.c_int
        _entries = launch, count
    return _entries


def _check(name, x, shape, device, dtype=torch.float32):
    if x.dtype != dtype:
        raise TypeError(f"fused_decode_score: {name} must be {dtype}, got "
                        f"{x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"fused_decode_score: {name} has shape "
                         f"{tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"fused_decode_score: {name} must be contiguous")
    if x.device != device:
        raise ValueError(f"fused_decode_score: {name} is on {x.device}, "
                         f"expected {device}")


def _launch(pre, attended, att_mask, weights, step, states, tables, *, beam,
            prior="window_around_median", before=100.0, after=100.0,
            initial_begin=0.0, initial_end=1e4, min_speed=0.0,
            max_speed=0.0):
    _check_prior(prior)
    dev = pre.device
    U, L, M = pre.shape
    K = int(beam)
    dims = {"U": U, "L": L, "M": M, "D": attended.shape[-1], "1": 1,
            "S": tables["state_trans"].shape[0],
            "R": tables["merge_k"].shape[1], "V": tables["post_k"].shape[1],
            "T": tables["conv_filters"].shape[-1]}
    D, S, R, V = dims["D"], dims["S"], dims["R"], dims["V"]
    _check("pre", pre, (U, L, M), dev)
    _check("attended", attended, (U, L, D), dev)
    _check("att_mask", att_mask, (U, L), dev)
    _check("weights", weights, (U * K, L), dev)
    _check("step", step, (U * K,), dev, torch.int32)
    _check("states", states, (U * K, S), dev)
    for name, letters in _TABLE_SHAPES.items():
        _check(name, tables[name], [dims[c] for c in letters], dev)
    costs = torch.empty(U * K, V, dtype=torch.float32, device=dev)
    wnew = torch.empty(U * K, L, dtype=torch.float32, device=dev)
    energies = torch.empty(U * K, L, dtype=torch.float32, device=dev)
    wa = torch.empty(U * K, D, dtype=torch.float32, device=dev)
    if not (U and K):
        return costs, wnew, energies, wa
    shape = dict(K=K, L=L, M=M, D=D, S=S, R=R, V=V, n_taps=dims["T"])
    cluster = launch_plan(U, shape, dev)["cluster"]
    ptr = lambda name: tables[name].data_ptr()
    args = _Args(
        pre=pre.data_ptr(), attended=attended.data_ptr(),
        att_mask=att_mask.data_ptr(), weights=weights.data_ptr(),
        step=step.data_ptr(), states=states.data_ptr(),
        conv_taps=ptr("conv_filters"), state_trans=ptr("state_trans"),
        handler=ptr("handler"), v=ptr("v"), merge_k=ptr("merge_k"),
        merge_b=ptr("merge_b"), post_k=ptr("post_k"), post_b=ptr("post_b"),
        costs=costs.data_ptr(), wnew=wnew.data_ptr(),
        energies=energies.data_ptr(), wa=wa.data_ptr(),
        U=U, L=L, M=M, D=D, S=S, R=R, V=V, K=K, n_taps=dims["T"],
        prior_median=int(prior == "window_around_median"),
        prior_mean=int(prior == "window_around_mean"), before=before,
        after=after, initial_begin=initial_begin, initial_end=initial_end,
        min_speed=min_speed, max_speed=max_speed, cluster=cluster)
    fn = _entry_points()[0]
    with torch.cuda.device(dev):
        status = fn(ctypes.byref(args), _build.stream_of(pre))
    _build.check(status, "decode_score_f32")
    launches.count += 1
    return costs, wnew, energies, wa


def fused_decode_score(pre, attended, att_mask, weights, step, states,
                       tables, **kwargs):
    """One score step; same arguments as the plain version."""
    device = pre.device.type
    if device == "cpu":
        return fused_decode_score_reference(pre, attended, att_mask, weights,
                                            step, states, tables, **kwargs)
    if device == "cuda":
        return _launch(pre, attended, att_mask, weights, step, states,
                       tables, **kwargs)
    raise ValueError(f"fused_decode_score: no kernel for device {pre.device}")
