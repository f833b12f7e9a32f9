"""Differentiable teacher-forced attention-decoder scan: the CUDA kernels'
wrapper and its plain version.

Counterpart of ``attention_lvcsr_tpu/ops/pallas/decoder_train.py::
decoder_scan_train`` (:839): the whole label-time loop of
``SequenceGenerator.evaluate`` (windowed prior, Toeplitz convolution of
the previous weights, match / tanh / energies, normalizer, weighted
average and the GRU transition), same arguments and outputs.

* :func:`decoder_scan_train_reference`, the plain version, covers what the
  TPU kernel covers: content-only attention (``n_filters=0``), 1-16 conv
  filters, the softmax, logistic and relu normalizers, the expanding,
  ``window_around_mean`` and ``window_around_median`` priors and stacked
  GRU decoders (``dec_stack`` up to 4).  Autograd takes its gradient.
* On a CUDA tensor :func:`decoder_scan_train` is a
  ``torch.autograd.Function`` over ``csrc/decoder_train.cu`` for conv
  attention (1-16 filters, the softmax, logistic or relu normalizer, the
  expanding, median or mean prior, one GRU layer; logistic and relu with
  the energy bias ``e_bias``, which gets its gradient; with more than one
  filter and softmax also two to four GRU layers, ``dec_stack``, whose
  interlayer tables ``inter_in`` and ``inter_gate`` get their gradients)
  and for
  content-only attention (``n_filters=0``: no
  convolution and no handler term, so the previous weights do not feed
  the energies, and the Toeplitz band and handler get no gradient): a
  forward kernel, then a reverse-time backward kernel
  that recomputes each step's (B, L, M) match tensor from the previous
  state and weights instead of storing it, then ``csrc/outer_sum.cu`` for
  the weight gradients and for datt, one job a batch row (its two kernels
  a call count on ``outer_sum.launches``); with F filters the backward
  writes dconv (T, B, F, L), from which the Toeplitz bands' gradient (L,
  F * L) is one job, and the handler's (F, M) a job over the blocks'
  partials.  Other variants raise ``NotImplementedError`` naming the
  variant.
* Each kernel runs the launch plan of :func:`plan`, which mirrors the
  kernels' own: thread-block clusters of 4, 8 or 16 blocks over as many
  clusters as the card holds at once, the rows spread over them, block j
  of a cluster owning a frame tile of the attention and a column slice of
  every product (the weights packed per block by :func:`pack_forward` and
  :func:`pack_backward`), and the tiles that stay in shared memory
  (:func:`layout`).  A shape no plan covers raises ``NotImplementedError``
  naming it.

The window of the ``window_around_*`` priors spans the whole batch: its
bounds are the min / max of every row's bounds, as in the JAX package's
XLA scan and in its TPU kernel whenever the kernel's batch block is the
batch.  The CUDA forward records each step's bounds and the backward reads
them, so the gradient is the exact gradient of the forward.  The median of
a row is ``max(0, below - 1)`` with ``below`` the number of frames whose
running sum stays under 0.5 (the TPU kernel's rule).  Masked steps keep the
previous values by selection, not arithmetic, so a NaN of a masked row
does not leak.
"""
from __future__ import annotations

import ctypes

import torch

from attention_lvcsr_torch import _build
# the normalizers in the order of the kernels' ``normalizer`` field, the
# priors and the most conv filters the kernels take
from attention_lvcsr_torch.ops.beam_loop import (MAX_FILTERS, MAX_STACK,
                                                 NORMALIZERS, PRIORS)
from attention_lvcsr_torch.ops.outer_sum import MAX_JOBS, outer_sum

NEG = -1e30
launches = _build.LaunchCounter()   # forward + backward; outer_sum has its own


def toeplitz_band(filters, length):
    """(L, L) band with ``T[i, l] = filter[n + l - i]`` inside it, zero
    outside: ``weights @ T`` is the reference's trimmed full convolution.
    Differentiable in the taps (``decode_score.py::toeplitz_band`` :149)."""
    taps = filters.reshape(-1)
    n = (taps.shape[0] - 1) // 2
    pos = torch.arange(length, device=taps.device)
    offset = pos[None, :] - pos[:, None] + n
    inside = (offset >= 0) & (offset < taps.shape[0])
    return torch.where(inside, taps[offset.clamp(0, taps.shape[0] - 1)],
                       taps.new_zeros(()))


def prior_config(prior):
    p = dict(prior)
    return dict(
        prior=p.get("type", "expanding"),
        before=float(p.get("before", 0.0)), after=float(p.get("after", 0.0)),
        initial_begin=float(p.get("initial_begin", 0.0)),
        initial_end=float(p.get("initial_end", 1e4)),
        min_speed=float(p.get("min_speed", 0.0)),
        max_speed=float(p.get("max_speed", 0.0)))


def step_zero(mask):
    """The expanding prior's step counter: the number of unmasked steps
    row 0 has seen before each step (int32, (T,))."""
    c = torch.cumsum(mask[:, 0], dim=0)
    return torch.cat([c.new_zeros(1), c[:-1]]).to(torch.int32)


def _window(w, step0, amask, cfg):
    """(global mask (1, L), combined (B, L), bounds (2,)) of one step."""
    B, L = w.shape
    f32 = torch.float32
    pos = torch.arange(L, device=w.device, dtype=f32)
    if cfg["prior"] == "expanding":
        s = step0.to(f32)
        begin = torch.floor(torch.clamp(
            cfg["initial_begin"] + s * cfg["min_speed"], 0.0, L - 1.0))
        end = torch.ceil(torch.clamp(
            cfg["initial_end"] + s * cfg["max_speed"], 0.0, float(L)))
        gmask = ((pos >= begin) & (pos < end)).to(f32)[None]
        return gmask, gmask * amask, torch.stack([begin, end])
    if cfg["prior"] == "window_around_mean":
        expected = (w * pos).sum(dim=1)
    elif cfg["prior"] == "window_around_median":
        below = (torch.cumsum(w, dim=1) < 0.5).sum(dim=1).to(f32)
        expected = torch.clamp(below - 1.0, min=0.0)
    else:
        raise ValueError(f"unknown prior {cfg['prior']!r}")
    begins = torch.floor(expected - cfg["before"])
    ends = torch.ceil(expected + cfg["after"])
    gb = torch.floor(torch.clamp(begins.min(), min=0.0))
    ge = torch.ceil(torch.clamp(ends.max(), max=float(L)))
    gmask = ((pos >= gb) & (pos < ge)).to(f32)[None]
    additional = ((pos > begins[:, None]) & (pos < ends[:, None])).to(f32)
    return gmask, gmask * additional * amask, torch.stack([gb, ge])


def _attend(h, w, pre, att, amask, toep, st, hand, v, e_b, step0, cfg):
    """One attention step: (wnew, wa_new, energies, gmask)."""
    L = att.shape[1]
    with torch.no_grad():
        gmask, combined, _ = _window(w.detach(), step0, amask, cfg)
    sp = h @ st
    match = pre + sp[:, None, :]
    if cfg["n_filters"]:
        conv = (w * gmask) @ toep                       # (B, Fh * L)
        for f in range(cfg["n_filters"]):
            match = match + conv[:, f * L:(f + 1) * L, None] * hand[f]
    match = torch.tanh(match)
    energies = (match * v).sum(dim=2) + e_b
    if cfg["normalizer"] == "softmax":
        masked = torch.where(gmask > 0, energies, NEG)
        mx = masked.max(dim=1, keepdim=True).values
        mx = torch.where(mx > NEG / 2, mx, 0.0)
        unnorm = torch.exp(energies - mx) * combined
    elif cfg["normalizer"] == "logistic":
        unnorm = torch.sigmoid(energies) * combined
    elif cfg["normalizer"] == "relu":
        unnorm = torch.clamp(energies / 1000.0, min=0.0) * combined
    else:
        raise ValueError(f"unknown normalizer {cfg['normalizer']!r}")
    denom = unnorm.sum(dim=1, keepdim=True) + (
        combined.sum(dim=1, keepdim=True) == 0).to(energies.dtype)
    wnew = unnorm / denom
    wa_new = torch.bmm(wnew[:, None, :], att)[:, 0]
    return wnew, wa_new, energies, gmask


def decoder_scan_train_reference(fx, fg, mask, pre, attended, att_mask, h0,
                                 w0, wa0, toep, st, hand, v, wss, wsg, dxm,
                                 dgm, *, prior, e_bias=None,
                                 normalizer="softmax", n_filters=1,
                                 dec_stack=1, inter_in=None,
                                 inter_gate=None):
    """Plain version of :func:`decoder_scan_train`, same arguments."""
    T, B, NS = fx.shape
    N = int(dec_stack)
    S = NS // N
    if mask is None:
        mask = fx.new_ones(T, B)
    e_b = e_bias.reshape(()) if e_bias is not None else fx.new_zeros(())
    hand = hand.reshape(-1, hand.shape[-1])
    cfg = dict(prior_config(prior), normalizer=normalizer,
               n_filters=int(n_filters))
    step0 = step_zero(mask)
    h, w, wa = h0, w0, wa0
    e_keep = fx.new_zeros(B, pre.shape[1])
    outs = []
    for t in range(T):
        wnew, wa_new, energies, gmask = _attend(
            h, w, pre, attended, att_mask, toep, st, hand, v, e_b, step0[t],
            cfg)
        parts, below = [], None
        for ly in range(N):
            s1, s2 = slice(ly * S, (ly + 1) * S), slice(ly * 2 * S,
                                                        (ly + 1) * 2 * S)
            h_ly = h[:, s1]
            g_in = fg[t][:, s2] + wa_new @ dgm[:, s2]
            x_in = fx[t][:, s1] + wa_new @ dxm[:, s1]
            if ly > 0:
                g_in = g_in + below @ inter_gate[:, (ly - 1) * 2 * S:
                                                 ly * 2 * S]
                x_in = x_in + below @ inter_in[:, (ly - 1) * S:ly * S]
            gates = torch.sigmoid(h_ly @ wsg[:, s2] + g_in)
            u, r = gates[:, :S], gates[:, S:]
            cand = torch.tanh((h_ly * r) @ wss[:, s1] + x_in)
            below = u * cand + (1.0 - u) * h_ly
            parts.append(below)
        h_new = parts[0] if N == 1 else torch.cat(parts, dim=1)
        m = (mask[t] > 0.5)[:, None]
        h = torch.where(m, h_new, h)
        w = torch.where(m, wnew, w)
        wa = torch.where(m, wa_new, wa)
        e_keep = torch.where(m, energies * gmask, e_keep)
        outs.append((h, w, wa, e_keep))
    return tuple(torch.stack(seq) for seq in zip(*outs))


# --------------------------------------------------------------------------
# the CUDA route: the launch plan (a mirror of csrc/decoder_train.cu's)
# --------------------------------------------------------------------------

# csrc/decoder_train.cu's constants
THREADS, WARPS, MAX_ROWS, ROW_CHUNK, MAX_SLICES = 512, 16, 16, 8, 32
MAX_SMEM = 232448          # the opt-in shared memory of a block on sm_90
CLUSTERS = (16, 8, 4)
KINDS = ("forward", "backward")
# the tiles a kind keeps on chip where they fit, in the order they are kept
TILES = {"forward": ("att", "pre"), "backward": ("dpre", "att", "pre")}
# the cost of a cluster's row apart from its share of the block's work
# (the plan's score: R / C + R * ROW_COST), fitted to the kernels' times at
# B=1, 32 and 64 with C = 4, 8 and 16 on an H100 (PERF.md section 6)
ROW_COST = 1 / 8


def _cdiv(a, b):
    return -(-a // b)


def _up4(n):
    return _cdiv(n, 4) * 4


def dims(C, R, L, M, D, S):
    """A plan's slices: block j of a ``C``-block cluster owns frames
    ``[j*Lt, (j+1)*Lt)`` (``Lq`` padded to four) and columns ``[j*Xc,
    (j+1)*Xc)`` of the S, M and D wide products (multiples of four; ``Xp =
    C * Xc``); ``R`` rows a cluster at most."""
    Lt = _cdiv(L, C)
    Sc, Mc, Dc = (_up4(_cdiv(n, C)) for n in (S, M, D))
    Mch = _cdiv(M, 32)
    return dict(C=C, R=R, Lt=Lt, Lq=_up4(Lt), L4=_up4(L), Sc=Sc, Sp=C * Sc,
                Mc=Mc, Mp=C * Mc, Dc=Dc, Dp=C * Dc, M4=_up4(M), Mt=M | 1,
                Mch=Mch, groups=WARPS // min(Mch, WARPS))


def slices(K, width):
    """k slices of a product over K rows into ``width`` columns."""
    return max(1, min(MAX_SLICES, THREADS // (width // 4), K))


def products(kind, d, L, M, D, S, n_filters=1, dec_stack=1):
    """{name: (K, width)} of a kind's products, each block's packed slice
    of a weight being (K, width); with ``n_filters`` 0 (content-only
    attention) no convolution and no transposed one.  ``n_filters``
    bands side by side widen the convolution, and their transposes, each
    padded to ``L4`` rows, lengthen the transposed one.  A stack of
    ``dec_stack`` layers reads every layer's states in the state
    products, the layer below's new state in a layer's gate and
    candidate products, and every layer's gate gradients in the
    distribute products' backward, whose interlayer share (``ibT``) is a
    product of its own."""
    nf, N = n_filters, dec_stack
    if N > 1:
        Sp, Dp, Sc = d["Sp"], d["Dp"], d["Sc"]
        if kind == "forward":
            out = {"toep": (L, nf * d["Lq"]), "st": (N * Sp, d["Mc"]),
                   "gate": (2 * Sp + Dp, 2 * Sc), "dx": (Sp + D, Sc),
                   "ss": (S, Sc)}
        else:
            out = {"st": (N * Sp, d["Mc"]), "toep": (L, nf * d["Lq"]),
                   "ssT": (S, Sc), "sgT": (2 * Sp, Sc),
                   "dxgT": (N * 3 * Sp, d["Dc"]), "stT": (M, N * Sc),
                   "ibT": (3 * Sp, Sc),
                   "toepT": (nf * d["L4"] if nf > 1 else L, d["Lq"])}
    elif kind == "forward":
        out = {"toep": (L, nf * d["Lq"]), "st": (S, d["Mc"]),
               "gate": (d["Dp"] + d["Sp"], 2 * d["Sc"]),
               "dx": (D, d["Sc"]), "ss": (S, d["Sc"])}
    else:
        out = {"st": (S, d["Mc"]), "toep": (L, nf * d["Lq"]),
               "ssT": (S, d["Sc"]), "sgT": (2 * d["Sp"], d["Sc"]),
               "dxgT": (3 * d["Sp"], d["Dc"]), "stT": (M, d["Sc"]),
               "toepT": (nf * d["L4"] if nf > 1 else L, d["Lq"])}
    if not nf:
        out.pop("toep")
        out.pop("toepT", None)
    return out


# the buffers of the conv term, empty without it
CONV_BUFFERS = {"forward": ("wgv", "conv"),
                "backward": ("wgv", "dcv", "conv", "dcvw")}


def layout(kind, C, R, L, M, D, S, res, n_filters=1, dec_stack=1):
    """The kernel's shared memory (``csrc/decoder_train.cu::layout``):
    {buffer: (offset, floats)} in floats, every buffer on 16 bytes, and
    the bytes of a block.  ``res``: {"pre", "att", "dpre"} rows whose tiles
    stay in shared memory (dpre in the backward only).  With ``n_filters``
    0 (content-only attention) the buffers of :data:`CONV_BUFFERS` hold
    nothing; ``n_filters`` > 1 widens the convolutions and their
    gradients, and the backward then keeps one row's dconv partials
    (``dcvw``) and the handler's gradient a block (``dhg``).  A stack of
    ``dec_stack`` layers keeps every layer's states (forward ``hst``,
    backward ``hp``), gate gradients (``g1``) and carried gradients
    (``dh``, ``dhp``), a row's ``gin`` gains the layer below's new state
    in front, and the backward keeps the gradient reaching the layer
    below (``dbl``)."""
    nf, N = n_filters, dec_stack
    d = dims(C, R, L, M, D, S)
    Lq, L4, Sc, Sp, Mp, Dp = (d[k] for k in ("Lq", "L4", "Sc", "Sp", "Mp",
                                             "Dp"))
    below = Sp if N > 1 else 0
    if kind == "forward":
        sizes = [("gin", R * (below + Dp + Sp)), ("w", R * L4),
                 ("wgv", R * L4),
                 ("rh", R * Sp), ("sp", R * Mp), ("wanp", R * Dp),
                 ("wa", R * d["Dc"]), ("ek", R * Lq), ("conv", R * nf * Lq)] \
            + [(n, R * Lq) for n in ("e", "un", "comb")] \
            + [("xin", R * Sc), ("gate", R * 2 * Sc),
               ("hst", R * N * Sp if N > 1 else 0)]
        pmax = max(Lq, d["Mc"], 2 * Sc)
    else:
        sizes = [("hp", R * N * Sp), ("wgv", R * L4), ("g1", R * N * 3 * Sp),
                 ("sp", R * Mp), ("dwan", R * Dp), ("dspp", R * Mp),
                 ("dsp", R * Mp), ("dcv", R * nf * L4),
                 ("conv", R * nf * Lq)] \
            + [(n, R * Lq) for n in ("wn", "dwn", "dE")] \
            + [("dh", R * N * Sc), ("dhp", R * N * Sc), ("dw", R * Lq),
               ("dwa", R * d["Dc"]),
               ("dcvw", nf * d["Mch"] * (Lq if nf > 1 else R * Lq))] \
            + [(n, d["groups"] * R * d["M4"]) for n in ("dspg", "dvg")] \
            + [("dhg", d["groups"] * d["M4"] * (nf if nf > 1 else R)),
               ("dbl", below and R * Sc)]
        pmax = max(Lq, d["Mc"], N * Sc, d["Dc"])
    if not nf:
        sizes = [(n, 0 if n in CONV_BUFFERS[kind] else k) for n, k in sizes]
    part = max(slices(K, w) * min(R, ROW_CHUNK) * w
               for K, w in products(kind, d, L, M, D, S, nf, N).values())
    sizes += [("pout", R * pmax), ("rs", 8 * R), ("red", 2 * WARPS),
              ("vh", (1 + max(nf, 1)) * d["M4"]), ("part", part)]
    tiles = {"dpre": d["Lt"] * d["Mt"], "pre": d["Lt"] * d["Mt"],
             "att": d["Lt"] * D}
    for name in TILES[kind]:
        if res.get(name, 0) > 0:
            sizes.append((name, res[name] * tiles[name]))
    out, at = {}, 0
    for name, n in sizes:
        out[name] = (at, n)
        at += _up4(n)
    return {"buffers": out, "floats": at, "smem_bytes": 4 * at, **d}


def cluster_rows(B, clusters):
    """[(first row, rows)] of each cluster: the B rows spread evenly, the
    first ``B % clusters`` clusters one row more."""
    q, rem = divmod(B, clusters)
    return [(c * q + min(c, rem), q + (c < rem)) for c in range(clusters)]


def residency(kind, C, R, L, M, D, S, n_filters=1, dec_stack=1):
    """{tile: rows kept in shared memory} of a plan: per tile in the kind's
    order (TILES), as many of the R rows as fit beside the tiles before it,
    or None when not even the vectors fit."""
    res = {name: 0 for name in TILES[kind]}
    fits = lambda: layout(kind, C, R, L, M, D, S, res, n_filters,
                          dec_stack)["smem_bytes"] <= MAX_SMEM
    if not fits():
        return None
    for name in TILES[kind]:
        while res[name] < R:
            res[name] += 1
            if not fits():
                res[name] -= 1
                break
    return res


def plan(kind, B, L, M, D, S, active, cluster=None, clusters=None,
         n_filters=1, dec_stack=1):
    """The launch plan of a kind's kernel over B rows, given how many
    clusters of each size the card holds at once (``active``: {size:
    count}).  Per size: the rows spread over as many clusters as the card
    holds (at most B), R = ceil(B / clusters) rows a cluster, and as many
    rows as fit keeping their tiles in shared memory (``residency``).  The
    size with the least time a step wins: R / C rows of work a block plus
    R * ROW_COST for the exchanges and reductions of each row; on a tie
    the one with fewer tile bytes streamed from L2 a step, then the
    larger.  ``cluster`` and ``clusters`` force a size and a number of
    clusters (a timing tool's choice).  ``n_filters``: the conv branch's
    filters, 0 the content branch, whose layout has no conv buffers;
    ``dec_stack`` the GRU layers.  Raises NotImplementedError naming the
    shape when no size fits."""
    options = []
    for C in (CLUSTERS if cluster is None else (cluster,)):
        count = active.get(C, 0) if clusters is None else clusters
        n = min(count, B)
        if n <= 0 or (clusters is not None and clusters > active.get(C, 0)):
            continue
        R = _cdiv(B, n)
        if R > MAX_ROWS:
            continue
        res = residency(kind, C, R, L, M, D, S, n_filters, dec_stack)
        if res is None:
            continue
        streamed = sum((R - res[name]) * size for name, size in
                       (("pre", M), ("att", D), ("dpre", 2 * M))
                       if name in res)
        options.append(((R / C + R * ROW_COST, streamed / C, -C),
                        dict(cluster=C, clusters=n, rows=R, blocks=n * C,
                             **{f"res_{k}": v for k, v in res.items()})))
    if not options:
        raise NotImplementedError(
            f"decoder_scan_train: no {kind} launch plan covers a batch of "
            f"{B} rows at L={L}, M={M}, D={D}, S={S}"
            + (f", {n_filters} filters" if n_filters > 1 else "")
            + (f", {dec_stack} layers" if dec_stack > 1 else "")
            + " (clusters of "
            f"{'/'.join(map(str, CLUSTERS))} blocks, the card holding "
            f"{active} at once, at most {MAX_ROWS} rows a cluster, "
            f"{MAX_SMEM} bytes of shared memory a block)")
    best = min(options, key=lambda o: o[0])[1]
    best["smem_bytes"] = layout(
        kind, best["cluster"], best["rows"], L, M, D, S,
        {k: best[f"res_{k}"] for k in TILES[kind]}, n_filters,
        dec_stack)["smem_bytes"]
    return best


# --------------------------------------------------------------------------
# the weights' column slices, packed for the kernels
# --------------------------------------------------------------------------

def _slice_columns(N, chunk, C, width):
    """Source column of each (block, column) of a slice ``chunk`` wide
    padded to ``width``, -1 past N: (C * width,)."""
    j = torch.arange(C)[:, None]
    c = torch.arange(width)[None, :]
    col = j * chunk + c
    return torch.where((c < chunk) & (col < N), col, -1).reshape(-1)


def _segments(parts):
    """Source rows of [(first row, rows, padded rows)]: -1 for padding."""
    out = []
    for first, n, padded in parts:
        out += list(range(first, first + n)) + [-1] * (padded - n)
    return torch.tensor(out)


def pack(w, rows, cols, C):
    """``w``'s rows ``rows`` and columns ``cols`` (-1: zero) as a (C, K,
    width) tensor, block j's slice k-major: the layout the kernels read."""
    ext = torch.nn.functional.pad(w, (0, 1, 0, 1))     # a zero row, column
    K, width = rows.numel(), cols.numel() // C
    r = torch.where(rows < 0, w.shape[0], rows).to(w.device)
    c = torch.where(cols < 0, w.shape[1], cols).to(w.device)
    return ext[r][:, c].reshape(K, C, width).permute(1, 0, 2).contiguous()


def _band_columns(L, d, C, n_filters):
    """Source column of each (block, column) of the (L, F * L) bands: a
    block's frame tile of each filter's band, one after another."""
    tile = _slice_columns(L, d["Lt"], C, d["Lq"]).reshape(C, d["Lq"])
    return torch.cat([torch.where(tile >= 0, tile + f * L, -1)
                      for f in range(n_filters)], dim=1).reshape(-1)


def _layers(w, n):
    """The n layers' column blocks of a lane-stacked table."""
    return w.chunk(n, dim=1) if n > 1 else (w,)


def _flat(tables):
    """Per-layer packed tables one after another, flat."""
    return torch.cat([t.reshape(-1) for t in tables])


def _state_rows(d, N, S):
    """Source rows of the states of N layers, each padded to Sp."""
    return _segments([(ly * S, S, d["Sp"]) for ly in range(N)])


def pack_forward(d, toep, st, wss, wsg, dxm, dgm, inter_in=None,
                 inter_gate=None):
    """The forward kernel's packed weights for the slices ``d``; no
    Toeplitz band when ``toep`` is None (the content branch).  A stack
    (``inter_in`` given) packs its layers one after another: layer l > 0
    reads [below | wan | h] in its gate product ([inter_gate; dgm; wsg])
    and [below | wan] in its candidate's ([inter_in; dxm]); the state
    transform's rows are each layer's S padded to Sp."""
    C, S = d["C"], wss.shape[0]
    M, D = st.shape[1], dxm.shape[0]
    N = wss.shape[1] // S
    Sc, Sp, Dp = d["Sc"], d["Sp"], d["Dp"]
    s_cols = _slice_columns(S, Sc, C, Sc)
    gate_cols = torch.cat([s_cols.reshape(C, Sc),
                           torch.where(s_cols >= 0, s_cols + S, -1)
                           .reshape(C, Sc)], dim=1).reshape(-1)
    ident = lambda n: torch.arange(n)
    m_cols = _slice_columns(M, d["Mc"], C, d["Mc"])
    if N == 1:
        out = {
            "p_st": pack(st, ident(S), m_cols, C),
            "p_gate": pack(torch.cat([dgm, wsg]),
                           _segments([(0, D, Dp), (D, S, Sp)]), gate_cols, C),
            "p_dx": pack(dxm, ident(D), s_cols, C),
            "p_ss": pack(wss, ident(S), s_cols, C)}
    else:
        dgs, wsgs = _layers(dgm, N), _layers(wsg, N)
        dxs, igs = _layers(dxm, N), _layers(inter_gate, N - 1)
        iis = _layers(inter_in, N - 1)
        gates = [pack(torch.cat([dgs[0], wsgs[0]]),
                      _segments([(0, D, Dp), (D, S, Sp)]), gate_cols, C)]
        gates += [pack(torch.cat([igs[ly - 1], dgs[ly], wsgs[ly]]),
                       _segments([(0, S, Sp), (S, D, Dp), (S + D, S, Sp)]),
                       gate_cols, C) for ly in range(1, N)]
        dxp = [pack(dxs[0], ident(D), s_cols, C)]
        dxp += [pack(torch.cat([iis[ly - 1], dxs[ly]]),
                     _segments([(0, S, Sp), (S, D, D)]), s_cols, C)
                for ly in range(1, N)]
        out = {"p_st": pack(st, _state_rows(d, N, S), m_cols, C),
               "p_gate": _flat(gates), "p_dx": _flat(dxp),
               "p_ss": _flat([pack(w, ident(S), s_cols, C)
                              for w in _layers(wss, N)])}
    if toep is not None:
        L = toep.shape[0]
        out["p_toep"] = pack(toep, ident(L),
                             _band_columns(L, d, C, toep.shape[1] // L), C)
    return out


def pack_backward(d, toep, st, wss, wsg, dxm, dgm, inter_in=None,
                  inter_gate=None):
    """The backward kernel's packed weights (transposes included); no
    Toeplitz bands when ``toep`` is None (the content branch).  A stack
    (``inter_in`` given) packs the per-layer transposes one after another,
    the distribute products' transposes of every layer as one table over
    the layers' [dca | dgu | dgr] rows, the state transform's transpose
    with each layer's column slice side by side, and the interlayer
    transposes ``p_ibT`` ([inter_in^T; inter_gate^T u; inter_gate^T r] of
    each layer l > 0, into layer l-1's units)."""
    C, S = d["C"], wss.shape[0]
    M, D = st.shape[1], dxm.shape[0]
    N = wss.shape[1] // S
    Sc, Sp = d["Sc"], d["Sp"]
    s_cols = _slice_columns(S, Sc, C, Sc)
    ident = lambda n: torch.arange(n)
    g_rows = _segments([(0, S, Sp), (S, S, Sp), (2 * S, S, Sp)])
    d_cols = _slice_columns(D, d["Dc"], C, d["Dc"])
    m_cols = _slice_columns(M, d["Mc"], C, d["Mc"])
    if N == 1:
        out = {
            "p_st": pack(st, ident(S), m_cols, C),
            "p_ssT": pack(wss.t(), ident(S), s_cols, C),
            "p_sgT": pack(wsg.t(), _segments([(0, S, Sp), (S, S, Sp)]),
                          s_cols, C),
            "p_dxgT": pack(torch.cat([dxm.t(), dgm.t()]), g_rows, d_cols, C),
            "p_stT": pack(st.t(), ident(M), s_cols, C)}
    else:
        dxs, dgs = _layers(dxm, N), _layers(dgm, N)
        # layer l's [dca | dgu | dgr] rows at l * 3S of the stacked table
        dxg = torch.cat([torch.cat([dxs[ly].t(), dgs[ly].t()])
                         for ly in range(N)])
        dxg_rows = _segments([(ly * 3 * S + k * S, S, Sp)
                              for ly in range(N) for k in range(3)])
        # block j's columns of every layer's S slice side by side
        st_cols = torch.cat([torch.where(s_cols >= 0, s_cols + ly * S, -1)
                             .reshape(C, Sc) for ly in range(N)],
                            dim=1).reshape(-1)
        ib = [torch.cat([ii.t(), ig.t()]) for ii, ig in
              zip(_layers(inter_in, N - 1), _layers(inter_gate, N - 1))]
        out = {
            "p_st": pack(st, _state_rows(d, N, S), m_cols, C),
            "p_ssT": _flat([pack(w.t(), ident(S), s_cols, C)
                            for w in _layers(wss, N)]),
            "p_sgT": _flat([pack(w.t(), _segments([(0, S, Sp), (S, S, Sp)]),
                                 s_cols, C) for w in _layers(wsg, N)]),
            "p_dxgT": pack(dxg, dxg_rows, d_cols, C),
            "p_stT": pack(st.t(), ident(M), st_cols, C),
            "p_ibT": _flat([pack(w, g_rows, s_cols, C) for w in ib])}
    if toep is not None:
        L = toep.shape[0]
        nf = toep.shape[1] // L
        out["p_toep"] = pack(toep, ident(L), _band_columns(L, d, C, nf), C)
        # the bands' transposes, each padded to L4 rows past one band
        rows = (ident(L) if nf == 1 else
                _segments([(f * L, L, d["L4"]) for f in range(nf)]))
        out["p_toepT"] = pack(toep.t(), rows,
                              _slice_columns(L, d["Lt"], C, d["Lq"]), C)
    return out


class _Args(ctypes.Structure):
    """Mirror of ``struct DecoderArgs`` in csrc/decoder_train.cu."""
    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "fx", "fg", "mask", "step0", "pre", "att", "amask", "h0", "w0",
            "wa0", "hand", "v", "p_toep", "p_st", "p_gate", "p_dx", "p_ss",
            "p_ssT", "p_sgT", "p_dxgT", "p_stT", "p_toepT",
            "h_out", "w_out", "wa_out", "e_out", "u_out", "r_out", "c_out",
            "bounds", "exch", "barrier",
            "dh", "dw", "dwa", "dfx", "dfg", "dh0", "dwa0", "dpre", "dsp",
            "wg", "dconv", "dwan", "dhand", "dv", "e_bias", "gsc")]
        + [(name, ctypes.c_int) for name in (
            "T", "B", "L", "M", "D", "S", "prior_median", "content",
            "normalizer", "cluster",
            "clusters", "res_pre", "res_att", "res_dpre")]
        + [(name, ctypes.c_float) for name in (
            "before", "after", "initial_begin", "initial_end", "min_speed",
            "max_speed")]
        + [(name, ctypes.c_int) for name in ("n_filters", "prior_mean")]
        + [("p_ibT", ctypes.c_void_p), ("dec_stack", ctypes.c_int)])


def unported_variant(normalizer, n_filters, dec_stack, prior_type):
    """The first piece of a decoder variant the CUDA kernel does not cover,
    or None.  A stack of two to four layers runs with more than one conv
    filter and softmax: the instance the configs under ``exp/`` use."""
    for ok, piece in (
            (0 <= int(n_filters) <= MAX_FILTERS, f"{n_filters} conv filters"),
            (normalizer == "softmax" or (int(n_filters) >= 1
                                         and normalizer in NORMALIZERS),
             f"the {normalizer!r} normalizer"
             + (" of content attention" if int(n_filters) == 0 else "")),
            (int(dec_stack) == 1
             or (2 <= int(dec_stack) <= MAX_STACK and int(n_filters) > 1
                 and normalizer == "softmax"),
             f"dec_stack={dec_stack}"
             + (f" with {n_filters} conv filters and the {normalizer!r} "
                "normalizer" if int(dec_stack) <= MAX_STACK else "")),
            (prior_type in PRIORS, f"the {prior_type!r} prior")):
        if not ok:
            return piece
    return None


def _check(name, t, shape, device, dtype=torch.float32):
    if t.dtype != dtype:
        raise TypeError(f"decoder_scan_train: {name} must be {dtype}, got "
                        f"{t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"decoder_scan_train: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"decoder_scan_train: {name} must be contiguous")
    if t.device != device:
        raise ValueError(f"decoder_scan_train: {name} is on {t.device}, "
                         f"expected {device}")


_active = {}


def max_active_clusters(kind, device, n_filters=1, dec_stack=1):
    """{cluster size: clusters of the kind's kernel (the conv branch with
    one filter or more, or the content branch, ``n_filters`` 0; a stack's
    own instance) the device holds at once}
    (``cudaOccupancyMaxActiveClusters`` at a block's most shared memory),
    queried once per device and instance."""
    # every filter count above one shares an instance, every stack one
    key = (device.index, kind, min(int(n_filters), 2), min(int(dec_stack), 2))
    if key not in _active:
        lib = _build.load().lib
        lib.decoder_train_max_clusters.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.decoder_train_max_clusters.restype = ctypes.c_int
        active = {}
        with torch.cuda.device(device):
            for size in CLUSTERS:
                count = ctypes.c_int(0)
                _build.check(lib.decoder_train_max_clusters(
                    KINDS.index(kind), key[2], key[3], size,
                    ctypes.byref(count)), "decoder_train_max_clusters")
                active[size] = count.value
        _active[key] = active
    return _active[key]


def launch_plan(kind, B, L, M, D, S, device, n_filters=1, dec_stack=1,
                **force):
    """The plan a launch of the kind's kernel takes on ``device``."""
    return plan(kind, B, L, M, D, S,
                max_active_clusters(kind, device, n_filters, dec_stack),
                n_filters=n_filters, dec_stack=dec_stack, **force)


def _launch(name, args, stream_of):
    lib = _build.load().lib
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(stream_of.device):
        status = fn(ctypes.byref(args), _build.stream_of(stream_of))
    if status == -1:
        raise NotImplementedError(
            f"decoder_scan_train: a batch of {args.B} rows at L={args.L}, "
            f"M={args.M}, D={args.D}, S={args.S} does not fit the plan of "
            f"{args.clusters} co-resident clusters of {args.cluster} blocks "
            f"in a block's shared memory")
    _build.check(status, name)


def _ptr(t):
    return t.data_ptr() if t is not None else None


_PRIOR = ("before", "after", "initial_begin", "initial_end", "min_speed",
          "max_speed")


def _plan_args(kind, B, L, M, D, S, device, n_filters, dec_stack):
    p = launch_plan(kind, B, L, M, D, S, device, n_filters=n_filters,
                    dec_stack=dec_stack)
    return p, dims(p["cluster"], p["rows"], L, M, D, S)


def _prior_fields(cfg):
    return dict(prior_median=int(cfg["prior"] == "window_around_median"),
                prior_mean=int(cfg["prior"] == "window_around_mean"),
                **{k: cfg[k] for k in _PRIOR})


class _DecoderScanTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, cfg, fx, fg, mask, step0, pre, att, amask, h0, w0, wa0,
                toep, st, hand, v, wss, wsg, dxm, dgm, e_bias, inter_in,
                inter_gate):
        T, B, NS = fx.shape
        N = cfg["dec_stack"]
        S = NS // N
        L, M, D = pre.shape[1], pre.shape[2], att.shape[2]
        new = lambda *s: torch.empty(*s, dtype=fx.dtype, device=fx.device)
        norm = NORMALIZERS.index(cfg["normalizer"])
        outs = dict(h_out=new(T, B, NS), w_out=new(T, B, L),
                    wa_out=new(T, B, D), e_out=new(T, B, L),
                    u_out=new(T, B, NS), r_out=new(T, B, NS),
                    c_out=new(T, B, NS), bounds=new(max(T, 1), 2),
                    exch=new(2, 2 * B),
                    gsc=new(T, B, L) if norm else new(0))
        ins = dict(fx=fx, fg=fg, mask=mask, step0=step0, pre=pre, att=att,
                   amask=amask, h0=h0, w0=w0, wa0=wa0, hand=hand, v=v,
                   e_bias=e_bias)
        nf = cfg["n_filters"]
        if T and B:
            p, d = _plan_args("forward", B, L, M, D, S, fx.device, nf, N)
            packed = pack_forward(d, toep if nf else None, st, wss, wsg,
                                  dxm, dgm, inter_in, inter_gate)
            barrier = torch.zeros(2, dtype=torch.int32, device=fx.device)
            args = _Args(**{k: _ptr(t) for k, t in
                            {**ins, **outs, **packed}.items()},
                         barrier=barrier.data_ptr(), T=T, B=B, L=L, M=M, D=D,
                         S=S, content=int(nf == 0), normalizer=norm,
                         n_filters=nf, cluster=p["cluster"],
                         clusters=p["clusters"], res_pre=p["res_pre"],
                         res_att=p["res_att"], dec_stack=N,
                         **_prior_fields(cfg))
            _launch("decoder_train_fwd_f32", args, fx)
            launches.count += 1
        ctx.cfg = cfg
        ctx.save_for_backward(fx, fg, mask, step0, pre, att, amask, h0, w0,
                              wa0, toep, st, hand, v, wss, wsg, dxm, dgm,
                              e_bias, inter_in, inter_gate, *outs.values())
        return (outs["h_out"], outs["w_out"], outs["wa_out"], outs["e_out"])

    @staticmethod
    def backward(ctx, dh, dw, dwa, _de):
        saved = ctx.saved_tensors
        (fx, fg, mask, step0, pre, att, amask, h0, w0, wa0, toep, st, hand,
         v, wss, wsg, dxm, dgm, e_bias, inter_in, inter_gate) = saved[:21]
        (h_out, w_out, wa_out, e_out, u_out, r_out, c_out, bounds,
         exch, gsc) = saved[21:]
        cfg = ctx.cfg
        # logistic and relu: dv's rows carry the bias's gradient last
        nb = int(cfg["normalizer"] != "softmax")
        T, B, NS = fx.shape
        N = cfg["dec_stack"]
        S = NS // N
        L, M, D = pre.shape[1], pre.shape[2], att.shape[2]
        new = lambda *s: torch.empty(*s, dtype=fx.dtype, device=fx.device)
        zeros = lambda *s: torch.zeros(*s, dtype=fx.dtype, device=fx.device)
        cot = lambda g, *s: g.contiguous() if g is not None else zeros(*s)
        dh, dw, dwa = cot(dh, T, B, NS), cot(dw, T, B, L), cot(dwa, T, B, D)
        nf = cfg["n_filters"]
        nh = max(nf, 1)
        g = dict(dfx=new(T, B, NS), dfg=new(T, B, 2 * NS), dh0=new(B, NS),
                 dwa0=new(B, D), dpre=new(B, L, M), dsp=new(T, B, M),
                 dwan=new(T, B, D))
        if nf:
            g.update(wg=new(T, B, L), dconv=new(T, B, nf * L))
        # the content branch: the band and the handler feed nothing, so
        # their gradients stay zero and no outer_sum job forms them
        w_grads = dict(dtoep=zeros(L, nh * L), dst=zeros(NS, M),
                       dwss=[zeros(S, S) for _ in range(N)],
                       dwsg=[zeros(S, 2 * S) for _ in range(N)],
                       ddx=zeros(D, NS), ddg=zeros(D, 2 * NS),
                       dhand=zeros(1, nh * M), dv=zeros(1, M + nb),
                       datt=zeros(B, L, D),
                       dii=[zeros(S, S) for _ in range(N - 1)],
                       dig=[zeros(S, 2 * S) for _ in range(N - 1)])
        if T and B:
            p, d = _plan_args("backward", B, L, M, D, S, fx.device, nf, N)
            C = p["cluster"]
            g.update(dv=new(B * C, M + nb))
            # the handler's partials: a (row, block)'s, or with more
            # filters a (cluster, block)'s
            hand_rows = B * C if nf == 1 else p["clusters"] * C
            if nf:
                g.update(dhand=new(hand_rows, nf * M))
            packed = pack_backward(d, toep if nf else None, st, wss, wsg,
                                   dxm, dgm, inter_in, inter_gate)
            ins = dict(fx=fx, fg=fg, mask=mask, step0=step0, pre=pre, att=att,
                       amask=amask, h0=h0, w0=w0, wa0=wa0, hand=hand, v=v,
                       h_out=h_out, w_out=w_out, wa_out=wa_out, e_out=e_out,
                       u_out=u_out, r_out=r_out, c_out=c_out, bounds=bounds,
                       dh=dh, dw=dw, dwa=dwa, e_bias=e_bias, gsc=gsc)
            args = _Args(**{k: _ptr(t) for k, t in
                            {**ins, **g, **packed}.items()},
                         T=T, B=B, L=L, M=M, D=D, S=S,
                         content=int(nf == 0),
                         normalizer=NORMALIZERS.index(cfg["normalizer"]),
                         n_filters=nf, cluster=C, clusters=p["clusters"],
                         res_pre=p["res_pre"], res_att=p["res_att"],
                         res_dpre=p["res_dpre"], dec_stack=N,
                         **_prior_fields(cfg))
            _launch("decoder_train_bwd_f32", args, fx)
            launches.count += 1
            h_prev = torch.cat([h0[None], h_out[:-1]])
            ones = fx.new_ones(B * C, 1)  # the (row, block) dhand, dv sums
            lane = lambda x, ly, w=S: x[..., ly * w:(ly + 1) * w]
            jobs = [(h_prev, None, g["dsp"], w_grads["dst"])]
            for ly in range(N):
                jobs += [(lane(h_prev, ly), lane(r_out, ly),
                          lane(g["dfx"], ly), w_grads["dwss"][ly]),
                         (lane(h_prev, ly), None, lane(g["dfg"], ly, 2 * S),
                          w_grads["dwsg"][ly])]
            jobs += [(wa_out, None, g["dfx"], w_grads["ddx"]),
                     (wa_out, None, g["dfg"], w_grads["ddg"])]
            for ly in range(1, N):
                # the layer below's unmasked new state, recomputed from
                # the residuals as the forward formed it
                u, c = lane(u_out, ly - 1), lane(c_out, ly - 1)
                below = u * c + (1.0 - u) * lane(h_prev, ly - 1)
                jobs += [(below, None, lane(g["dfx"], ly),
                          w_grads["dii"][ly - 1]),
                         (below, None, lane(g["dfg"], ly, 2 * S),
                          w_grads["dig"][ly - 1])]
            if nf:
                jobs.insert(0, (g["wg"], None, g["dconv"], w_grads["dtoep"]))
                jobs.append((fx.new_ones(hand_rows, 1), None, g["dhand"],
                             w_grads["dhand"]))
            jobs.append((ones, None, g["dv"], w_grads["dv"]))
            for j0 in range(0, len(jobs), MAX_JOBS):
                outer_sum(jobs[j0:j0 + MAX_JOBS], fx)
            # datt[b] = sum_t w_t[b]^T dwan_t[b]: one job a batch row
            for b0 in range(0, B, MAX_JOBS):
                outer_sum([(w_out[:, b], None, g["dwan"][:, b],
                            w_grads["datt"][b])
                           for b in range(b0, min(B, b0 + MAX_JOBS))], fx)
        else:
            for k in ("dfx", "dfg", "dh0", "dwa0", "dpre"):
                g[k].zero_()
        dv = w_grads["dv"][0]
        lanes = lambda ts: ts[0] if len(ts) == 1 else torch.cat(ts, dim=1)
        return (None, g["dfx"], g["dfg"], None, None, g["dpre"],
                w_grads["datt"], None, g["dh0"], None, g["dwa0"],
                w_grads["dtoep"], w_grads["dst"],
                w_grads["dhand"].view(nh, M),
                dv[:M], lanes(w_grads["dwss"]), lanes(w_grads["dwsg"]),
                w_grads["ddx"], w_grads["ddg"],
                dv[M:].reshape(e_bias.shape) if nb else None,
                lanes(w_grads["dii"]) if N > 1 else None,
                lanes(w_grads["dig"]) if N > 1 else None)


def decoder_scan_train(fx, fg, mask, pre, attended, att_mask, h0, w0, wa0,
                       toep, st, hand, v, wss, wsg, dxm, dgm, *, prior,
                       e_bias=None, normalizer="softmax", n_filters=1,
                       dec_stack=1, inter_in=None, inter_gate=None):
    """Differentiable attention-decoder scan.

    fx (T, B, N*S) / fg (T, B, 2N*S): fork projections of the fed-back
    labels (bias included), lane-stacked over the N = ``dec_stack``
    layers; mask (T, B) or None; pre (B, L, M) preprocessed keys;
    attended (B, L, D); att_mask (B, L); h0 / w0 / wa0 initial state,
    alignment and weighted average; toep (L, max(n_filters, 1) * L) the
    Toeplitz bands of the conv taps (filter-major); st (S * dec_stack, M)
    state transform; hand (max(n_filters, 1), M) conv handler rows; v (M,)
    energy vector; e_bias the energy bias of the non-softmax normalizers;
    wss / wsg the GRU matrices and dxm / dgm the distribute matrices, each
    lane-stacked over the layers; inter_in (S, (N-1)*S) / inter_gate (S,
    2(N-1)*S) the interlayer projections of a stacked decoder.  Returns
    (h, weights, weighted averages, energies), each (T, B, .), mask-mixed
    by selection."""
    device = fx.device
    if device.type == "cpu":
        return decoder_scan_train_reference(
            fx, fg, mask, pre, attended, att_mask, h0, w0, wa0, toep, st,
            hand, v, wss, wsg, dxm, dgm, prior=prior, e_bias=e_bias,
            normalizer=normalizer, n_filters=n_filters, dec_stack=dec_stack,
            inter_in=inter_in, inter_gate=inter_gate)
    if device.type != "cuda":
        raise ValueError(f"decoder_scan_train: no kernel for device {device}")
    N = int(dec_stack)
    cfg = dict(prior_config(prior), n_filters=int(n_filters),
               normalizer=normalizer, dec_stack=N)
    piece = unported_variant(normalizer, n_filters, dec_stack, cfg["prior"])
    if piece is not None:
        raise NotImplementedError(
            f"decoder_scan_train: the CUDA kernel does not cover {piece} yet "
            f"(the plain version does, on CPU tensors)")
    T, B, NS = fx.shape
    S = NS // N
    L, M = pre.shape[1], pre.shape[2]
    D = attended.shape[2]
    nh = max(int(n_filters), 1)
    if mask is None:
        mask = fx.new_ones(T, B)
    checks = [
        ("fx", fx, (T, B, NS)), ("fg", fg, (T, B, 2 * NS)),
        ("mask", mask, (T, B)), ("pre", pre, (B, L, M)),
        ("attended", attended, (B, L, D)), ("att_mask", att_mask, (B, L)),
        ("h0", h0, (B, NS)), ("w0", w0, (B, L)), ("wa0", wa0, (B, D)),
        ("toep", toep, (L, nh * L)), ("st", st, (NS, M)),
        ("hand", hand.reshape(nh, -1), (nh, M)), ("v", v, (M,)),
        ("wss", wss, (S, NS)), ("wsg", wsg, (S, 2 * NS)),
        ("dxm", dxm, (D, NS)), ("dgm", dgm, (D, 2 * NS))]
    if N > 1:
        checks += [("inter_in", inter_in, (S, (N - 1) * S)),
                   ("inter_gate", inter_gate, (S, 2 * (N - 1) * S))]
    else:
        inter_in = inter_gate = None
    for name, t, shape in checks:
        _check(name, t, shape, device)
    if normalizer != "softmax":
        e_bias = e_bias.reshape(1).contiguous()
        _check("e_bias", e_bias, (1,), device)
    else:
        e_bias = None
    return _DecoderScanTrain.apply(
        cfg, fx, fg, mask, step_zero(mask), pre, attended, att_mask, h0, w0,
        wa0, toep, st, hand.reshape(nh, M), v, wss, wsg, dxm, dgm, e_bias,
        inter_in, inter_gate)
