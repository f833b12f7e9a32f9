"""The whole beam-search decode loop: the CUDA kernel's wrapper and its
plain version.

Counterpart of ``attention_lvcsr_tpu/ops/pallas/beam_loop.py::
beam_search_loop`` for conv attention with 1-16 filters and for
content-only attention (``content_attention=True``: no conv term, the
caller's window spanning every frame; see ``csrc/beam_loop.cu`` for the
list), with the expanding, ``window_around_median`` or
``window_around_mean`` prior, the softmax, logistic or relu normalizer
(``normalizer``), the tanh, rectifier, sigmoid, identity or maxout
post-merge activation (``post_act``), the log-likelihood or the task
loss's costs (``mse_cost``) and one to four GRU decoder layers (the tables'
``wss`` (S, N*S); a stack's interlayer tables ``inter_in_w`` and
``inter_gate_w``).
``beam_search_loop`` takes the plain PyTorch version for tensors on the
CPU and launches the kernel for tensors on a CUDA device; any other
device raises, and so does a configuration the kernel does not cover, on
either device.  On the card a decode whose layout fits a block's shared
memory takes the resident instance (``csrc/beam_loop.cu``), any other
the workspace instance (``csrc/beam_loop_ws.cu``: the K-row buffers in
a global workspace the wrapper allocates), up to ``MAX_BEAM`` rows
(:func:`route`, decided before the launch).

Semantics shared by both versions (and by the TPU kernel):

* candidates are ranked by (cost, flat index k*V + v): the lowest index
  wins ties, like ``lax.top_k`` of the negated costs — the plain version
  uses a stable sort, never ``torch.topk``, whose tie order is undefined;
* the done-set merge ranks [existing K, new K] the same way, so an
  existing entry wins a tie;
* the prior's window bounds are taken per utterance over its K rows, so
  no result depends on which utterances share a batch;
* the median position is the first frame whose cumulative weight reaches
  0.5, minus one, and 0 when no frame switches (``attention.py:238-242``);
  the mean position is the weights' sum of frame indices;
* the convolution over the previous weights is a true convolution
  (filter flipped), trimmed from 'full' mode; with F filters the handler
  term is the sum over the filters in their order of each filter's
  convolution times its handler row (JAX ``beam_loop.py:311-318``);
  content-only attention has none, and its tables need no ``handler`` and
  no ``conv_filters``;
* a maxout readout keeps the max of each group of k merged units, and its
  ``post_k`` has ``R / k`` rows;
* a stack advances its layers in order, layer l > 0 adding ``below @
  inter_*`` of layer l-1's new state (JAX ``beam_loop.py:481-511``); the
  attention's and the readout's state terms are one product each over
  the row-stacked ``state_trans`` and ``merge_states_k`` (N*S rows);
* a fully masked utterance starts retired; an utterance that stops
  commits nothing more, and ``steps`` counts the steps it ran;
* under relu, a row whose unnormalized weights are all zero over a
  non-empty window gets zero weights and its candidates cost ``BIG``, so
  they lose the selection (where the module path divides 0 by 0 and its
  NaN candidates are never picked).
"""
from __future__ import annotations

import ctypes

import torch

from attention_lvcsr_torch import _build
from attention_lvcsr_torch.ops.expressions import (ACTIVATIONS, conv1d_full,
                                                   maxout_pieces,
                                                   post_merge_activation)

INF = 1e9
BIG = 3e38
NEG = -1e30
PATIENCE = 30

PRIORS = ("expanding", "window_around_median", "window_around_mean")
MAX_FILTERS = 16
MAX_STACK = 4          # decoder layers the kernels take
STOP_ON = ("patience", "optimistic_future_cost")
# the attention's energy normalizers, in the order of the kernel's
# ``normalizer`` field (0, a zeroed field, is softmax)
NORMALIZERS = ("softmax", "logistic", "relu")
# the post-merge activations in the order of the kernel's ``post_act``
# field (0, a zeroed field, is tanh); maxout is 4 with its pieces in
# ``maxout``
POST_ACTS = ("tanh", "relu", "sigmoid", "identity", "maxout")
_POST_ACT_ALIASES = {"rectifier": "relu", "logistic": "sigmoid"}

launches = _build.LaunchCounter()      # the resident instances
launches_ws = _build.LaunchCounter()   # the workspace instances
launches_select = _build.LaunchCounter()   # beam_select's test entry

# table name -> shape in terms of the dimension letters below (S a
# layer's state, Z = N*S and G = 2*N*S the N layers' lanes)
_TABLE_SHAPES = {
    "state_trans": "ZM", "v": "M",
    "merge_k": "DR", "merge_b": "R", "post_k": "PV", "post_b": "V",
    "embed": "AF", "fork_in_w": "FZ", "fork_in_b": "Z",
    "fork_gate_w": "FG", "fork_gate_b": "G", "dist_in_w": "DZ",
    "dist_gate_w": "DG", "wsg": "SG", "wss": "SZ", "h0": "Z",
}
# a stack's interlayer tables (I = (N-1)*S, J = 2*(N-1)*S)
_STACK_TABLE_SHAPES = {"inter_in_w": "SI", "inter_gate_w": "SJ"}
# the tables a stacked launch passes layer-major, each layer's (rows,
# width) contiguous: the kernel's products read one layer's at a time
_LAYER_MAJOR = ("fork_in_w", "fork_gate_w", "dist_in_w", "dist_gate_w",
                "wsg", "wss", "inter_in_w", "inter_gate_w")


def _layer_major(x, n):
    """(rows, n * width) lane-stacked -> (n, rows, width) contiguous."""
    rows, cols = x.shape
    return x.view(rows, n, cols // n).transpose(0, 1).contiguous()
# the conv attention's tables besides (N filters, handler rows (N, M); one
# filter's row (M,))
_CONV_TABLE_SHAPES = {"handler": "NM", "conv_filters": "NT"}


def post_act_code(post_act):
    """(``post_act`` field, ``maxout`` pieces) of a post-merge activation,
    or None for one the kernel does not know."""
    pieces = maxout_pieces(post_act)
    if pieces:
        return POST_ACTS.index("maxout"), pieces
    if post_act not in ACTIVATIONS:
        return None
    return POST_ACTS.index(_POST_ACT_ALIASES.get(post_act, post_act)), 0


def unported_loop(prior, n_filters, normalizer, content_attention,
                  post_act="tanh", mse_cost=False, dec_stack=1):
    """The first piece of a decode configuration the loop kernel does not
    cover, or None: the search's router asks it before any launch, and
    :func:`beam_search_loop` refuses what it names.  More than one filter,
    the mean prior and an activation besides tanh run under the
    log-likelihood alone, and a stacked decoder under the log-likelihood
    and the softmax normalizer: the kernel instantiates what the configs
    under ``exp/`` use."""
    if not 1 <= dec_stack <= MAX_STACK:
        return f"{dec_stack} decoder layers (1-{MAX_STACK} are ported)"
    if dec_stack > 1 and (mse_cost or normalizer != "softmax"):
        return ("a stacked decoder with the "
                + ("task loss's costs" if mse_cost
                   else f"{normalizer!r} normalizer"))
    if prior not in PRIORS:
        return f"prior {prior!r} (supported: {PRIORS})"
    if normalizer not in NORMALIZERS:
        return f"the {normalizer!r} normalizer"
    if post_act_code(post_act) is None:
        return f"the {post_act!r} post-merge activation"
    if mse_cost and (n_filters > 1 or post_act != "tanh"
                     or prior == "window_around_mean"):
        return (f"the task loss's costs with {n_filters} conv filters, "
                f"the {post_act!r} activation and the {prior!r} prior")
    if content_attention:
        if normalizer != "softmax":
            return f"the {normalizer!r} normalizer of content attention"
        return None
    if not 1 <= n_filters <= MAX_FILTERS:
        return f"{n_filters} conv filters (1-{MAX_FILTERS} are ported)"
    return None


def _n_filters(tables, content_attention):
    """The conv filters of the tables (0 for content attention)."""
    if content_attention:
        return 0
    filters = tables["conv_filters"]
    return filters.shape[0] if filters.ndim == 2 else -1


def dec_stack_of(tables):
    """The decoder layers of the tables: ``wss`` is (S, N*S)."""
    S, NS = tables["wss"].shape
    return NS // S


def _check_config(tables, prior, stop_on, content_attention, normalizer,
                  post_act, mse_cost):
    if stop_on not in STOP_ON:
        raise ValueError(f"unknown stop_on {stop_on!r}")
    piece = unported_loop(prior, _n_filters(tables, content_attention),
                          normalizer, content_attention, post_act, mse_cost,
                          dec_stack_of(tables))
    if piece is not None:
        raise NotImplementedError(f"beam_search_loop: {piece} is not ported")
    if normalizer != "softmax" and "energy_b" not in tables:
        raise ValueError(f"beam_search_loop: the {normalizer!r} normalizer "
                         "needs the energy bias (table 'energy_b')")


def beam_search_loop_reference(pre, attended, att_mask, tables, *, beam,
                               max_len, eol, stop_on="patience",
                               ignore_first_eol=False, char_discount=0.0,
                               round_to_inf=1e9, prior="expanding",
                               before=0.0, after=0.0, initial_begin=0.0,
                               initial_end=1e4, min_speed=0.0,
                               max_speed=0.0, content_attention=False,
                               normalizer="softmax", mse_cost=False,
                               post_act="tanh", window_widths=None):
    """Plain PyTorch version, vectorized over all U*K hypothesis rows.

    ``normalizer``: the energies' normalizer (logistic and relu add the
    energy bias, ``tables["energy_b"]``); ``mse_cost``: the costs are the
    negated logits (the task loss's reward regression) in place of their
    negated log-softmax; ``post_act``: the readout's activation;
    ``window_widths``: a list that gets each step's (U,) frames inside
    the window prior's (the kernel's) window, for counting the work of a
    decode.  Returns
    (done_out (U, K, max_len) int32, done_meta (U, K, 3) float32 [cost,
    adjusted, length], steps (U,) int32)."""
    _check_config(tables, prior, stop_on, content_attention, normalizer,
                  post_act, mse_cost)
    f32 = torch.float32
    dev = pre.device
    U, L, M = pre.shape
    D = attended.shape[-1]
    K = beam
    R = U * K
    Lout = int(max_len)
    t = tables
    S = t["wss"].shape[0]
    N = dec_stack_of(t)
    V = t["post_k"].shape[1]
    taps = t.get("conv_filters")

    pos = torch.arange(L, device=dev, dtype=f32)
    rows = torch.arange(R, device=dev)
    slot = rows % K
    utt = rows // K
    dead = att_mask.sum(dim=1) == 0                          # (U,)
    att_rows = att_mask.repeat_interleave(K, dim=0)          # (R, L)

    h = t["h0"].expand(R, N * S).clone()
    w = (pos == 0).to(f32).expand(R, L).clone()
    aout = torch.zeros(R, Lout, dtype=torch.int32, device=dev)
    dout = torch.zeros(R, Lout, dtype=torch.int32, device=dev)
    acost = torch.where((slot == 0) & ~dead[utt],
                        torch.zeros((), device=dev),
                        torch.full((), INF, device=dev))
    dcost = torch.full((R,), INF, device=dev)
    dadj = torch.full((R,), INF, device=dev)
    dlen = torch.zeros(R, device=dev)
    patience = torch.full((U,), PATIENCE, dtype=torch.int32, device=dev)
    min_cost = torch.full((U,), 1000.0, device=dev)
    stopped = dead.clone()
    steps = torch.zeros(U, dtype=torch.int32, device=dev)
    first = torch.arange(U, device=dev)[:, None] * K

    def merge(done_col, new_col, pick):
        trail = done_col.shape[1:]
        stacked = torch.cat([done_col.reshape(U, K, *trail),
                             new_col.reshape(U, K, *trail)], dim=1)
        idx = pick.reshape(U, K, *([1] * len(trail))).expand(U, K, *trail)
        return stacked.gather(1, idx).reshape(R, *trail)

    for i in range(Lout):
        # ---- stopping bookkeeping ----------------------------------------
        dadj_g = dadj.view(U, K)
        valid = dadj_g < INF / 2
        has_done = valid.any(dim=1)
        best_adj = dadj_g.min(dim=1).values
        alive_min = acost.view(U, K).min(dim=1).values
        empty = alive_min >= INF
        if stop_on == "patience":
            improved = best_adj < min_cost
            min_cost = torch.where(has_done & improved, best_adj, min_cost)
            patience = torch.where(
                has_done, torch.where(improved, PATIENCE, patience - 1),
                patience).to(torch.int32)
            newly = patience <= 0
        else:
            kth_adj = torch.where(valid, dadj_g, -INF).max(dim=1).values
            optimistic = alive_min - char_discount * float(Lout)
            newly = valid.all(dim=1) & (kth_adj < optimistic)
        stopped = stopped | newly | empty
        if bool(stopped.all()):
            break
        steps = torch.where(stopped, steps, i + 1).to(torch.int32)
        live = ~stopped[utt]                                 # (R,)

        # ---- window prior ------------------------------------------------
        if prior == "expanding":
            step0 = torch.tensor(float(i), device=dev)
            begin = torch.floor(torch.clamp(
                initial_begin + step0 * min_speed, max=float(L - 1)
            ).clamp(min=0.0))
            end = torch.ceil(torch.clamp(
                initial_end + step0 * max_speed, max=float(L)
            ).clamp(min=0.0))
            gmask = ((pos >= begin) & (pos < end)).to(f32).expand(R, L)
            combined = gmask * att_rows
        else:
            if prior == "window_around_mean":
                expected = (w * pos).sum(dim=1)
            else:
                below = (torch.cumsum(w, dim=1) < 0.5).sum(dim=1)
                expected = torch.where((below >= 1) & (below <= L - 1),
                                       below - 1, 0).to(f32)
            begins = torch.floor(expected - before)          # (R,)
            ends = torch.ceil(expected + after)
            gb = torch.floor(begins.view(U, K).min(dim=1).values
                             .clamp(min=0.0))
            ge = torch.ceil(ends.view(U, K).max(dim=1).values
                            .clamp(max=float(L)))
            gmask = ((pos >= gb[:, None]) & (pos < ge[:, None])).to(f32)
            gmask = gmask.repeat_interleave(K, dim=0)        # (R, L)
            additional = ((pos > begins[:, None])
                          & (pos < ends[:, None])).to(f32)
            combined = gmask * additional * att_rows

        if window_widths is not None:
            window_widths.append(gmask.reshape(U, K, L)[:, 0].sum(dim=1))

        # ---- energies ------------------------------------------------------
        sp = h @ t["state_trans"]                            # (R, M)
        match = pre[:, None, :, :] + sp.view(U, K, 1, M)
        if not content_attention:
            n = (taps.shape[-1] - 1) // 2
            conv = conv1d_full(w * gmask, taps)[:, :, n:n + L]   # (R, F, L)
            hand = t["handler"].reshape(-1, M)
            # the filters' rank-1 terms summed in filter order
            term = conv[:, 0, :, None] * hand[0]
            for f in range(1, len(hand)):
                term = term + conv[:, f, :, None] * hand[f]
            match = match + term.view(U, K, L, M)
        match = torch.tanh(match)
        energies = (match * t["v"].view(1, 1, 1, M)).sum(dim=3).view(R, L)

        # ---- masked normalization ------------------------------------------
        bad = None
        if normalizer == "softmax":
            masked = torch.where(gmask > 0, energies, NEG)
            mx = masked.max(dim=1, keepdim=True).values
            mx = torch.where(mx > NEG / 2, mx, 0.0)
            unnorm = torch.exp(energies - mx) * combined
        else:
            energies = energies + t["energy_b"].reshape(())
            if normalizer == "logistic":
                unnorm = torch.sigmoid(energies) * combined
            else:
                unnorm = torch.clamp(energies / 1000.0, min=0.0) * combined
        denom = unnorm.sum(dim=1, keepdim=True) + (
            combined.sum(dim=1, keepdim=True) == 0).to(f32)
        if normalizer == "relu":
            # all-zero weights over a live window: zero weights, and the
            # row's candidates lose the selection (JAX beam_loop.py:353)
            bad = denom == 0.0
            denom = denom + bad.to(f32)
        wnew = unnorm / denom

        # ---- readout -------------------------------------------------------
        wa = torch.bmm(wnew.view(U, K, L), attended).view(R, D)
        merged = wa @ t["merge_k"] + t["merge_b"]
        if "merge_states_k" in t:
            merged = merged + h @ t["merge_states_k"]
        logits = post_merge_activation(merged, post_act) @ t["post_k"] \
            + t["post_b"]
        if mse_cost:
            costs = -logits
        else:
            lmx = logits.max(dim=1, keepdim=True).values
            lse = lmx + torch.log(torch.exp(logits - lmx).sum(
                dim=1, keepdim=True))
            costs = lse - logits                             # (R, V)
        if bad is not None:
            costs = torch.where(bad, BIG, costs)

        # ---- selection: K best of K*V, lowest flat index wins ties -------
        work = (acost[:, None] + costs).view(U, K * V)
        order = torch.sort(work, dim=1, stable=True).indices[:, :K]
        chosen = work.gather(1, order).view(R)
        symbols = (order % V).view(R)
        src = (first + order // V).view(R)

        # ---- gather, record ------------------------------------------------
        prev_costs = acost[src]
        h_src = h[src]
        w_src = wnew[src]
        wa_src = wa[src]
        aout_col = aout[src].clone()
        aout_col[:, i] = symbols.to(torch.int32)
        alive_len = float(i + 1)
        step_costs = chosen - prev_costs

        # ---- GRU advance: the layers in order, layer l > 0 adding the
        # interlayer projections of layer l-1's new state ----------------
        fb = t["embed"][symbols]
        gate_in = fb @ t["fork_gate_w"] + t["fork_gate_b"] \
            + wa_src @ t["dist_gate_w"]
        in_tot = fb @ t["fork_in_w"] + t["fork_in_b"] \
            + wa_src @ t["dist_in_w"]
        parts, below = [], None
        for ly in range(N):
            s1 = slice(ly * S, (ly + 1) * S)
            s2 = slice(ly * 2 * S, (ly + 1) * 2 * S)
            h_ly = h_src[:, s1]
            gi, ii = gate_in[:, s2], in_tot[:, s1]
            if ly > 0:
                gi = gi + below @ t["inter_gate_w"][:, (ly - 1) * 2 * S:
                                                    ly * 2 * S]
                ii = ii + below @ t["inter_in_w"][:, (ly - 1) * S:ly * S]
            gates = torch.sigmoid(h_ly @ t["wsg"][:, s2] + gi)
            update, reset = gates[:, :S], gates[:, S:]
            cand = torch.tanh((h_ly * reset) @ t["wss"][:, s1] + ii)
            below = update * cand + (1.0 - update) * h_ly
            parts.append(below)
        h_new = parts[0] if N == 1 else torch.cat(parts, dim=1)

        # ---- EOS retirement ------------------------------------------------
        is_eos = symbols == eol
        if ignore_first_eol and i == 0:
            is_eos = torch.zeros_like(is_eos)
        finishing = (is_eos & (step_costs < round_to_inf)
                     & (prev_costs < INF / 2) & live)
        adjusted = chosen - char_discount * (alive_len + 1.0)
        new_adj = torch.where(finishing, adjusted, INF)

        # ---- done-set merge: [existing K, new K] -> K ----------------------
        cand_adj = torch.cat([dadj.view(U, K), new_adj.view(U, K)], dim=1)
        pick = torch.sort(cand_adj, dim=1, stable=True).indices[:, :K]
        dadj_new = merge(dadj, new_adj, pick)
        dcost_new = merge(dcost, chosen, pick)
        dlen_new = merge(dlen, torch.full_like(dlen, alive_len), pick)
        dout_new = merge(dout, aout_col, pick)

        # ---- commit (stopped utterances keep everything) ------------------
        lc = live[:, None]
        h = torch.where(lc, h_new, h)
        w = torch.where(lc, w_src, w)
        aout = torch.where(lc, aout_col, aout)
        acost = torch.where(live, torch.where(is_eos, INF, chosen), acost)
        dadj = torch.where(live, dadj_new, dadj)
        dcost = torch.where(live, dcost_new, dcost)
        dlen = torch.where(live, dlen_new, dlen)
        dout = torch.where(lc, dout_new, dout)

    done_meta = torch.stack([dcost, dadj, dlen], dim=-1).view(U, K, 3)
    return dout.view(U, K, Lout), done_meta, steps


# ---- mirror of the kernel's layouts and of its products' split over the
# block (csrc/beam_loop_body.cuh, csrc/beam_products.cuh), held to the C
# code on the card by chip_smoke.py
THREADS = 512            # kThreads, kProdThreads
MAX_GROUP_ROWS = 8       # kMaxGroupRows
MAX_BEAM = 512           # kMaxBeam: the merge's commit takes a thread a row
SMEM_LIMIT = 232448      # shared memory an H100 block may use
# the workspace instances' products' ring (csrc/beam_products_ws.cuh):
# kRingStages stages of kRingK k rows, each (BM + pad) + (BN + pad) wide
RING_K, RING_STAGES, RING_PAD = 16, 3, 4
RING_FLOATS = RING_STAGES * RING_K * (32 + 512 + 2 * RING_PAD)
SMALL_ROWS = 16          # kSmallRows: beams with no ring (ring_phases)


def _align4(n):
    return (n + 3) & ~3


def sel_floats(K):
    """``sel_floats``: the workspace instances' selection area, the
    winners' 64-bit keys (K padded to a power of two) and 4 x 16 words of
    counts."""
    P = 1
    while P < K:
        P <<= 1
    return 2 * P + 4 * (THREADS // 32)


def ring_plan(nrows, N):
    """``ring_plan``: the tile shape of a workspace product over nrows x N
    outputs, the fewest tiles, then the fewest floats staged a k:
    (row threads rg, column threads cg, tile rows bm = 8 rg, tile columns
    bn = 4 cg, row tiles, column tiles)."""
    best = None
    for rg in (4, 8, 16, 32, 64):
        cg = THREADS // rg
        bm, bn = 8 * rg, 4 * cg
        rt, ct = -(-nrows // bm), -(-N // bn)
        key = (rt * ct, rt * N + ct * nrows)
        if best is None or key < best[0]:
            best = (key, (rg, cg, bm, bn, rt, ct))
    return best[1]


def _layout(K, L, M, D, S, R, V, F, Lout, n_taps, n_filters, maxout,
            dec_stack, bad, workspace):
    """``make_layout<..., kWorkspace>``: (offsets, shared floats, workspace
    floats an utterance).  The K-row buffers take their own cursor in the
    workspace instance, the one cursor of shared memory otherwise."""
    offsets, cur = {}, {"shared": 0, "rows": 0}
    rows = "rows" if workspace else "shared"

    def take(name, n, where):
        offsets[name] = cur[where]
        cur[where] = _align4(cur[where] + n)

    warps = THREADS // 32
    for name, n, where in (
            ("h", K * S * dec_stack, rows), ("w", K * L, rows),
            ("aout", K * Lout, rows), ("dout", K * Lout, rows),
            ("acost", K, "shared"), ("dadj", K, "shared"),
            ("dcost", K, "shared"), ("dlen", K, "shared"),
            ("newadj", K, "shared"), ("chosen", K, "shared"),
            ("src", K, "shared"), ("sym", K, "shared"),
            ("pick", K, "shared"), ("mask", L, "shared"),
            ("taps", n_filters * n_taps, "shared"),
            ("handler", n_filters * M, "shared"), ("v", M, "shared"),
            ("begins", K, "shared"), ("ends", K, "shared"),
            # relu's row flags take no room under the other normalizers
            *((("bad", K, "shared"),) if bad else ()),
            ("red_v", warps + 1, "shared"), ("red_i", warps + 1, "shared"),
            ("wn", K * L, rows), ("wa", K * D, rows)):
        take(name, n, where)
    if workspace and K > SMALL_ROWS:
        # the ring of the staged phases and the selection's area
        take("ring", RING_FLOATS, "shared")
        take("sel", sel_floats(K), "shared")
    scratch, ends = cur[rows], []
    for phase in ((("conv", n_filters * K * L), ("sp", K * M)),
                  # a maxout readout's grouped units after the merged
                  (("act", K * R + (K * R // maxout if maxout else 0)),
                   ("costs", K * V)),
                  (("hs", K * S), ("was", K * D), ("aout2", K * Lout),
                   ("dout2", K * Lout),
                   ("fb", 0 if dec_stack > 1 else K * F),
                   ("gi", 2 * K * S), ("it", K * S))):
        cur[rows] = scratch
        for name, n in phase:
            take(name, n, rows)
        ends.append(cur[rows])
    if workspace:
        return offsets, cur["shared"], max(ends)
    return offsets, max(ends), 0


def smem_plan(K, L, M, D, S, R, V, F, Lout, n_taps, content=False,
              normalizer="softmax", n_filters=1, maxout=0, dec_stack=1):
    """``make_layout``: buffer offsets (floats, each 16-byte aligned) and
    the block's bytes, and whether they fit an H100 block; under
    ``"workspace"`` the workspace instance's (``make_layout<...,
    kWorkspace>``): its offsets (the K-row buffers' in an utterance's
    workspace rows, the rest in shared memory), ``stride`` (workspace
    floats an utterance), its block's ``smem_bytes`` and ``fits``.  ``F``
    is the feedback width; ``n_filters`` conv filters keep their taps, handler
    rows and convolutions, content-only attention none; only the relu
    normalizer keeps its rows' all-zero flags, and only a maxout readout
    (``maxout`` pieces) its grouped activation.  A stack of ``dec_stack``
    layers keeps their states (K, N*S) and stages no feedback rows: its
    fork products read the embedding rows from global memory."""
    if content:
        n_taps = n_filters = 0
    dims = (K, L, M, D, S, R, V, F, Lout, n_taps, n_filters, maxout,
            dec_stack, normalizer == "relu")
    offsets, total, _ = _layout(*dims, workspace=False)
    ws_offsets, ws_total, stride = _layout(*dims, workspace=True)
    return {"offsets": offsets, "smem_bytes": 4 * total,
            "fits": 4 * total <= SMEM_LIMIT,
            "workspace": {"offsets": ws_offsets, "stride": stride,
                          "smem_bytes": 4 * ws_total,
                          "fits": 4 * ws_total <= SMEM_LIMIT}}


def route(plan, beam):
    """``"resident"`` where the resident layout of :func:`smem_plan`'s
    ``plan`` fits a block, else ``"workspace"``; a beam past
    ``MAX_BEAM`` or a workspace instance whose shared part does not fit
    raises."""
    if not 1 <= beam <= MAX_BEAM:
        raise ValueError(f"beam_search_loop: beam {beam} (the kernel takes "
                         f"1-{MAX_BEAM})")
    if plan["fits"]:
        return "resident"
    if not plan["workspace"]["fits"]:
        raise ValueError(
            "beam_search_loop: the workspace instance's shared part needs "
            f"{plan['workspace']['smem_bytes']} bytes (limit {SMEM_LIMIT})")
    return "workspace"


def product_plan(nrows, N):
    """``product_plan``: a thread owns a column pair and a row group;
    (units, groups, rows of the largest group, passes over the block)."""
    units = (N + 1) // 2
    groups = max(min(THREADS // units, nrows),
                 -(-nrows // MAX_GROUP_ROWS), 1)
    rows = -(-nrows // groups)
    return units, groups, rows, -(-units * groups // THREADS)


class _Args(ctypes.Structure):
    """Mirror of ``struct BeamLoopArgs`` in csrc/beam_loop_body.cuh."""
    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "pre", "attended", "att_mask", "conv_taps", "state_trans",
            "handler", "v", "merge_k", "merge_b", "merge_states_k",
            "post_k", "post_b", "embed", "fork_in_w", "fork_in_b",
            "fork_gate_w", "fork_gate_b", "dist_in_w", "dist_gate_w",
            "wsg", "wss", "h0", "done_out", "done_meta", "steps")]
        + [(name, ctypes.c_int) for name in (
            "U", "L", "M", "D", "S", "R", "V", "F", "K", "Lout", "n_taps",
            "eol", "stop_patience", "ignore_first_eol", "prior_median",
            "content", "normalizer", "mse_cost")]
        + [(name, ctypes.c_float) for name in (
            "energy_b", "char_discount", "round_to_inf", "before", "after",
            "initial_begin", "initial_end", "min_speed", "max_speed")]
        + [(name, ctypes.c_int) for name in (
            "n_filters", "post_act", "maxout", "prior_mean")]
        + [(name, ctypes.c_void_p) for name in ("inter_in_w",
                                                 "inter_gate_w")]
        + [("dec_stack", ctypes.c_int), ("ws", ctypes.c_void_p),
           ("ws_stride", ctypes.c_int)])


def _check_tensor(name, x, shape, device):
    if x.dtype != torch.float32:
        raise TypeError(f"beam_search_loop: {name} must be float32, "
                        f"got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"beam_search_loop: {name} has shape "
                         f"{tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"beam_search_loop: {name} must be contiguous")
    if x.device != device:
        raise ValueError(f"beam_search_loop: {name} is on {x.device}, "
                         f"expected {device}")


def _launch(pre, attended, att_mask, tables, *, beam, max_len, eol,
            stop_on="patience", ignore_first_eol=False, char_discount=0.0,
            round_to_inf=1e9, prior="expanding", before=0.0, after=0.0,
            initial_begin=0.0, initial_end=1e4, min_speed=0.0,
            max_speed=0.0, content_attention=False, normalizer="softmax",
            mse_cost=False, post_act="tanh", instance=None):
    _check_config(tables, prior, stop_on, content_attention, normalizer,
                  post_act, mse_cost)
    act, pieces = post_act_code(post_act)
    n_filters = _n_filters(tables, content_attention)
    U, L, M = pre.shape
    D = attended.shape[-1]
    R = tables["merge_k"].shape[1]
    if pieces and R % pieces:
        raise ValueError(f"beam_search_loop: maxout:{pieces} of {R} "
                         "merged units")
    N = dec_stack_of(tables)
    S = tables["wss"].shape[0]
    dims = {"U": U, "L": L, "M": M, "D": D, "1": 1, "R": R,
            "P": R // (pieces or 1), "N": n_filters, "S": S, "Z": N * S,
            "G": 2 * N * S, "I": (N - 1) * S, "J": 2 * (N - 1) * S,
            "V": tables["post_k"].shape[1], "A": tables["embed"].shape[0],
            "F": tables["embed"].shape[1],
            "T": (0 if content_attention
                  else tables["conv_filters"].shape[-1])}
    dev = pre.device
    _check_tensor("pre", pre, (U, L, M), dev)
    _check_tensor("attended", attended, (U, L, D), dev)
    _check_tensor("att_mask", att_mask, (U, L), dev)
    shapes = dict(_TABLE_SHAPES,
                  **({} if content_attention else _CONV_TABLE_SHAPES),
                  **(_STACK_TABLE_SHAPES if N > 1 else {}))
    for name, letters in shapes.items():
        if name == "handler" and n_filters == 1:
            letters = "M"
        _check_tensor(name, tables[name], [dims[c] for c in letters], dev)
    states_k = tables.get("merge_states_k")
    if states_k is not None:
        _check_tensor("merge_states_k", states_k, (dims["Z"], dims["R"]),
                      dev)
    K, Lout = int(beam), int(max_len)
    # the instance, chosen before anything is allocated or launched
    plan = smem_plan(K, L, M, D, S, dims["R"], dims["V"], dims["F"], Lout,
                     dims["T"], content=content_attention,
                     normalizer=normalizer, n_filters=n_filters,
                     maxout=pieces, dec_stack=N)
    which = route(plan, K)
    if instance is not None:
        if instance not in ("resident", "workspace") or (
                instance == "resident" and not plan["fits"]):
            raise ValueError(f"beam_search_loop: instance {instance!r} "
                             f"cannot take beam {K} at L={L}, D={D}")
        which = instance
    stride = plan["workspace"]["stride"] if which == "workspace" else 0
    if stride >= 2 ** 31:
        raise ValueError(f"beam_search_loop: {stride} workspace floats an "
                         "utterance")
    done_out = torch.zeros(U, K, Lout, dtype=torch.int32, device=dev)
    done_meta = torch.zeros(U, K, 3, dtype=torch.float32, device=dev)
    steps = torch.zeros(U, dtype=torch.int32, device=dev)
    if U == 0:
        return done_out, done_meta, steps
    ws = (torch.empty(U * stride, dtype=torch.float32, device=dev)
          if stride else None)
    if N > 1:
        tables = dict(tables, **{
            name: _layer_major(tables[name],
                               N - 1 if name.startswith("inter") else N)
            for name in _LAYER_MAJOR})
    ptr = lambda name: (tables[name].data_ptr() if name in shapes
                        else None)
    args = _Args(
        pre=pre.data_ptr(), attended=attended.data_ptr(),
        att_mask=att_mask.data_ptr(), conv_taps=ptr("conv_filters"),
        state_trans=ptr("state_trans"), handler=ptr("handler"), v=ptr("v"),
        merge_k=ptr("merge_k"), merge_b=ptr("merge_b"),
        merge_states_k=(states_k.data_ptr() if states_k is not None
                        else None),
        post_k=ptr("post_k"), post_b=ptr("post_b"), embed=ptr("embed"),
        fork_in_w=ptr("fork_in_w"), fork_in_b=ptr("fork_in_b"),
        fork_gate_w=ptr("fork_gate_w"), fork_gate_b=ptr("fork_gate_b"),
        dist_in_w=ptr("dist_in_w"), dist_gate_w=ptr("dist_gate_w"),
        wsg=ptr("wsg"), wss=ptr("wss"), h0=ptr("h0"),
        inter_in_w=ptr("inter_in_w"), inter_gate_w=ptr("inter_gate_w"),
        dec_stack=N, ws=None if ws is None else ws.data_ptr(),
        ws_stride=stride, done_out=done_out.data_ptr(),
        done_meta=done_meta.data_ptr(), steps=steps.data_ptr(),
        U=U, L=L, M=M, D=D, S=dims["S"], R=dims["R"], V=dims["V"],
        F=dims["F"], K=K, Lout=Lout, n_taps=dims["T"], eol=int(eol),
        stop_patience=int(stop_on == "patience"),
        ignore_first_eol=int(bool(ignore_first_eol)),
        prior_median=int(prior == "window_around_median"),
        content=int(bool(content_attention)),
        normalizer=NORMALIZERS.index(normalizer), mse_cost=int(bool(mse_cost)),
        n_filters=n_filters, post_act=act, maxout=pieces,
        prior_mean=int(prior == "window_around_mean"),
        energy_b=(float(tables["energy_b"]) if normalizer != "softmax"
                  else 0.0),
        char_discount=char_discount,
        round_to_inf=round_to_inf,
        before=before, after=after, initial_begin=initial_begin,
        initial_end=initial_end, min_speed=min_speed, max_speed=max_speed)
    lib = _build.load().lib
    entry, counter = ((lib.beam_loop_f32, launches) if which == "resident"
                      else (lib.beam_loop_ws_f32, launches_ws))
    entry.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    entry.restype = ctypes.c_int
    with torch.cuda.device(dev):
        status = entry(ctypes.byref(args), _build.stream_of(pre))
    _build.check(status, entry.__name__)
    counter.count += 1
    return done_out, done_meta, steps


def beam_search_loop(pre, attended, att_mask, tables, *, instance=None,
                     **kwargs):
    """Run the full decode loop; same arguments as the plain version.  On
    the card ``instance="resident"`` or ``"workspace"`` names the kernel
    instance in place of :func:`route` (tests and ``chip_smoke.py``); the
    CPU's plain version has one route."""
    device = pre.device.type
    if device == "cpu":
        return beam_search_loop_reference(pre, attended, att_mask, tables,
                                          **kwargs)
    if device == "cuda":
        return _launch(pre, attended, att_mask, tables, instance=instance,
                       **kwargs)
    raise ValueError(f"beam_search_loop: no kernel for device {pre.device}")


# ---- the workspace instances' selection alone (chip_smoke.py phase 25f) --

def beam_select_reference(costs):
    """Plain version of the kernel's selection over each of G grids of K x
    V candidates (``costs`` (G, K, V) float32): the K lowest entries by
    (cost, flat index k*V + v) among those below ``BIG`` (a stable sort;
    -0.0 and +0.0 equal), then, where fewer than K lie below ``BIG``, flat
    index 0 at cost ``BIG`` in every slot left (what K rounds of
    ``lex_min`` that mark their picks ``BIG`` take there).  Returns (src,
    sym, chosen), each (G, K)."""
    G, K, V = costs.shape
    flat = costs.reshape(G, K * V)
    below = flat < torch.tensor(BIG, dtype=flat.dtype)
    order = torch.sort(torch.where(below, flat, float("inf")), dim=1,
                       stable=True).indices[:, :K]
    live = torch.arange(K, device=costs.device)[None] < below.sum(
        dim=1, keepdim=True)
    idx = torch.where(live, order, 0)
    chosen = torch.where(live, flat.gather(1, idx),
                         torch.tensor(BIG, dtype=flat.dtype))
    return ((idx // V).to(torch.int32), (idx % V).to(torch.int32), chosen)


class _SelectArgs(ctypes.Structure):
    """Mirror of ``struct BeamSelectArgs`` in csrc/beam_loop_ws.cu."""
    _fields_ = ([(name, ctypes.c_void_p) for name in ("costs", "work",
                                                      "out")]
                + [(name, ctypes.c_int) for name in ("G", "K", "V")])


def beam_select(costs):
    """The workspace instances' one-pass selection (``select_k``) and the
    resident instances' K rounds (``block_argmin``) on each of G grids of
    K x V candidates, ``costs`` (G, K, V) float32, 1 <= K <= ``MAX_BEAM``:
    {"pass": (src, sym, chosen), "rounds": (...)}, each (G, K).  On the
    card one launch of ``csrc/beam_loop_ws.cu``'s test entry (a block a
    grid); on the CPU both from :func:`beam_select_reference`."""
    G, K, V = costs.shape
    if costs.device.type == "cpu":
        picks = beam_select_reference(costs)
        return {"pass": picks, "rounds": picks}
    if costs.device.type != "cuda":
        raise ValueError(f"beam_select: no kernel for device {costs.device}")
    if costs.dtype != torch.float32 or not costs.is_contiguous():
        raise ValueError("beam_select: costs must be contiguous float32")
    if not 1 <= K <= MAX_BEAM or G < 1 or V < 1:
        raise ValueError(f"beam_select: {G} grids of {K} x {V}")
    work = torch.empty_like(costs)
    out = torch.empty(G, 6, K, dtype=torch.int32, device=costs.device)
    args = _SelectArgs(costs=costs.data_ptr(), work=work.data_ptr(),
                       out=out.data_ptr(), G=G, K=K, V=V)
    lib = _build.load().lib
    entry = lib.beam_select_ws_test
    entry.argtypes = [ctypes.POINTER(_SelectArgs), ctypes.c_void_p]
    entry.restype = ctypes.c_int
    with torch.cuda.device(costs.device):
        status = entry(ctypes.byref(args), _build.stream_of(costs))
    _build.check(status, "beam_select_ws_test")
    launches_select.count += 1
    picks = lambda a: (out[:, a], out[:, a + 1], out[:, a + 2].view(
        torch.float32))
    return {"pass": picks(0), "rounds": picks(3)}


def selection_grids(K, V, seed=0):
    """Adversarial (K, V) float32 grids of candidate costs for the
    selection (``tests/test_torch_beam_select.py`` and ``chip_smoke.py``
    phase 25f): exact ties; +-0.0 among small values; the first step's
    rows (row 0 alive, every other at ``INF`` plus costs that round to
    one float32 value); relu's dropped rows at ``BIG`` (fewer than K
    candidates below it where K > V); every candidate at ``BIG``; and a
    mix of all with +inf entries.  Returns {name: array}."""
    import numpy as np
    rng = np.random.RandomState(seed + 1009 * K + V)
    f32 = np.float32
    grids = {
        "ties": rng.choice(np.array([0.5, 1.0, 1.5, 2.0], f32), (K, V)),
        "zeros": rng.choice(np.array([-0.0, 0.0, -1e-30, 1e-30, 0.25], f32),
                            (K, V)),
    }
    first = (f32(INF) + rng.rand(K, V).astype(f32) * f32(5.0)).astype(f32)
    first[0] = rng.rand(V).astype(f32) * f32(5.0)
    grids["inf_rows"] = first
    dropped = (rng.rand(K, V) * 4.0).astype(f32)
    keep = rng.rand(K) < 0.3
    keep[K // 2] = True
    if K > V:                       # fewer than K below BIG
        keep[:] = False
        keep[K // 2] = True
    dropped[~keep] = f32(BIG)
    grids["big_rows"] = dropped
    grids["all_big"] = np.full((K, V), BIG, f32)
    mixed = np.round(rng.rand(K, V) * 8.0).astype(f32) / f32(4.0)
    mixed[rng.rand(K, V) < 0.1] = -0.0
    mixed[rng.rand(K) < 0.2] = f32(BIG)
    mixed[rng.rand(K) < 0.2] += f32(INF)
    mixed[rng.rand(K, V) < 0.02] = np.inf
    grids["mixed"] = mixed.astype(f32)
    return grids
