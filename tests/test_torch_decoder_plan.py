"""The teacher-forced decoder kernels' launch plan, on the CPU.

``ops/decoder_train.py`` mirrors ``csrc/decoder_train.cu``'s plan: the
clusters a launch takes and the rows each serves, block j's frame tile and
column slices, the rows whose tiles stay in shared memory, the shared-memory
layout, and the packing of each weight's column slices that the kernels'
products read.  The card holds the C layout to this mirror
(``chip_smoke.py`` phase 12); here the mirror is held to the header's
constants, to ownership and layout rules, and the packed slices to the
plain weight products."""
import os
import re

import numpy as np
import pytest
import torch

from attention_lvcsr_torch.ops import decoder_train as dt

CSRC = os.path.join(os.path.dirname(dt.__file__), os.pardir, "csrc")
# cudaOccupancyMaxActiveClusters of an H100 SXM at one block an SM
H100 = {16: 7, 8: 15, 4: 30}
FLAGSHIP = dict(L=200, M=250, D=500, S=250)


def test_mirror_constants_match_the_header():
    text = open(os.path.join(CSRC, "decoder_train.cu")).read()
    consts = dict(re.findall(r"constexpr int (\w+) = ([\w /]+);", text))
    assert int(consts["kThreads"]) == dt.THREADS
    assert consts["kWarps"].split() == ["kThreads", "/", "32"]
    assert dt.WARPS == dt.THREADS // 32
    assert int(consts["kMaxRows"]) == dt.MAX_ROWS
    assert int(consts["kRowChunk"]) == dt.ROW_CHUNK
    assert int(consts["kMaxSlices"]) == dt.MAX_SLICES
    assert consts["kMaxSmemFloats"].split() == [str(dt.MAX_SMEM), "/", "4"]
    sizes = re.search(r"cluster == 4 \|\| a.cluster == 8 \|\| a.cluster == 16",
                      text)
    assert sizes and sorted(dt.CLUSTERS) == [4, 8, 16]


def _owners(kind, B, L, M, D, S, active):
    """Per (row, frame), (row, S, M and D column): how many blocks own it."""
    p = dt.plan(kind, B, L, M, D, S, active)
    d = dt.dims(p["cluster"], p["rows"], L, M, D, S)
    frames = np.zeros((B, L), int)
    cols = {n: np.zeros((B, w), int) for n, w in
            (("S", S), ("M", M), ("D", D))}
    rows = dt.cluster_rows(B, p["clusters"])
    assert len(rows) == p["clusters"] and p["blocks"] == \
        p["clusters"] * p["cluster"]
    for b0, nr in rows:
        assert 1 <= nr <= p["rows"]
        for j in range(p["cluster"]):
            frames[b0:b0 + nr, j * d["Lt"]:(j + 1) * d["Lt"]] += 1
            for n, chunk in (("S", d["Sc"]), ("M", d["Mc"]), ("D", d["Dc"])):
                cols[n][b0:b0 + nr, j * chunk:(j + 1) * chunk] += 1
    return p, frames, cols


@pytest.mark.parametrize("kind", dt.KINDS)
@pytest.mark.parametrize("B", [1, 3, 32, 33, 64, 132])
@pytest.mark.parametrize("L", [10, 199, 200])
def test_every_row_frame_and_column_has_one_owner(kind, B, L):
    p, frames, cols = _owners(kind, B, L, 250, 500, 250, H100)
    assert (frames == 1).all()
    for n, owned in cols.items():
        assert (owned == 1).all(), n
    assert p["clusters"] <= H100[p["cluster"]]       # all co-resident


@pytest.mark.parametrize("kind", dt.KINDS)
@pytest.mark.parametrize("B,dims", [
    (32, FLAGSHIP), (64, FLAGSHIP), (132, FLAGSHIP), (1, FLAGSHIP),
    (5, dict(L=199, M=33, D=17, S=33)), (3, dict(L=10, M=7, D=9, S=5))])
def test_layout_fits_aligned_without_overlap(kind, B, dims):
    p = dt.plan(kind, B, active=H100, **dims)
    assert p["smem_bytes"] <= 232448
    res = {t: p[f"res_{t}"] for t in dt.TILES[kind]}
    lay = dt.layout(kind, p["cluster"], p["rows"], res=res, **dims)
    assert lay["smem_bytes"] == p["smem_bytes"]
    spans = sorted(lay["buffers"].values())
    for (at, n), (nxt, _) in zip(spans, spans[1:]):
        assert at % 4 == 0 and at + n <= nxt      # 16 bytes, no overlap
    assert spans[-1][0] + spans[-1][1] <= lay["floats"]
    # tile by tile, in the kind's order, as many rows as fit stay on chip
    kept = {}
    for t in dt.TILES[kind]:
        if res[t] < p["rows"]:
            more = dt.layout(kind, p["cluster"], p["rows"],
                             res={**kept, t: res[t] + 1}, **dims)
            assert more["smem_bytes"] > 232448, t
        kept[t] = res[t]


def test_one_row_keeps_every_tile_on_chip():
    for kind in dt.KINDS:
        p = dt.plan(kind, 1, active=H100, **FLAGSHIP)
        assert (p["cluster"], p["clusters"], p["rows"]) == (16, 1, 1)
        assert all(p[f"res_{t}"] == 1 for t in dt.TILES[kind])


@pytest.mark.parametrize("B,active,chosen", [
    (32, H100, (8, 15, 3)),           # 120 blocks, 2 or 3 rows a cluster
    (64, H100, (4, 30, 3)),
    (132, H100, (4, 30, 5)),
    (7, H100, (16, 7, 1)),            # one row a 16-block cluster
    (8, H100, (8, 8, 1)),
    (32, {16: 7, 8: 0, 4: 0}, (16, 7, 5)),
    (32, {16: 0, 8: 15, 4: 0}, (8, 15, 3)),
    (32, {16: 8, 8: 16, 4: 32}, (4, 32, 1)),
    (200, {16: 7, 8: 15, 4: 12}, (8, 15, 14)),   # 17 rows of 4 too many
])
def test_cluster_choice_follows_the_co_residency_counts(B, active, chosen):
    p = dt.plan("forward", B, active=active, **FLAGSHIP)
    assert (p["cluster"], p["clusters"], p["rows"]) == chosen
    assert p["clusters"] <= active[p["cluster"]]


def test_forced_plans():
    p = dt.plan("backward", 32, active=H100, cluster=4, **FLAGSHIP)
    assert (p["cluster"], p["clusters"], p["rows"]) == (4, 30, 2)
    p = dt.plan("forward", 32, active=H100, cluster=8, clusters=11,
                **FLAGSHIP)
    assert (p["clusters"], p["rows"], p["blocks"]) == (11, 3, 88)
    # more clusters than the card holds at once is no plan
    with pytest.raises(NotImplementedError):
        dt.plan("forward", 32, active=H100, cluster=8, clusters=16,
                **FLAGSHIP)


@pytest.mark.parametrize("B,active", [
    (32, {16: 0, 8: 0, 4: 0}),        # nothing co-resident
    (1000, H100),                     # more than 16 rows a cluster
])
def test_refusals_name_the_shape(B, active):
    with pytest.raises(NotImplementedError,
                       match=f"{B} rows at L=200, M=250, D=500, S=250"):
        dt.plan("forward", B, active=active, **FLAGSHIP)


def _weights(rng, L, M, D, S):
    f = lambda *s: torch.tensor(rng.randn(*s).astype(np.float32))
    return dict(toep=f(L, L), st=f(S, M), wss=f(S, S), wsg=f(S, 2 * S),
                dxm=f(D, S), dgm=f(D, 2 * S))


def _slice_product(x, P, cols):
    """The kernels' product: block j's outputs x @ P[j], placed at the
    source columns ``cols`` (block-major, -1 dropped)."""
    out = torch.einsum("rk,jkc->rjc", x, P.double()).reshape(x.shape[0], -1)
    keep = cols >= 0
    res = torch.zeros(x.shape[0], int(cols.max()) + 1, dtype=torch.float64)
    res[:, cols[keep]] = out[:, keep]
    return res


def _pad(x, parts):
    """x's column runs [(first, count, padded)] laid out with padding."""
    return torch.cat([torch.nn.functional.pad(x[:, a:a + c], (0, p - c))
                      for a, c, p in parts], dim=1)


@pytest.mark.parametrize("C", [4, 8, 16])
@pytest.mark.parametrize("L,M,D,S", [(200, 250, 500, 250), (13, 33, 17, 11)])
def test_packed_slices_give_the_plain_products(C, L, M, D, S):
    """Every weight column lands in exactly one block's packed slice, and
    the blocks' products over their slices (with the kernels' padded input
    vectors) give the plain products."""
    rng = np.random.RandomState(C + L)
    w = _weights(rng, L, M, D, S)
    d = dt.dims(C, 1, L, M, D, S)
    fwd = dt.pack_forward(d, **w)
    bwd = dt.pack_backward(d, **w)
    Sp, Dp = d["Sp"], d["Dp"]
    x = {n: torch.tensor(rng.randn(2, k)) for n, k in (
        ("L", L), ("S", S), ("D", D), ("M", M), ("S2", 2 * S), ("S3", 3 * S))}
    s_cols = dt._slice_columns(S, d["Sc"], C, d["Sc"])
    l_cols = dt._slice_columns(L, d["Lt"], C, d["Lq"])
    m_cols = dt._slice_columns(M, d["Mc"], C, d["Mc"])
    d_cols = dt._slice_columns(D, d["Dc"], C, d["Dc"])
    W = {k: v.double() for k, v in w.items()}
    close = lambda a, b: torch.testing.assert_close(a, b, rtol=1e-9,
                                                    atol=1e-9)
    for P, xs, cols, want in (
            (fwd["p_toep"], x["L"], l_cols, x["L"] @ W["toep"]),
            (fwd["p_st"], x["S"], m_cols, x["S"] @ W["st"]),
            (fwd["p_dx"], x["D"], s_cols, x["D"] @ W["dxm"]),
            (fwd["p_ss"], x["S"], s_cols, x["S"] @ W["wss"]),
            (bwd["p_ssT"], x["S"], s_cols, x["S"] @ W["wss"].T),
            (bwd["p_stT"], x["M"], s_cols, x["M"] @ W["st"].T),
            (bwd["p_toepT"], x["L"], l_cols, x["L"] @ W["toep"].T),
            (bwd["p_sgT"], _pad(x["S2"], [(0, S, Sp), (S, S, Sp)]),
             s_cols, x["S2"] @ W["wsg"].T),
            (bwd["p_dxgT"], _pad(x["S3"], [(0, S, Sp), (S, S, Sp),
                                           (2 * S, S, Sp)]),
             d_cols, x["S3"][:, :S] @ W["dxm"].T
             + x["S3"][:, S:] @ W["dgm"].T)):
        assert P.shape[0] == C and P.shape[2] % 4 == 0
        assert (torch.bincount(cols[cols >= 0]) == 1).all()
        close(_slice_product(xs, P, cols)[:, :want.shape[1]], want)
    assert torch.equal(bwd["p_st"], fwd["p_st"])
    assert torch.equal(bwd["p_toep"], fwd["p_toep"])
    # the gates: [wan | h] padded, [u | r] columns of each unit slice
    gin = torch.cat([torch.nn.functional.pad(x["D"], (0, Dp - D)),
                     torch.nn.functional.pad(x["S"], (0, Sp - S))], dim=1)
    out = torch.einsum("rk,jkc->rjc", gin, fwd["p_gate"].double())
    want = x["D"] @ W["dgm"] + x["S"] @ W["wsg"]
    Sc = d["Sc"]
    for j in range(C):
        n = max(0, min(S - j * Sc, Sc))
        close(out[:, j, :n], want[:, j * Sc:j * Sc + n])
        close(out[:, j, Sc:Sc + n], want[:, S + j * Sc:S + j * Sc + n])
        assert not out[:, j, n:Sc].any() and not out[:, j, Sc + n:].any()
