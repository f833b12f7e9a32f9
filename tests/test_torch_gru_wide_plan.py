"""The wide GRU instances' layouts, routing and weight packing, on the CPU.

``ops/gru_scan.py`` and ``ops/gru_train.py`` mirror ``csrc/gru_wide.cuh``'s
layouts of the wide forward (``wide_layout``) and backward
(``bwd_wide_layout``), which keep the leading tiles of each block's
recurrent weight slice in shared memory and stream the rest from L2
through a ring of TMA-filled slots (``ring_layout``, ``ring_stream``), and
pick the instance of a width before any launch: the resident forward up to
D=448, the resident backward up to D=384, the wide ones up to D=1024,
nothing wider.  The card checks the C
layouts against these mirrors (``chip_smoke.py`` phase 24a,
``tests/test_torch_cuda_wide_gru.py``); here the mirrors are held to the
header's constants and to values worked out by hand, and the packed
weights to the products they stand for."""
import os
import re

import numpy as np
import pytest
import torch

from attention_lvcsr_torch.ops import gru_scan as gs
from attention_lvcsr_torch.ops import gru_train as gt

CSRC = os.path.join(os.path.dirname(gs.__file__), os.pardir, "csrc")


def test_mirror_constants_match_the_header():
    text = open(os.path.join(CSRC, "gru_wide.cuh")).read()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", text))
    assert int(consts["kWideMaxD"]) == gs.WIDE_MAX_D
    assert int(consts["kWideMax8"]) == gs.WIDE_MAX_8
    assert int(consts["kRingFloats"]) == gs.RING_FLOATS
    assert int(consts["kRingMinTiles"]) == gs.RING_MIN_TILES
    assert int(consts["kRingMaxTiles"]) == gs.RING_MAX_TILES
    assert int(consts["kRingChunk"]) == gs.RING_CHUNK
    assert int(consts["kRingBarFloats"]) == gs.RING_BAR_FLOATS
    train = open(os.path.join(CSRC, "gru_train.cu")).read()
    assert re.search(r"constexpr int kBwdCluster = (\d+);", train) \
        .group(1) == str(gt.BWD_CLUSTER)


# (D, cluster): n, Dp, gate / candidate slices, tile rows, bytes, fits;
# ring slots, resident gate and candidate tiles
@pytest.mark.parametrize("D,cluster,expected,ring", [
    (449, 16, (30, 480, 8, 8, 32, 64, 226176, True), (3, 6, 4)),
    (500, 16, (32, 512, 8, 8, 32, 64, 229760, True), (3, 6, 3)),
    (1000, 16, (64, 1024, 4, 8, 16, 32, 229760, True), (3, 0, 0)),
    (1024, 16, (64, 1024, 4, 8, 16, 32, 229760, True), (3, 0, 0)),
    (500, 8, (64, 512, 4, 8, 16, 32, 229760, True), (3, 5, 3)),
    # 8 blocks: the state and r * state outgrow a block's ring past D=992
    (992, 8, (124, 992, 2, 4, 8, 16, 231552, True), (2, 1, 0)),
    (1000, 8, (126, 1008, 2, 4, 8, 16, 226688, False), (2, 0, 0)),
])
def test_wide_layout(D, cluster, expected, ring):
    o = gs.wide_layout(D, cluster)
    assert (o["n"], o["Dp"], o["slices_g"], o["slices_c"], o["kt_g"],
            o["kt_c"], o["smem_bytes"], gs.wide_fits(D, cluster)) == expected
    r = o["ring"]
    assert (r["slots"], r["res0"], r["res1"]) == ring


# D: n, Dp, slices, tile rows, bytes; ring slots, resident reset-path and
# gate-path tiles
@pytest.mark.parametrize("D,expected,ring", [
    (385, (26, 416, 8, 72, 228288), (3, 5, 8)),
    (500, (32, 512, 8, 64, 231680), (3, 4, 6)),
    # eight slices' partial sums would pass a block by 1 KB: four
    (1000, (64, 1024, 4, 32, 225536), (2, 1, 0)),
])
def test_wide_backward_layout(D, expected, ring):
    o = gt.bwd_wide_layout(D)
    assert (o["n"], o["Dp"], o["slices"], o["kt"], o["smem_bytes"]) \
        == expected
    r = o["ring"]
    assert (r["slots"], r["res0"], r["res1"]) == ring


def test_every_wide_width_has_a_layout():
    """Every D in 449-1024 has a wide forward layout with 16-block
    clusters, every D in 385-1024 a wide backward one, each within a
    block's 232,448 bytes; the tiles are 16-byte copies of whole rows, the
    same rows for every k slice."""
    for D in range(449, 1025):
        assert gs.wide_fits(D, 16), D
        assert gs.wide_layout(D, 16)["smem_bytes"] <= gs.MAX_SMEM
    for D in range(385, 1025):
        assert gt.bwd_wide_fits(D), D
        assert gt.bwd_wide_layout(D)["smem_bytes"] <= gs.MAX_SMEM
    for D in range(1, 1025):
        for cluster in gs.CLUSTERS:
            o = gs.wide_layout(D, cluster)
            for cols, slices, kt in ((2 * o["n"], o["slices_g"], o["kt_g"]),
                                     (o["n"], o["slices_c"], o["kt_c"])):
                assert kt % slices == 0 and kt * cols % 4 == 0
                assert kt * cols <= gs.RING_FLOATS
        o = gt.bwd_wide_layout(D)
        assert o["kt"] % o["slices"] == 0 and o["kt"] * o["n"] % 4 == 0
        assert o["kt"] * o["n"] <= gs.RING_FLOATS
    # the 8-block layouts cover what they covered with the cp.async ring
    assert [D for D in range(1, 1025) if gs.wide_fits(D, 8)] == list(
        range(1, gs.WIDE_MAX_8 + 1))


def _layouts():
    """(name, layout, [(K, cols, kt)] of its two products, [(offset,
    floats)] of its buffers in order) of every wide layout that fits."""
    out = []
    for cluster in gs.CLUSTERS:
        for D in range(449, 1025):
            if not gs.wide_fits(D, cluster):
                continue
            o = gs.wide_layout(D, cluster)
            n, Dp, off = o["n"], o["Dp"], o["offsets"]
            bufs = [(off["h"], Dp * 16), (off["rh"], Dp * 16),
                    (off["z"], 16 * n), (off["stage"], 3 * 16 * n + 32),
                    (off["part"], max(2 * o["slices_g"], o["slices_c"])
                     * 16 * n)]
            out.append((f"fwd D={D} C={cluster}", o,
                        [(Dp, 2 * n, o["kt_g"]), (Dp, n, o["kt_c"])], bufs))
    for D in range(385, 1025):
        o = gt.bwd_wide_layout(D)
        n, Dp, off = o["n"], o["Dp"], o["offsets"]
        bufs = [(off["big"], 2 * Dp * 16), (off["oa"], 16 * n),
                (off["og"], 2 * 16 * n), (off["stage"], 6 * 16 * n),
                (off["part"], o["slices"] * 16 * n)]
        out.append((f"bwd D={D}", o, [(Dp, n, o["kt"]), (2 * Dp, n, o["kt"])],
                    bufs))
    return out


def test_ring_regions_do_not_overlap_and_copies_are_16_byte():
    """Every wide layout: the buffers, the ring's state and mbarriers, its
    slots and the resident tiles lie one after another without overlap
    within a block's 232,448 bytes, every region and every mbarrier on a
    16- and 8-byte boundary; every bulk copy (each product's resident
    tiles, each chunk of the stream) starts and ends on 16 bytes, in
    global memory (from a block's pack) and in the slot it fills, and no
    chunk passes its slot."""
    for name, o, prods, bufs in _layouts():
        r = o["ring"]
        assert r["slots"] * gs.RING_CHUNK >= gs.RING_MIN_TILES, name
        assert r["slots"] * gs.RING_CHUNK <= gs.RING_MAX_TILES, name
        (K0, c0, kt0), (K1, c1, kt1) = prods
        regions = bufs + [
            (r["bar"], gs.RING_BAR_FLOATS),
            (r["ring"], r["slots"] * gs.RING_CHUNK * gs.RING_FLOATS),
            (r["res"], min(r["res0"] * kt0, K0) * c0),
            (r["res2"], min(r["res1"] * kt1, K1) * c1)]
        at = 0
        for start, size in regions:
            assert start == at and start % 4 == 0 and size % 4 == 0, name
            at = start + size
        assert at == r["total"] and 4 * at <= gs.MAX_SMEM, name
        # the state (24 floats), the resident tiles' barrier, then the
        # slots' full and empty barriers, 8 bytes each
        barriers = [r["bar"] + 24 + 2 * i
                    for i in range(1 + 2 * gs.RING_MAX_TILES)]
        assert all(4 * b % 8 == 0 for b in barriers)
        assert barriers[-1] + 2 <= r["bar"] + gs.RING_BAR_FLOATS
        # a block's pack holds product 0 then product 1, k-major
        pack = 3 * o["Dp"] * o["n"]
        assert (4 * pack) % 16 == 0 and (4 * K0 * c0) % 16 == 0
        for rows, cols in ((min(r["res0"] * kt0, K0), c0),
                           (min(r["res1"] * kt1, K1), c1)):
            assert 4 * rows * cols % 16 == 0, name
        for which, t0, tiles in gs.ring_stream(K0, kt0, r["res0"],
                                               K1, kt1, r["res1"]):
            K, cols, kt = prods[which]
            rows = min(tiles * kt, K - t0 * kt)
            assert rows > 0 and 4 * rows * cols % 16 == 0, name
            assert 4 * t0 * kt * cols % 16 == 0, name
            assert rows * cols <= gs.RING_CHUNK * gs.RING_FLOATS, name


@pytest.mark.parametrize("D", [449, 500, 992, 1000, 1024])
def test_resident_then_streamed_give_back_each_slice(D):
    """A block's resident tiles followed by the ring's chunks, copied as
    the kernel copies them, give back each product of its packed slice
    whole, and each k slice's rows come in the parent's order: tile after
    tile, within a tile the slice's rows (so every output's fmaf chain is
    the parent's).  Both cluster sizes of the forward where they fit, and
    the backward."""
    rng = np.random.RandomState(D)
    layouts = []
    for cluster in gs.CLUSTERS:
        if gs.wide_fits(D, cluster):
            o = gs.wide_layout(D, cluster)
            layouts.append((o, [(o["Dp"], 2 * o["n"], o["kt_g"],
                                 o["slices_g"]),
                                (o["Dp"], o["n"], o["kt_c"],
                                 o["slices_c"])]))
    o = gt.bwd_wide_layout(D)
    layouts.append((o, [(o["Dp"], o["n"], o["kt"], o["slices"]),
                        (2 * o["Dp"], o["n"], o["kt"], o["slices"])]))
    for o, prods in layouts:
        r = o["ring"]
        packs = [rng.randn(K * cols) for K, cols, _, _ in prods]
        got = [list(pk[:min(res * kt, K) * cols])
               for pk, (K, cols, kt, _), res in zip(
                   packs, prods, (r["res0"], r["res1"]))]
        order = [[list(range(min(res, -(-K // kt))))] for (K, _, kt, _), res
                 in zip(prods, (r["res0"], r["res1"]))]
        for which, t0, tiles in gs.ring_stream(
                *[v for (K, cols, kt, _), res in zip(
                    prods, (r["res0"], r["res1"])) for v in (K, kt, res)]):
            K, cols, kt, _ = prods[which]
            rows = min(tiles * kt, K - t0 * kt)
            got[which] += list(packs[which][t0 * kt * cols:
                                            (t0 * kt + rows) * cols])
            order[which].append(list(range(t0, t0 + tiles)))
        for pk, g, (K, cols, kt, slices), tiles in zip(packs, got, prods,
                                                       order):
            assert np.array_equal(np.array(g), pk)
            walk = [t for run in tiles for t in run]
            assert walk == list(range(-(-K // kt)))
            per = kt // slices
            for q in range(slices):
                rows = [k for t in walk
                        for k in range(t * kt + q * per,
                                       min(t * kt + (q + 1) * per, K))]
                assert rows == sorted(rows)


def test_wider_than_1024_is_refused():
    assert not gs.wide_fits(1025, 16) and not gt.bwd_wide_fits(1025)
    with pytest.raises(NotImplementedError, match=r"D=1025 .* up to 1024"):
        gs.route(1025)
    with pytest.raises(NotImplementedError, match=r"D=1025 .* up to 1024"):
        gt.backward_route(1025)


def test_router_picks_resident_where_the_weights_fit():
    assert [gs.route(D) for D in range(1, 449)] == ["resident"] * 448
    assert [gs.route(D) for D in range(449, 1025)] == ["wide"] * 576
    assert [gt.backward_route(D) for D in range(1, 385)] == \
        ["resident"] * 384
    assert [gt.backward_route(D) for D in range(385, 1025)] == \
        ["wide"] * 640
    # the resident backward's own mirror: it ends at 384
    assert [gt.bwd_layout(D)["smem_bytes"] for D in (250, 384, 385)] == [
        112640, 205824, 232960]
    assert gt.bwd_fits(384) and not gt.bwd_fits(385)
    assert gs.kernel_name(448) == "gru_scan"
    assert gs.kernel_name(449) == "gru_scan_wide"


@pytest.mark.parametrize("D,active,chosen", [
    (500, {16: 7, 8: 15}, 8),     # the decode at B=64: one wave of 8
    (1000, {16: 7, 8: 0}, 16),    # 8 blocks do not fit D=1000
])
def test_wide_cluster_choice(monkeypatch, D, active, chosen):
    seen = []
    monkeypatch.setattr(gs, "query_active_clusters",
                        lambda kernel, D, device: seen.append(kernel)
                        or active)
    plan = gs.launch_plan(D, 64, 2, None)
    assert seen == ["gru_scan_wide"]
    assert (plan["clusters"], plan["cluster"]) == (8, chosen)


@pytest.mark.parametrize("D,cluster", [(37, 16), (449, 16), (500, 8),
                                       (1000, 16)])
def test_pack_forward_holds_each_blocks_columns(D, cluster):
    """Block j's packed slice times the padded state gives the gate and
    candidate pre-activations of its owned columns, zero past D."""
    rng = np.random.RandomState(D)
    ws = torch.tensor(rng.randn(D, D))
    wg = torch.tensor(rng.randn(D, 2 * D))
    o = gs.wide_layout(D, cluster)
    n, Dp = o["n"], o["Dp"]
    pack = gs.pack_forward(ws, wg, cluster)
    assert tuple(pack.shape) == (cluster, 3 * Dp * n)
    h = torch.tensor(rng.randn(3, D))
    hp = torch.nn.functional.pad(h, (0, Dp - D))
    gates, state = h @ wg, h @ ws
    for j in range(cluster):
        g = hp @ pack[j, :2 * Dp * n].view(Dp, 2 * n)
        s = hp @ pack[j, 2 * Dp * n:].view(Dp, n)
        k = max(0, min(D, (j + 1) * n) - j * n)
        torch.testing.assert_close(g[:, :k], gates[:, j * n:j * n + k])
        torch.testing.assert_close(g[:, n:n + k],
                                   gates[:, D + j * n:D + j * n + k])
        torch.testing.assert_close(s[:, :k], state[:, j * n:j * n + k])
        assert not g[:, k:n].any() and not g[:, n + k:].any()
        assert not s[:, k:].any()


@pytest.mark.parametrize("D", [37, 385, 1000])
def test_pack_backward_holds_each_blocks_rows(D):
    """Block j's packed slice gives the transposed products of its owned
    columns: da @ w_state^T and [du | dr] @ w_gates^T."""
    rng = np.random.RandomState(D)
    ws = torch.tensor(rng.randn(D, D))
    wg = torch.tensor(rng.randn(D, 2 * D))
    o = gt.bwd_wide_layout(D)
    n, Dp = o["n"], o["Dp"]
    pack = gt.pack_backward(ws, wg)
    assert tuple(pack.shape) == (gt.BWD_CLUSTER, 3 * Dp * n)
    da, du, dr = (torch.tensor(rng.randn(3, D)) for _ in range(3))
    pad = lambda x: torch.nn.functional.pad(x, (0, Dp - D))
    reset = da @ ws.T
    gate = du @ wg[:, :D].T + dr @ wg[:, D:].T
    for j in range(gt.BWD_CLUSTER):
        a = pad(da) @ pack[j, :Dp * n].view(Dp, n)
        b = torch.cat([pad(du), pad(dr)], 1) @ pack[j, Dp * n:].view(
            2 * Dp, n)
        k = max(0, min(D, (j + 1) * n) - j * n)
        torch.testing.assert_close(a[:, :k], reset[:, j * n:j * n + k])
        torch.testing.assert_close(b[:, :k], gate[:, j * n:j * n + k])
        assert not a[:, k:].any() and not b[:, k:].any()
