"""The forward GRU kernel's launch plan, on the CPU.

``ops/gru_scan.py`` mirrors ``csrc/gru_pull.cuh``'s shared-memory layout
of the forward kernel (owned columns n, padded width Dp, the products' k
slices, a block's bytes) and picks the cluster size of a launch from the
number of clusters it needs and how many of each size the card holds at
once.  A layout that does not fit a block's 227 KB is refused, so the
widest width covered is D=448 with 16-block clusters and D=256 with 8.
The card checks the C layout against this mirror (``chip_smoke.py``
phase 2); here the mirror is held to values worked out by hand and to
the header's constants."""
import os
import re

import pytest

from attention_lvcsr_torch.ops import gru_scan as gs

CSRC = os.path.join(os.path.dirname(gs.__file__), os.pardir, "csrc")


def test_mirror_constants_match_the_header():
    text = open(os.path.join(CSRC, "gru_pull.cuh")).read()
    consts = dict(re.findall(r"constexpr int (\w+) = ([\d /]+);", text))
    assert int(consts["kGroupRows"]) == gs.GROUP_ROWS
    assert int(consts["kClusterThreads"]) == gs.THREADS
    assert int(consts["kTileRows"]) == gs.TILE_ROWS
    assert int(consts["kTileCols"]) == gs.TILE_COLS
    assert int(consts["kMaxSlices"]) == gs.MAX_SLICES
    assert consts["kMaxSmemFloats"].split() == [str(gs.MAX_SMEM), "/", "4"]


# (D, cluster): n, Dp, gate slices, candidate slices, bytes, fits
@pytest.mark.parametrize("D,cluster,expected", [
    (250, 16, (16, 256, 8, 8, 103424, True)),
    (250, 8, (32, 256, 8, 8, 174080, True)),
    (330, 16, (22, 352, 8, 8, 167552, True)),
    (384, 16, (24, 384, 8, 8, 192000, True)),
    # the slices halve until the layout fits
    (448, 16, (28, 448, 4, 4, 231168, True)),
    (460, 16, (30, 480, 1, 1, 247680, False)),
    # 8 blocks: a thread finishes one candidate item, 16 n <= 512
    (256, 8, (32, 256, 8, 8, 174080, True)),
    (330, 8, (42, 336, 1, 1, 231168, False)),
])
def test_layout(D, cluster, expected):
    o = gs.fwd_layout(D, cluster)
    assert (o["n"], o["Dp"], o["slices_g"], o["slices_c"], o["smem_bytes"],
            gs.fits(D, cluster)) == expected


@pytest.mark.parametrize("cluster,widest", [(16, 448), (8, 256)])
def test_widest_width_covered(cluster, widest):
    assert gs.fits(widest, cluster) and not gs.fits(widest + 1, cluster)
    assert all(gs.fits(D, cluster) for D in range(1, widest + 1))
    # wsj_pyramide.yaml's widths stay refused
    assert not any(gs.fits(D, cluster) for D in (500, 1000))


@pytest.mark.parametrize("clusters,active,chosen", [
    (4, {16: 7, 8: 16}, 16),      # the training forward, B=32
    (8, {16: 8, 8: 16}, 16),      # the decode, B=64: one wave of either
    (8, {16: 7, 8: 16}, 8),       # ... two waves of 16
    (16, {16: 7, 8: 16}, 8),      # B=128
    (32, {16: 7, 8: 16}, 8),      # B=256: two waves of 8, five of 16
    (32, {16: 16, 8: 16}, 16),    # a tie in waves takes the larger
    (8, {16: 7, 8: 0}, 16),       # D > 256: only 16 fits
])
def test_cluster_choice(clusters, active, chosen):
    assert gs.choose_cluster(clusters, active) == chosen


def test_no_cluster_size_fits():
    with pytest.raises(NotImplementedError, match="no cluster size"):
        gs.choose_cluster(8, {16: 0, 8: 0})


@pytest.mark.parametrize("B,ndir,clusters", [(32, 2, 4), (35, 2, 6),
                                             (64, 1, 4), (256, 2, 32)])
def test_launch_plan_counts_clusters(monkeypatch, B, ndir, clusters):
    monkeypatch.setattr(gs, "max_active_clusters",
                        lambda D, device: {16: 7, 8: 16})
    plan = gs.launch_plan(250, B, ndir, None)
    assert plan["clusters"] == clusters
    assert plan["cluster"] == (16 if clusters <= 7 else 8)
