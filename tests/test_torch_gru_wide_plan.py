"""The wide GRU instances' layouts, routing and weight packing, on the CPU.

``ops/gru_scan.py`` and ``ops/gru_train.py`` mirror ``csrc/gru_wide.cuh``'s
layouts of the wide forward (``wide_layout``) and backward
(``bwd_wide_layout``), which stream each block's recurrent weight slice
from L2 through a ring of tiles, and pick the instance of a width before
any launch: the resident forward up to D=448, the resident backward up to
D=384, the wide ones up to D=1024, nothing wider.  The card checks the C
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
    assert int(consts["kRingStages"]) == gs.RING_STAGES
    assert int(consts["kRingFloats"]) == gs.RING_FLOATS
    train = open(os.path.join(CSRC, "gru_train.cu")).read()
    assert re.search(r"constexpr int kBwdCluster = (\d+);", train) \
        .group(1) == str(gt.BWD_CLUSTER)


# (D, cluster): n, Dp, gate / candidate slices, ring rows, bytes, fits
@pytest.mark.parametrize("D,cluster,expected", [
    (449, 16, (30, 480, 8, 8, 32, 64, 134528, True)),
    (500, 16, (32, 512, 8, 8, 32, 64, 141312, True)),
    (1000, 16, (64, 1024, 4, 8, 16, 32, 217088, True)),
    (1024, 16, (64, 1024, 4, 8, 16, 32, 217088, True)),
    (500, 8, (64, 512, 4, 8, 16, 32, 151552, True)),
    # 8 blocks: the state and r * state outgrow a block past D=992
    (992, 8, (124, 992, 2, 4, 8, 16, 231168, True)),
    (1000, 8, (126, 1008, 2, 4, 8, 16, 234368, False)),
])
def test_wide_layout(D, cluster, expected):
    o = gs.wide_layout(D, cluster)
    assert (o["n"], o["Dp"], o["slices_g"], o["slices_c"], o["kt_g"],
            o["kt_c"], o["smem_bytes"], gs.wide_fits(D, cluster)) == expected


# D: n, Dp, slices, ring rows, bytes
@pytest.mark.parametrize("D,expected", [
    (385, (26, 416, 8, 72, 114304)),
    (500, (32, 512, 8, 64, 133120)),
    # eight slices' partial sums would pass a block by 1 KB: four
    (1000, (64, 1024, 4, 32, 217088)),
])
def test_wide_backward_layout(D, expected):
    o = gt.bwd_wide_layout(D)
    assert (o["n"], o["Dp"], o["slices"], o["kt"], o["smem_bytes"]) \
        == expected


def test_every_wide_width_has_a_layout():
    """Every D in 449-1024 has a wide forward layout with 16-block
    clusters, every D in 385-1024 a wide backward one, each within a
    block's 232,448 bytes; the ring tiles are 16-byte copies of whole
    rows, the same rows for every k slice."""
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
