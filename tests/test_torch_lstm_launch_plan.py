"""The LSTM kernels' launch plans, on the CPU.

``ops/lstm_scan.py`` mirrors the shared-memory layout of the forward
kernel (``csrc/lstm_scan.cu::lstm_layout``: owned columns n, padded width
Dp, the product's k slices, a block's bytes) and picks its cluster size
per launch as the GRU forward does; ``ops/lstm_train.py`` mirrors the
backward kernel's layout (``csrc/lstm_train.cu::bwd_layout``, 16-block
clusters, each block's product split by k over its own gate columns).  A layout that does not fit a block's 227 KB is refused, so the
widest widths covered are D=384 forward with 16-block clusters, D=256 with
8, and D=352 backward.  The card checks the C layouts against these
mirrors (``chip_smoke.py`` phase 16); here the mirrors are held to values
worked out by hand and to the headers' constants."""
import os
import re

import pytest

from attention_lvcsr_torch.ops import gru_scan as gs
from attention_lvcsr_torch.ops import lstm_scan as ls
from attention_lvcsr_torch.ops import lstm_train as lt

CSRC = os.path.join(os.path.dirname(ls.__file__), os.pardir, "csrc")


def _constants(name):
    text = open(os.path.join(CSRC, name)).read()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);",
                                             text)}


def test_mirror_constants_match_the_headers():
    assert _constants("lstm_scan.cu")["kOperands"] == ls.OPERANDS
    bwd = _constants("lstm_train.cu")
    assert (bwd["kBwdCluster"], bwd["kBwdOperands"]) == \
        (lt.BWD_CLUSTER, lt.BWD_OPERANDS)
    # both kernels build on gru_pull.cuh and no longer on the push design's
    # header, which is gone
    for name in ("lstm_scan.cu", "lstm_train.cu"):
        text = open(os.path.join(CSRC, name)).read()
        assert '#include "gru_pull.cuh"' in text
        assert "gru_cluster" not in text
    assert not os.path.exists(os.path.join(CSRC, "gru_cluster.cuh"))


# (D, cluster): n, Dp, slices, bytes, fits
@pytest.mark.parametrize("D,cluster,expected", [
    (250, 16, (16, 256, 8, 136192, True)),
    (250, 8, (32, 256, 4, 206848, True)),
    (275, 16, (18, 288, 7, 157824, True)),
    (300, 16, (20, 320, 6, 180480, True)),
    # the slices halve until the layout fits
    (384, 16, (24, 384, 4, 228864, True)),
    (385, 16, (26, 416, 1, 241280, False)),
    # 8 blocks: a thread finishes one item, 16 n <= 512
    (256, 8, (32, 256, 4, 206848, True)),
    (275, 8, (36, 288, 1, 223488, False)),
])
def test_forward_layout(D, cluster, expected):
    o = ls.fwd_layout(D, cluster)
    assert (o["n"], o["Dp"], o["slices"], o["smem_bytes"],
            ls.fits(D, cluster)) == expected


# D: n, Dp, slices, bytes, fits
@pytest.mark.parametrize("D,expected", [
    # the product's 16 x Dp outputs take 256 (two k slices) or more threads
    (250, (16, 256, 2, 143360, True)),
    (275, (18, 288, 1, 152064, True)),
    (300, (20, 320, 1, 179200, True)),
    (352, (22, 352, 1, 208384, True)),
    (353, (24, 384, 1, 239616, False)),
])
def test_backward_layout(D, expected):
    o = lt.bwd_layout(D)
    assert (o["n"], o["Dp"], o["slices"], o["smem_bytes"],
            lt.bwd_fits(D)) == expected


@pytest.mark.parametrize("covers,widest", [
    (lambda D: ls.fits(D, 16), 384), (lambda D: ls.fits(D, 8), 256),
    (lt.bwd_fits, 352)])
def test_widest_width_covered(covers, widest):
    assert ls.widest(covers) == widest
    assert all(covers(D) for D in range(1, widest + 1))
    assert not any(covers(D) for D in (widest + 1, 500, 1000))


def test_the_first_designs_widths_stay_covered():
    """The push design covered the forward up to about D=300 and the
    backward up to about D=275."""
    assert ls.widest(lambda D: ls.fits(D, 16)) >= 300
    assert ls.widest(lt.bwd_fits) >= 275


class _Lib:
    """A stand-in for the kernel library whose width query answers
    ``status``."""

    def __init__(self, status):
        self.lstm_scan_supported = lambda D: status
        self.lstm_train_supported = lambda D: status


@pytest.mark.parametrize("query,name,covers,limit", [
    ("lstm_scan_supported", "lstm_scan", lambda D: ls.fits(D, 16), 384),
    ("lstm_train_supported", "lstm_scan_train", lt.bwd_fits, 352)])
def test_a_width_past_the_limit_names_it(query, name, covers, limit):
    ls.require_width(_Lib(1), query, name, limit, covers)
    with pytest.raises(NotImplementedError,
                       match=rf"{name}: width D={limit + 1} .*16-block "
                             rf"cluster.* up to D={limit}\)"):
        ls.require_width(_Lib(0), query, name, limit + 1, covers)


@pytest.mark.parametrize("B,ndir,active,clusters,chosen", [
    (32, 2, {16: 7, 8: 15}, 4, 16),     # the training forward
    (64, 2, {16: 7, 8: 15}, 8, 8),      # the decode: two waves of 16
    (64, 1, {16: 7, 8: 15}, 4, 16),
    (35, 2, {16: 7, 8: 15}, 6, 16),
    (256, 2, {16: 7, 8: 15}, 32, 8),    # three waves of 8, five of 16
    (64, 2, {16: 7, 8: 0}, 8, 16),      # D > 256: only 16 fits
])
def test_launch_plan(monkeypatch, B, ndir, active, clusters, chosen):
    monkeypatch.setattr(ls, "max_active_clusters", lambda D, device: active)
    plan = ls.launch_plan(250, B, ndir, None)
    assert (plan["clusters"], plan["cluster"]) == (clusters, chosen)


def test_no_cluster_size_fits(monkeypatch):
    monkeypatch.setattr(ls, "max_active_clusters",
                        lambda D, device: {16: 0, 8: 0})
    with pytest.raises(NotImplementedError, match="lstm_scan: no cluster"):
        ls.launch_plan(400, 32, 2, None)
    assert gs.choose_cluster(4, {16: 7, 8: 15}, "lstm_scan") == 16
