"""The whole-loop decode kernel's plan, on the CPU.

``ops/beam_loop.py`` mirrors ``csrc/beam_loop_body.cuh``'s shared-memory layout
(every buffer on a 16-byte boundary, so the products' float2 loads along
a row of even pitch are aligned) and ``csrc/beam_products.cuh``'s split
of a product over the block: a thread owns a column pair and a row group
of at most 8 rows, the groups interleaved along the thread index.  Here
the mirror is held to the sources' constants and to what the kernel
needs: every output of every product computed exactly once, all 512
threads busy at the flagship widths, the flagship shape fitting an H100
block and a larger one refused.  The card holds the C layout to this
mirror (``chip_smoke.py`` phase 3, ``tests/test_torch_cuda.py``)."""
import os
import re

import pytest

from attention_lvcsr_torch.ops import beam_loop as bl

CSRC = os.path.join(os.path.dirname(bl.__file__), os.pardir, "csrc")
# flagship widths (``__graft_entry__.FLAGSHIP_NET``, 800 frames, beam 10)
FLAGSHIP = dict(K=10, L=200, M=250, D=500, S=250, R=250, V=32, F=250,
                Lout=100, n_taps=201)
PHASES = (("conv", "sp"), ("act", "costs"),
          ("hs", "was", "aout2", "dout2", "fb", "gi", "it"))


def _constants(name):
    text = open(os.path.join(CSRC, name)).read()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);",
                                             text)}


def test_mirror_constants_match_the_sources():
    loop, products = _constants("beam_loop_body.cuh"), _constants(
        "beam_products.cuh")
    assert loop["kThreads"] == products["kProdThreads"] == bl.THREADS
    assert loop["kMaxBeam"] == bl.MAX_BEAM
    assert products["kMaxGroupRows"] == bl.MAX_GROUP_ROWS
    # the kernel dispatches row groups of 1-6 and 8 rows
    text = open(os.path.join(CSRC, "beam_products.cuh")).read()
    assert sorted(map(int, re.findall(r"product_rows<(\d)>", text))) == [
        1, 2, 3, 4, 5, 6, 8]


def _items(nrows, N):
    """Per (pass, thread): its rows and columns, as ``product_rows`` in
    ``csrc/beam_products.cuh`` computes them (groups interleave along the
    thread index)."""
    units, groups, _, passes = bl.product_plan(nrows, N)
    base, extra = divmod(nrows, groups)
    items = {}
    for item in range(units * groups):
        q, c = item % groups, 2 * (item // groups)
        r0 = q * base + min(q, extra)
        nr = base + (1 if q < extra else 0)
        items[divmod(item, bl.THREADS)] = (range(r0, r0 + nr),
                                           range(c, min(c + 2, N)))
    return items


def _check_cover(K, N):
    units, groups, rows, passes = bl.product_plan(K, N)
    seen = {}
    for (pas, thread), (rs, cs) in _items(K, N).items():
        assert 0 <= thread < bl.THREADS and pas < passes
        assert 1 <= len(rs) <= rows <= bl.MAX_GROUP_ROWS
        assert cs.start % 2 == 0 and len(cs) in (1, 2)
        for r in rs:
            for c in cs:
                seen[r, c] = seen.get((r, c), 0) + 1
    assert seen == {(r, c): 1 for r in range(K) for c in range(N)}
    return passes


@pytest.mark.parametrize("K", [1, 4, 8, 10, 12, 16])
@pytest.mark.parametrize("N", [32, 33, 250, 500])
def test_every_output_is_computed_once(K, N):
    assert _check_cover(K, N) == 1


@pytest.mark.parametrize("K,N,passes", [(10, 660, 2), (16, 1100, 3),
                                        (1, 1100, 2)])
def test_wide_products_take_several_passes(K, N, passes):
    assert _check_cover(K, N) == passes


@pytest.mark.parametrize("N,groups,sizes,busy", [
    (500, 2, [5, 5], 500),            # 2S, D
    (250, 4, [3, 3, 2, 2], 500),      # S, M, R
    (32, 10, [1] * 10, 160),          # V: one row a group
])
def test_flagship_splits(N, groups, sizes, busy):
    units, got, rows, passes = bl.product_plan(10, N)
    assert (got, rows, passes) == (groups, max(sizes), 1)
    per_group = {}
    for (_, thread), (rs, _) in _items(10, N).items():
        per_group[thread % groups] = len(rs)
    assert [per_group[g] for g in range(groups)] == sizes
    assert len(_items(10, N)) == busy


@pytest.mark.parametrize("K,nbytes", [(10, 136320), (12, 162720),
                                      (16, 215696)])
def test_flagship_layout_fits(K, nbytes):
    plan = bl.smem_plan(**dict(FLAGSHIP, K=K))
    assert plan["fits"] and plan["smem_bytes"] == nbytes
    offsets = plan["offsets"]
    assert all(off % 4 == 0 for off in offsets.values())


@pytest.mark.parametrize("shape", [FLAGSHIP, dict(
    K=10, L=30, M=13, D=66, S=33, R=17, V=9, F=15, Lout=8, n_taps=5)])
def test_buffers_do_not_overlap(shape):
    plan = bl.smem_plan(**shape)
    K, o = shape["K"], plan["offsets"]
    size = dict(h=K * shape["S"], w=K * shape["L"], aout=K * shape["Lout"],
                dout=K * shape["Lout"], mask=shape["L"],
                taps=shape["n_taps"], handler=shape["M"], v=shape["M"],
                red_v=bl.THREADS // 32 + 1, red_i=bl.THREADS // 32 + 1,
                wn=K * shape["L"], wa=K * shape["D"], conv=K * shape["L"],
                sp=K * shape["M"], act=K * shape["R"], costs=K * shape["V"],
                hs=K * shape["S"], was=K * shape["D"],
                aout2=K * shape["Lout"], dout2=K * shape["Lout"],
                fb=K * shape["F"], gi=2 * K * shape["S"], it=K * shape["S"])
    scratch = {name for phase in PHASES for name in phase}
    persistent = [name for name in o if name not in scratch]
    for phase in PHASES:
        spans = sorted((o[n], o[n] + size.get(n, K))
                       for n in persistent + list(phase))
        for (_, end), (start, _) in zip(spans, spans[1:]):
            assert end <= start
        assert spans[-1][1] * 4 <= plan["smem_bytes"]


@pytest.mark.parametrize("shape", [
    dict(FLAGSHIP, S=500, M=500, R=500, F=500, D=1000),
    dict(FLAGSHIP, K=32),
])
def test_a_shape_that_cannot_fit_is_refused(shape):
    plan = bl.smem_plan(**shape)
    assert not plan["fits"] and plan["smem_bytes"] > bl.SMEM_LIMIT
