"""The workspace instances' one-pass selection (CPU).

``csrc/beam_loop_body.cuh::select_k`` replaces the K rounds of
``block_argmin`` with one pass: each candidate's key is its cost's
order-preserving bits (-0.0 folded into +0.0, NaN above every number),
the candidates rank by (key, flat index), the entries below ``BIG`` are
taken in that order and, where fewer than K lie below ``BIG``, every slot
left takes flat index 0 at cost ``BIG``.  Here:

* a numpy model of that key order and tail rule against a literal numpy
  transcription of JAX's ``sel_round`` K-round loop
  (``attention_lvcsr_tpu/ops/pallas/beam_loop.py:431-442``), on
  ``ops/beam_loop.py::selection_grids`` (exact ties, +-0.0, rows at
  ``INF``, relu's rows at ``BIG``, all at ``BIG``, a mix with +inf) at
  K in {1, 17, 18, 200, 512} and V in {5, 32}: the same source rows and
  symbols, equal costs;
* a numpy model of the kernel's algorithm (bisection over the keys, then
  over the tied flat indices, by exact counts; compaction; sort) against
  the key model: the same picks;
* the port's plain version (``beam_select_reference``, what
  ``beam_select`` runs on the CPU) against the key model, bit for bit;
* the order of the keys, and the tile shapes of the workspace products
  (``ring_plan``: every output owned by one thread of one tile)."""
import numpy as np
import pytest
import torch

from attention_lvcsr_tpu.ops.pallas import beam_loop as jax_loop
from attention_lvcsr_torch.ops import beam_loop as bl

BEAMS = (1, 17, 18, 200, 512)
WIDTHS = (5, 32)
GRIDS = ("ties", "zeros", "inf_rows", "big_rows", "all_big", "mixed")
BIG = np.float32(jax_loop.BIG)


def order_key(costs):
    """uint32 keys: -0.0 as +0.0, negative floats below positive ones,
    NaN above every number (``order_key``)."""
    u = np.ascontiguousarray(costs, np.float32).view(np.uint32).copy()
    u[(u << np.uint32(1)) == 0] = 0
    key = np.where(u >> np.uint32(31) == 1, ~u, u | np.uint32(0x80000000))
    key[np.isnan(costs)] = np.uint32(0xFFFFFFFF)
    return key.astype(np.uint32)


def key_model(costs):
    """(src, sym, chosen) by the key order and the tail rule."""
    K, V = costs.shape
    flat = costs.reshape(-1)
    key = order_key(flat).astype(np.uint64)
    below = np.nonzero(key < np.uint64(order_key(np.array([BIG]))[0]))[0]
    ranked = below[np.argsort((key[below] << np.uint64(32))
                              | below.astype(np.uint64), kind="stable")]
    idx = np.zeros(K, np.int64)
    n = min(K, len(ranked))
    idx[:n] = ranked[:n]
    chosen = np.where(np.arange(K) < n, flat[idx], BIG).astype(np.float32)
    return idx // V, idx % V, chosen


def jax_rounds(costs):
    """JAX's ``sel_round`` loop for one utterance, line for line in numpy:
    the minimum, the lowest flat index holding it, that entry set to
    BIG."""
    K, V = costs.shape
    work = costs.astype(np.float32).copy()
    flat_rv = np.arange(K * V).reshape(K, V)
    src = np.zeros(K, np.int64)
    sym = np.zeros(K, np.int64)
    chosen = np.zeros(K, np.float32)
    for slot in range(K):
        m = np.min(np.min(work, axis=1, keepdims=True))
        cand = np.where(work == m, flat_rv, K * V)
        idx = np.min(np.min(cand, axis=1, keepdims=True))
        work = np.where(flat_rv == idx, BIG, work)
        src[slot], sym[slot], chosen[slot] = idx // V, idx % V, m
    return src, sym, chosen


def kernel_model(costs):
    """``select_k``'s steps in numpy: the count of keys below BIG's; if it
    passes K, the least key kt with K keys at or below it (bisection by
    counts), then the least flat index it among the keys equal to kt that
    makes K; the winners (key, index) compacted in thread order and
    sorted; slots past them (kBig, 0)."""
    K, V = costs.shape
    flat = costs.reshape(-1)
    key = order_key(flat).astype(np.int64)
    j = np.arange(flat.size)
    big = int(order_key(np.array([BIG]))[0])
    below = int((key < big).sum())
    kt, it = big, -1
    if below > K:
        lo, hi = 0, big - 1
        while lo < hi:
            mid = lo + (hi - lo) // 2
            if int((key <= mid).sum()) >= K:
                hi = mid
            else:
                lo = mid + 1
        kt = lo
        a, b = 0, flat.size - 1
        while a < b:
            mid = a + (b - a) // 2
            if int(((key < kt) | ((key == kt) & (j <= mid))).sum()) >= K:
                b = mid
            else:
                a = mid + 1
        it = a
    won = (key < kt) | ((key == kt) & (j <= it))
    wins = min(K, below)
    assert int(won.sum()) == wins
    # thread t of 512 holds the indices t, t + 512, ...: the compacted
    # order is thread-major, and the sort orders it
    threads = 512
    packed = [(int(key[i]) << 32) | int(i)
              for t in range(threads) for i in range(t, flat.size, threads)
              if won[i]]
    packed.sort()
    idx = np.zeros(K, np.int64)
    idx[:wins] = [p & 0xFFFFFFFF for p in packed]
    chosen = np.where(np.arange(K) < wins, flat[idx], BIG).astype(np.float32)
    return idx // V, idx % V, chosen


CASES = [(K, V, g) for K in BEAMS for V in WIDTHS for g in GRIDS]
IDS = [f"K{K}-V{V}-{g}" for K, V, g in CASES]


@pytest.mark.parametrize("K,V,grid", CASES, ids=IDS)
def test_key_order_takes_the_rounds_picks(K, V, grid):
    costs = bl.selection_grids(K, V)[grid]
    src, sym, chosen = key_model(costs)
    j_src, j_sym, j_chosen = jax_rounds(costs)
    np.testing.assert_array_equal(src, j_src)
    np.testing.assert_array_equal(sym, j_sym)
    # JAX keeps the minimum's value, the kernel the winner's: equal,
    # though a +-0.0 tie may differ in sign
    np.testing.assert_array_equal(chosen, j_chosen)


@pytest.mark.parametrize("K,V,grid", CASES, ids=IDS)
def test_kernel_algorithm_takes_the_key_order(K, V, grid):
    costs = bl.selection_grids(K, V)[grid]
    for got, want in zip(kernel_model(costs), key_model(costs)):
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("K,V,grid", CASES, ids=IDS)
def test_plain_version_matches_the_key_order(K, V, grid):
    costs = bl.selection_grids(K, V)[grid]
    picks = bl.beam_select(torch.tensor(costs[None]))
    assert picks["pass"] is picks["rounds"]
    for got, want in zip(picks["pass"], key_model(costs)):
        assert got.numpy()[0].astype(want.dtype).tobytes() == want.tobytes()


def test_order_key_orders_floats():
    x = np.array([-np.inf, -3e38, -1.0, -1e-40, -0.0, 0.0, 1e-40, 1.0,
                  3e38, np.inf], np.float32)
    key = order_key(x)
    assert key[4] == key[5]
    assert np.all(np.diff(key.astype(np.int64))[[0, 1, 2, 3, 5, 6, 7, 8]]
                  > 0)
    assert order_key(np.array([np.nan, -np.nan], np.float32)).tolist() == [
        0xFFFFFFFF] * 2


@pytest.mark.parametrize("nrows,N", [(10, 500), (18, 500), (64, 500),
                                     (200, 250), (200, 500), (200, 32),
                                     (512, 1000), (512, 32), (201, 253),
                                     (40, 2000)])
def test_ring_tiles_own_every_output_once(nrows, N):
    """``ring_plan``'s tiles: 512 threads of 8 x 4 outputs (rows ty*8 + i,
    columns tx*4 + j), warps of 4 x 8 threads; every (row, column) of the
    product owned once."""
    rg, cg, bm, bn, rt, ct = bl.ring_plan(nrows, N)
    assert rg * cg == bl.THREADS and bm == 8 * rg and bn == 4 * cg
    assert rt * bm >= nrows and ct * bn >= N
    owner = np.zeros((rt * bm, ct * bn), np.int32)
    wx = cg // 8
    for tile in range(rt * ct):
        r0, c0 = (tile // ct) * bm, (tile % ct) * bn
        for tid in range(bl.THREADS):
            warp, lane = divmod(tid, 32)
            ty = (warp // wx) * 4 + lane // 8
            tx = (warp % wx) * 8 + lane % 8
            owner[r0 + ty * 8:r0 + ty * 8 + 8,
                  c0 + tx * 4:c0 + tx * 4 + 4] += 1
    assert np.all(owner == 1)
    # the stage holds the widest tile: (bm + pad) + (bn + pad) per k row
    assert bl.RING_STAGES * bl.RING_K * (bm + bn + 2 * bl.RING_PAD) \
        <= bl.RING_FLOATS
