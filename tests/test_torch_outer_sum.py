"""The training scans' weight-gradient reduction, ``ops/outer_sum.py``, on
the CPU: the wrapper takes its plain version for CPU tensors (one matrix
product per job, no launch counted) and adds ``sum_row (a * a2)^T b`` into
each job's ``c``.  Held to float64 numpy at 1e-5 of the largest value: f32
sums over at most 300 rows in another order."""
import numpy as np
import pytest
import torch

from attention_lvcsr_torch.ops import outer_sum as osum


@pytest.mark.parametrize("rows,shapes,gated", [
    (13, [(8, 24), (8, 16)], True), (300, [(5, 7)], False),
    (40, [(6, 6), (6, 12), (1, 18)], True)])
def test_outer_sum_plain_matches_numpy(rows, shapes, gated):
    rng = np.random.RandomState(rows)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    wide = f(rows, sum(J for _, J in shapes))     # b: its column slices
    wide_t = torch.from_numpy(wide)
    jobs, expect, col = [], [], 0
    for k, (I, J) in enumerate(shapes):
        a, c = f(rows, I), f(I, J)
        a2 = f(rows, I) if gated and k == 0 else None
        b = wide_t[:, col:col + J]
        left = a.astype(np.float64) * (a2 if a2 is not None else 1.0)
        expect.append(c + left.T @ wide[:, col:col + J].astype(np.float64))
        jobs.append((torch.from_numpy(a),
                     torch.from_numpy(a2) if a2 is not None else None, b,
                     torch.from_numpy(c.copy())))
        col += J
    before = osum.launches.count
    osum.outer_sum(jobs, wide_t)
    assert osum.launches.count == before
    for (_, _, _, c), ref in zip(jobs, expect):
        np.testing.assert_allclose(c.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("shapes", [
    [(25600, 250, 250), (25600, 250, 500)] * 2,     # the flagship layer
    [(3200, 200, 200), (3200, 250, 250), (3200, 250, 250), (3200, 250, 500),
     (3200, 500, 250), (3200, 500, 500), (32, 1, 250), (32, 1, 250)],
    [(1, 17, 19)], [(13, 8, 24), (13, 8, 16)], [(0, 5, 7)],
    [(301, 5, 7), (301, 3, 130), (301, 129, 9)],
    [(97, 3, 5), (97, 130, 1), (97, 1, 130), (97, 64, 64), (97, 9, 257),
     (97, 256, 4), (97, 2, 2), (97, 31, 33)]])
def test_launch_plan_covers_every_row_once(shapes):
    """Every (row, tile) of every job falls in exactly one block; a tile's
    splits are consecutive blocks in row order (the order the second
    kernel adds them); blocks and tiles are numbered without gaps, and the
    workspace holds one partial tile per block."""
    plan, blocks, tiles = osum.launch_plan(shapes)
    seen = np.zeros(blocks, int)
    for p, (rows, I, J) in zip(plan, shapes):
        n_tiles = -(-I // osum.TILE_I) * -(-J // osum.TILE_J)
        assert p["tiles_j"] == -(-J // osum.TILE_J)
        assert p["split_rows"] % osum.CHUNK == 0
        for tile in range(n_tiles):
            covered = np.zeros(rows, int)
            for split in range(p["splits"]):
                block = p["block0"] + tile * p["splits"] + split
                seen[block] += 1
                r0 = split * p["split_rows"]
                assert r0 < max(rows, 1)        # no block without rows
                covered[r0:r0 + p["split_rows"]] += 1
            assert (covered == 1).all()
    assert (seen == 1).all()
    assert tiles == sum(-(-I // osum.TILE_I) * -(-J // osum.TILE_J)
                        for _, I, J in shapes)
    assert [p["tile0"] for p in plan] == list(np.cumsum(
        [0] + [-(-I // osum.TILE_I) * -(-J // osum.TILE_J)
               for _, I, J in shapes[:-1]]))
    if shapes[0][0] == 25600:      # one wave: a block on each of 132 SMs
        assert blocks == osum.TARGET_BLOCKS


def test_outer_sum_checks_its_jobs():
    a, b = torch.zeros(4, 3), torch.zeros(4, 5)
    with pytest.raises(ValueError, match="1..8 jobs"):
        osum.outer_sum([], a)
    with pytest.raises(ValueError, match="1..8 jobs"):
        osum.outer_sum([(a, None, b, torch.zeros(3, 5))] * 9, a)
