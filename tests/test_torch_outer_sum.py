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


def test_outer_sum_checks_its_jobs():
    a, b = torch.zeros(4, 3), torch.zeros(4, 5)
    with pytest.raises(ValueError, match="1..8 jobs"):
        osum.outer_sum([], a)
    with pytest.raises(ValueError, match="1..8 jobs"):
        osum.outer_sum([(a, None, b, torch.zeros(3, 5))] * 9, a)
