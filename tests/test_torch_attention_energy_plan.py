"""The energy kernel's launch plan, on the CPU.

``ops/attention_energy.py::plan`` mirrors the blocks, threads and shared
memory of ``csrc/attention_energy.cu``: a block per utterance and tile of
frames, a thread per 2 rows x 2 frames and slice of M."""
import pytest

from attention_lvcsr_torch.ops import attention_energy as ae


@pytest.mark.parametrize("U", [64, 128, 256])
def test_flagship_tile_balances_the_waves(U):
    """At K=10, L=200, M=250 on 132 SMs: 20-frame tiles (10 a frame row),
    5 slices of M, 250 of 256 threads busy, 36,128 bytes a block."""
    p = ae.plan(U, 10, 200, 250, 132)
    assert p == {"tile": 20, "slices": 5, "threads": 256, "blocks": 10 * U,
                 "smem_bytes": 4 * ((20 + 10 + 2) * 251 + 5 * 10 * 20)}


@pytest.mark.parametrize("U,K,L,M", [(3, 4, 23, 9), (2, 1, 7, 300),
                                     (1, 12, 33, 64), (5, 3, 5, 33),
                                     (1, 10, 1, 250), (3, 32, 40, 250),
                                     (64, 12, 7, 250)])
def test_every_plan_fits_a_block(U, K, L, M):
    p = ae.plan(U, K, L, M, 132)
    rows = 1 if K == 1 else 2
    tiles = -(-K // rows) * -(-min(p["tile"], L) // 2)
    assert tiles * p["slices"] <= p["threads"] <= ae.MAX_THREADS
    assert p["threads"] % 32 == 0
    assert 1 <= p["slices"] <= min(ae.MAX_SLICES, M)
    assert p["tile"] % 2 == 0 and p["tile"] <= L + L % 2
    assert p["blocks"] == U * -(-L // p["tile"])
    assert p["smem_bytes"] <= ae.MAX_SMEM


def test_small_batches_take_small_tiles():
    """One utterance spreads its frames over many blocks."""
    assert ae.plan(1, 10, 200, 250, 132)["blocks"] >= 100


def test_too_wide_a_row_is_refused():
    with pytest.raises(NotImplementedError, match="beam 10 at M=8000"):
        ae.plan(64, 10, 200, 8000, 132)


@pytest.mark.parametrize("K,sizes", [(10, [10]), (200, [200]),
                                     (300, [150, 150]),
                                     (513, [171, 171, 171]),
                                     (1000, [200] * 5)])
def test_a_wide_beam_runs_in_row_chunks(K, sizes):
    """The module path's beams past a block's rows (513 and up, where the
    loop kernel leaves the decode to it) run as the fewest near-equal row
    chunks whose launches fit, covering every row once."""
    chunks = ae.row_chunks(16, K, 200, 250, 132)
    assert [k1 - k0 for k0, k1 in chunks] == sizes
    assert [k0 for k0, _ in chunks] == [sum(sizes[:i])
                                         for i in range(len(sizes))]
    for k0, k1 in chunks:
        assert ae.plan(16, k1 - k0, 200, 250, 132)["smem_bytes"] \
            <= ae.MAX_SMEM
    if len(chunks) > 1:      # one chunk fewer would not fit
        with pytest.raises(NotImplementedError):
            ae.plan(16, -(-K // (len(chunks) - 1)), 200, 250, 132)
