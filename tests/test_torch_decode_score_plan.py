"""The fused score kernel's launch plan and shared-memory layout, on the
CPU.

``ops/decode_score.py`` mirrors ``csrc/decode_score.cu``: :func:`plan`
picks how many blocks of a thread-block cluster take one utterance from
what the card holds at once, and :func:`smem_layout` gives the block's
shared memory, which decides which cluster sizes a shape may take and the
widest shape the kernel accepts.  The byte counts here are worked out by
hand from the layout (K=10, L=200, M=250, D=500, S=250, R=250, V=32, 201
taps on one block: 15,672 floats for the whole kernel, the zone's 10,240
among them, plus the larger of the early region, 9,050, and the late one,
9,840); ``chip_smoke.py`` holds the mirror to the C layout on the card."""
import pytest

from attention_lvcsr_torch.ops import decode_score as ds

FLAGSHIP = dict(K=10, L=200, M=250, D=500, S=250, R=250, V=32, n_taps=201)
# clusters of each size an H100 80GB HBM3 holds at once at the flagship
# shape (cudaOccupancyMaxActiveClusters, printed by chip_smoke.py phase 7)
H100 = {8: 15, 4: 30, 2: 66, 1: 132}


@pytest.mark.parametrize("U,cluster", [(1, 8), (8, 8), (15, 8), (16, 4),
                                       (30, 4), (31, 2), (33, 2), (64, 2),
                                       (66, 2), (67, 1), (128, 1), (256, 1)])
def test_cluster_size_fills_the_card_in_one_wave(U, cluster):
    """The size whose clusters the card holds in the fewest waves (one
    wave wherever a size allows it), the larger on a tie."""
    assert ds.plan(U, H100) == cluster
    waves = {c: -(-U // n) for c, n in H100.items()}
    assert waves[cluster] == min(waves.values())


@pytest.mark.parametrize("active,U,cluster", [
    ({8: 0, 4: 0, 2: 0, 1: 132}, 64, 1),      # only one block fits
    ({8: 0, 4: 0, 2: 66, 1: 132}, 1, 2),
    ({8: 7, 4: 14, 2: 28, 1: 57}, 57, 1),     # a smaller card
    ({8: 7, 4: 14, 2: 28, 1: 57}, 28, 2),
    ({8: 15, 4: 30, 2: 66, 1: 264}, 256, 1)])  # two blocks an SM
def test_cluster_size_follows_the_sm_count(active, U, cluster):
    """What the card holds at once follows its SMs and the layouts that
    fit: sizes that do not fit count 0."""
    assert ds.plan(U, active) == cluster


def test_no_cluster_size_fits_raises():
    with pytest.raises(NotImplementedError, match="no cluster size fits"):
        ds.plan(4, {8: 0, 4: 0, 2: 0, 1: 0})


@pytest.mark.parametrize("cluster,nbytes", [(1, 102048), (2, 101936),
                                            (4, 99376), (8, 98096)])
def test_layout_bytes_at_the_flagship(cluster, nbytes):
    layout = ds.smem_layout(cluster=cluster, **FLAGSHIP)
    assert layout["bytes"] == nbytes
    assert layout["zone_floats"] == ds.ZONE
    # every buffer on a 16-byte boundary, in the C struct's order; the
    # late region starts where the early one does; the previous weights
    # live in conv's place, and one block's partial energies are e
    names = ["mask", "taps", "hand", "v", "begins", "ends"] + (
        ["pe"] if cluster > 1 else []) + ["mp", "e", "zone", "wx"]
    whole = [layout[k] for k in names]
    early = [layout[k] for k in ("wx", "h", "conv", "sp")]
    late = [layout[k] for k in ("wt", "wa", "act", "costs")]
    assert whole == sorted(whole) and early == sorted(early)
    assert late == sorted(late) and late[0] == early[0]
    assert all(o % 4 == 0 for o in whole + early + late)
    assert layout["w"] == layout["conv"]
    assert (layout["pe"] == layout["e"]) == (cluster == 1)


@pytest.mark.parametrize("K,rows", [(1, 4), (4, 4), (5, 8), (10, 10),
                                    (12, 16), (16, 16), (17, 24), (20, 24),
                                    (24, 24)])
def test_products_x_buffers_take_whole_row_blocks(K, rows):
    """Beams up to 16 keep every row in registers, larger ones blocks of
    8: the products' X buffers get the rounded-up rows."""
    layout = ds.smem_layout(**dict(FLAGSHIP, K=K), cluster=1)
    assert layout["h"] - layout["wx"] == 4 * -(-rows * 200 // 4)
    assert layout["wa"] - layout["wt"] == rows * 200
    assert layout["act"] - layout["wa"] == rows * 500


@pytest.mark.parametrize("L,sizes", [(776, [8, 4, 2, 1]),
                                     (1000, [8, 4, 2, 1]),
                                     (1244, [8, 4, 2, 1]),
                                     (1245, [8, 4, 1]), (1261, [8, 1]),
                                     (1269, [1]), (1437, [1])])
def test_long_windows_fit_a_cluster_size(L, sizes):
    """Clusters hold windows up to 1244-1268 frames at the flagship
    widths, one block up to 1606 (its zone shrunk to what is left); a
    batch of any size takes a size that fits."""
    shape = dict(FLAGSHIP, L=L)
    assert ds.check_fits(**shape) == sizes
    for size in sizes:
        assert ds.smem_layout(cluster=size, **shape)["bytes"] <= ds.MAX_SMEM
    active = {size: H100[size] if size in sizes else 0 for size in H100}
    for U in (1, 64, 67, 128, 256):
        assert ds.plan(U, active) in sizes


def test_widest_window_it_accepts():
    """L=1606 frames fit one block at the flagship widths, with a zone of
    20 floats (the products then take one or two k slices); 1607 do not,
    and the wrapper refuses them by name."""
    widest = ds.smem_layout(cluster=1, **dict(FLAGSHIP, L=1606))
    assert widest["bytes"] == 232448 and widest["zone_floats"] == 20
    assert ds.check_fits(**dict(FLAGSHIP, L=1606)) == [1]
    with pytest.raises(NotImplementedError,
                       match=r"beam 10 at L=1607, D=500 needs 232464 bytes "
                             r"of shared memory per utterance "
                             r"\(limit 232448\)"):
        ds.check_fits(**dict(FLAGSHIP, L=1607))


@pytest.mark.parametrize("K,sizes", [(24, [8, 4, 2, 1]), (30, [8, 4, 2, 1]),
                                     (36, [8, 4, 2, 1]), (40, [8, 4])])
def test_wide_beams_fit(K, sizes):
    """Beam 36 fits every cluster size at the flagship widths, 40 only
    the clusters whose blocks' shares of M and D are small."""
    assert ds.check_fits(**dict(FLAGSHIP, K=K)) == sizes


def test_widest_beam_it_accepts():
    with pytest.raises(NotImplementedError, match="beam 41 at L=200"):
        ds.check_fits(**dict(FLAGSHIP, K=41))
