"""The wide instances of the GRU kernels against their plain versions, on
the card: ``gru_scan.cu``'s ``gru_wide_kernel`` (D above 448) and
``gru_train.cu``'s ``gru_bwd_wide_kernel`` (D above 384), which keep the
leading tiles of each block's recurrent weight slice in shared memory and
stream the rest from L2 every step through a TMA ring, up to D=1024.
Marked ``cuda``: they skip without a CUDA device, and run there with
``python -m pytest -m cuda tests/test_torch_cuda_wide_gru.py
--noconftest`` (no JAX needed)."""
import ctypes

import numpy as np
import pytest
import torch

from attention_lvcsr_torch.ops import gru_scan as gs
from attention_lvcsr_torch.ops import gru_train as gt

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _operands(rng, device, T, B, D, ndir):
    """Projections, a ragged mask (the last row masked from the first
    step) and per-direction (h0, w_state, w_gates) scaled as an encoder's
    orthogonal weights are: the sums over D keep their size."""
    f = lambda *s: torch.tensor(rng.randn(*s).astype(np.float32),
                                device=device)
    lengths = rng.randint(1, T + 1, size=B)
    lengths[0] = T
    lengths[-1] = 0
    mask = torch.tensor((np.arange(T)[:, None] < lengths[None])
                        .astype(np.float32), device=device)
    weights = [(f(B, D) * 0.5, f(D, D) / D ** 0.5, f(D, 2 * D) / D ** 0.5)
               for _ in range(ndir)]
    return f(T, B, 3 * D * ndir) * 0.5, mask, weights


@pytest.mark.parametrize("D", [449, 500, 1000, 1024])
@pytest.mark.parametrize("B", [10, 17])
@pytest.mark.parametrize("ndir", [1, 2])
def test_wide_forward_matches_plain(device, D, B, ndir):
    """States within 1e-5 absolute of the plain scan (|h| < 1), a masked
    row keeps its initial state, and a second call repeats bit for bit."""
    rng = np.random.RandomState(D + B + ndir)
    T = 6
    proj, mask, weights = _operands(rng, device, T, B, D, ndir)
    assert gs.route(D) == "wide"
    before = (gs.launches.count, gs.launches_wide.count)
    got = gs.gru_scan(proj, mask, *weights)
    assert (gs.launches.count, gs.launches_wide.count) == (
        before[0], before[1] + 1)
    again = gs.gru_scan(proj, mask, *weights)
    ref = gs.gru_scan_reference(proj, mask, *weights)
    assert float((got - ref).abs().max()) <= 1e-5
    assert torch.equal(got, again)
    h0 = torch.cat([w[0][-1] for w in weights])
    assert torch.equal(got[:, -1], h0.expand(T, D * ndir))


@pytest.mark.parametrize("D,cluster", [(449, 8), (500, 8), (992, 8),
                                       (500, 16)])
def test_wide_forward_cluster_sizes(device, monkeypatch, D, cluster):
    """Both cluster sizes of the wide instance, forced; its C layout
    equals the Python mirror."""
    from attention_lvcsr_torch import _build
    lib = _build.load().lib
    lib.gru_scan_wide_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    assert lib.gru_scan_wide_smem_bytes(D, cluster) == \
        gs.wide_layout(D, cluster)["smem_bytes"]
    monkeypatch.setattr(gs, "max_active_clusters", lambda D, device: {
        size: 16 if size == cluster else 0 for size in gs.CLUSTERS})
    rng = np.random.RandomState(D + cluster)
    proj, mask, weights = _operands(rng, device, 5, 35, D, 2)
    got = gs.gru_scan(proj, mask, *weights)
    ref = gs.gru_scan_reference(proj, mask, *weights)
    assert float((got - ref).abs().max()) <= 1e-5


def _grads(fn, proj, mask, weights, cot):
    leaves = [proj] + [w for d in weights for w in d]
    xs = [x.detach().requires_grad_() for x in leaves]
    dirs = [tuple(xs[1 + 3 * i:4 + 3 * i]) for i in range(len(weights))]
    out = fn(xs[0], mask, *dirs)
    return out.detach(), torch.autograd.grad(out, xs, cot)


@pytest.mark.parametrize("D", [400, 449, 500, 1000, 1024])
@pytest.mark.parametrize("B", [10, 17])
@pytest.mark.parametrize("ndir", [1, 2])
def test_wide_backward_matches_plain(device, D, B, ndir):
    """gru_scan_train through the wide backward (D=400: the resident
    forward under it) against autograd through the plain scan: states
    within 1e-5, every gradient within 1e-4 of its largest value, a second
    call bit for bit."""
    rng = np.random.RandomState(3 * D + B + ndir)
    T = 5
    proj, mask, weights = _operands(rng, device, T, B, D, ndir)
    cot = torch.tensor(rng.randn(T, B, D * ndir).astype(np.float32),
                       device=device)
    assert gt.backward_route(D) == "wide"
    counter = gt.launches_wide if ndir == 1 else gt.launches_bidir_wide
    before = counter.count
    got, ggot = _grads(gt.gru_scan_train, proj, mask, weights, cot)
    # the wide backward launched; the forward too where it is wide
    assert counter.count == before + (2 if gs.route(D) == "wide" else 1)
    ref, gref = _grads(gt.gru_scan_train_reference, proj, mask, weights,
                       cot)
    assert float((got - ref).abs().max()) <= 1e-5
    for g, r in zip(ggot, gref):
        assert float((g - r).abs().max() / r.abs().max()) <= 1e-4
    _, again = _grads(gt.gru_scan_train, proj, mask, weights, cot)
    assert all(torch.equal(g, h) for g, h in zip(ggot, again))


# T=1 (one step: the ring's first fill is its whole stream); D=600, whose
# rings are the deepest (three slots) with resident tiles in both
# products; D=961, whose backward ring is the shallowest (two slots, none
# resident)
@pytest.mark.parametrize("D,T", [(500, 1), (1000, 1), (600, 3), (961, 3)])
def test_wide_ring_depths(device, D, T):
    """The forward and the backward through the wide instances at one
    step, and at the deepest and the shallowest rings, against the plain
    scan (the tolerances of the tests above), a second call bit for
    bit."""
    o, b = gs.wide_layout(D, 16)["ring"], gt.bwd_wide_layout(D)["ring"]
    tiles = lambda r: r["slots"] * gs.RING_CHUNK
    if D == 600:
        assert tiles(o) == tiles(b) == gs.RING_MAX_TILES
        assert min(o["res0"], o["res1"], b["res0"], b["res1"]) > 0
    if D == 961:
        assert tiles(b) == gs.RING_MIN_TILES and not b["res0"]
    rng = np.random.RandomState(7 * D + T)
    B = 17
    proj, mask, weights = _operands(rng, device, T, B, D, 2)
    cot = torch.tensor(rng.randn(T, B, 2 * D).astype(np.float32),
                       device=device)
    got, ggot = _grads(gt.gru_scan_train, proj, mask, weights, cot)
    ref, gref = _grads(gt.gru_scan_train_reference, proj, mask, weights,
                       cot)
    assert float((got - ref).abs().max()) <= 1e-5
    for g, r in zip(ggot, gref):
        assert float((g - r).abs().max() / r.abs().max()) <= 1e-4
    _, again = _grads(gt.gru_scan_train, proj, mask, weights, cot)
    assert all(torch.equal(g, h) for g, h in zip(ggot, again))
    scan = gs.gru_scan(proj, mask, *weights)
    assert float((scan - ref).abs().max()) <= 1e-5


def test_wide_backward_layout_matches_mirror(device):
    from attention_lvcsr_torch import _build
    lib = _build.load().lib
    for name in ("gru_train_smem_bytes", "gru_train_wide_smem_bytes"):
        getattr(lib, name).argtypes = [ctypes.c_int]
    for D in (250, 384, 385, 500, 777, 1000, 1024):
        assert lib.gru_train_smem_bytes(D) == gt.bwd_layout(D)["smem_bytes"]
        assert lib.gru_train_wide_smem_bytes(D) == \
            gt.bwd_wide_layout(D)["smem_bytes"]
