"""On-card parity of the engines at a realistic size (65,536 leaves), and
of the Triton count kernel compiled for the card against the plain pass.

Marked ``gpu``: each test skips unless JAX's first device is a GPU, decided
in the ``gpu`` fixture at run time.  ``chip_smoke.py`` runs them on the
card; ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` does too.
Float32 on the card may contract multiply-adds differently from the walk's
fusions, so sets may differ only by pairs on the contact boundary.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import implicitbvh_tpu as ib
from implicitbvh_tpu.traverse import TileTraversal

pytestmark = pytest.mark.gpu

N = 1 << 16


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU")


def _scene(n, seed):
    rng = np.random.default_rng(seed)
    scale = float(n) ** (1 / 3)
    c = (rng.random((n, 3)) * scale).astype(np.float32)
    r = (rng.random(n) * 0.4 + 0.05).astype(np.float32)
    bvh = ib.build(ib.BSphere(jnp.asarray(c), jnp.asarray(r)), ib.BBox)
    return bvh, c.astype(np.float64), r.astype(np.float64)


def _assert_same(got, ref, margin):
    got = {tuple(p) for p in np.asarray(got).tolist()}
    ref = {tuple(p) for p in np.asarray(ref).tolist()}
    diff = np.asarray(sorted(got ^ ref), np.int64).reshape(-1, 2)
    assert (margin(diff) <= 1e-6).all(), diff[:10]
    assert len(diff) <= 1e-4 * len(ref) + 2


def _sphere_margin(ca, ra, cb, rb):
    def m(pr):
        i, j = pr[:, 0] - 1, pr[:, 1] - 1
        d2 = ((ca[i] - cb[j]) ** 2).sum(-1)
        rr = (ra[i] + rb[j]) ** 2
        return np.abs(d2 - rr) / rr
    return m


def test_gpu_self_tiles_match_walk(gpu):
    bvh, c, r = _scene(N, 0)
    t = ib.traverse(bvh, TileTraversal())
    w = ib.traverse(bvh, ib.LVTTraversal())
    assert int(t.num_contacts) > 0
    _assert_same(t.contacts, w.contacts, _sphere_margin(c, r, c, r))


def test_gpu_pair_tiles_match_walk(gpu):
    b1, c1, r1 = _scene(N, 1)
    b2, c2, r2 = _scene(N // 2, 2)
    t = ib.traverse(b1, b2, TileTraversal())
    w = ib.traverse(b1, b2, ib.LVTTraversal())
    assert int(t.num_contacts) > 0
    _assert_same(t.contacts, w.contacts, _sphere_margin(c1, r1, c2, r2))


def test_gpu_rays_tiles_match_walk(gpu):
    bvh, c, r = _scene(N, 3)
    rng = np.random.default_rng(4)
    scale = float(N) ** (1 / 3)
    p = (rng.random((3, 20_000)) * scale).astype(np.float32)
    d = (rng.random((3, 20_000)) - 0.5).astype(np.float32)
    t = ib.traverse_rays(bvh, p, d, TileTraversal())
    w = ib.traverse_rays(bvh, p, d, ib.LVTTraversal())
    assert int(t.num_contacts) > 0
    got = {tuple(x) for x in np.asarray(t.contacts).tolist()}
    ref = {tuple(x) for x in np.asarray(w.contacts).tolist()}
    # boundary rays are rare at this size; allow a handful
    assert len(got ^ ref) <= 1e-4 * len(ref) + 2


def test_gpu_count_kernel_matches_plain(gpu):
    """The compiled Triton count kernel against the plain count pass on the
    entries of a 65k-leaf scene: rows may differ only where multiply-add
    contraction moves a leaf pair across the contact boundary."""
    from implicitbvh_tpu.ops import band_row_counts, band_row_counts_triton
    from implicitbvh_tpu.traverse import tiles
    bvh, _, _ = _scene(N, 5)
    G, NB = 128, 4
    pcap = tiles._pair_capacity_for(N // G, NB)
    f, _, ea, eb, ne, _ = jax.jit(
        lambda b: tiles._self_entries(b, G, NB, pcap))(bvh)
    bands = tuple(x.reshape(-1, G // NB) for x in f)
    ref = band_row_counts(bands, f, ea, eb, ne, mask_kind="sphere", NB=NB,
                          dedup=True)
    got = band_row_counts_triton(bands, f, ea, eb, ne, mask_kind="sphere",
                                 NB=NB, dedup=True)
    assert int(ref.sum()) > 0
    assert int(jnp.sum(jnp.any(got != ref, axis=1))) <= 2
