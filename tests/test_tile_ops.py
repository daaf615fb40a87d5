"""Plain tile ops (ops/subtile.py, ops/tile_contact.py) against NumPy
references, and the tile engine at capacities of any size.

Scenes use small integers and half-integers, so every predicate is exact
in float32 whatever the order of operations: the references must agree
bit for bit, boundary cases included.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import implicitbvh_tpu as ib
from implicitbvh_tpu.ops import (band_emit, band_row_counts,
                                 subtile_band_bits)
from implicitbvh_tpu.traverse import TileTraversal
from implicitbvh_tpu.traverse.tiles import (_tiled_fields,
                                            traverse_tiles_fixed,
                                            traverse_tiles_pair_fixed)

SS = 32


def _int_volumes(kind, n, seed, extent=24):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, extent, (n, 3)).astype(np.float32)
    if kind == "sphere":
        r = rng.integers(1, 5, n).astype(np.float32) * 0.5
        return ib.BSphere(jnp.asarray(c), jnp.asarray(r))
    up = c + rng.integers(0, 4, (n, 3)).astype(np.float32)
    return ib.BBox(jnp.asarray(c), jnp.asarray(up))


def _np_tiles(bounds):
    return [np.asarray(c) for c in bounds]


@pytest.mark.parametrize("nb", [4, 8, 16])
@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
@pytest.mark.parametrize("kind", ["sphere", "box"])
def test_band_bits_match_numpy(kind, cross, nb):
    G = 16
    bvh_a = ib.build(_int_volumes(kind, 1200, 1), ib.BBox)
    bvh_b = ib.build(_int_volumes(kind, 700, 2), ib.BBox) if cross else bvh_a
    _, _, _, _, sub_lo, sub_up, Ta = _tiled_fields(bvh_a, G, nb)
    _, _, tlo, tup, _, _, Tb = _tiled_fields(bvh_b, G, nb)
    Sa, Sb = -(-Ta // SS), -(-Tb // SS)
    si, sj = np.meshgrid(np.arange(Sa), np.arange(Sb), indexing="ij")
    si, sj = si.reshape(-1), sj.reshape(-1)
    nsp = len(si) - 1                     # the last superpair is invalid
    bits = np.asarray(subtile_band_bits(
        sub_lo, sub_up, tlo, tup, jnp.asarray(si, jnp.int32),
        jnp.asarray(sj, jnp.int32), nsp, Ta=Ta, Tb=Tb, triangle=not cross,
        n_bands=nb))

    alo, aup = _np_tiles(sub_lo), _np_tiles(sub_up)
    blo, bup = _np_tiles(tlo), _np_tiles(tup)
    ref = np.zeros((len(si), SS, SS), np.int64)
    for p in range(nsp):
        for i in range(SS):
            ti = si[p] * SS + i
            if ti >= Ta:
                continue
            for j in range(SS):
                tj = sj[p] * SS + j
                if tj >= Tb or (not cross and ti > tj):
                    continue
                ov = np.ones(nb, bool)
                for k in range(3):
                    ov &= (aup[k][ti] >= blo[k][tj]) & (alo[k][ti] <= bup[k][tj])
                ref[p, i, j] = int((ov * (1 << np.arange(nb))).sum())
    np.testing.assert_array_equal(bits, ref)
    assert bits.any()


def _np_mask(kind, a, b):
    """NumPy predicate of one a element against the b leaves."""
    with np.errstate(divide="ignore", invalid="ignore"):
        if kind == "sphere":
            d2 = sum((a[k] - b[k]) ** 2 for k in range(3))
            return d2 <= (a[3] + b[3]) ** 2
        if kind == "box":
            m = np.ones(b[0].shape, bool)
            for k in range(3):
                m &= (a[3 + k] >= b[k]) & (a[k] <= b[3 + k])
            return m
        if kind == "ray_box":
            tmin = tmax = None
            for k in range(3):
                inv = np.float32(1.0) / a[3 + k]
                t1 = (b[k] - a[k]) * inv
                t2 = (b[3 + k] - a[k]) * inv
                lo = np.where(t1 < t2, t1, t2)
                hi = np.where(t1 > t2, t1, t2)
                tmin = lo if tmin is None else np.where(tmin > lo, tmin, lo)
                tmax = hi if tmax is None else np.where(tmax < hi, tmax, hi)
            return (tmin <= tmax) & (tmax >= 0)
        qa = a[3] ** 2 + a[4] ** 2 + a[5] ** 2
        po = [a[k] - b[k] for k in range(3)]
        qb = 2 * (po[0] * a[3] + po[1] * a[4] + po[2] * a[5])
        qc = po[0] ** 2 + po[1] ** 2 + po[2] ** 2 - b[3] ** 2
        return (qb * qb - 4 * qa * qc >= 0) & ((qb <= 0) | (qc <= 0))


def _int_fields(kind, T, G, seed):
    """(T, G) float32 field tuples of one side for a mask kind."""
    rng = np.random.default_rng(seed)
    pos = [rng.integers(0, 8, (T, G)).astype(np.float32) for _ in range(3)]
    if kind in ("sphere", "b_sphere"):
        return pos + [rng.integers(1, 6, (T, G)).astype(np.float32) * 0.5]
    if kind in ("box", "b_box"):
        return pos + [p + rng.integers(0, 3, (T, G)).astype(np.float32)
                      for p in pos]
    # rays: integer origins, directions in {-2, -1, 0, 1, 2}
    return pos + [rng.integers(-2, 3, (T, G)).astype(np.float32)
                  for _ in range(3)]


_SIDES = {"sphere": ("sphere", "b_sphere"), "box": ("box", "b_box"),
          "ray_box": ("ray", "b_box"), "ray_sphere": ("ray", "b_sphere")}


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("mask_kind", ["sphere", "box", "ray_box",
                                       "ray_sphere"])
def test_band_row_counts_tile_brute_force(mask_kind, dedup):
    G, NB, Ta, Tb = 16, 4, 3, 4
    BH = G // NB
    fa = _int_fields(_SIDES[mask_kind][0], Ta, G, 3)
    fb = _int_fields(_SIDES[mask_kind][1], Tb, G, 4)
    # every (a-band, b-tile) entry, then a dead tail past ``ne``
    ea = np.repeat(np.arange(Ta * NB), Tb).astype(np.int32)
    eb = np.tile(np.arange(Tb), Ta * NB).astype(np.int32)
    ne = len(ea)
    ea_p = np.concatenate([ea, np.zeros(5, np.int32)])
    eb_p = np.concatenate([eb, np.zeros(5, np.int32)])
    rows = np.asarray(band_row_counts(
        tuple(jnp.asarray(f.reshape(-1, BH)) for f in fa),
        tuple(jnp.asarray(f) for f in fb), jnp.asarray(ea_p),
        jnp.asarray(eb_p), ne, mask_kind=mask_kind, NB=NB, dedup=dedup,
        chunk=7))
    assert rows.shape == (ne + 5, BH)
    assert not rows[ne:].any()
    af = [f.reshape(-1) for f in fa]
    bf = [f.reshape(-1) for f in fb]
    for e in range(ne):
        for i in range(BH):
            gi = ea[e] * BH + i
            b = [f[eb[e] * G:(eb[e] + 1) * G] for f in bf]
            m = _np_mask(mask_kind, [f[gi] for f in af], b)
            if dedup:
                m &= eb[e] * G + np.arange(G) > gi
            assert rows[e, i] == m.sum(), (e, i)
    assert rows.sum() > 0


@pytest.mark.parametrize("chunk", [7, 1 << 16])
@pytest.mark.parametrize("ti,tj", [(32768, 32769), (7, 40000)])
def test_band_emit_high_tile_index(ti, tj, chunk):
    """Tile indices >= 32768 (past any 16-bit packing) must decode to the
    right global positions through the count and emit passes, whether the
    emit fills its slots in one chunk or in many."""
    G, NB = 128, 4
    BH = G // NB
    T = max(ti, tj) + 1
    # tile ti leaf k at (k, 0, 0), tile tj leaf k at (k, 0.05, 0), r = 0.1:
    # exactly the diagonal (k, k) pairs touch; all other tiles are far away
    x0 = jnp.zeros((T, G), jnp.float32).at[ti].set(
        jnp.arange(G, dtype=jnp.float32)).at[tj].set(
        jnp.arange(G, dtype=jnp.float32))
    x1 = jnp.full((T, G), 1e6, jnp.float32).at[ti].set(0.0).at[tj].set(0.05)
    x2 = jnp.zeros((T, G), jnp.float32)
    r = jnp.full((T, G), 0.1, jnp.float32)
    fields = (x0, x1, x2, r)
    bands = tuple(f.reshape(-1, BH) for f in fields)
    ea = jnp.asarray([ti * NB + k for k in range(NB)], jnp.int32)
    eb = jnp.full((NB,), tj, jnp.int32)
    rows = band_row_counts(bands, fields, ea, eb, NB, mask_kind="sphere",
                           NB=NB, dedup=False)
    gi, gj, total = band_emit(rows, bands, fields, ea, eb,
                              mask_kind="sphere", NB=NB, dedup=False,
                              capacity=2 * G, chunk=chunk)
    assert int(total) == G
    pairs = sorted(zip(np.asarray(gi)[:G].tolist(),
                       np.asarray(gj)[:G].tolist()))
    assert pairs == [(ti * G + k, tj * G + k) for k in range(G)]


def _brute_self(xs, rs):
    d2 = ((xs[:, None, :] - xs[None, :, :]) ** 2).sum(-1)
    rr = (rs[:, None] + rs[None, :]) ** 2
    i, j = np.nonzero(np.triu(d2 <= rr, 1))
    return {(a + 1, b + 1) for a, b in zip(i, j)}


@pytest.mark.parametrize("capacity", [37, 777, 1500])
def test_tiles_capacity_any_size(capacity):
    """Capacities need no alignment quantum: exact at or above the
    contact total, an overflow flag and a correct prefix below it."""
    rng = np.random.default_rng(5)
    xs = (rng.random((400, 3)) * 6).astype(np.float32)
    rs = (rng.random(400) * 0.3 + 0.05).astype(np.float32)
    bf = _brute_self(xs, rs)
    assert 37 < len(bf) < 777
    bvh = ib.build(ib.BSphere(jnp.asarray(xs), jnp.asarray(rs)), ib.BBox)
    total, contacts, ov, _ = traverse_tiles_fixed(
        bvh, capacity, alg=TileTraversal(tile=32))
    got = {tuple(map(int, r)) for r in np.asarray(contacts)[:int(total)]}
    if capacity < len(bf):
        # the exact total is still reported; the buffer holds a prefix
        assert int(ov) & 1
        assert int(total) == len(bf) and len(got) == capacity and got <= bf
    else:
        assert int(ov) == 0 and got == bf


@pytest.mark.parametrize("capacity", [50, 999])
def test_tiles_pair_capacity_any_size(capacity):
    rng = np.random.default_rng(6)
    x1 = (rng.random((300, 3)) * 6).astype(np.float32)
    x2 = (rng.random((200, 3)) * 6).astype(np.float32)
    r1 = (rng.random(300) * 0.3 + 0.05).astype(np.float32)
    r2 = (rng.random(200) * 0.3 + 0.05).astype(np.float32)
    d2 = ((x1[:, None, :] - x2[None, :, :]) ** 2).sum(-1)
    i, j = np.nonzero(d2 <= (r1[:, None] + r2[None, :]) ** 2)
    bf = {(a + 1, b + 1) for a, b in zip(i, j)}
    assert 50 < len(bf) < 999
    b1 = ib.build(ib.BSphere(jnp.asarray(x1), jnp.asarray(r1)), ib.BBox)
    b2 = ib.build(ib.BSphere(jnp.asarray(x2), jnp.asarray(r2)), ib.BBox)
    total, contacts, ov, _ = traverse_tiles_pair_fixed(
        b1, b2, capacity, alg=TileTraversal(tile=32))
    got = {tuple(map(int, r)) for r in np.asarray(contacts)[:int(total)]}
    if capacity < len(bf):
        assert int(ov) & 1 and got <= bf
    else:
        assert int(ov) == 0 and got == bf


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("mask_kind", ["sphere", "box", "ray_box",
                                       "ray_sphere"])
def test_count_kernel_interpret_matches_plain(mask_kind, dedup):
    """The Triton-route count kernel, run in the Pallas interpreter, must
    give exactly the plain count pass's rows (dead tail included)."""
    from implicitbvh_tpu.ops import band_row_counts_triton
    G, NB, Ta, Tb = 16, 4, 3, 4
    BH = G // NB
    fa = _int_fields(_SIDES[mask_kind][0], Ta, G, 5)
    fb = _int_fields(_SIDES[mask_kind][1], Tb, G, 6)
    ea = jnp.asarray(np.repeat(np.arange(Ta * NB), Tb), jnp.int32)
    eb = jnp.asarray(np.tile(np.arange(Tb), Ta * NB), jnp.int32)
    ne = ea.shape[0] - 3
    a_bands = tuple(jnp.asarray(f.reshape(-1, BH)) for f in fa)
    b_tiles = tuple(jnp.asarray(f) for f in fb)
    ref = band_row_counts(a_bands, b_tiles, ea, eb, ne, mask_kind=mask_kind,
                          NB=NB, dedup=dedup)
    got = band_row_counts_triton(a_bands, b_tiles, ea, eb, ne,
                                 mask_kind=mask_kind, NB=NB, dedup=dedup,
                                 interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    assert int(ref.sum()) > 0
