"""Dense tile contact tests: count and emit passes over live tile bands.

The tile engine (traverse/tiles.py, traverse/ray_tiles.py) reduces a
contact query to a list of *entries*: (a-band, b-tile) pairs in which a
band of ``G // NB`` consecutive sorted a-side leaves (or rays) may touch a
tile of ``G`` consecutive sorted b-side leaves.  This module runs the exact
leaf tests for every entry in plain ``jnp``/``lax``:

- :func:`band_row_counts` tests every entry's ``(G // NB, G)`` block and
  returns per-a-row contact counts (the count pass);
  :func:`band_row_counts_triton` is the same pass as a Pallas kernel on
  the Triton route, one program per entry;
- :func:`band_emit` turns those counts into a dense stream of contact
  positions: each output slot finds its a-row by a binary search over the
  rows' exclusive offsets and re-tests that one row against its b-tile to
  pick its set bit (the emit pass).

Padded leaves and rays carry NaN fields, so every predicate comparison
against them is false and no validity mask is needed for padding.

The predicates follow the reference's term order
(ref src/bounding_volumes/iscontact.jl:1-10, isintersection.jl:1-65) and
match ``volumes.iscontact`` / ``volumes.isintersection``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

MASK_FIELD_COUNTS = {
    # mask_kind -> (a-side field count, b-side field count)
    "sphere": (4, 4),        # spheres vs spheres: (x0, x1, x2, r)
    "box": (6, 6),           # boxes vs boxes: (lo0, lo1, lo2, up0, up1, up2)
    "ray_box": (6, 6),       # rays (p0, p1, p2, d0, d1, d2) vs box leaves
    "ray_sphere": (6, 4),    # rays vs sphere leaves
}


def contact_mask(mask_kind: str, a, b):
    """Elementwise contact/intersection predicate of broadcastable field
    lists ``a`` (a side: leaves or rays) and ``b`` (b side: leaves)."""
    if mask_kind == "sphere":
        dx = a[0] - b[0]
        dy = a[1] - b[1]
        dz = a[2] - b[2]
        rr = a[3] + b[3]
        return dx * dx + dy * dy + dz * dz <= rr * rr
    if mask_kind == "box":
        m = (a[3] >= b[0]) & (a[0] <= b[3])
        m &= (a[4] >= b[1]) & (a[1] <= b[4])
        return m & (a[5] >= b[2]) & (a[2] <= b[5])

    if mask_kind == "ray_box":
        # forward slab test with where-select min/max, which keeps the
        # reference's NaN asymmetry (ref isintersection.jl:1-40)
        def min2(x, y):
            return jnp.where(x < y, x, y)

        def max2(x, y):
            return jnp.where(x > y, x, y)

        tmin = None
        tmax = None
        for k in range(3):
            inv = 1.0 / a[3 + k]
            t1 = (b[k] - a[k]) * inv
            t2 = (b[3 + k] - a[k]) * inv
            lo = min2(t1, t2)
            hi = max2(t1, t2)
            tmin = lo if tmin is None else max2(tmin, lo)
            tmax = hi if tmax is None else min2(tmax, hi)
        return (tmin <= tmax) & (tmax >= 0)
    assert mask_kind == "ray_sphere", mask_kind
    # quadratic-discriminant forward test (ref isintersection.jl:42-65)
    qa = a[3] * a[3] + a[4] * a[4] + a[5] * a[5]
    po0 = a[0] - b[0]
    po1 = a[1] - b[1]
    po2 = a[2] - b[2]
    qb = 2.0 * (po0 * a[3] + po1 * a[4] + po2 * a[5])
    qc = po0 * po0 + po1 * po1 + po2 * po2 - b[3] * b[3]
    disc = qb * qb - 4.0 * qa * qc
    return (disc >= 0) & ((qb <= 0) | (qc <= 0))


def _check_fields(mask_kind, a_bands, b_tiles):
    Fa, Fb = MASK_FIELD_COUNTS[mask_kind]
    assert len(a_bands) == Fa and len(b_tiles) == Fb, \
        (mask_kind, len(a_bands), len(b_tiles))


def _entry_block(mask_kind, a_bands, b_tiles, ea, eb, dedup, NB):
    """(E, BH, G) contact block of entries ``(ea, eb)``: a-band ``ea``
    (row of the (Ta * NB, BH) band view) against b-tile ``eb``."""
    BH = a_bands[0].shape[1]
    G = b_tiles[0].shape[1]
    a = [f[ea][:, :, None] for f in a_bands]
    b = [f[eb][:, None, :] for f in b_tiles]
    m = contact_mask(mask_kind, a, b)
    if dedup:
        # self-contact keeps j > i in global sorted order
        # (ref traverse_single.jl (lvt):163-167)
        gi = ((ea // NB) * G + (ea % NB) * BH)[:, None, None] + \
            jax.lax.broadcasted_iota(jnp.int32, (1, BH, 1), 1)
        gj = (eb * G)[:, None, None] + \
            jax.lax.broadcasted_iota(jnp.int32, (1, 1, G), 2)
        m &= gj > gi
    return m


@functools.partial(jax.jit, static_argnames=("mask_kind", "NB", "dedup",
                                             "chunk"))
def band_row_counts(a_bands, b_tiles, ea, eb, ne, *, mask_kind: str,
                    NB: int, dedup: bool, chunk: int = 1 << 14):
    """Count pass: per-a-row contact counts of every live entry.

    - ``a_bands``: a-side fields in band view, tuple of (Ta * NB, G // NB);
    - ``b_tiles``: b-side fields in tile view, tuple of (Tb, G);
    - ``ea``/``eb``: (E_cap,) int32 band row / b-tile of each entry, the
      first ``ne`` of them valid.

    Returns ``rows`` (E_cap, G // NB) int32 (zero for invalid entries).
    Entries are processed ``chunk`` at a time in a loop that stops after
    the last live chunk, so dead capacity costs nothing and the gathered
    operands of one chunk bound the memory.
    """
    _check_fields(mask_kind, a_bands, b_tiles)
    E_cap = ea.shape[0]
    BH = a_bands[0].shape[1]
    CH = min(chunk, E_cap)
    n_chunks = -(-E_cap // CH)
    pad = n_chunks * CH - E_cap
    if pad:
        ea = jnp.concatenate([ea, jnp.zeros((pad,), ea.dtype)])
        eb = jnp.concatenate([eb, jnp.zeros((pad,), eb.dtype)])

    def body(c, rows):
        s = (c * CH).astype(jnp.int32)
        ea_c = jax.lax.dynamic_slice(ea, (s,), (CH,))
        eb_c = jax.lax.dynamic_slice(eb, (s,), (CH,))
        m = _entry_block(mask_kind, a_bands, b_tiles, ea_c, eb_c, dedup, NB)
        valid = s + jnp.arange(CH, dtype=jnp.int32) < ne
        cnt = jnp.where(valid[:, None],
                        m.sum(axis=2, dtype=jnp.int32), 0)
        return jax.lax.dynamic_update_slice(rows, cnt, (s, jnp.int32(0)))

    live_chunks = (jnp.minimum(ne, E_cap) + CH - 1) // CH
    rows = jax.lax.fori_loop(0, live_chunks, body,
                             jnp.zeros((n_chunks * CH, BH), jnp.int32))
    return rows[:E_cap]


def _count_kernel(ea_ref, eb_ref, ne_ref, *refs, mask_kind: str, NB: int,
                  dedup: bool, Fa: int):
    """One program: the row counts of one entry.  Its a-band and b-tile
    are gathered by index straight from the field arrays, so no gathered
    copy of the operands goes through memory."""
    a_refs, b_refs, out_ref = refs[:Fa], refs[Fa:-1], refs[-1]
    e = pl.program_id(0)

    @pl.when(e >= ne_ref[0])
    def _():
        out_ref[...] = jnp.zeros(out_ref.shape, jnp.int32)

    @pl.when(e < ne_ref[0])
    def _():
        m = _entry_block(mask_kind, a_refs, b_refs, ea_ref[...],
                         eb_ref[...], dedup, NB)
        out_ref[...] = m.astype(jnp.int32).sum(axis=2)


@functools.partial(jax.jit, static_argnames=("mask_kind", "NB", "dedup",
                                             "num_warps", "interpret"))
def band_row_counts_triton(a_bands, b_tiles, ea, eb, ne, *, mask_kind: str,
                           NB: int, dedup: bool, num_warps: int = 2,
                           interpret: bool = False):
    """:func:`band_row_counts` as a Pallas kernel (``backend="triton"``):
    one program per entry, programs past ``ne`` only write zeros.  Same
    arguments and result; ``interpret=True`` runs it in the Pallas
    interpreter (tests).  One entry per program with 2 warps measured
    fastest on an H100 (blocks of 2-4 entries spill; PERF.md)."""
    _check_fields(mask_kind, a_bands, b_tiles)
    E_cap = ea.shape[0]
    BH = a_bands[0].shape[1]
    ne = jnp.reshape(jnp.minimum(ne, E_cap), (1,)).astype(jnp.int32)

    def whole(f):
        return pl.BlockSpec(f.shape, lambda i: (0, 0))

    return pl.pallas_call(
        functools.partial(_count_kernel, mask_kind=mask_kind, NB=NB,
                          dedup=dedup, Fa=len(a_bands)),
        out_shape=jax.ShapeDtypeStruct((E_cap, BH), jnp.int32),
        grid=(E_cap,),
        in_specs=[pl.BlockSpec((1,), lambda i: (i,)),
                  pl.BlockSpec((1,), lambda i: (i,)),
                  pl.BlockSpec((1,), lambda i: (0,))]
        + [whole(f) for f in a_bands] + [whole(f) for f in b_tiles],
        out_specs=pl.BlockSpec((1, BH), lambda i: (i, 0)),
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps,
                                                 num_stages=1),
        backend="triton",
        interpret=interpret,
        name="band_row_counts",
    )(ea.astype(jnp.int32), eb.astype(jnp.int32), ne, *a_bands, *b_tiles)


@functools.partial(jax.jit, static_argnames=("mask_kind", "NB", "dedup",
                                             "capacity", "chunk"))
def band_emit(rows, a_bands, b_tiles, ea, eb, *, mask_kind: str, NB: int,
              dedup: bool, capacity: int, chunk: int = 1 << 16):
    """Emit pass: the dense stream of contact positions.

    ``rows`` is :func:`band_row_counts`' output.  Rows holding contacts
    are compacted (there are at most as many as contacts), their exclusive
    offsets give every output slot its row by binary search, and the slot
    re-tests that row against its b-tile to take its own set bit — no
    per-entry slot caps, so any contact density is exact.  Output slots
    are filled ``chunk`` at a time up to the contact total, so the cost
    follows the contacts found, not the capacity.

    Returns ``(gi, gj, total)``: (capacity,) int32 global sorted positions
    (a side, b side) of the first ``min(total, capacity)`` contacts (zero
    beyond), and the exact contact total (``total > capacity`` means the
    stream was truncated).
    """
    _check_fields(mask_kind, a_bands, b_tiles)
    BH = a_bands[0].shape[1]
    G = b_tiles[0].shape[1]
    flat = rows.reshape(-1)
    total = jnp.sum(flat, dtype=jnp.int32)
    live = flat > 0
    v = live.astype(jnp.int32)
    pos = jnp.cumsum(v, dtype=jnp.int32) - v
    dst = jnp.where(live, pos, capacity)
    hit = jnp.zeros((capacity,), jnp.int32).at[dst].set(
        jnp.arange(flat.shape[0], dtype=jnp.int32), mode="drop")
    nhit = jnp.minimum(jnp.sum(v, dtype=jnp.int32), capacity)
    cnt = jnp.where(jnp.arange(capacity, dtype=jnp.int32) < nhit,
                    flat[hit], 0)
    incl = jnp.cumsum(cnt, dtype=jnp.int32)
    n_out = jnp.minimum(total, capacity)

    CH = min(chunk, capacity)
    n_chunks = -(-capacity // CH)

    def body(c, out):
        s = (c * CH).astype(jnp.int32)
        k = s + jnp.arange(CH, dtype=jnp.int32)
        slot_row = jnp.minimum(
            jnp.searchsorted(incl, k, side="right").astype(jnp.int32),
            capacity - 1)
        q = k - (incl[slot_row] - cnt[slot_row])     # rank within the row
        row = hit[slot_row]
        e = row // BH
        i = row % BH
        ea_k = ea[e]
        eb_k = eb[e]
        a = [f[ea_k, i][:, None] for f in a_bands]
        b = [f[eb_k] for f in b_tiles]
        m = contact_mask(mask_kind, a, b)             # (CH, G)
        gi = (ea_k // NB) * G + (ea_k % NB) * BH + i
        if dedup:
            m &= (eb_k * G)[:, None] + \
                jax.lax.broadcasted_iota(jnp.int32, (1, G), 1) > gi[:, None]
        csum = jnp.cumsum(m.astype(jnp.int32), axis=1, dtype=jnp.int32)
        j = jnp.sum(csum <= q[:, None], axis=1, dtype=jnp.int32)
        gj = eb_k * G + jnp.minimum(j, G - 1)
        ok = k < n_out
        return jax.lax.dynamic_update_slice(
            out, jnp.stack([jnp.where(ok, gi, 0), jnp.where(ok, gj, 0)]),
            (jnp.int32(0), s))

    out = jax.lax.fori_loop(0, (n_out + CH - 1) // CH, body,
                            jnp.zeros((2, n_chunks * CH), jnp.int32))
    return out[0, :capacity], out[1, :capacity], total
