"""Phase-1b band bits: which a-side sub-bands can touch which b-side tiles.

Nearly every leaf test of a tile pair misses (57.9k contacts from 1.6e9
candidate tests on the 1M-leaf benchmark scene), so the candidate count
itself must drop.  For every surviving supertile pair of phase 1 this
computes an ``n_bands``-bit word per (a-tile, b-tile) pair saying which
(G / n_bands)-leaf sub-bands of the a-tile overlap the b-tile's AABB.  The
count pass then tests only the live (band, b-tile) blocks, and ``bits > 0``
is a stricter pair filter than the tile-vs-tile AABB test (every leaf lies
inside its sub-band box, so a pair with no overlapping band holds no
contacts).

Semantics parity note: this is a broad-phase refinement with no reference
counterpart — the reference prunes via its implicit tree instead
(ref src/traverse/traverse.jl:19-34); contact sets are unchanged because
band boxes cover all leaves.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

SS = 32        # tiles per supertile (matches traverse/tiles.py phase 1)


def _rows(c, S: int, fill):
    """Pad (T, ...) to S * SS tiles with ``fill`` and view as (S, SS, ...)."""
    pad = S * SS - c.shape[0]
    if pad:
        c = jnp.concatenate(
            [c, jnp.full((pad,) + c.shape[1:], fill, c.dtype)])
    return c.reshape((S, SS) + c.shape[1:])


@functools.partial(
    jax.jit, static_argnames=("Ta", "Tb", "triangle", "n_bands"))
def subtile_band_bits(sub_lo, sub_up, tile_lo, tile_up, si, sj, nsp, *,
                      Ta: int, Tb: int, triangle: bool = True,
                      n_bands: int = 4):
    """Band-bit words for every candidate supertile pair.

    - ``sub_lo``/``sub_up``: 3-tuples of (Ta, n_bands) per-sub-band bounds
      of the *a* side (lo/up per axis).
    - ``tile_lo``/``tile_up``: 3-tuples of (Tb,) tile bounds of the *b*
      side (equal to the a side's for self-contact).
    - ``si``/``sj``: (SP_cap,) int32 supertile pair rows/cols (a/b side).
    - ``nsp``: number of valid supertile pairs.

    Returns ``bits`` (SP_cap, SS, SS) int32 — bit r of ``bits[p, i, j]``
    set iff sub-band r of a-tile ``si[p]*SS+i`` overlaps b-tile
    ``sj[p]*SS+j``; zero for invalid pairs, tiles past ``Ta``/``Tb`` and,
    with ``triangle``, below the diagonal (a-tile > b-tile).
    """
    Sa = -(-Ta // SS)
    Sb = -(-Tb // SS)
    alo = [_rows(c, Sa, jnp.inf)[si][:, :, None, :] for c in sub_lo]
    aup = [_rows(c, Sa, -jnp.inf)[si][:, :, None, :] for c in sub_up]
    blo = [_rows(c, Sb, jnp.inf)[sj][:, None, :, None] for c in tile_lo]
    bup = [_rows(c, Sb, -jnp.inf)[sj][:, None, :, None] for c in tile_up]
    ov = (aup[0] >= blo[0]) & (alo[0] <= bup[0])
    ov &= (aup[1] >= blo[1]) & (alo[1] <= bup[1])
    ov &= (aup[2] >= blo[2]) & (alo[2] <= bup[2])     # (SP, SS, SS, NB)
    wts = jnp.left_shift(1, jnp.arange(n_bands, dtype=jnp.int32))
    bits = jnp.sum(jnp.where(ov, wts, 0), axis=3, dtype=jnp.int32)

    SP_cap = si.shape[0]
    shape = (SP_cap, SS, SS)
    tii = si[:, None, None] * SS + jax.lax.broadcasted_iota(jnp.int32,
                                                            shape, 1)
    tjj = sj[:, None, None] * SS + jax.lax.broadcasted_iota(jnp.int32,
                                                            shape, 2)
    valid = (tii < Ta) & (tjj < Tb)
    valid &= jax.lax.broadcasted_iota(jnp.int32, shape, 0) < nsp
    if triangle:
        valid &= tii <= tjj
    return jnp.where(valid, bits, 0)
