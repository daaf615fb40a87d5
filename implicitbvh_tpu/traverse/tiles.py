"""Tile traversal — the dense broad-phase engine for contact queries.

A flat 2-level scheme in place of a tree walk:

1. Morton-sorted leaves are grouped into tiles of ``G`` (default 128);
   tile AABBs and per-band AABBs (``G // bands`` leaves each) come from
   reshape-reductions.
2. Phase 1: a dense supertile-vs-supertile AABB test (32 tiles per
   supertile, upper triangle for self-contact) yields candidate supertile
   pairs; for each, the band bits (ops/subtile.py) say which a-bands can
   touch which b-tiles.  The live (a-band, b-tile) *entries* are
   compacted with cumsum + scatter.
3. Phase 2 (ops/tile_contact.py): a count pass tests every entry's
   ``(G // bands, G)`` leaf block and keeps per-row contact counts; an
   emit pass turns the counts into a dense stream of contact positions.
4. User indices are applied and pairs emitted as sorted (min, max) for
   self-contact or tree order for two BVHs — identical contact sets to
   LVT/BFS traversal.

The implicit tree prunes more candidates than the tiles do, but its walk
is a sequence of dependent gathers per leaf; the tile scheme trades more
candidate tests for dense, independent work — the trade the reference
documents between BFS and LVT (ref src/traverse/traverse.jl:19-34), taken
one step further.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..build import BVH
from ..ops.subtile import SS, subtile_band_bits
from ..ops.tile_contact import (band_emit, band_row_counts,
                                band_row_counts_triton)
from ..options import DEFAULT_OPTIONS, BVHOptions
from ..volumes import BSphere
from .types import BVHTraversal, TraversalAlgorithm


@dataclasses.dataclass(frozen=True)
class TileTraversal(TraversalAlgorithm):
    """Dense-tile traversal parameters.

    - ``tile``: leaves per tile (G).  A tile pair is the unit of the
      broad phase; a smaller tile prunes more finely at the cost of a
      larger phase 1.
    - ``bands``: sub-bands per a-side tile (4, 8 or 16).  A live
      (band, b-tile) entry costs ``(tile // bands) * tile`` leaf tests, so
      finer bands cut dead tests at the cost of more entries.

    There are no per-pair slot caps: the emit pass is exact at any contact
    density.  Output and candidate-list capacities overflow into the host
    wrapper's growth loop.
    """

    tile: int = 128
    bands: int = 4


# Capacity heuristics, from the densities of unit-density random scenes
# (1M soup: 47 live entries per tile; 100k random rays x 262k BVs: 845
# per ray tile); the headroom absorbs scene variation and the wrappers'
# growth loops cover the rest.
ENTRIES_PER_TILE = 72            # live (band, b-tile) entries, at 4 bands
SUPERPAIRS_PER_SUPERTILE = 24
RAY_ENTRIES_PER_RAY_TILE = 1280  # live (ray band, leaf tile) entries
ENTRY_CHUNK = 1 << 16            # entries per step of the plain count pass

# The count pass each backend runs: the Triton kernel where it measured
# faster end to end (PERF.md, "Kernels"), the plain pass elsewhere.
COUNT_PASS = {"gpu": "triton"}


def _pair_capacity_for(num_tiles: int, bands: int = 4) -> int:
    """Static capacity of the candidate entry list."""
    cap = num_tiles * ENTRIES_PER_TILE * bands // 4
    return max(-(-cap // 8192) * 8192, 8192)


def _grow_capacity(capacity: int, growth: float) -> int:
    """Scale a buffer capacity by ``BVHOptions.capacity_growth``: small
    capacities stay powers of two, larger ones round up to 1024 (fewer
    distinct compiled shapes).  Always grows."""
    new = max(int(capacity * growth), capacity + 1)
    if new <= 1024:
        return 1 << math.ceil(math.log2(new))
    return -(-new // 1024) * 1024


def _overlap(alo, aup, blo, bup, bc=lambda x: x[:, None],
             br=lambda x: x[None, :]):
    ov = (bc(aup[0]) >= br(blo[0])) & (bc(alo[0]) <= br(bup[0]))
    ov &= (bc(aup[1]) >= br(blo[1])) & (bc(alo[1]) <= br(bup[1]))
    ov &= (bc(aup[2]) >= br(blo[2])) & (bc(alo[2]) <= br(bup[2]))
    return ov


def _compact_flat(flat, values, cap, pad=0):
    """cumsum+scatter compaction of ``values`` where ``flat``; (out, count)."""
    v = flat.astype(jnp.int32)
    pos = jnp.cumsum(v, dtype=jnp.int32) - v
    posx = jnp.where(flat, pos, cap)
    out = jnp.full((cap,), pad, values.dtype).at[posx].set(values,
                                                           mode="drop")
    return out, jnp.sum(v, dtype=jnp.int32)


def _supertile_bounds(tile_lo, tile_up):
    """(S,) supertile AABBs of SS consecutive tiles (pad tiles never
    overlap anything)."""
    T = tile_lo[0].shape[0]
    S = -(-T // SS)
    pad = S * SS - T

    def padt(a, fill):
        if pad:
            a = jnp.concatenate([a, jnp.full((pad,), fill, a.dtype)])
        return a.reshape(S, SS)

    return (tuple(padt(c, jnp.inf).min(1) for c in tile_lo),
            tuple(padt(c, -jnp.inf).max(1) for c in tile_up), S)


def _superpair_cap(S1: int, S2: int, P_cap: int, sp_round: int) -> int:
    # scale with P_cap so the wrapper's growth loop also grows this level
    cap = max(S1 * SUPERPAIRS_PER_SUPERTILE, S2 * SUPERPAIRS_PER_SUPERTILE,
              64, P_cap // 128)
    return -(-cap // sp_round) * sp_round


def _phase1_superpairs(tile_lo, tile_up, P_cap: int, sp_round: int = 16):
    """Level A of phase 1: dense supertile-vs-supertile AABB overlap
    (upper triangle) compacted to a superpair list.

    Shared by the single-device engine and the multi-device path, which
    deals the *superpair list* out to the devices (``sp_round`` rounds the
    list's capacity up so it splits evenly).  Returns
    ``(si, sj, nsp, overflow)``.
    """
    slo, sup, S = _supertile_bounds(tile_lo, tile_up)
    ovA = _overlap(slo, sup, slo, sup)
    ovA &= jax.lax.broadcasted_iota(jnp.int32, (S, S), 0) <= \
        jax.lax.broadcasted_iota(jnp.int32, (S, S), 1)
    SP_cap = _superpair_cap(S, S, P_cap, sp_round)
    kA = jnp.arange(S * S, dtype=jnp.int32)
    spacked, nsp = _compact_flat(ovA.reshape(-1), kA, SP_cap)
    return spacked // S, spacked % S, nsp, nsp > SP_cap


def _phase1_cross_superpairs(tlo1, tup1, tlo2, tup2, P_cap: int,
                             sp_round: int = 16):
    """Two-BVH level A: the full S1 x S2 supertile grid, no triangle (the
    reference's pair-traversal semantics, ref traverse_pair_cpu.jl:615-645).
    Returns ``(si, sj, nsp, overflow)``."""
    slo1, sup1, S1 = _supertile_bounds(tlo1, tup1)
    slo2, sup2, S2 = _supertile_bounds(tlo2, tup2)
    ovA = _overlap(slo1, sup1, slo2, sup2)
    SP_cap = _superpair_cap(S1, S2, P_cap, sp_round)
    kA = jnp.arange(S1 * S2, dtype=jnp.int32)
    spacked, nsp = _compact_flat(ovA.reshape(-1), kA, SP_cap)
    return spacked // S2, spacked % S2, nsp, nsp > SP_cap


def _live_bands(bits, NB: int):
    """Flat liveness of every (element of ``bits``, band) pair."""
    r = jnp.arange(NB, dtype=jnp.int32)
    return ((bits[..., None] >> r) & 1).reshape(-1) != 0


def _entries_from_bits(bits, si, sj, NB: int, cap: int):
    """Compact the live bands of (SP_cap, SS, SS) superpair band bits into
    ``(ea, eb, ne)``: a-band row (``ti * NB + band``), b-tile and the live
    count (> cap signals overflow)."""
    idx, ne = _compact_flat(_live_bands(bits, NB),
                            jnp.arange(bits.size * NB, dtype=jnp.int32), cap)
    per_sp = SS * SS * NB
    p = idx // per_sp
    rem = idx % per_sp
    ti = si[p] * SS + rem // (SS * NB)
    tj = sj[p] * SS + (rem // NB) % SS
    return ti * NB + rem % NB, tj, ne


def _band_contacts(a_fields, b_fields, ea, eb, ne, mask_kind: str, NB: int,
                   dedup: bool, capacity: int):
    """Count + emit over the entry list: (capacity,) a/b sorted positions
    and the exact contact total.  ``a_fields`` are (Ta, G) tiles, viewed
    here as (Ta * NB, G // NB) bands."""
    BH = a_fields[0].shape[1] // NB
    a_bands = tuple(f.reshape(-1, BH) for f in a_fields)
    with jax.named_scope("tiles/count"):
        if COUNT_PASS.get(jax.default_backend()) == "triton":
            rows = band_row_counts_triton(a_bands, b_fields, ea, eb, ne,
                                          mask_kind=mask_kind, NB=NB,
                                          dedup=dedup)
        else:
            rows = band_row_counts(a_bands, b_fields, ea, eb, ne,
                                   mask_kind=mask_kind, NB=NB, dedup=dedup,
                                   chunk=ENTRY_CHUNK)
    with jax.named_scope("tiles/emit"):
        return band_emit(rows, a_bands, b_fields, ea, eb,
                         mask_kind=mask_kind, NB=NB, dedup=dedup,
                         capacity=capacity)


def _tiled_fields(bvh: BVH, G: int, NB: int = 4):
    """Tile the sorted leaf fields to (T, G) plus tile AABBs (T,) and
    per-(G/NB)-leaf band AABBs (T, NB) (tuples per axis)."""
    vol = bvh.leaves.volume
    n = bvh.num_leaves
    T = -(-n // G)
    pad = T * G - n

    def padded(a, fill):
        if pad:
            a = jnp.concatenate([a, jnp.full((pad,), fill, a.dtype)])
        return a.reshape(T, G)

    # NaN field padding: every predicate comparison against a padded leaf
    # is false, so no validity guard is needed for the trailing tile; the
    # bound pads are min/max-neutral
    nan = float("nan")
    if isinstance(vol, BSphere):
        fields = tuple(padded(c, nan) for c in vol.xs) + (padded(vol.r, nan),)
        blos = tuple(padded(vol.xs[k] - vol.r, jnp.inf) for k in range(3))
        bups = tuple(padded(vol.xs[k] + vol.r, -jnp.inf) for k in range(3))
        sphere = True
    else:
        fields = tuple(padded(c, nan) for c in vol.los) + \
            tuple(padded(c, nan) for c in vol.ups)
        blos = tuple(padded(c, jnp.inf) for c in vol.los)
        bups = tuple(padded(c, -jnp.inf) for c in vol.ups)
        sphere = False
    sub_lo = tuple(b.reshape(T, NB, G // NB).min(axis=2) for b in blos)
    sub_up = tuple(b.reshape(T, NB, G // NB).max(axis=2) for b in bups)
    tile_lo = tuple(b.min(axis=1) for b in sub_lo)
    tile_up = tuple(b.max(axis=1) for b in sub_up)
    return fields, sphere, tile_lo, tile_up, sub_lo, sub_up, T


def _finish_contacts(out_gi, out_gj, total, leaf_index, narrow_mask_fn,
                     capacity: int, leaf_index_b=None,
                     sort_pairs: bool = True):
    """Map a dense (capacity,) stream of global sorted positions to the
    final user-index contact list: index mapping, optional narrow
    filtering (re-compacted), and pair ordering."""
    lane = jnp.arange(capacity, dtype=jnp.int32)
    if leaf_index_b is None:
        leaf_index_b = leaf_index
    n = leaf_index.shape[0]
    nb = leaf_index_b.shape[0]
    out_gi = jnp.clip(out_gi, 0, n - 1)
    out_gj = jnp.clip(out_gj, 0, nb - 1)
    ui = leaf_index[out_gi]
    uj = leaf_index_b[out_gj]
    in_range = lane < total
    if narrow_mask_fn is not None:
        keep = in_range & narrow_mask_fn(out_gi, out_gj)
        k = keep.astype(jnp.int32)
        pos2 = jnp.cumsum(k, dtype=jnp.int32) - k
        posx2 = jnp.where(keep, pos2, capacity)
        ui = jnp.zeros((capacity,), ui.dtype).at[posx2].set(ui, mode="drop")
        uj = jnp.zeros((capacity,), uj.dtype).at[posx2].set(uj, mode="drop")
        total = jnp.sum(k, dtype=jnp.int32)
        in_range = lane < total
    if sort_pairs:
        a = jnp.where(in_range, jnp.minimum(ui, uj), 0)
        b = jnp.where(in_range, jnp.maximum(ui, uj), 0)
    else:
        a = jnp.where(in_range, ui, 0)
        b = jnp.where(in_range, uj, 0)
    return total, jnp.stack([a, b], axis=-1)


def _leaf_narrow(narrow, leaves_a, leaves_b):
    """Adapt a user ``narrow(leaves_i, leaves_j)`` predicate to sorted
    positions; None stays None."""
    if narrow is None:
        return None

    def narrow_fn(gi, gj):
        la = jax.tree_util.tree_map(lambda x: x[gi], leaves_a)
        lb = jax.tree_util.tree_map(lambda x: x[gj], leaves_b)
        return narrow(la, lb)

    return narrow_fn


def _overflow_bits(contact_over, candidate_over):
    """Overflow bitmask: bit 0 = the contact buffer (grow ``capacity``),
    bit 1 = a candidate list (grow ``pair_capacity``)."""
    return (jnp.where(contact_over, 1, 0) | jnp.where(candidate_over, 2, 0)
            ).astype(jnp.int32)


@partial(jax.jit, static_argnames=("capacity", "alg", "pair_capacity",
                                   "narrow"))
def traverse_tiles_fixed(bvh: BVH, capacity: int, *,
                         alg: "TileTraversal" = None,
                         pair_capacity: Optional[int] = None,
                         narrow=None):
    """Fully-traced fixed-capacity tile self-contact traversal.

    Returns ``(total, contacts, overflow, num_checks)``; ``overflow`` is
    nonzero when a static capacity (bit 0: the contact buffer, bit 1: the
    candidate lists) was exceeded and results are incomplete — the
    :func:`traverse_tiles` wrapper grows and re-runs.  ``num_checks`` is
    the number of leaf-pair tests of the live entries (the tile engine's
    analogue of the reference's traversal self-metric,
    ref traverse.jl:48,59).
    """
    alg = alg or TileTraversal()
    G, NB = alg.tile, alg.bands
    if pair_capacity is None:
        pair_capacity = _pair_capacity_for(-(-bvh.num_leaves // G), NB)
    fields, sphere, ea, eb, ne, sp_over = _self_entries(bvh, G, NB,
                                                        pair_capacity)
    gi, gj, raw_total = _band_contacts(
        fields, fields, ea, eb, ne, "sphere" if sphere else "box", NB,
        dedup=True, capacity=capacity)
    with jax.named_scope("tiles/finish"):
        total, contacts = _finish_contacts(
            gi, gj, raw_total, bvh.leaves.index,
            _leaf_narrow(narrow, bvh.leaves, bvh.leaves), capacity)
    overflow = _overflow_bits(raw_total > capacity,
                              sp_over | (ne > pair_capacity))
    num_checks = ne.astype(jnp.float32) * ((G // NB) * G)
    return total, contacts, overflow, num_checks


def _self_entries(bvh: BVH, G: int, NB: int, pair_capacity: int):
    """Phase 1 of self-contact: ``(fields, sphere, ea, eb, ne,
    sp_overflow)`` — the tiled leaf fields and the live entry list."""
    with jax.named_scope("tiles/phase1"):
        fields, sphere, tile_lo, tile_up, sub_lo, sub_up, T = \
            _tiled_fields(bvh, G, NB)
        si, sj, nsp, sp_over = _phase1_superpairs(tile_lo, tile_up,
                                                  pair_capacity)
        bits = subtile_band_bits(sub_lo, sub_up, tile_lo, tile_up, si, sj,
                                 nsp, Ta=T, Tb=T, triangle=True, n_bands=NB)
        ea, eb, ne = _entries_from_bits(bits, si, sj, NB, pair_capacity)
    return fields, sphere, ea, eb, ne, sp_over


def _grow_loop(run, capacity: int, pair_capacity: int,
               options: BVHOptions):
    """Host wrapper loop: run the fixed-capacity traversal, growing the
    capacities named by its overflow bits.  Returns ``(total, contacts,
    num_checks, pair_capacity)`` or None if the scene outgrew 8 rounds."""
    for _ in range(8):
        total, contacts, overflow, num_checks = run(capacity, pair_capacity)
        ov = int(overflow)
        if ov == 0:
            return total, contacts, num_checks, pair_capacity
        if ov & 1:
            capacity = _grow_capacity(capacity, options.capacity_growth)
        if ov & 2:
            pair_capacity = _grow_capacity(pair_capacity,
                                           options.capacity_growth)
    return None


def _initial_capacity(need: int, options: BVHOptions,
                      cache: Optional[BVHTraversal]) -> int:
    if cache is not None and cache.cache1.ndim == 2 \
            and cache.cache1.shape[0] > 0:
        return cache.cache1.shape[0]
    return 1 << math.ceil(math.log2(max(options.min_capacity, need)))


def traverse_tiles(bvh: BVH, *, alg: "TileTraversal" = None, narrow=None,
                   cache: Optional[BVHTraversal] = None,
                   options: BVHOptions = DEFAULT_OPTIONS) -> BVHTraversal:
    """Host wrapper with overflow-driven capacity growth.

    ``cache``: a previous traversal result; its (compiled) capacities are
    re-used so moving-geometry loops perform zero new compiles when shapes
    repeat (the reference's cache-reuse contract, ref traverse.jl:120-145).
    """
    alg = alg or TileTraversal()
    idt = bvh.skips.dtype
    if bvh.tree.real_nodes <= 1:
        return BVHTraversal(num_contacts=jnp.zeros((), idt),
                            cache1=jnp.zeros((0, 2), idt),
                            cache2=jnp.zeros((0,), idt), start_level1=1)
    # the contact buffer starts at one slot per leaf (a unit-density scene
    # holds ~0.06 contacts per leaf); denser scenes grow it
    capacity = _initial_capacity(bvh.num_leaves, options, cache)
    if cache is not None and cache.pair_capacity > 0:
        pair_capacity = cache.pair_capacity
    else:
        pair_capacity = _pair_capacity_for(-(-bvh.num_leaves // alg.tile),
                                           alg.bands)

    def run(cap, pcap):
        return traverse_tiles_fixed(bvh, cap, alg=alg, pair_capacity=pcap,
                                    narrow=narrow)

    done = _grow_loop(run, capacity, pair_capacity, options)
    if done is None:
        from .api import traverse as _traverse
        from .types import LVTTraversal
        return _traverse(bvh, LVTTraversal(), narrow=narrow, options=options)
    total, contacts, num_checks, pair_capacity = done
    return BVHTraversal(num_contacts=int(total), cache1=contacts,
                        cache2=jnp.zeros((0,), idt), start_level1=1,
                        num_checks=int(num_checks),
                        pair_capacity=pair_capacity, tile_alg=alg)


# --------------------------------------------------------------------------
# Two-BVH tile traversal
# --------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("capacity", "alg", "pair_capacity",
                                   "narrow"))
def traverse_tiles_pair_fixed(bvh1: BVH, bvh2: BVH, capacity: int, *,
                              alg: "TileTraversal" = None,
                              pair_capacity: Optional[int] = None,
                              narrow=None):
    """Fully-traced fixed-capacity two-BVH tile traversal.

    Returns ``(total, contacts, overflow, num_checks)``; contacts are
    tree-order (index-in-bvh1, index-in-bvh2) pairs including symmetric and
    (i, i) pairs — the reference's pair-traversal semantics
    (ref traverse_pair_cpu.jl:615-645).  Both BVHs must have the same leaf
    volume kind.
    """
    alg = alg or TileTraversal()
    G, NB = alg.tile, alg.bands
    if bvh1.leaf_kind is not bvh2.leaf_kind:
        raise NotImplementedError(
            "tile pair traversal requires matching leaf volume kinds")
    f1, sphere, tlo1, tup1, asub_lo, asub_up, T1 = \
        _tiled_fields(bvh1, G, NB)
    f2, _, tlo2, tup2, _, _, T2 = _tiled_fields(bvh2, G)
    if pair_capacity is None:
        pair_capacity = _pair_capacity_for((T1 + T2) // 2, NB)

    si, sj, nsp, sp_over = _phase1_cross_superpairs(
        tlo1, tup1, tlo2, tup2, pair_capacity)
    bits = subtile_band_bits(asub_lo, asub_up, tlo2, tup2, si, sj, nsp,
                             Ta=T1, Tb=T2, triangle=False, n_bands=NB)
    ea, eb, ne = _entries_from_bits(bits, si, sj, NB, pair_capacity)
    gi, gj, raw_total = _band_contacts(
        f1, f2, ea, eb, ne, "sphere" if sphere else "box", NB,
        dedup=False, capacity=capacity)
    total, contacts = _finish_contacts(
        gi, gj, raw_total, bvh1.leaves.index,
        _leaf_narrow(narrow, bvh1.leaves, bvh2.leaves), capacity,
        leaf_index_b=bvh2.leaves.index, sort_pairs=False)
    overflow = _overflow_bits(raw_total > capacity,
                              sp_over | (ne > pair_capacity))
    num_checks = ne.astype(jnp.float32) * ((G // NB) * G)
    return total, contacts, overflow, num_checks


def traverse_tiles_pair(bvh1: BVH, bvh2: BVH, *, alg: "TileTraversal" = None,
                        narrow=None,
                        cache: Optional[BVHTraversal] = None,
                        options: BVHOptions = DEFAULT_OPTIONS
                        ) -> BVHTraversal:
    """Host wrapper with overflow-driven capacity growth (two-BVH)."""
    alg = alg or TileTraversal()
    idt = bvh1.skips.dtype
    capacity = _initial_capacity(2 * max(bvh1.num_leaves, bvh2.num_leaves),
                                 options, cache)
    if cache is not None and cache.pair_capacity > 0:
        pair_capacity = cache.pair_capacity
    else:
        T = (-(-bvh1.num_leaves // alg.tile)) + \
            (-(-bvh2.num_leaves // alg.tile))
        pair_capacity = _pair_capacity_for(T // 2, alg.bands)

    def run(cap, pcap):
        return traverse_tiles_pair_fixed(bvh1, bvh2, cap, alg=alg,
                                         pair_capacity=pcap, narrow=narrow)

    done = _grow_loop(run, capacity, pair_capacity, options)
    if done is None:
        from .api import traverse as _traverse
        from .types import LVTTraversal
        return _traverse(bvh1, bvh2, LVTTraversal(), narrow=narrow,
                         options=options)
    total, contacts, num_checks, pair_capacity = done
    return BVHTraversal(num_contacts=int(total), cache1=contacts,
                        cache2=jnp.zeros((0,), idt), start_level1=1,
                        start_level2=1, num_checks=int(num_checks),
                        pair_capacity=pair_capacity, tile_alg=alg)
