"""Bounding volumes: coordinate-tuple SoA bounding spheres and boxes.

Counterpart of the reference geometry core
(/root/reference/src/bounding_volumes/): ``BSphere``/``BBox`` structs,
triangle constructors, the merge monoid, overlap predicates and ray
intersection tests.

Layout rationale: the reference stores AoS ``Vector{BSphere{T}}``; here
each coordinate is its own ``(N,)`` array (a 3-tuple), so every field is a
contiguous, unit-stride vector that XLA fuses and gathers without
relayouts (an ``(N, 3)`` array would interleave the axes).  Public constructors
still accept ``(N, 3)`` arrays and ``.x``/``.lo``/``.up`` properties
re-stack for convenience; all internal math is per-coordinate.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import jax
import jax.numpy as jnp

Coords = Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]


def as_coords(x) -> Coords:
    """Normalize an (..., 3) array (or a 3-sequence of arrays) to a
    coordinate 3-tuple of equal-shape arrays."""
    if isinstance(x, (tuple, list)):
        if len(x) != 3:
            raise ValueError(f"coordinate tuple must have 3 entries, got {len(x)}")
        a, b, c = (jnp.asarray(v) for v in x)
        return (a, b, c)
    x = jnp.asarray(x)
    if x.shape[-1] != 3:
        raise ValueError(f"expected trailing dimension 3, got shape {x.shape}")
    return (x[..., 0], x[..., 1], x[..., 2])


def stack_coords(c: Coords):
    return jnp.stack(c, axis=-1)


# per-coordinate scalar math (ref src/utils.jl:160-181)

def dot3(a: Coords, b: Coords):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def dist3sq(a: Coords, b: Coords):
    d0, d1, d2 = a[0] - b[0], a[1] - b[1], a[2] - b[2]
    return d0 * d0 + d1 * d1 + d2 * d2


def dist3(a: Coords, b: Coords):
    return jnp.sqrt(dist3sq(a, b))


def _map3(f, *cs):
    return tuple(f(*[c[k] for c in cs]) for k in range(3))


class _BSphereFields(NamedTuple):
    xs: Coords
    r: jnp.ndarray


class BSphere(_BSphereFields):
    """Bounding sphere; ref /root/reference/src/bounding_volumes/bsphere.jl:26-142.

    ``xs`` is the center coordinate tuple (3 x (...,) arrays), ``r`` the
    radius array.  ``BSphere(centers_(N,3), r)`` also works.
    """

    __slots__ = ()

    def __new__(cls, xs, r):
        return super().__new__(cls, as_coords(xs), jnp.asarray(r))

    @property
    def x(self):
        """Centers re-stacked as an (..., 3) array (convenience view)."""
        return stack_coords(self.xs)

    @property
    def dtype(self):
        return self.r.dtype

    @property
    def batch_shape(self):
        return self.r.shape

    def __getitem__(self, idx):
        return tuple.__new__(BSphere,
                             (tuple(c[idx] for c in self.xs), self.r[idx]))


class _BBoxFields(NamedTuple):
    los: Coords
    ups: Coords


class BBox(_BBoxFields):
    """Axis-aligned box; ref /root/reference/src/bounding_volumes/bbox.jl:35-102."""

    __slots__ = ()

    def __new__(cls, lo, up):
        return super().__new__(cls, as_coords(lo), as_coords(up))

    @property
    def lo(self):
        return stack_coords(self.los)

    @property
    def up(self):
        return stack_coords(self.ups)

    @property
    def dtype(self):
        return self.los[0].dtype

    @property
    def batch_shape(self):
        return self.los[0].shape

    def __getitem__(self, idx):
        return tuple.__new__(BBox, (tuple(c[idx] for c in self.los),
                                    tuple(c[idx] for c in self.ups)))


Volume = Union[BSphere, BBox]


def center_coords(v: Volume) -> Coords:
    """Geometric center coordinate tuple; ref bsphere.jl:142, bbox.jl:100-102."""
    if isinstance(v, BSphere):
        return v.xs
    return _map3(lambda lo, up: 0.5 * (lo + up), v.los, v.ups)


def center(v: Volume):
    """Geometric centers as an (..., 3) array (public convenience; internal
    code uses :func:`center_coords` to stay in the padded-free layout)."""
    return stack_coords(center_coords(v))


# --------------------------------------------------------------------------
# Constructors from triangles (vectorized over the batch dim)
# --------------------------------------------------------------------------

def bbox_from_triangles(p1, p2, p3) -> BBox:
    """AABBs of triangles given three (..., 3) vertex arrays (or coordinate
    tuples).  Ref: src/bounding_volumes/bbox.jl:59-70."""
    a, b, c = as_coords(p1), as_coords(p2), as_coords(p3)
    lo = _map3(lambda x, y, z: jnp.minimum(jnp.minimum(x, y), z), a, b, c)
    up = _map3(lambda x, y, z: jnp.maximum(jnp.maximum(x, y), z), a, b, c)
    return BBox(lo, up)


def bsphere_from_triangles(p1, p2, p3) -> BSphere:
    """Minimal bounding spheres of triangles given three (..., 3) vertex
    arrays (or coordinate tuples).

    Vectorized port of the Ericson-style circumsphere with collinear and
    obtuse-angle special cases (ref src/bounding_volumes/bsphere.jl:43-112);
    the branch chain becomes nested ``jnp.where`` selection.
    """
    a, b, c = as_coords(p1), as_coords(p2), as_coords(p3)
    T = a[0].dtype
    ab = _map3(lambda x, y: y - x, a, b)
    ac = _map3(lambda x, y: y - x, a, c)
    abab = dot3(ab, ab)
    abac = dot3(ab, ac)
    acac = dot3(ac, ac)
    d = 2.0 * (abab * acac - abac * abac)

    eps = jnp.finfo(T).eps

    # Case 1: collinear — AABB center of the three points.
    lo = _map3(lambda x, y, z: jnp.minimum(jnp.minimum(x, y), z), a, b, c)
    up = _map3(lambda x, y, z: jnp.maximum(jnp.maximum(x, y), z), a, b, c)
    c_lin = _map3(lambda l, u: 0.5 * (l + u), lo, up)
    r_lin = dist3(c_lin, up)

    d_safe = jnp.where(jnp.abs(d) <= eps, 1.0, d)
    s = (abab * acac - acac * abac) / d_safe
    t = (acac * abab - abab * abac) / d_safe

    c_s0 = _map3(lambda x, y: 0.5 * (x + y), a, c)
    c_t0 = _map3(lambda x, y: 0.5 * (x + y), a, b)
    c_st = _map3(lambda x, y: 0.5 * (x + y), b, c)
    c_in = tuple(a[k] + s * ab[k] + t * ac[k] for k in range(3))

    r_s0 = dist3(c_s0, a)
    r_t0 = dist3(c_t0, a)
    r_st = dist3(c_st, b)
    r_in = dist3(c_in, a)

    # Nested selection mirrors the reference's branch order exactly.
    cen = _map3(lambda ci, cs: jnp.where(s + t >= 1.0, cs, ci), c_in, c_st)
    rad = jnp.where(s + t >= 1.0, r_st, r_in)
    cen = _map3(lambda cc, ct: jnp.where(t <= 0.0, ct, cc), cen, c_t0)
    rad = jnp.where(t <= 0.0, r_t0, rad)
    cen = _map3(lambda cc, cs: jnp.where(s <= 0.0, cs, cc), cen, c_s0)
    rad = jnp.where(s <= 0.0, r_s0, rad)
    cen = _map3(lambda cc, cl: jnp.where(jnp.abs(d) <= eps, cl, cc), cen, c_lin)
    rad = jnp.where(jnp.abs(d) <= eps, r_lin, rad)

    return BSphere(cen, rad)


def from_triangles(kind, p1, p2, p3) -> Volume:
    """Dispatch helper: ``kind`` is the BSphere or BBox class."""
    if kind is BSphere:
        return bsphere_from_triangles(p1, p2, p3)
    if kind is BBox:
        return bbox_from_triangles(p1, p2, p3)
    raise TypeError(f"unknown volume kind {kind}")


# --------------------------------------------------------------------------
# Merge monoid (ref: src/bounding_volumes/merge.jl:1-85)
# --------------------------------------------------------------------------

def merge(a: Volume, b: Volume) -> Volume:
    """Merge two bounding volumes of the same kind (the tree-build monoid)."""
    if isinstance(a, BSphere) and isinstance(b, BSphere):
        return merge_bspheres(a, b)
    if isinstance(a, BBox) and isinstance(b, BBox):
        return merge_bboxes(a, b)
    raise TypeError(f"cannot merge {type(a)} with {type(b)}")


def merge_bspheres(a: BSphere, b: BSphere) -> BSphere:
    """Enclosure-aware sphere+sphere merge; ref merge.jl:2-22."""
    length = dist3(a.xs, b.xs)
    a_in_b = length + a.r <= b.r
    b_in_a = length + b.r <= a.r

    len_safe = jnp.where(length == 0.0, 1.0, length)
    frac = 0.5 * ((b.r - a.r) / len_safe + 1.0)
    cen = tuple(a.xs[k] + frac * (b.xs[k] - a.xs[k]) for k in range(3))
    rad = 0.5 * (length + a.r + b.r)

    cen = tuple(jnp.where(b_in_a, a.xs[k],
                          jnp.where(a_in_b, b.xs[k], cen[k])) for k in range(3))
    rad = jnp.where(b_in_a, a.r, jnp.where(a_in_b, b.r, rad))
    return BSphere(cen, rad)


def merge_bboxes(a: BBox, b: BBox) -> BBox:
    """Box+box merge; ref merge.jl:30-40."""
    return BBox(_map3(jnp.minimum, a.los, b.los),
                _map3(jnp.maximum, a.ups, b.ups))


def bbox_of_bsphere(a: BSphere) -> BBox:
    """Sphere -> enclosing box; ref merge.jl:47-55."""
    return BBox(tuple(c - a.r for c in a.xs), tuple(c + a.r for c in a.xs))


def bbox_of_two_bspheres(a: BSphere, b: BSphere) -> BBox:
    """Enclosure-aware sphere+sphere -> box; ref merge.jl:58-81.

    Not simply the union of the two spheres' boxes: if one sphere encloses
    the other only the enclosing sphere's box is returned — required for
    exact node parity with the reference build.
    """
    length = dist3(a.xs, b.xs)
    a_in_b = length + a.r <= b.r
    b_in_a = length + b.r <= a.r
    boxa = bbox_of_bsphere(a)
    boxb = bbox_of_bsphere(b)
    lo = _map3(jnp.minimum, boxa.los, boxb.los)
    up = _map3(jnp.maximum, boxa.ups, boxb.ups)
    lo = tuple(jnp.where(b_in_a, boxa.los[k],
                         jnp.where(a_in_b, boxb.los[k], lo[k]))
               for k in range(3))
    up = tuple(jnp.where(b_in_a, boxa.ups[k],
                         jnp.where(a_in_b, boxb.ups[k], up[k]))
               for k in range(3))
    return BBox(lo, up)


def convert_volume(kind, v: Volume) -> Volume:
    """Convert a volume to ``kind`` (leaf->node type conversion)."""
    if isinstance(v, kind):
        return v
    if kind is BBox and isinstance(v, BSphere):
        return bbox_of_bsphere(v)
    raise TypeError(f"cannot convert {type(v)} to {kind}")


def merge_into(kind, a: Volume, b: Volume) -> Volume:
    """Merge two leaf volumes into a node volume of type ``kind``.

    Covers the reference's heterogeneous pair constructors
    (``BBox{T}(a::BSphere, b::BSphere)``, merge.jl:58-81).
    """
    if kind is BBox and isinstance(a, BSphere) and isinstance(b, BSphere):
        return bbox_of_two_bspheres(a, b)
    return merge(convert_volume(kind, a), convert_volume(kind, b))


# --------------------------------------------------------------------------
# Overlap predicates (ref: src/bounding_volumes/iscontact.jl:1-28)
# --------------------------------------------------------------------------

def iscontact(a: Volume, b: Volume):
    """Vectorized touch/overlap test; returns a boolean batch array."""
    if isinstance(a, BSphere) and isinstance(b, BSphere):
        rr = a.r + b.r
        return dist3sq(a.xs, b.xs) <= rr * rr
    if isinstance(a, BBox) and isinstance(b, BBox):
        out = (a.ups[0] >= b.los[0]) & (a.los[0] <= b.ups[0])
        out &= (a.ups[1] >= b.los[1]) & (a.los[1] <= b.ups[1])
        out &= (a.ups[2] >= b.los[2]) & (a.los[2] <= b.ups[2])
        return out
    # Mixed sphere/box: test via the sphere's AABB (ref iscontact.jl:15-28).
    if isinstance(a, BSphere):
        return iscontact(bbox_of_bsphere(a), b)
    return iscontact(a, bbox_of_bsphere(b))


# --------------------------------------------------------------------------
# Ray intersection predicates (ref: src/bounding_volumes/isintersection.jl)
# --------------------------------------------------------------------------

def isintersection(v: Volume, p, d):
    """Forward-ray intersection test against box (slab) or sphere
    (quadratic).  ``p``/``d`` are (..., 3) arrays or coordinate tuples,
    broadcast against the volume batch.  Ref: isintersection.jl:1-65.
    """
    p, d = as_coords(p), as_coords(d)
    if isinstance(v, BBox):
        # min2/max2 use `where(a < b, a, b)` select, replicating the
        # reference's asymmetric NaN behaviour for rays lying exactly in a
        # face plane with a zero direction component (0 * inf slabs).
        def min2(a, b):
            return jnp.where(a < b, a, b)

        def max2(a, b):
            return jnp.where(a > b, a, b)

        inv0 = 1.0 / d[0]
        t1 = (v.los[0] - p[0]) * inv0
        t2 = (v.ups[0] - p[0]) * inv0
        tmin = min2(t1, t2)
        tmax = max2(t1, t2)
        inv1 = 1.0 / d[1]
        t1 = (v.los[1] - p[1]) * inv1
        t2 = (v.ups[1] - p[1]) * inv1
        tmin = max2(tmin, min2(t1, t2))
        tmax = min2(tmax, max2(t1, t2))
        inv2 = 1.0 / d[2]
        t1 = (v.los[2] - p[2]) * inv2
        t2 = (v.ups[2] - p[2]) * inv2
        tmin = max2(tmin, min2(t1, t2))
        tmax = min2(tmax, max2(t1, t2))
        return (tmin <= tmax) & (tmax >= 0)
    # Sphere: quadratic discriminant, forward-only.
    a = dot3(d, d)
    po = tuple(p[k] - v.xs[k] for k in range(3))
    b = 2.0 * dot3(po, d)
    c = dot3(po, po) - v.r * v.r
    discriminant = b * b - 4.0 * a * c
    return (discriminant >= 0) & ((b <= 0) | (c <= 0))
