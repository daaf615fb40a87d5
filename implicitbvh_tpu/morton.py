"""Morton (Z-order) encoding of bounding-volume centers.

Counterpart of /root/reference/src/morton/ — the canonical 3D
bit-interleave with per-width bit splitting (5/10/21 bits per axis for
16/32/64-bit codes), extrema computation with epsilon expansion, and the
``MortonAlgorithm`` extension point.

The whole encode is a single fused XLA program over the SoA center arrays:
two reductions (extrema) + one elementwise pass (quantize + split).  The
reference launches device kernels through AcceleratedKernels for the same
steps (src/morton/default.jl:43-108, src/morton/utils.jl:1-72).

64-bit codes: with ``jax.config.update('jax_enable_x64', True)`` native
``uint64`` is used.  Without x64 JAX has no 64-bit integers, so the
``uint64`` option falls back to a (hi, lo) pair of ``uint32`` arrays used
as a two-key sort — see ``build.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp


# Exclusive maximum quantization bound per code width (ref default.jl:167-169)
MORTON_SCALING = {16: 2 ** 5, 32: 2 ** 10, 64: 2 ** 21}

# Relative precision used to expand extrema so codes are exclusively bounded
# (ref default.jl:179-181)
RELATIVE_PRECISION = {
    jnp.float16: 1e-2,
    jnp.bfloat16: 1e-2,
    jnp.float32: 1e-5,
    jnp.float64: 1e-14,
}


def relative_precision(dtype) -> float:
    key = jnp.dtype(dtype).type
    return RELATIVE_PRECISION[key]


# --------------------------------------------------------------------------
# Bit splitting — shift bits so each has two zeros after it
# (ref: src/morton/default.jl:118-157; the magic masks are the standard
# public-domain 3D Morton constants)
# --------------------------------------------------------------------------

def morton_split3_u16(v):
    s = v.astype(jnp.uint16) & jnp.uint16(0x001F)
    s = (s | s << 8) & jnp.uint16(0x100F)
    s = (s | s << 4) & jnp.uint16(0x10C3)
    s = (s | s << 2) & jnp.uint16(0x1249)
    return s


def morton_split3_u32(v):
    s = v.astype(jnp.uint32) & jnp.uint32(0x0000_03FF)
    s = (s | s << 16) & jnp.uint32(0x3_0000FF)
    s = (s | s << 8) & jnp.uint32(0x0300_F00F)
    s = (s | s << 4) & jnp.uint32(0x3_0C30C3)
    s = (s | s << 2) & jnp.uint32(0x9_249249)
    return s


def morton_split3_u64(v):
    s = v.astype(jnp.uint64) & jnp.uint64(0x001F_FFFF)
    s = (s | s << 32) & jnp.uint64(0x1F00000000FFFF)
    s = (s | s << 16) & jnp.uint64(0x1F0000FF0000FF)
    s = (s | s << 8) & jnp.uint64(0x100F00F00F00F00F)
    s = (s | s << 4) & jnp.uint64(0x10C30C30C30C30C3)
    s = (s | s << 2) & jnp.uint64(0x1249249249249249)
    return s


def morton_split3(v, bits: int):
    """Spread an integer's low bits two apart for 3D interleaving — the
    reference's per-width magic-mask cascades (ref default.jl:118-157)."""
    if bits == 16:
        return morton_split3_u16(v)
    if bits == 32:
        return morton_split3_u32(v)
    if bits == 64:
        return morton_split3_u64(v)
    raise ValueError(f"unsupported morton width {bits}")


def _split3_21bit_hi_lo(v):
    """Split a 21-bit integer (as uint32) into the (hi, lo) uint32 halves of
    the 63-bit spread pattern — the uint64 fallback without x64.

    bit j of v lands at spread position 3*j; positions 0..31 -> lo,
    32..62 -> hi.  Bits j<=10 go fully to lo (3*10=30); j>=11 to hi.
    """
    v = v.astype(jnp.uint32)
    # bits 0..9 -> spread positions 0..27; bit 10 -> position 30
    lo = morton_split3_u32(v & jnp.uint32(0x3FF)) | (((v >> 10) & jnp.uint32(1)) << 30)
    hi_bits = (v >> 11) & jnp.uint32(0x3FF)               # bits 11..20
    hi = morton_split3_u32(hi_bits) << 1                  # 3*11=33 -> hi bit 1
    return hi, lo


# --------------------------------------------------------------------------
# Extrema with epsilon expansion (ref: src/morton/utils.jl:1-72)
# --------------------------------------------------------------------------

def bounding_volumes_extrema(centers):
    """Exclusive (mins, maxs) bounds of centers given as a coordinate tuple
    of (N,) arrays (or an (N, 3) array).

    Expanded by float-type relative precision so all quantized coordinates
    are strictly inside [0, 1).  Returns two coordinate 3-tuples.
    """
    from .volumes import as_coords
    centers = as_coords(centers)
    T = centers[0].dtype
    rp = jnp.asarray(relative_precision(T), T)
    tiny = jnp.asarray(jnp.finfo(T).tiny, T)
    mins = tuple(jnp.min(c) - rp * jnp.abs(jnp.min(c)) - tiny for c in centers)
    maxs = tuple(jnp.max(c) + rp * jnp.abs(jnp.max(c)) + tiny for c in centers)
    return mins, maxs


# --------------------------------------------------------------------------
# Morton algorithm objects (extension point, ref src/morton/morton.jl:15-48)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MortonAlgorithm:
    """Base class for Morton encoding algorithms (hashable, jit-static)."""


@dataclasses.dataclass(frozen=True)
class DefaultMortonAlgorithm(MortonAlgorithm):
    """Canonical 3D bit-interleave (ref src/morton/default.jl:21-40).

    ``bits`` selects the code width (16/32/64).  With
    ``compute_extrema=False`` the fixed ``mins``/``maxs`` world bounds are
    used and the extrema reduction is skipped — the caller must guarantee no
    center touches or exceeds the bounds.
    """

    bits: int = 32
    compute_extrema: bool = True
    mins: Tuple[float, float, float] = (float("nan"),) * 3
    maxs: Tuple[float, float, float] = (float("nan"),) * 3

    def __post_init__(self):
        if self.bits not in (16, 32, 64):
            raise ValueError(f"morton bits must be 16/32/64, got {self.bits}")


def _quantize(c, mn, mx, scaling):
    scaled = (c - mn) / (mx - mn)
    # trunc toward zero like the reference's unsafe_trunc
    return (scaled * jnp.asarray(scaling, c.dtype)).astype(jnp.uint32)


def morton_encode(centers, alg: DefaultMortonAlgorithm):
    """Morton codes for centers given as a coordinate tuple of (N,) arrays
    (or an (N, 3) array).

    Returns a single (N,) unsigned array for 16/32-bit codes (and for 64-bit
    when x64 is enabled); for 64-bit without x64 support returns a tuple
    ``(hi, lo)`` of uint32 arrays forming a lexicographic sort key.

    Ref: morton_encode_single, src/morton/default.jl:91-108.
    """
    from .volumes import as_coords
    centers = as_coords(centers)
    T = centers[0].dtype
    if alg.compute_extrema:
        mins, maxs = bounding_volumes_extrema(centers)
    else:
        mins = tuple(jnp.asarray(m, T) for m in alg.mins)
        maxs = tuple(jnp.asarray(m, T) for m in alg.maxs)

    scaling = MORTON_SCALING[alg.bits]
    q1 = _quantize(centers[0], mins[0], maxs[0], scaling)
    q2 = _quantize(centers[1], mins[1], maxs[1], scaling)
    q3 = _quantize(centers[2], mins[2], maxs[2], scaling)

    if alg.bits == 64 and not jax.config.jax_enable_x64:
        h1, l1 = _split3_21bit_hi_lo(q1)
        h2, l2 = _split3_21bit_hi_lo(q2)
        h3, l3 = _split3_21bit_hi_lo(q3)
        # m = (s1 << 2) | (s2 << 1) | s3 across the 64-bit lane
        hi = (h1 << 2) | (l1 >> 30) | (h2 << 1) | (l2 >> 31) | h3
        lo = (l1 << 2) | (l2 << 1) | l3
        return hi, lo

    s1 = morton_split3(q1, alg.bits)
    s2 = morton_split3(q2, alg.bits)
    s3 = morton_split3(q3, alg.bits)
    return (s1 << 2) | (s2 << 1) | s3


# --------------------------------------------------------------------------
# Extended Morton codes (Vinkler, Bittner & Havran, HPG 2017)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExtendedMortonAlgorithm(MortonAlgorithm):
    """Extended Morton codes: adaptive axis order, variable bits per axis
    from repeated longest-axis splits, and optional primitive-size bits.

    Behavioral counterpart of the reference's experimental
    ExtendedMortonAlgorithm (ref src/morton/extended.jl:29-124 schedule,
    :225-241 split loop, :316-352 assembly/encode; gated off upstream at
    src/morton/morton.jl:48).  Defaults per code width match the reference:
    ``size_interval``/``size_budget``/``use_sqrt_size`` = (0, 0, off) for
    16-bit, (7, 4, on) for 32-bit, (7, 6, on) for 64-bit — i.e. every 7th
    code bit stores quantized primitive extent, up to the budget.

    A redesign, not a translation:
    - the bit schedule depends on the scene extents, which are traced
      inside the fused build; the longest-axis split loop therefore runs on
      traced (3,)-scalars, and only the *axis choice* per bit is dynamic —
      bit positions are static, so assembly unrolls to a few selects/shifts
      per code bit (one elementwise pass over the leaves);
    - per-axis bits are capped at 24 so f32 quantization is exact (the
      reference promotes to Float64; only a degenerate scene with two
      zero-extent axes could want more than 24 bits on one axis);
    - 64-bit codes return the (hi, lo) uint32 pair used as a two-key sort
      (without x64), like :class:`DefaultMortonAlgorithm`.
    """

    bits: int = 32
    compute_extrema: bool = True
    mins: Tuple[float, float, float] = (float("nan"),) * 3
    maxs: Tuple[float, float, float] = (float("nan"),) * 3
    size_interval: int = -1      # -1 -> per-width default
    size_budget: int = -1
    use_sqrt_size: int = -1      # -1 -> default (interval >= 7)

    def __post_init__(self):
        if self.bits not in (16, 32, 64):
            raise ValueError(f"morton bits must be 16/32/64, got {self.bits}")
        interval = self.size_interval
        if interval < 0:
            interval = 0 if self.bits == 16 else 7
        budget = self.size_budget
        if budget < 0:
            budget = {16: 0, 32: 4, 64: 6}[self.bits]
        if interval <= 0:
            budget = 0
        budget = min(budget, self.bits // interval) if interval > 0 else 0
        sqrt_flag = self.use_sqrt_size
        if sqrt_flag < 0:
            sqrt_flag = 1 if interval >= 7 else 0
        if budget == 0:
            sqrt_flag = 0
        object.__setattr__(self, "size_interval", interval)
        object.__setattr__(self, "size_budget", budget)
        object.__setattr__(self, "use_sqrt_size", sqrt_flag)

    @property
    def size_slots(self):
        """Static (0-based) code-bit positions holding size bits: every
        ``size_interval``-th slot (1-based, ref extended.jl:231) up to the
        budget."""
        if self.size_interval <= 0 or self.size_budget <= 0:
            return ()
        slots = []
        for idx in range(1, self.bits + 1):
            if idx % self.size_interval == 0 and len(slots) < self.size_budget:
                slots.append(idx - 1)
        return tuple(slots)


_AXIS_BIT_CAP = 24   # f32-exact quantization ceiling per axis


def _extended_schedule(ranges, alg: ExtendedMortonAlgorithm):
    """Traced longest-axis split schedule (ref _build_extended_schedule,
    extended.jl:225-241).  Returns (axes, counts): ``axes`` is a list over
    code bits, each entry a traced int32 axis in 0..2 or the static string
    "size"; ``counts`` the traced (3,) per-axis bit counts."""
    size_slots = set(alg.size_slots)
    lengths = jnp.abs(jnp.stack(ranges)).astype(jnp.float32)
    counts = jnp.zeros((3,), jnp.int32)
    axes = []
    for i in range(alg.bits):
        if i in size_slots:
            axes.append("size")
            continue
        eligible = counts < _AXIS_BIT_CAP
        le = jnp.where(eligible & jnp.isfinite(lengths) & (lengths > 0),
                       lengths, -jnp.inf)
        ax = jnp.argmax(le).astype(jnp.int32)
        ok = le[ax] > -jnp.inf
        # fallback cycles axes starting at i % 3, skipping capped ones
        # (ref _select_axis fallback, extended.jl:186-202)
        fb0, fb1, fb2 = i % 3, (i + 1) % 3, (i + 2) % 3
        fb = jnp.where(eligible[fb0], fb0,
                       jnp.where(eligible[fb1], fb1, fb2)).astype(jnp.int32)
        ax = jnp.where(ok, ax, fb)
        onehot = (jnp.arange(3, dtype=jnp.int32) == ax)
        counts = counts + onehot.astype(jnp.int32)
        lengths = jnp.where(onehot, lengths * 0.5, lengths)
        axes.append(ax)
    return axes, counts


def _quantize_extended(v, mn, scale, maxv):
    """(v - mn) * scale truncated toward zero, clamped to [0, maxv]
    (ref _quantize_axis, extended.jl:282-300)."""
    enc = (v - mn) * scale
    enc = jnp.where(jnp.isfinite(enc) & (enc >= 0), enc, 0.0)
    return jnp.minimum(enc, maxv).astype(jnp.uint32)


def morton_encode_extended(volume, alg: ExtendedMortonAlgorithm):
    """Extended-Morton encode a batch of volumes (needs the full volume,
    not just centers, for the size bits).  Return convention matches
    :func:`morton_encode` (single array, or (hi, lo) for 64-bit no-x64)."""
    from .volumes import BSphere, center_coords
    centers = center_coords(volume)
    T = centers[0].dtype
    if alg.compute_extrema:
        mins, maxs = bounding_volumes_extrema(centers)
    else:
        mins = tuple(jnp.asarray(m, T) for m in alg.mins)
        maxs = tuple(jnp.asarray(m, T) for m in alg.maxs)
    ranges = tuple(jnp.abs(mx - mn).astype(jnp.float32)
                   for mn, mx in zip(mins, maxs))

    axes, counts = _extended_schedule(ranges, alg)
    c4 = len(alg.size_slots)
    # per-axis scales: (2^bits - 1) / range, 0 for zero-range axes
    maxv = jnp.exp2(counts.astype(jnp.float32)) - 1.0          # (3,)
    rng_v = jnp.stack(ranges)
    eps = jnp.asarray(jnp.finfo(jnp.float32).eps, jnp.float32)
    scales = jnp.where((counts > 0) & (rng_v > eps) & jnp.isfinite(rng_v),
                       maxv / jnp.maximum(rng_v, eps), 0.0)

    q = [_quantize_extended(centers[k].astype(jnp.float32),
                            jnp.asarray(mins[k], jnp.float32),
                            scales[k], maxv[k]) for k in range(3)]

    # size bits: quantized volume diagonal (2r for spheres), optionally
    # sqrt-compressed (ref _volume_diagonal / _compute_size_scale)
    if c4 > 0:
        if isinstance(volume, BSphere):
            diag = 2.0 * volume.r.astype(jnp.float32)
        else:
            d = [(volume.ups[k] - volume.los[k]).astype(jnp.float32)
                 for k in range(3)]
            diag = jnp.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        scene_diag = jnp.sqrt(rng_v[0] * rng_v[0] + rng_v[1] * rng_v[1] +
                              rng_v[2] * rng_v[2])
        maxv4 = float((1 << c4) - 1)
        if alg.use_sqrt_size:
            denom = jnp.sqrt(scene_diag)
            measure = jnp.sqrt(jnp.maximum(diag, 0.0))
        else:
            denom = scene_diag
            measure = jnp.maximum(diag, 0.0)
        size_scale = jnp.where(
            jnp.isfinite(denom) & (denom > eps), maxv4 / denom, 0.0)
        q4 = _quantize_extended(measure, jnp.float32(0.0), size_scale, maxv4)
    else:
        q4 = jnp.zeros_like(q[0])

    # assembly (ref _assemble_code, extended.jl:316-341): bit i of the code
    # (MSB first) takes the next most-significant unconsumed bit of its
    # axis's quantized value; bit positions are static, axis choice traced
    n = q[0].shape[0]
    rem = counts.astype(jnp.uint32)          # traced per-axis countdown
    rem4 = c4                                # static countdown
    N = alg.bits
    pair64 = N == 64 and not jax.config.jax_enable_x64
    if pair64:
        hi = jnp.zeros((n,), jnp.uint32)
        lo = jnp.zeros((n,), jnp.uint32)
    else:
        dt = {16: jnp.uint16, 32: jnp.uint32, 64: jnp.uint64}[N]
        code = jnp.zeros((n,), dt)
    for i, ax in enumerate(axes):
        if ax == "size":
            rem4 -= 1
            bit = (q4 >> jnp.uint32(rem4)) & jnp.uint32(1)
        else:
            onehot = (jnp.arange(3, dtype=jnp.int32) == ax)
            rem = rem - onehot.astype(jnp.uint32)
            bit = jnp.zeros((n,), jnp.uint32)
            for a in range(3):
                bit_a = (q[a] >> rem[a]) & jnp.uint32(1)
                bit = jnp.where(ax == a, bit_a, bit)
        pos = N - 1 - i
        if pair64:
            if pos >= 32:
                hi = hi | (bit << jnp.uint32(pos - 32))
            else:
                lo = lo | (bit << jnp.uint32(pos))
        else:
            code = code | (bit.astype(code.dtype) << pos)
    if pair64:
        return hi, lo
    return code


def morton_encode_single(center, mins, maxs, alg: DefaultMortonAlgorithm):
    """Scalar-style encode of a single (3,) center given explicit bounds
    (API parity with ref morton_encode_single)."""
    c = jnp.asarray(center, jnp.float32)[None, :]
    sub = DefaultMortonAlgorithm(bits=alg.bits, compute_extrema=False,
                                 mins=tuple(map(float, mins)),
                                 maxs=tuple(map(float, maxs)))
    m = morton_encode(c, sub)
    if isinstance(m, tuple):
        return m[0][0], m[1][0]
    return m[0]
