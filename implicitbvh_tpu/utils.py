"""Scalar/integer math utilities and the compile-cache setting.

Counterparts of the reference's utility layer
(/root/reference/src/utils.jl:98-275): integer log2, power-of-two helpers,
child-index arithmetic for BVTT sprouting, and upper-triangle pair unranking.

Everything comes in two flavours where needed:

- ``*_static``: pure-Python integer math, used for jit-static tree-shape
  computation (tree shapes are compile-time constants under jit).
- traced versions operating on ``jnp`` integer arrays.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp


def use_compile_cache() -> str:
    """Point JAX's persistent compilation cache at
    ``JAX_COMPILATION_CACHE_DIR`` when that is set, else at ``.jax_cache/``
    in the checkout (a fixed path: the path is part of the cache key).
    Called by every entry point (bench.py, chip_smoke.py,
    __graft_entry__.py, the test suite); nothing else sets a cache path.
    Returns the directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


# --------------------------------------------------------------------------
# Static (host) integer helpers
# --------------------------------------------------------------------------

def ilog2_static(n: int, round_up: bool = False) -> int:
    """Integer log2 (ref: src/utils.jl:111-133)."""
    if n < 1:
        raise ValueError(f"ilog2 domain error: {n}")
    f = n.bit_length() - 1
    if round_up and (n & (n - 1)) != 0:
        return f + 1
    return f


def pow2_static(n: int) -> int:
    return 1 << n


# --------------------------------------------------------------------------
# Traced (device) integer helpers — vectorized bit tricks
# --------------------------------------------------------------------------

def floor_ilog2(v):
    """Vectorized floor(log2(v)) for positive int32/int64 arrays.

    Classic 5-step branch-free bit reduction; replaces the reference's
    ``leading_zeros``-based ilog2 (src/utils.jl:131-133) which has no jnp
    primitive.
    """
    v = v.astype(jnp.int32) if v.dtype == jnp.int32 else v
    r = jnp.zeros_like(v)
    for shift, bound in ((16, 0xFFFF), (8, 0xFF), (4, 0xF), (2, 0x3), (1, 0x1)):
        s = jnp.where(v > bound, shift, 0).astype(v.dtype)
        v = v >> s
        r = r | s
    return r


def trailing_ones(v):
    """Number of trailing one-bits of v == count-trailing-zeros of v+1 when the
    low bits are a 0111... pattern; used by the stackless LVT walk's climb step.
    """
    return count_trailing_zeros(v + 1)


def count_trailing_zeros(v):
    """Vectorized ctz for positive integer arrays (int32/int64 ok)."""
    one = jnp.ones_like(v)
    # Isolate lowest set bit, then take its floor_ilog2.
    low = v & (~v + one)
    return floor_ilog2(jnp.maximum(low, one))


# --------------------------------------------------------------------------
# Child index arithmetic for BVTT sprouting (ref: src/utils.jl:98-106)
# --------------------------------------------------------------------------

def leftleft(i1, i2):
    return i1 * 2, i2 * 2


def leftright(i1, i2):
    return i1 * 2, i2 * 2 + 1


def rightleft(i1, i2):
    return i1 * 2 + 1, i2 * 2


def rightright(i1, i2):
    return i1 * 2 + 1, i2 * 2 + 1


def leftnoop(i1, i2):
    return i1 * 2, i2


def rightnoop(i1, i2):
    return i1 * 2 + 1, i2


def noopleft(i1, i2):
    return i1, i2 * 2


def noopright(i1, i2):
    return i1, i2 * 2 + 1


# NOTE: the 3D scalar math (dot3/dist3sq/dist3, ref src/utils.jl:160-181)
# lives in volumes.py in coordinate-tuple SoA form — the layout every
# consumer uses.  No (..., 3)-array variants are kept here.


# --------------------------------------------------------------------------
# Upper-triangle pair unranking (ref: src/utils.jl:202-275)
# --------------------------------------------------------------------------
# Map a linear index k to the (i, j) upper-triangular pair in lexicographic
# block order; used to generate the initial BVTT all-pairs frontier with one
# vector op per element instead of a host double loop.

def _block_search(s_before, n_blocks, k):
    """Largest i in [0, n_blocks) with s_before(i) <= k, via branch-free
    vectorized binary search (31 fixed steps).

    The reference uses a Float32 quadratic guess plus an unbounded integer
    correction loop (src/utils.jl:202-275); under jit an unbounded loop
    serializes the whole vector, and the f32 guess can be off by thousands near
    the diagonal due to catastrophic cancellation, so a fixed-depth binary
    search is both safer and vector-friendly.
    """
    lo = jnp.zeros_like(k)
    hi = jnp.broadcast_to(jnp.asarray(n_blocks - 1, dtype=k.dtype), k.shape)
    for _ in range(31):
        mid = (lo + hi + 1) >> 1
        go_up = s_before(mid) <= k
        lo = jnp.where(go_up, mid, lo)
        hi = jnp.where(go_up, hi, mid - 1)
    return lo


def k2ij_inclusive(n, k):
    """Unrank 0-based inclusive upper-triangle index k -> (i, j), 0<=i<=j<n.

    Order: (0,0),(0,1),..,(0,n-1),(1,1),..,(n-1,n-1).
    """
    k = jnp.asarray(k)
    n = jnp.asarray(n, dtype=k.dtype)

    def s_before(t):
        return t * n - (t * (t - 1)) // 2

    i = _block_search(s_before, n, k)
    j = i + (k - s_before(i))
    return i, j


def k2ij_exclusive(n, k):
    """Unrank 0-based exclusive upper-triangle index k -> (i, j), 0<=i<j<n.

    Order: (0,1),..,(0,n-1),(1,2),..,(n-2,n-1).
    """
    k = jnp.asarray(k)
    n = jnp.asarray(n, dtype=k.dtype)

    def s_before(t):
        return (t * (2 * n - t - 1)) // 2

    i = _block_search(s_before, jnp.maximum(n - 1, 1), k)
    j = i + 1 + (k - s_before(i))
    return i, j
