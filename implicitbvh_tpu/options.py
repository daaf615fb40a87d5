"""BVHOptions — the frozen, hashable, jit-static configuration object.

Counterpart of /root/reference/src/utils.jl:34-93.  The reference's CPU
thread counts / per-op grain sizes and GPU block size have no counterpart
here (XLA owns scheduling); index and Morton dtypes are kept with the same
semantics (Int32 indices by default — the efficient width on accelerators,
ref src/build.jl:383-385).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from .morton import DefaultMortonAlgorithm, MortonAlgorithm


@dataclasses.dataclass(frozen=True)
class BVHOptions:
    """Options for building and traversing BVHs.

    Fields
    - ``index_bits``: width of the indices used everywhere (32 or 64);
      mirrors the reference's ``index_exemplar``.
    - ``morton``: the Morton encoding algorithm object.
    - ``capacity_growth``: when a traversal's contact/frontier buffer
      overflows its static capacity, the Python wrapper re-runs with capacity
      scaled by this factor (the XLA analogue of ``resize!``) — honored by
      the BFS frontier growth and by every tile-engine wrapper's
      capacity/pair-capacity growth loop (buffers round up to the engines'
      alignment quanta, so the effective factor is >= this value).
    - ``min_capacity``: smallest contact-buffer capacity to compile for.
    """

    index_bits: int = 32
    morton: MortonAlgorithm = DefaultMortonAlgorithm(bits=32)
    capacity_growth: float = 2.0
    min_capacity: int = 64
    # Accepted for migration parity with the reference's GPU block size and
    # CPU threading knobs (ref src/utils.jl:43-56); XLA owns scheduling on
    # the device and tile sizes live in TileTraversal, so these are
    # validated but otherwise ignored.
    block_size: int = 256
    num_threads: int = 1
    min_mortons_per_thread: int = 100
    min_sorts_per_thread: int = 100
    min_boundings_per_thread: int = 100
    min_traversals_per_thread: int = 100

    def __post_init__(self):
        if self.index_bits not in (32, 64):
            raise ValueError("index_bits must be 32 or 64")
        if self.capacity_growth <= 1.0:
            raise ValueError("capacity_growth must be > 1")
        if self.min_capacity <= 0 or self.block_size <= 0:
            raise ValueError("min_capacity and block_size must be positive")
        for f in ("num_threads", "min_mortons_per_thread",
                  "min_sorts_per_thread", "min_boundings_per_thread",
                  "min_traversals_per_thread"):
            if getattr(self, f) <= 0:
                raise ValueError(f"{f} must be positive")

    @property
    def index_dtype(self):
        if self.index_bits == 64:
            # Without the x64 flag JAX silently narrows int64 arrays to
            # int32 — a user asking for 64-bit indices on > 2^31-pair
            # workloads would get wraparound, so fail loudly instead
            # (ref parity: index_exemplar selects Int32/Int64 eagerly,
            # ref src/utils.jl:34-42).
            import jax
            if not jax.config.jax_enable_x64:
                raise ValueError(
                    "BVHOptions(index_bits=64) requires jax_enable_x64; "
                    "set JAX_ENABLE_X64=1 or "
                    "jax.config.update('jax_enable_x64', True) — without "
                    "it JAX silently narrows indices to int32")
            return jnp.int64
        return jnp.int32


DEFAULT_OPTIONS = BVHOptions()
