"""implicitbvh_tpu — an implicit BVH engine in JAX.

A from-scratch re-design of the capabilities of ImplicitBVH.jl (the
"Binary Ostensibly-Implicit Tree" BVH of Chitalu, Dubach & Komura, CGF 2020)
for accelerators: SoA bounding volumes, fused sync-free builds, a dense
tile contact engine, deterministic scan/compaction-based tree traversal,
and ``jax.sharding`` multi-device scaling.
"""

from .options import BVHOptions, DEFAULT_OPTIONS
from .morton import (DefaultMortonAlgorithm, ExtendedMortonAlgorithm,
                     MortonAlgorithm, morton_encode,
                     morton_encode_extended, morton_encode_single,
                     morton_split3, bounding_volumes_extrema)
from .tree import ImplicitTree, compute_skips
from .volumes import (BBox, BSphere, bbox_from_triangles,
                      bsphere_from_triangles, center, from_triangles,
                      iscontact, isintersection, merge)
from .build import (BVH, BoundingVolume, Leaves, build, compute_build_level,
                    wrap_bounding_volumes)
from .traverse import (BFSTraversal, BVHTraversal, DFSTraversal,
                       LVTTraversal,
                       TileTraversal, TraversalAlgorithm,
                       default_start_level, traverse,
                       traverse_lvt_pair_fixed, traverse_lvt_single_fixed,
                       traverse_rays_tiles, traverse_rays_tiles_fixed,
                       traverse_tiles, traverse_tiles_fixed)
from .raytrace import traverse_rays, traverse_rays_fixed

__version__ = "0.1.0"

__all__ = [
    "BFSTraversal", "BVHTraversal", "DFSTraversal", "LVTTraversal",
    "TraversalAlgorithm",
    "default_start_level", "traverse", "traverse_rays", "traverse_rays_fixed",
    "traverse_rays_tiles", "traverse_rays_tiles_fixed",
    "traverse_lvt_single_fixed", "traverse_lvt_pair_fixed",
    "BVH", "BVHOptions", "DEFAULT_OPTIONS", "BoundingVolume", "Leaves",
    "ImplicitTree", "DefaultMortonAlgorithm", "ExtendedMortonAlgorithm",
    "MortonAlgorithm", "morton_encode_extended",
    "BBox", "BSphere",
    "build", "compute_build_level", "compute_skips",
    "bbox_from_triangles", "bsphere_from_triangles", "from_triangles",
    "center", "iscontact", "isintersection", "merge",
    "morton_encode", "morton_encode_single", "morton_split3",
    "bounding_volumes_extrema", "wrap_bounding_volumes",
]
