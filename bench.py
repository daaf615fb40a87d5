#!/usr/bin/env python
"""Benchmark: full rebuild + self-contact traversal of a 1M-triangle mesh
on one GPU (BASELINE.json north star: < 10 ms).

Pipeline per step (the moving-geometry simulation loop, BASELINE config 5):
triangles -> BSphere leaves -> Morton encode -> sort -> aggregate ->
tile self-contact traversal — all in one jitted program.

Prints ONE JSON line:
  {"metric": ..., "value": <ms>, "unit": "ms", "vs_baseline": <target/value>,
   "device": {"platform", "kind", "count"}}
(vs_baseline >= 1 means the 10 ms target is met).  The value is the median
of several steps, each timed to ``block_until_ready``.  Exits non-zero
when JAX finds no GPU: a CPU run measures nothing anyone deploys.
"""

import json
import math
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

import implicitbvh_tpu as ib
from implicitbvh_tpu.traverse import TileTraversal, traverse_tiles_fixed
from implicitbvh_tpu.traverse.tiles import _pair_capacity_for
from implicitbvh_tpu.utils import use_compile_cache

TARGET_MS = 10.0
N_TRI = 1 << 20
STEPS = 10


def synth_triangles(n_tri: int, seed: int = 0):
    """Random triangle soup at ~unit density (contact-rich, dragon-like).

    Vertices are returned as coordinate 3-tuples of (N,) arrays (the
    package's SoA layout)."""
    rng = np.random.default_rng(seed)
    scale = float(n_tri) ** (1.0 / 3.0)
    c = (rng.random((n_tri, 3)) * scale).astype(np.float32)
    e1 = (rng.random((n_tri, 3)) - 0.5).astype(np.float32) * 0.4
    e2 = (rng.random((n_tri, 3)) - 0.5).astype(np.float32) * 0.4

    def tup(a):
        return tuple(jnp.asarray(a[:, k]) for k in range(3))
    return tup(c), tup(c + e1), tup(c + e2)


def make_step(n_tri: int):
    """The fused moving-geometry step at fixed capacities: ``step(p1, p2,
    p3) -> (total, contacts, overflow)``."""
    T = -(-n_tri // 128)
    pair_capacity = _pair_capacity_for(T)
    # ~2.3x the contacts of the 1M soup; overflow is checked and reported
    capacity = max(1 << math.ceil(math.log2(n_tri)) - 3, 4096)
    alg = TileTraversal()

    def step(q1, q2, q3):
        spheres = ib.bsphere_from_triangles(q1, q2, q3)
        bvh = ib.build(spheres, ib.BBox)
        total, contacts, overflow, _nc = traverse_tiles_fixed(
            bvh, capacity, alg=alg, pair_capacity=pair_capacity)
        return total, contacts, overflow

    return jax.jit(step)


def main():
    use_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {dev.platform}")
    p1, p2, p3 = synth_triangles(N_TRI)
    step = make_step(N_TRI)

    total, _, overflow = jax.block_until_ready(step(p1, p2, p3))
    if int(overflow):
        sys.exit("capacity overflow")
    print(f"# {N_TRI} triangles, {int(total)} contacts", file=sys.stderr)

    times = []
    for k in range(STEPS):
        q1 = tuple(x + jnp.float32(1e-4 * (k + 1)) for x in p1)
        jax.block_until_ready(q1)
        t0 = time.perf_counter()
        jax.block_until_ready(step(q1, p2, p3))
        times.append(time.perf_counter() - t0)
    ms = 1000.0 * float(np.median(times))
    print(json.dumps({
        "metric": "1M-tri mesh rebuild+self-contact per step",
        "value": ms, "unit": "ms", "vs_baseline": TARGET_MS / ms,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
