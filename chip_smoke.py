#!/usr/bin/env python
"""On-chip smoke test: the BVH engine's main path on one NVIDIA GPU.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the sharded paths on a 4-GPU mesh

One process drives the card through the entry points a user calls, at
full size, and checks every result against two references: the LVT walk
at full size, and a NumPy brute force over a ~16k-leaf corner of the same
scene (the full result restricted to that corner must equal it).  Phases:

1. device check; the card's name and power limit (``nvidia-smi``);
2. self-contact, host wrapper: ``ib.traverse`` at 1,048,576 triangles;
3. self-contact, fused: ``traverse_tiles_fixed`` in one ``jax.jit`` over
   moved geometry, and ``ib.traverse(..., cache=)`` over the same steps —
   no compile after the first step; ``memory_analysis()`` and the median
   step time;
4. rays: ``ib.traverse_rays``, 100,000 rays against 262,144 BVs;
5. pair: ``ib.traverse(bvh1, bvh2)`` at 32,768 x 16,384 leaves;
6. the Triton count kernel against the plain count pass at real widths,
   alone and end to end;
7. the tests marked ``gpu``.

Each engine's wrapper time (median of several cached calls) is printed
beside the card, for the routing table in traverse/api.py.  Contact sets
must be identical; the only allowed difference is a pair within float32
rounding of the contact boundary (FMA contraction on the card):
|d^2 - (r1 + r2)^2| <= 1e-6 (r1 + r2)^2, and for rays the analogous
relative margin on the discriminant.  The count of such pairs is printed.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero (and prints no such line) if any phase fails or JAX finds
no GPU.
"""

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REL_TOL = 1e-6
SELF_TRI = 1 << 20
RAY_BVS = 262_144
N_RAYS = 100_000
PAIR_A, PAIR_B = 32_768, 16_384
FUSED_STEPS = 5
TIMED_RUNS = 5


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def keys(pairs, n):
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    return pairs[:, 0] * (n + 1) + pairs[:, 1]


def unkey(k, n):
    return np.stack([k // (n + 1), k % (n + 1)], axis=1)


def sphere_margin(ca, ra, cb, rb):
    """|d^2 - (ra + rb)^2| / (ra + rb)^2 in float64."""
    d2 = ((ca.astype(np.float64) - cb.astype(np.float64)) ** 2).sum(-1)
    rr = (ra.astype(np.float64) + rb.astype(np.float64)) ** 2
    return np.abs(d2 - rr) / rr


def ray_margin(p, d, c, r):
    """Relative distance of a ray-sphere pair from the predicate's
    boundary: the discriminant and the two sign tests, each relative to
    the size of its terms, in float64 (the smallest of the three)."""
    p, d, c, r = (x.astype(np.float64) for x in (p, d, c, r))
    po = p - c
    qa = (d * d).sum(-1)
    qb = 2 * (po * d).sum(-1)
    qc = (po * po).sum(-1) - r * r
    disc = qb * qb - 4 * qa * qc
    m_disc = np.abs(disc) / (qb * qb + np.abs(4 * qa * qc) + 1e-300)
    m_qb = np.abs(qb) / (2 * np.sqrt((po * po).sum(-1) * qa) + 1e-300)
    m_qc = np.abs(qc) / ((po * po).sum(-1) + r * r + 1e-300)
    return np.minimum(m_disc, np.minimum(m_qb, m_qc))


def compare(name, got, ref, n, margin_fn):
    """Contact sets (arrays of user-index pairs) must be equal up to pairs
    on the float32 boundary.  Returns the number of boundary pairs."""
    kg, kr = keys(got, n), keys(ref, n)
    if len(np.unique(kg)) != len(kg):
        raise AssertionError(f"{name}: duplicate contacts")
    diff = np.setxor1d(kg, kr)
    if len(diff):
        m = margin_fn(unkey(diff, n))
        bad = int((m > REL_TOL).sum())
        if bad:
            raise AssertionError(
                f"{name}: {bad} of {len(diff)} differing pairs are not on "
                f"the boundary (max margin {float(m.max()):.3g})")
    log(f"  {name}: {len(kg)} vs {len(kr)} contacts, "
        f"{len(diff)} boundary pairs")
    return len(diff)


def timed(fn, runs=TIMED_RUNS):
    """Median wall time (ms) of ``fn()``, which must block on its result."""
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return 1000.0 * float(np.median(ts))


def brute_self(c, r):
    """NumPy brute-force self-contact of spheres (0-based index pairs)."""
    out = []
    n = len(r)
    for s in range(0, n, 1024):
        d2 = ((c[s:s + 1024, None, :] - c[None, :, :]) ** 2).sum(-1)
        hit = d2 <= (r[s:s + 1024, None] + r[None, :]) ** 2
        i, j = np.nonzero(hit)
        i = i + s
        keep = j > i
        out.append(np.stack([i[keep], j[keep]], 1))
    return np.concatenate(out)


def brute_cross(ca, ra, cb, rb):
    out = []
    for s in range(0, len(ra), 1024):
        d2 = ((ca[s:s + 1024, None, :] - cb[None, :, :]) ** 2).sum(-1)
        i, j = np.nonzero(d2 <= (ra[s:s + 1024, None] + rb[None, :]) ** 2)
        out.append(np.stack([i + s, j], 1))
    return np.concatenate(out)


def brute_rays(c, r, p, d):
    """(leaf, ray) 0-based pairs of the isintersection sphere predicate."""
    out = []
    qa = (d * d).sum(-1)
    for s in range(0, len(r), 512):
        po = p[None, :, :] - c[s:s + 512, None, :]
        qb = 2 * (po * d[None]).sum(-1)
        qc = (po * po).sum(-1) - (r[s:s + 512, None] ** 2)
        disc = qb * qb - 4 * qa[None] * qc
        i, j = np.nonzero((disc >= 0) & ((qb <= 0) | (qc <= 0)))
        out.append(np.stack([i + s, j], 1))
    return np.concatenate(out)


def corner(c, frac=0.25):
    """Indices of the leaves whose centers lie in the low corner cube of
    the scene (``frac`` of each extent): a density-preserving subsample."""
    lo, hi = c.min(0), c.max(0)
    return np.nonzero((c <= lo + frac * (hi - lo)).all(1))[0]


def restrict(pairs, keep_a, keep_b):
    """Rows of 1-based ``pairs`` whose columns lie in the 0-based index
    sets, re-indexed into those sets (0-based)."""
    pos_a = np.full(keep_a.max() + 2, -1, np.int64)
    pos_a[keep_a + 1] = np.arange(len(keep_a))
    pos_b = np.full(keep_b.max() + 2, -1, np.int64)
    pos_b[keep_b + 1] = np.arange(len(keep_b))
    a = np.where(pairs[:, 0] < len(pos_a), pos_a[np.minimum(
        pairs[:, 0], len(pos_a) - 1)], -1)
    b = np.where(pairs[:, 1] < len(pos_b), pos_b[np.minimum(
        pairs[:, 1], len(pos_b) - 1)], -1)
    ok = (a >= 0) & (b >= 0)
    return np.stack([a[ok], b[ok]], 1)


class Smoke:
    def __init__(self, jax, ib, card):
        self.jax = jax
        self.ib = ib
        self.card = card
        self.failed = []

    def phase(self, name, fn):
        log(f"== {name}")
        t0 = time.perf_counter()
        try:
            fn()
            log(f"   PASS {name} ({time.perf_counter() - t0:.1f} s)")
        except Exception:
            traceback.print_exc()
            log(f"   FAIL {name}")
            self.failed.append(name)

    # -- scenes ---------------------------------------------------------
    def soup_bvh(self, n_tri, seed):
        from bench import synth_triangles
        jax, ib = self.jax, self.ib
        tri = synth_triangles(n_tri, seed)
        sph = jax.jit(ib.bsphere_from_triangles)(*tri)
        bvh = jax.jit(lambda s: ib.build(s, ib.BBox))(sph)
        c = np.stack([np.asarray(x) for x in sph.xs], 1)
        return tri, bvh, c, np.asarray(sph.r)

    def engines(self, kind, run_tile, run_lvt):
        t_tile = timed(run_tile)
        t_lvt = timed(run_lvt)
        log(f"  engine time {kind}: tiles {t_tile:.3f} ms, "
            f"lvt {t_lvt:.3f} ms  [{self.card}]")

    # -- phases ---------------------------------------------------------
    def self_contact(self):
        jax, ib = self.jax, self.ib
        from implicitbvh_tpu.traverse import TileTraversal
        tri, bvh, c, r = self.soup_bvh(SELF_TRI, 0)
        self.self_scene = (tri, bvh)
        t = ib.traverse(bvh)
        log(f"  default engine: {type(t.tile_alg or ib.LVTTraversal()).__name__}"
            f", {int(t.num_contacts)} contacts, num_checks {t.num_checks}")
        tile = t if t.tile_alg else ib.traverse(bvh, TileTraversal())
        lvt = ib.traverse(bvh, ib.LVTTraversal())
        self.self_tile = tile
        got = np.asarray(tile.contacts)
        compare("self tiles vs LVT walk", got, np.asarray(lvt.contacts),
                SELF_TRI, lambda pr: sphere_margin(
                    c[pr[:, 0] - 1], r[pr[:, 0] - 1],
                    c[pr[:, 1] - 1], r[pr[:, 1] - 1]))
        sub = corner(c)
        ref = brute_self(c[sub], r[sub])
        compare(f"self corner ({len(sub)} leaves) vs brute force",
                restrict(got, sub, sub), ref, len(sub),
                lambda pr: sphere_margin(c[sub][pr[:, 0]], r[sub][pr[:, 0]],
                                         c[sub][pr[:, 1]], r[sub][pr[:, 1]]))
        self.engines(
            "self (1,048,576 leaves)",
            lambda: jax.block_until_ready(
                ib.traverse(bvh, TileTraversal(), cache=tile).cache1),
            lambda: jax.block_until_ready(
                ib.traverse(bvh, ib.LVTTraversal(), cache=lvt).cache1))

    def fused(self):
        jax, ib = self.jax, self.ib
        from implicitbvh_tpu.traverse import (TileTraversal,
                                              traverse_tiles_fixed)
        tri, _ = self.self_scene
        cap = int(self.self_tile.cache1.shape[0])
        pcap = int(self.self_tile.pair_capacity)
        alg = TileTraversal()

        def step(q1, q2, q3):
            bvh = ib.build(ib.bsphere_from_triangles(q1, q2, q3), ib.BBox)
            total, contacts, overflow, _ = traverse_tiles_fixed(
                bvh, cap, alg=alg, pair_capacity=pcap)
            return total, contacts, overflow

        step_j = jax.jit(step)
        build_j = jax.jit(lambda q1, q2, q3: ib.build(
            ib.bsphere_from_triangles(q1, q2, q3), ib.BBox))
        prev = self.self_tile
        n_fixed = None
        for k in range(FUSED_STEPS):
            q1 = tuple(x + np.float32(0.01 * k) for x in tri[0])
            total, contacts, overflow = jax.block_until_ready(
                step_j(q1, *tri[1:]))
            assert int(overflow) == 0, f"step {k}: overflow {int(overflow)}"
            t = ib.traverse(build_j(q1, *tri[1:]), alg, cache=prev)
            if k == 0:
                n_fixed = traverse_tiles_fixed._cache_size()
            prev = t
            sph = jax.jit(ib.bsphere_from_triangles)(q1, *tri[1:])
            c = np.stack([np.asarray(x) for x in sph.xs], 1)
            r = np.asarray(sph.r)
            compare(f"step {k}: fused vs wrapper",
                    np.asarray(contacts)[:int(total)],
                    np.asarray(t.contacts), SELF_TRI,
                    lambda pr: sphere_margin(
                        c[pr[:, 0] - 1], r[pr[:, 0] - 1],
                        c[pr[:, 1] - 1], r[pr[:, 1] - 1]))
        assert step_j._cache_size() == 1, step_j._cache_size()
        assert traverse_tiles_fixed._cache_size() == n_fixed, \
            "cache= reuse compiled again"
        log("  compiles after the first step: 0")
        compiled = step_j.lower(*tri).compile()
        log(f"  memory_analysis [{self.card}]: {compiled.memory_analysis()}")
        ms = timed(lambda: jax.block_until_ready(step_j(*tri)), runs=10)
        log(f"  fused 1M rebuild+self-contact step: median {ms:.3f} ms "
            f"[{self.card}]")

    def rays(self):
        jax, ib = self.jax, self.ib
        from implicitbvh_tpu.traverse import TileTraversal
        _, bvh, c, r = self.soup_bvh(RAY_BVS, 3)
        rng = np.random.default_rng(4)
        scale = float(RAY_BVS) ** (1 / 3)
        p = (rng.random((3, N_RAYS)) * scale).astype(np.float32)
        d = (rng.random((3, N_RAYS)) - 0.5).astype(np.float32)
        pj, dj = jax.numpy.asarray(p), jax.numpy.asarray(d)
        self.ray_scene = (bvh, pj, dj)
        t = ib.traverse_rays(bvh, pj, dj)
        tile = t if t.tile_alg else ib.traverse_rays(bvh, pj, dj,
                                                     TileTraversal())
        lvt = ib.traverse_rays(bvh, pj, dj, ib.LVTTraversal())
        log(f"  {int(tile.num_contacts)} hits, num_checks {tile.num_checks}")
        got = np.asarray(tile.contacts)
        pt, dt = p.T, d.T
        compare("rays tiles vs LVT walk", got, np.asarray(lvt.contacts),
                max(RAY_BVS, N_RAYS), lambda pr: ray_margin(
                    pt[pr[:, 1] - 1], dt[pr[:, 1] - 1], c[pr[:, 0] - 1],
                    r[pr[:, 0] - 1]))
        sub = corner(c, 0.4)
        rsub = np.arange(0, N_RAYS, 12)
        ref = brute_rays(c[sub], r[sub], pt[rsub], dt[rsub])
        compare(f"rays corner ({len(sub)} leaves x {len(rsub)} rays) vs "
                "brute force", restrict(got, sub, rsub), ref,
                max(len(sub), len(rsub)), lambda pr: ray_margin(
                    pt[rsub][pr[:, 1]], dt[rsub][pr[:, 1]],
                    c[sub][pr[:, 0]], r[sub][pr[:, 0]]))
        self.engines(
            "rays (100,000 x 262,144)",
            lambda: jax.block_until_ready(ib.traverse_rays(
                bvh, pj, dj, TileTraversal(), cache=tile).cache1),
            lambda: jax.block_until_ready(ib.traverse_rays(
                bvh, pj, dj, ib.LVTTraversal(), cache=lvt).cache1))

    def pair(self):
        jax, ib = self.jax, self.ib
        from implicitbvh_tpu.traverse import TileTraversal
        _, b1, c1, r1 = self.soup_bvh(PAIR_A, 1)
        _, b2, c2, r2 = self.soup_bvh(PAIR_B, 2)
        t = ib.traverse(b1, b2)
        tile = t if t.tile_alg else ib.traverse(b1, b2, TileTraversal())
        lvt = ib.traverse(b1, b2, ib.LVTTraversal())
        got = np.asarray(tile.contacts)
        compare("pair tiles vs LVT walk", got, np.asarray(lvt.contacts),
                PAIR_A, lambda pr: sphere_margin(
                    c1[pr[:, 0] - 1], r1[pr[:, 0] - 1],
                    c2[pr[:, 1] - 1], r2[pr[:, 1] - 1]))
        sub = np.arange(0, PAIR_A, 2)
        allb = np.arange(PAIR_B)
        ref = brute_cross(c1[sub], r1[sub], c2, r2)
        compare(f"pair ({len(sub)} x {PAIR_B} leaves) vs brute force",
                restrict(got, sub, allb), ref, PAIR_A,
                lambda pr: sphere_margin(c1[sub][pr[:, 0]], r1[sub][pr[:, 0]],
                                         c2[pr[:, 1]], r2[pr[:, 1]]))
        self.engines(
            "pair (32,768 x 16,384)",
            lambda: jax.block_until_ready(ib.traverse(
                b1, b2, TileTraversal(), cache=tile).cache1),
            lambda: jax.block_until_ready(ib.traverse(
                b1, b2, ib.LVTTraversal(), cache=lvt).cache1))

    def kernels(self):
        """The Triton count kernel against the plain count pass at real
        widths (1M self scene, 100k-ray scene): row counts, time alone
        per launch configuration, and end to end in turns (plain, kernel,
        kernel, plain)."""
        jax, ib = self.jax, self.ib
        from implicitbvh_tpu.ops import band_row_counts, band_row_counts_triton
        from implicitbvh_tpu.raytrace import _prep_rays
        from implicitbvh_tpu.traverse import TileTraversal, tiles
        from implicitbvh_tpu.traverse.ray_tiles import (_ray_entries,
                                                        _ray_pair_capacity)
        G, NB = 128, 4
        BH = G // NB
        _, bvh = self.self_scene
        pcap = tiles._pair_capacity_for(-(-SELF_TRI // G), NB)
        f, _, ea, eb, ne, _ = jax.jit(
            lambda b: tiles._self_entries(b, G, NB, pcap))(bvh)
        self_case = ("sphere", True, tuple(x.reshape(-1, BH) for x in f), f,
                     ea, eb, ne)
        rbvh, pj, dj = self.ray_scene
        p, d = _prep_rays(pj, dj, jax.numpy.float32)
        rcap = _ray_pair_capacity(-(-N_RAYS // G), NB)
        f, _, rf, _, ea, eb, ne = jax.jit(
            lambda b, p, d: _ray_entries(b, p, d, G, NB, rcap))(rbvh, p, d)
        ray_case = ("ray_sphere", False, tuple(x.reshape(-1, BH) for x in rf),
                    f, ea, eb, ne)
        for name, (kind, dedup, ab, bt, ea, eb, ne) in (
                ("self 1M", self_case), ("rays 100k x 262k", ray_case)):
            ref = band_row_counts(ab, bt, ea, eb, ne, mask_kind=kind, NB=NB,
                                  dedup=dedup)
            t_ref = timed(lambda: jax.block_until_ready(band_row_counts(
                ab, bt, ea, eb, ne, mask_kind=kind, NB=NB, dedup=dedup)), 10)
            log(f"  count pass {name}: {int(ne)} entries, plain "
                f"{t_ref:.3f} ms [{self.card}]")
            for warps in (2, 4):
                def run(warps=warps):
                    return band_row_counts_triton(
                        ab, bt, ea, eb, ne, mask_kind=kind, NB=NB,
                        dedup=dedup, num_warps=warps)
                got = run()
                ndiff = int((got != ref).any(axis=1).sum())
                t = timed(lambda: jax.block_until_ready(run()), 10)
                log(f"    triton warps={warps}: {t:.3f} ms, "
                    f"{ndiff} entries differ, total {int(got.sum())} vs "
                    f"{int(ref.sum())}")
                assert ndiff <= 1e-5 * int(ne) + 2, ndiff

        tri, _ = self.self_scene
        cap = int(self.self_tile.cache1.shape[0])
        alg = TileTraversal()

        def fused_ms():
            jax.clear_caches()
            step = jax.jit(lambda q1, q2, q3: tiles.traverse_tiles_fixed(
                ib.build(ib.bsphere_from_triangles(q1, q2, q3), ib.BBox),
                cap, alg=alg, pair_capacity=pcap)[:2])
            jax.block_until_ready(step(*tri))
            return timed(lambda: jax.block_until_ready(step(*tri)), 10)

        def rays_ms():
            jax.clear_caches()
            ib.traverse_rays(rbvh, pj, dj, alg)
            return timed(lambda: jax.block_until_ready(ib.traverse_rays(
                rbvh, pj, dj, alg).cache1))

        default = tiles.COUNT_PASS.get(jax.default_backend())
        try:
            for which in ("plain", "triton", "triton", "plain"):
                tiles.COUNT_PASS[jax.default_backend()] = which
                log(f"  end to end, count pass {which}: fused 1M step "
                    f"{fused_ms():.3f} ms, rays wrapper {rays_ms():.3f} ms "
                    f"[{self.card}]")
        finally:
            tiles.COUNT_PASS[jax.default_backend()] = default
            jax.clear_caches()

    def gpu_tests(self):
        import pytest
        os.environ["JAX_PLATFORMS"] = "cuda"
        here = os.path.dirname(os.path.abspath(__file__))
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          os.path.join(here, "tests")])
        assert rc == 0, f"gpu tests: pytest exit code {rc}"

    # -- four cards -----------------------------------------------------
    def four_cards(self):
        jax, ib = self.jax, self.ib
        from implicitbvh_tpu.parallel import (make_mesh, sharded_rays,
                                              sharded_rebuild_traverse_step,
                                              sharded_tile_pair)
        from implicitbvh_tpu.traverse import (TileTraversal,
                                              traverse_rays_tiles)
        from implicitbvh_tpu.traverse.tiles import traverse_tiles
        devs = jax.devices()
        assert len(devs) >= 4, f"need 4 GPUs, found {len(devs)}"
        mesh = make_mesh(devs[:4])

        def gathered(out, counts, cpd):
            out, counts = np.asarray(out), np.asarray(counts)
            return np.concatenate([out[d * cpd:d * cpd + int(counts[d])]
                                   for d in range(len(counts))])

        def self_step():
            from bench import synth_triangles
            n = 4 * SELF_TRI
            tri = synth_triangles(n, 5)
            sph = jax.jit(ib.bsphere_from_triangles)(*tri)
            cpd = 1 << 17
            step = sharded_rebuild_traverse_step(
                mesh, capacity_per_device=cpd, alg=TileTraversal())
            total, out, counts, over = jax.block_until_ready(
                step(jax.numpy.stack(sph.xs, 1), sph.r))
            assert not bool(over), "overflow"
            bvh = jax.jit(lambda s: ib.build(s, ib.BBox))(sph)
            single = traverse_tiles(bvh)
            c = np.stack([np.asarray(x) for x in sph.xs], 1)
            r = np.asarray(sph.r)
            assert int(total) == int(np.asarray(counts).sum())
            compare("sharded 4 x 1M self vs one card",
                    gathered(out, counts, cpd), np.asarray(single.contacts),
                    n, lambda pr: sphere_margin(
                        c[pr[:, 0] - 1], r[pr[:, 0] - 1],
                        c[pr[:, 1] - 1], r[pr[:, 1] - 1]))
            ms = timed(lambda: jax.block_until_ready(
                step(jax.numpy.stack(sph.xs, 1), sph.r)))
            log(f"  sharded 4 x 1M rebuild+self-contact step: median "
                f"{ms:.3f} ms [{self.card}; 4 cards]")

        def rays():
            _, bvh, c, r = self.soup_bvh(RAY_BVS, 3)
            rng = np.random.default_rng(4)
            scale = float(RAY_BVS) ** (1 / 3)
            p = jax.numpy.asarray(
                (rng.random((3, N_RAYS)) * scale).astype(np.float32))
            d = jax.numpy.asarray(
                (rng.random((3, N_RAYS)) - 0.5).astype(np.float32))
            cpd = 1 << 18
            total, out, counts, over = sharded_rays(
                mesh, bvh, p, d, capacity_per_device=cpd)
            assert not bool(over), "overflow"
            single = traverse_rays_tiles(bvh, p, d)
            assert int(total) == int(single.num_contacts), (
                int(total), int(single.num_contacts))
            got = gathered(out, counts, cpd)
            assert np.array_equal(np.sort(keys(got, N_RAYS + RAY_BVS)),
                                  np.sort(keys(np.asarray(single.contacts),
                                               N_RAYS + RAY_BVS)))
            log(f"  sharded rays: {int(total)} hits, identical to one card")

        def pair():
            _, b1, _, _ = self.soup_bvh(PAIR_A, 1)
            _, b2, _, _ = self.soup_bvh(PAIR_B, 2)
            cpd = 1 << 16
            total, out, counts, over = sharded_tile_pair(
                mesh, b1, b2, capacity_per_device=cpd)
            assert not bool(over), "overflow"
            single = ib.traverse(b1, b2, TileTraversal())
            got = gathered(out, counts, cpd)
            assert np.array_equal(np.sort(keys(got, PAIR_A)),
                                  np.sort(keys(np.asarray(single.contacts),
                                               PAIR_A)))
            log(f"  sharded pair: {int(total)} contacts, identical to one "
                "card")

        self.phase("four cards: sharded_rebuild_traverse_step (tiles)",
                   self_step)
        self.phase("four cards: sharded_rays", rays)
        self.phase("four cards: sharded_tile_pair", pair)


def main():
    four = "--four-cards" in sys.argv[1:]
    import jax
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import implicitbvh_tpu as ib
    from implicitbvh_tpu.utils import use_compile_cache

    use_compile_cache()
    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke.py needs a GPU; JAX found "
                 f"{devices[0].platform}")
    card = card_line()
    log(f"card: {card}")
    log(f"jax {jax.__version__}, {len(devices)} x {devices[0].device_kind}")
    smoke = Smoke(jax, ib, card)
    if four:
        smoke.four_cards()
    else:
        smoke.phase("self-contact, host wrapper (1,048,576 triangles)",
                    smoke.self_contact)
        if not smoke.failed:
            smoke.phase("self-contact, fused steps", smoke.fused)
        smoke.phase("rays (100,000 x 262,144)", smoke.rays)
        smoke.phase("pair (32,768 x 16,384)", smoke.pair)
        if not smoke.failed:
            smoke.phase("Triton count kernel vs plain", smoke.kernels)
        smoke.phase("tests marked gpu", smoke.gpu_tests)
    if smoke.failed:
        sys.exit(f"failed phases: {smoke.failed}")
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": 4 if four else len(devices)}}), flush=True)


if __name__ == "__main__":
    main()
