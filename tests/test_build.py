"""BVH build tests: golden small-tree structure checks.

Port of reference coverage /root/reference/test/runtests.jl:596-834 —
exact node merge results per level for 5 ordered/unordered spheres/boxes.
"""

import numpy as np
import jax.numpy as jnp

import implicitbvh_tpu as ib


def spheres5(order=None):
    xs = np.array([[0, 0, 0], [0, 0, 1], [0, 0, 2], [0, 0, 3], [0, 0, 4]],
                  np.float32)
    rs = np.array([0.5, 0.6, 0.5, 0.4, 0.6], np.float32)
    if order is not None:
        xs, rs = xs[order], rs[order]
    return ib.BSphere(jnp.asarray(xs), jnp.asarray(rs))


def test_build_5_spheres_bbox_nodes_golden():
    bvh = ib.build(spheres5(), ib.BBox)
    t = bvh.tree
    assert (t.levels, t.real_leaves, t.real_nodes) == (4, 5, 11)
    # leaves sorted along +z so user indices stay 1..5 in order
    np.testing.assert_array_equal(np.asarray(bvh.leaves.index), [1, 2, 3, 4, 5])
    lo = np.asarray(bvh.nodes.lo)
    up = np.asarray(bvh.nodes.up)
    # level 3 (mem 4..6): merge leaves (1,2), (3,4), conv(5)
    np.testing.assert_allclose(lo[3], [-0.6, -0.6, -0.5], atol=1e-6)
    np.testing.assert_allclose(up[3], [0.6, 0.6, 1.6], atol=1e-6)
    np.testing.assert_allclose(lo[4], [-0.5, -0.5, 1.5], atol=1e-6)
    np.testing.assert_allclose(up[4], [0.5, 0.5, 3.4], atol=1e-6)
    np.testing.assert_allclose(lo[5], [-0.6, -0.6, 3.4], atol=1e-6)
    np.testing.assert_allclose(up[5], [0.6, 0.6, 4.6], atol=1e-6)
    # level 2 (mem 2..3): merge (node4, node5), copy node6 (virtual right)
    np.testing.assert_allclose(lo[1], [-0.6, -0.6, -0.5], atol=1e-6)
    np.testing.assert_allclose(up[1], [0.6, 0.6, 3.4], atol=1e-6)
    np.testing.assert_allclose(lo[2], [-0.6, -0.6, 3.4], atol=1e-6)
    np.testing.assert_allclose(up[2], [0.6, 0.6, 4.6], atol=1e-6)
    # root
    np.testing.assert_allclose(lo[0], [-0.6, -0.6, -0.5], atol=1e-6)
    np.testing.assert_allclose(up[0], [0.6, 0.6, 4.6], atol=1e-6)


def test_build_unordered_input_sorts_leaves():
    order = [3, 0, 4, 2, 1]
    bvh = ib.build(spheres5(order), ib.BBox)
    # user indices follow input positions but leaves are morton-sorted to +z
    np.testing.assert_array_equal(np.asarray(bvh.leaves.index),
                                  np.argsort(order) + 1)
    z = np.asarray(bvh.leaves.volume.x)[:, 2]
    assert (np.diff(z) > 0).all()


def test_build_sphere_nodes():
    bvh = ib.build(spheres5(), ib.BSphere)
    assert isinstance(bvh.nodes, ib.BSphere)
    x = np.asarray(bvh.nodes.x)
    r = np.asarray(bvh.nodes.r)
    # level-3 first node merges spheres 1,2 (enclosure-aware sphere merge):
    # centers (0,0,0) r .5 and (0,0,1) r .6 -> length 1, radius (1+.5+.6)/2
    np.testing.assert_allclose(r[3], 1.05, atol=1e-6)
    np.testing.assert_allclose(x[3], [0, 0, 0.55], atol=1e-6)


def test_build_single_and_two_leaves():
    one = ib.build(ib.BSphere(jnp.zeros((1, 3)), jnp.ones((1,))), ib.BBox)
    assert one.tree.levels == 1
    assert one.tree.num_nodes == 0
    two = ib.build(ib.BSphere(jnp.asarray(np.array([[0, 0, 0], [0, 0, 3.0]],
                                                   np.float32)),
                              jnp.asarray(np.array([1, 1], np.float32))),
                   ib.BBox)
    assert two.tree.levels == 2
    lo = np.asarray(two.nodes.lo)
    np.testing.assert_allclose(lo[0], [-1, -1, -1], atol=1e-6)


def test_built_level():
    bvh = ib.build(spheres5(), ib.BBox, built_level=2)
    assert bvh.built_level == 2
    # root level is left unbuilt (zeros)
    np.testing.assert_array_equal(np.asarray(bvh.nodes.lo)[0], [0, 0, 0])
    np.testing.assert_array_equal(np.asarray(bvh.nodes.up)[0], [0, 0, 0])
    # level 2 is built
    assert (np.asarray(bvh.nodes.up)[1] != 0).any()


def test_built_level_fractional():
    bvh = ib.build(spheres5(), ib.BBox, built_level=0.0)
    assert bvh.built_level == 4  # 0.0 -> leaf level
    bvh = ib.build(spheres5(), ib.BBox, built_level=1.0)
    assert bvh.built_level == 1


def test_custom_indices_via_wrapped_leaves():
    opts = ib.BVHOptions()
    leaves = ib.wrap_bounding_volumes(
        spheres5(), opts, indices=jnp.asarray([10, 20, 30, 40, 50]))
    bvh = ib.build(leaves, ib.BBox, options=opts)
    np.testing.assert_array_equal(np.asarray(bvh.leaves.index),
                                  [10, 20, 30, 40, 50])


def test_build_under_jit():
    import jax

    @jax.jit
    def go(xs, rs):
        bvh = ib.build(ib.BSphere(xs, rs), ib.BBox)
        return bvh.nodes.lo[0], bvh.nodes.up[0]

    s = spheres5()
    lo, up = go(s.x, s.r)
    np.testing.assert_allclose(np.asarray(lo), [-0.6, -0.6, -0.5], atol=1e-6)
    np.testing.assert_allclose(np.asarray(up), [0.6, 0.6, 4.6], atol=1e-6)


def test_build_morton_dtypes():
    for bits in (16, 32, 64):
        opts = ib.BVHOptions(morton=ib.DefaultMortonAlgorithm(bits=bits))
        bvh = ib.build(spheres5(), ib.BBox, options=opts)
        z = np.asarray(bvh.leaves.volume.x)[:, 2]
        assert (np.diff(z) > 0).all(), bits


def test_options_reference_compat_kwargs():
    # reference-style threading knobs are accepted (and ignored)
    opts = ib.BVHOptions(num_threads=4, min_mortons_per_thread=50,
                         min_sorts_per_thread=50, min_boundings_per_thread=50,
                         min_traversals_per_thread=50)
    bvh = ib.build(spheres5(), ib.BBox, options=opts)
    assert bvh.tree.real_leaves == 5
    import pytest
    with pytest.raises(ValueError):
        ib.BVHOptions(num_threads=0)


def test_build_uint64_morton_traverse():
    # u64 codes (native under x64 on CPU) through the whole pipeline
    from implicitbvh_tpu.traverse import traverse
    opts = ib.BVHOptions(morton=ib.DefaultMortonAlgorithm(bits=64))
    bvh = ib.build(spheres5(), ib.BBox, options=opts)
    t = traverse(bvh)
    assert t.contacts_list() == [(1, 2), (2, 3), (4, 5)]


def test_build_int64_indices():
    opts = ib.BVHOptions(index_bits=64)
    bvh = ib.build(spheres5(), ib.BBox, options=opts)
    assert bvh.leaves.index.dtype == jnp.int64
    from implicitbvh_tpu.traverse import traverse
    t = traverse(bvh)
    assert t.contacts_list() == [(1, 2), (2, 3), (4, 5)]
