"""BVH4 differential tests — traversal vs the brute-force oracle, mirroring
the reference's BVH4-vs-BVH2 strategy (hitable/bvh4_test.go:86-157, 454-517):
same hit/miss on random rays, t within tolerance, plus structural validation
on a large random scene."""

import numpy as np
import jax.numpy as jnp
import pytest

from izpi_tpu import camera as camera_mod

from izpi_tpu.accel import bvh_build, traverse
from izpi_tpu.geometry import primitives as prim
from izpi_tpu.scene import types as st
from izpi_tpu.scene.compiler import compile_scene
from izpi_tpu.scene.library.cornell import cornell_box


def _random_tri_scene(n_tris: int, seed: int, spread: float = 10.0):
    rs = np.random.RandomState(seed)
    base = (rs.rand(n_tris, 1, 3) - 0.5) * 2 * spread
    verts = base + rs.randn(n_tris, 3, 3) * 0.5
    mesh = st.TriangleMesh(
        vertices=verts,
        material=st.Lambertian(albedo=st.ConstantTexture((0.5, 0.5, 0.5))),
    )
    cam = st.Camera(look_from=(0, 0, -30), look_at=(0, 0, 0))
    return st.Scene(world=[mesh], camera=cam)


def _compare(cs, n_rays: int, seed: int):
    cs2, bvh_intersect = traverse.attach(cs, seed=1)
    rs = np.random.RandomState(seed)
    o_np = rs.randn(n_rays, 3) * 15.0
    target = (rs.rand(n_rays, 3) - 0.5) * 10.0  # aim into the prim cloud
    o = jnp.asarray(o_np, jnp.float32)
    d = jnp.asarray(target - o_np, jnp.float32)
    t = jnp.zeros(n_rays, jnp.float32)

    brute = prim.intersect_brute(cs2.prims, o, d, t, 1e-3, prim.T_MAX)
    bvh = bvh_intersect(o, d, t, 1e-3, prim.T_MAX)

    np.testing.assert_array_equal(np.asarray(brute.hit), np.asarray(bvh.hit))
    mask = np.asarray(brute.hit)
    np.testing.assert_allclose(
        np.asarray(brute.t)[mask], np.asarray(bvh.t)[mask], rtol=1e-5
    )
    # Same material surface even if tie-order differs inside a leaf.
    np.testing.assert_array_equal(
        np.asarray(brute.mat_id)[mask], np.asarray(bvh.mat_id)[mask]
    )
    return mask.mean()


def test_bvh_matches_brute_random_triangles():
    cs, _ = compile_scene(_random_tri_scene(300, seed=0))
    hit_rate = _compare(cs, 512, seed=1)
    assert hit_rate > 0.1  # the test must actually exercise hits


def test_bvh_matches_brute_cornell():
    cs, _ = compile_scene(cornell_box())
    cs2, bvh_intersect = traverse.attach(cs, seed=1)
    rs = np.random.RandomState(2)
    n = 256
    o = jnp.asarray(
        rs.rand(n, 3) * [555, 555, 555] - [0, 0, 800], jnp.float32)
    d = jnp.asarray(rs.randn(n, 3), jnp.float32)
    t = jnp.asarray(rs.rand(n), jnp.float32)
    brute = prim.intersect_brute(cs2.prims, o, d, t, 1e-3, prim.T_MAX)
    bvh = bvh_intersect(o, d, t, 1e-3, prim.T_MAX)
    np.testing.assert_array_equal(np.asarray(brute.hit), np.asarray(bvh.hit))
    m = np.asarray(brute.hit)
    np.testing.assert_allclose(
        np.asarray(brute.t)[m], np.asarray(bvh.t)[m], rtol=1e-5)


def test_bvh_structure_10k():
    """Large-scene build integrity (bvh4_test.go:454-517)."""
    cs, _ = compile_scene(_random_tri_scene(10_000, seed=3, spread=50.0))
    arrays = bvh_build.build_bvh4(cs.prims, seed=1)
    assert bvh_build.validate(arrays, cs.prims.count) == []
    # Every leaf run ≤ 4; child indices < node count.
    assert (arrays.count <= 4).all()
    counts = arrays.count
    internal = counts == 0
    assert (arrays.child[internal] < arrays.child.shape[0]).all()


def test_bvh_adversarial_precision():
    """f32 conservative-bounds test (bvh4_test.go:418-451): huge and tiny
    coordinates; BVH must never miss what brute force hits."""
    rs = np.random.RandomState(4)
    tris = []
    for scale in (1e-3, 1.0, 1e4):
        base = (rs.rand(40, 1, 3) - 0.5) * 2 * scale
        tris.append(base + rs.randn(40, 3, 3) * 0.1 * scale)
    verts = np.concatenate(tris)
    mesh = st.TriangleMesh(
        vertices=verts,
        material=st.Lambertian(albedo=st.ConstantTexture((0.5, 0.5, 0.5))),
    )
    sc = st.Scene(world=[mesh],
                  camera=st.Camera(look_from=(0, 0, -1), look_at=(0, 0, 0)))
    cs, _ = compile_scene(sc)
    cs2, bvh_intersect = traverse.attach(cs, seed=1)
    n = 256
    o = jnp.asarray(rs.randn(n, 3) * 100.0, jnp.float32)
    d = jnp.asarray(rs.randn(n, 3), jnp.float32)
    t = jnp.zeros(n, jnp.float32)
    brute = prim.intersect_brute(cs2.prims, o, d, t, 1e-3, prim.T_MAX)
    bvh = bvh_intersect(o, d, t, 1e-3, prim.T_MAX)
    # BVH may only differ by NOT missing: anything brute hits, BVH hits.
    bh = np.asarray(brute.hit)
    vh = np.asarray(bvh.hit)
    assert (vh | ~bh).all(), "BVH missed a primitive brute force hit"


def test_stack_occupancy_computed_and_fits():
    """validate() computes worst-case traversal stack occupancy and the
    standard scenes fit comfortably inside the device stack."""
    cs, _ = compile_scene(_random_tri_scene(4096, seed=7))
    arrays = bvh_build.build_bvh4(cs.prims, seed=1)
    occ = bvh_build.max_stack_occupancy(arrays)
    assert 1 <= occ <= traverse.STACK_DEPTH
    assert bvh_build.validate(arrays, cs.prims.count,
                              stack_depth=traverse.STACK_DEPTH) == []


def test_pathological_tree_raises_at_build():
    """A constructed over-deep tree fails validate(stack_depth=...) instead
    of silently dropping hits on the device."""
    # A chain of nodes with 4 internal children each, only one of which
    # continues deep: worst-case occupancy grows by 3 per level (visit the
    # deep child while its 3 siblings are still stacked).
    depth = 40
    n_nodes = depth * 4 + 1
    bounds = np.zeros((n_nodes, 24), np.float32)
    bounds[:, 12:] = 1.0  # unit boxes
    child = np.full((n_nodes, 4), -1, np.int32)
    count = np.full((n_nodes, 4), -1, np.int32)
    n_prims = 0

    def add_leaf_node(ni):
        nonlocal n_prims
        child[ni, 0] = n_prims
        count[ni, 0] = 1
        n_prims += 1

    next_node = 1
    ni = 0
    for _ in range(depth):
        deep = next_node
        sibs = [next_node + 1, next_node + 2, next_node + 3]
        next_node += 4
        child[ni, 0] = deep
        count[ni, 0] = 0
        for s, sni in enumerate(sibs, start=1):
            child[ni, s] = sni
            count[ni, s] = 0
            add_leaf_node(sni)
        ni = deep
    add_leaf_node(ni)  # terminal
    arrays = bvh_build.BVH4Arrays(
        bounds=bounds, child=child, count=count,
        prim_order=np.arange(n_prims, dtype=np.int32))
    occ = bvh_build.max_stack_occupancy(arrays)
    assert occ > 64
    errors = bvh_build.validate(arrays, n_prims, stack_depth=64)
    assert any("stack" in e for e in errors)
    # ...and passes with a deep enough stack.
    assert bvh_build.validate(arrays, n_prims, stack_depth=256) == []


# --- accel.traverse vs brute force over scene and ray classes -------------


def _tri_soup_scene(n, seed):
    """`n` separate Triangle prims (not one mesh) in a 10-unit cube."""
    rs = np.random.RandomState(seed)
    mat = st.Lambertian(albedo=st.ConstantTexture((0.5, 0.5, 0.5)))
    tris = []
    for _ in range(n):
        v0 = rs.rand(3) * 10.0
        tris.append(st.Triangle(v0=tuple(v0), v1=tuple(v0 + rs.rand(3)),
                                v2=tuple(v0 + rs.rand(3)), material=mat))
    return st.Scene(world=tris, camera=st.Camera(look_from=(5, 5, -15),
                                                 look_at=(5, 5, 5)))


def _procedural_scene(n):
    from izpi_tpu.geometry import procedural

    tris = procedural.bumpy_blob(n)
    mesh = st.TriangleMesh(
        vertices=tris,
        material=st.Lambertian(albedo=st.ConstantTexture((0.5, 0.5, 0.5))))
    return st.Scene(world=[mesh], camera=st.Camera(look_from=(0, 0, -4),
                                                   look_at=(0, 0, 0)))


def _random_rays(n, seed, lo, hi):
    rs = np.random.RandomState(seed)
    o = jnp.asarray(lo + rs.rand(n, 3) * (hi - lo), jnp.float32)
    d = jnp.asarray(rs.randn(n, 3), jnp.float32)
    return o, d, jnp.asarray(rs.rand(n), jnp.float32)


def _camera_rays(cs, n, seed):
    rs = np.random.RandomState(seed)
    return camera_mod.get_rays(
        cs.camera, jnp.asarray(rs.rand(n), jnp.float32),
        jnp.asarray(rs.rand(n), jnp.float32),
        jnp.asarray(rs.rand(n, 3), jnp.float32))


# name -> (scene factory, ray factory(cs2), t_max)
TRAVERSE_CASES = {
    "random_tris": (lambda: _random_tri_scene(3000, seed=11),
                    lambda cs: _random_rays(512, 3, -12.0, 12.0), prim.T_MAX),
    "mixed_kinds_cornell": (cornell_box,
                            lambda cs: _random_rays(512, 5, -400.0, 400.0),
                            prim.T_MAX),
    "shrinking_t_window": (lambda: _random_tri_scene(512, seed=2),
                           lambda cs: _random_rays(256, 9, -12.0, 12.0), 2.0),
    "camera_rays": (cornell_box, lambda cs: _camera_rays(cs, 1024, 0),
                    prim.T_MAX),
    "incoherent_rays": (cornell_box,
                        lambda cs: _random_rays(1024, 1, 0.0, 555.0),
                        prim.T_MAX),
    "triangle_mesh_blocks": (lambda: _tri_soup_scene(300, 3),
                             lambda cs: _random_rays(1024, 4, -1.0, 11.0),
                             prim.T_MAX),
    "procedural_submesh_20k": (lambda: _procedural_scene(20_000),
                               lambda cs: _camera_rays(cs, 1024, 6),
                               prim.T_MAX),
}


@pytest.mark.parametrize("case", sorted(TRAVERSE_CASES))
def test_traverse_matches_brute(case):
    """The XLA traversal (the BVH path on every backend) agrees with brute
    force: same hits, t to 1e-5 relative, equal prim ids except at ties."""
    make_scene, make_rays, t_max = TRAVERSE_CASES[case]
    cs, _ = compile_scene(make_scene())
    cs2, inter = traverse.attach(cs, seed=1)
    o, d, tm = make_rays(cs2)
    got = inter(o, d, tm, 1e-3, t_max)
    want = prim.intersect_brute(cs2.prims, o, d, tm, 1e-3, t_max)
    h = np.asarray(want.hit)
    np.testing.assert_array_equal(np.asarray(got.hit), h)
    assert h.any()
    gt, wt = np.asarray(got.t)[h], np.asarray(want.t)[h]
    assert (gt <= t_max).all()
    np.testing.assert_allclose(gt, wt, rtol=1e-5)
    gi, wi = np.asarray(got.prim_idx)[h], np.asarray(want.prim_idx)[h]
    tie = np.isclose(gt, wt, rtol=1e-6)
    assert (tie | (gi == wi)).all()


def test_traverse_plain_while_matches_chunked(monkeypatch):
    """LOOP_CHUNK only sets how often the loop predicate is read: a plain
    while_loop (chunk 1) returns the same hits as the chunked loop."""
    cs, _ = compile_scene(_random_tri_scene(2000, seed=21))
    cs2, inter = traverse.attach(cs, seed=1)
    o, d, tm = _random_rays(512, 8, -12.0, 12.0)
    chunked = inter(o, d, tm, 1e-3, prim.T_MAX)
    monkeypatch.setattr(traverse, "LOOP_CHUNK", 1)
    plain = inter(o, d, tm, 1e-3, prim.T_MAX)
    for a, b in zip(chunked, plain):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
