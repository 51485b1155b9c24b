"""Matrix-form intersector vs the elementwise brute-force oracle."""

import numpy as np
import jax.numpy as jnp

from izpi_tpu.geometry import mxu_intersect, primitives as prim
from izpi_tpu.scene import types as st
from izpi_tpu.scene.compiler import compile_scene
from izpi_tpu.scene.library.cornell import cornell_box


def _compare(cs, o, d, t):
    oracle = prim.intersect_brute(cs.prims, o, d, t, 1e-3, prim.T_MAX)
    tables = mxu_intersect.build_tables(cs.prims)
    fast = mxu_intersect.make_intersector(cs.prims, tables)(
        o, d, t, 1e-3, prim.T_MAX)
    np.testing.assert_array_equal(np.asarray(oracle.hit), np.asarray(fast.hit))
    m = np.asarray(oracle.hit)
    np.testing.assert_allclose(np.asarray(oracle.t)[m],
                               np.asarray(fast.t)[m], rtol=2e-4, atol=1e-4)
    same_prim = (np.asarray(oracle.prim_idx) == np.asarray(fast.prim_idx))[m]
    assert same_prim.mean() > 0.999, same_prim.mean()  # rare fp ties may differ


def test_mxu_matches_oracle_cornell():
    cs, _ = compile_scene(cornell_box())
    rs = np.random.RandomState(0)
    n = 1024
    o_np = rs.rand(n, 3) * [555, 555, 1200] - [0, 0, 800]
    target = rs.rand(n, 3) * 555
    o = jnp.asarray(o_np, jnp.float32)
    d = jnp.asarray(target - o_np, jnp.float32)
    t = jnp.asarray(rs.rand(n), jnp.float32)
    _compare(cs, o, d, t)


def test_mxu_matches_oracle_mixed_scene():
    rs = np.random.RandomState(1)
    mat = st.Lambertian(albedo=st.ConstantTexture((0.5, 0.5, 0.5)))
    verts = (rs.rand(80, 1, 3) - 0.5) * 20 + rs.randn(80, 3, 3) * 0.7
    world = [
        st.TriangleMesh(vertices=verts, material=mat),
        st.XZRect(-4, 4, -4, 4, -2.0, mat),
        st.Sphere((0, 3, 0), (0, 3, 0), 0, 1, 2.0, mat),     # static
        st.Sphere((-5, 0, 0), (5, 0, 0), 0, 1, 1.0, mat),    # moving
    ]
    sc = st.Scene(world=world,
                  camera=st.Camera(look_from=(0, 0, -20), look_at=(0, 0, 0)))
    cs, _ = compile_scene(sc)
    n = 1024
    o_np = rs.randn(n, 3) * 12
    target = (rs.rand(n, 3) - 0.5) * 12
    o = jnp.asarray(o_np, jnp.float32)
    d = jnp.asarray(target - o_np, jnp.float32)
    t = jnp.asarray(rs.rand(n), jnp.float32)
    _compare(cs, o, d, t)


def test_mxu_render_matches_brute_render():
    from izpi_tpu.integrator import path as path_mod
    from izpi_tpu.render import renderer
    from izpi_tpu.scene.compiler import compile_scene as cc

    s = path_mod.RenderSettings(max_depth=4)
    scene = cornell_box()
    # Force oracle path.
    cs, meta = cc(scene)
    oracle_intersect = path_mod.make_brute_intersector(cs)
    import izpi_tpu.render.renderer as rmod
    a = renderer.render(scene, 16, 16, 4, settings=s, seed=3)  # default
    # Monkeypatch prepare to the oracle for comparison.
    orig = rmod.prepare

    def prep_oracle(sc_, use_bvh=None, seed=1):
        cs2, meta2 = cc(sc_)
        return cs2, meta2, path_mod.make_brute_intersector(cs2)

    rmod.prepare = prep_oracle
    try:
        b = renderer.render(scene, 16, 16, 4, settings=s, seed=3)
    finally:
        rmod.prepare = orig
    # Identical RNG; the intersection arithmetic differs by fp
    # reassociation, and a borderline hit decision flips a whole MC path —
    # so allow a small fraction of diverging pixels, require the rest tight.
    diff = np.abs(a.image - b.image)
    frac_diverged = (diff > 2e-3).mean()
    assert frac_diverged < 0.02, frac_diverged
    assert np.median(diff) < 1e-5
