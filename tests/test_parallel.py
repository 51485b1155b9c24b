"""Sharding tests on the 8-device virtual CPU mesh (conftest), plus the
differentiability contract: pixel gradients validated by finite differences
(BASELINE.md)."""

import numpy as np
import jax
import jax.numpy as jnp

from izpi_tpu.core import rng
from izpi_tpu.integrator import path as path_mod
from izpi_tpu.parallel import dist
from izpi_tpu.render import renderer
from izpi_tpu.scene.compiler import compile_scene
from izpi_tpu.scene.library.cornell import cornell_box


def test_distributed_matches_single_device():
    scene = cornell_box()
    settings = path_mod.RenderSettings(max_depth=4)
    single = renderer.render(scene, 16, 16, 8, settings=settings, seed=11)
    mesh = dist.make_mesh(8)
    multi = dist.render_distributed(scene, 16, 16, 8, mesh=mesh,
                                    settings=settings, seed=11)
    # Same seed → same (pixel, sample) keys; sample-sharding only reorders
    # the per-sample summation, so estimates agree to fp accumulation.
    np.testing.assert_allclose(single.image, multi.image, atol=1e-4,
                               rtol=1e-4)
    assert multi.rays_traced == single.rays_traced


def test_distributed_spectral():
    from izpi_tpu.scene.library.cornell_spectral import cornell_box_spectral

    scene = cornell_box_spectral()
    settings = path_mod.RenderSettings(max_depth=4)
    mesh = dist.make_mesh(4)
    multi = dist.render_distributed(scene, 8, 8, 8, mesh=mesh,
                                    settings=settings, seed=3)
    single = renderer.render(scene, 8, 8, 8, settings=settings, seed=3,
                             sampler_type="spectral")
    assert multi.xyz is not None
    np.testing.assert_allclose(multi.image, single.image, atol=1e-3,
                               rtol=1e-3)


def test_scaling_harness_runs():
    scene = cornell_box()
    settings = path_mod.RenderSettings(max_depth=3)
    out = dist.scaling_efficiency(scene, 8, 8, 8, device_counts=[1, 2],
                                  settings=settings)
    assert set(out) == {1, 2}
    assert out[1]["efficiency"] == 1.0
    assert out[2]["mrays"] > 0


def test_graft_entry_contracts():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    color, nrays = jax.jit(fn)(*args)
    assert color.shape == (64 * 64, 3)
    assert np.isfinite(np.asarray(color)).all()
    ge.dryrun_multichip(8)


def test_gradients_match_finite_differences():
    """d(loss)/d(albedo) via autodiff vs central differences."""
    scene = cornell_box(with_glass_sphere=False)
    cs, meta = compile_scene(scene)
    settings = path_mod.RenderSettings(max_depth=3)
    intersect = path_mod.make_brute_intersector(cs)

    nx = ny = 8
    n = nx * ny
    ys = jnp.repeat(jnp.arange(ny, dtype=jnp.int32), nx)
    xs = jnp.tile(jnp.arange(nx, dtype=jnp.int32), ny)
    key = rng.render_key(2)

    def loss_of_c0(c0):
        cs_p = cs._replace(textures=cs.textures._replace(c0=c0))
        color, _ = renderer.sample_pass(
            cs_p, meta, settings, intersect, nx, ny, xs, ys, key, 0,
            differentiable=True,
        )
        return jnp.mean(color)

    c0 = cs.textures.c0
    g = jax.grad(loss_of_c0)(c0)
    g = np.asarray(g)
    assert np.isfinite(g).all()

    # Same RNG stream on both sides of the perturbation → the MC estimate is
    # a deterministic function and central differences are exact up to f32.
    f = jax.jit(loss_of_c0)
    eps = 1e-2
    rs = np.random.RandomState(0)
    checked = 0
    for (i, j) in [(0, 0), (0, 1), (1, 2), (3, 0)]:
        if i >= c0.shape[0]:
            continue
        dir_ = jnp.zeros_like(c0).at[i, j].set(1.0)
        fp = float(f(c0 + eps * dir_))
        fm = float(f(c0 - eps * dir_))
        fd = (fp - fm) / (2 * eps)
        ad = float(g[i, j])
        assert abs(fd - ad) < max(2e-2 * max(abs(fd), abs(ad)), 2e-3), (
            i, j, fd, ad)
        checked += 1
    assert checked >= 3


def test_primitive_sharded_intersector_matches_replicated():
    """>HBM-scene path (SURVEY §2.6 geometry streaming → prim sharding):
    each device holds 1/N of the primitives; closest hits reduce over the
    mesh and must equal the replicated brute-force oracle exactly."""
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    from izpi_tpu.geometry import primitives as prim

    scene = cornell_box()
    cs, meta = compile_scene(scene)
    mesh = dist.make_mesh(8)

    n = 256
    rs = np.random.RandomState(4)
    o = jnp.asarray(278 + rs.randn(n, 3) * 200, jnp.float32)
    d = jnp.asarray(rs.randn(n, 3), jnp.float32)
    tm = jnp.zeros(n, jnp.float32)
    want = prim.intersect_brute(cs.prims, o, d, tm, 1e-3, prim.T_MAX)

    # brute mode AND per-shard-BVH mode (use_bvh forced on — the cornell
    # scene is below the auto threshold) must both equal the oracle.
    for use_bvh in (False, True):
        shard_args, intersect_local = dist.make_sharded_intersector(
            cs, mesh, use_bvh=use_bvh)

        def body(local, o, d, tm):
            rec = intersect_local(local, o, d, tm, 1e-3, prim.T_MAX)
            return tuple(rec)

        fn = shard_map(body, mesh=mesh,
                       in_specs=(P(dist.TILE_AXIS), P(), P(), P()),
                       out_specs=P())
        got = prim.Hit(*fn(shard_args, o, d, tm))
        np.testing.assert_array_equal(np.asarray(got.hit),
                                      np.asarray(want.hit))
        h = np.asarray(want.hit)
        np.testing.assert_allclose(np.asarray(got.t)[h],
                                   np.asarray(want.t)[h], rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(got.mat_id)[h],
                                      np.asarray(want.mat_id)[h])
        np.testing.assert_array_equal(np.asarray(got.prim_idx)[h],
                                      np.asarray(want.prim_idx)[h])
        np.testing.assert_allclose(np.asarray(got.normal)[h],
                                   np.asarray(want.normal)[h], rtol=1e-5,
                                   atol=1e-6)


def test_prim_sharded_render_matches_replicated():
    """render_distributed(shard_prims=True) — the end-to-end >HBM path —
    must produce the same frame as the replicated sample-sharded render on
    a 1-device mesh (identical sample streams: full spp, offset 0)."""
    from izpi_tpu.integrator import path as path_mod

    scene = cornell_box()
    settings = path_mod.RenderSettings(max_depth=3)
    a = dist.render_distributed(scene, 8, 8, 2, mesh=dist.make_mesh(8),
                                settings=settings, seed=0, shard_prims=True)
    b = dist.render_distributed(scene, 8, 8, 2, mesh=dist.make_mesh(1),
                                settings=settings, seed=0)
    assert a.rays_traced == b.rays_traced
    np.testing.assert_allclose(a.image, b.image, rtol=1e-4, atol=1e-5)


def test_prim_sharded_render_pbr_matches_replicated():
    """PBR scenes render prim-sharded: the winner's
    GLOBAL prim id indexes the replicated kind/tb shading tables after the
    psum, so normal-mapped PBR shading works with geometry 1/N per device."""
    from izpi_tpu.integrator import path as path_mod
    from izpi_tpu.scene.library.misc import pbr_ibl

    scene = pbr_ibl()
    settings = path_mod.RenderSettings(max_depth=3)
    a = dist.render_distributed(scene, 8, 8, 2, mesh=dist.make_mesh(8),
                                settings=settings, seed=0, shard_prims=True)
    b = dist.render_distributed(scene, 8, 8, 2, mesh=dist.make_mesh(1),
                                settings=settings, seed=0)
    assert a.rays_traced == b.rays_traced
    np.testing.assert_allclose(a.image, b.image, rtol=1e-4, atol=1e-5)


def test_prim_sharded_bvh_render_matches_replicated():
    """Per-shard BVH4 path at dragon-class prim counts (scaled down): the
    sharded render with each device traversing a BVH over its local slice
    must equal the replicated render."""
    from izpi_tpu.integrator import path as path_mod
    from izpi_tpu.scene.library.extracted import (
        cornell_box_pbr_stanford_dragon_spectral)

    scene = cornell_box_pbr_stanford_dragon_spectral(aspect=1.0, n_tris=4000)
    settings = path_mod.RenderSettings(max_depth=3)
    a = dist.render_distributed(scene, 6, 6, 1, mesh=dist.make_mesh(8),
                                settings=settings, seed=0, shard_prims=True)
    b = dist.render_distributed(scene, 6, 6, 1, mesh=dist.make_mesh(1),
                                settings=settings, seed=0)
    assert a.rays_traced == b.rays_traced
    np.testing.assert_allclose(a.image, b.image, rtol=1e-3, atol=1e-4)


def test_prim_and_texture_sharded_render_matches_replicated():
    """Texture-sharded rendering (the >HBM texture
    set path): image + combined stacks split over the mesh with per-lookup
    mask + psum (texture.tables sharded mode) must reproduce the replicated
    render exactly. pbr_ibl carries multiple image maps, so every shard
    owns a real slice and the merge path is exercised."""
    from izpi_tpu.integrator import path as path_mod
    from izpi_tpu.scene.library.misc import pbr_ibl

    scene = pbr_ibl()
    settings = path_mod.RenderSettings(max_depth=3)
    a = dist.render_distributed(scene, 8, 8, 2, mesh=dist.make_mesh(8),
                                settings=settings, seed=0, shard_prims=True,
                                shard_textures=True)
    b = dist.render_distributed(scene, 8, 8, 2, mesh=dist.make_mesh(1),
                                settings=settings, seed=0)
    assert a.rays_traced == b.rays_traced
    np.testing.assert_allclose(a.image, b.image, rtol=1e-4, atol=1e-5)
