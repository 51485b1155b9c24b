"""Pallas megakernel vs the XLA integrators (interpret mode on CPU), the
Triton launch geometry, its lowering for CUDA, and the renderer's engine
choice.

The megakernel consumes the same Threefry streams as the oracle
(tests/test_ops_threefry.py), so images must agree to fp accumulation order
— the same contract test_wavefront holds the XLA pool to."""

import jax
import numpy as np
import pytest

from izpi_tpu.integrator import path as path_mod
from izpi_tpu.render import renderer
from izpi_tpu.scene.library.cornell import cornell_box


@pytest.fixture(scope="module")
def ctx():
    return renderer.RenderContext(cornell_box(aspect=1.0))


def test_eligible(ctx):
    assert ctx.mega_supported()


def test_megakernel_matches_oracle(ctx):
    s = path_mod.RenderSettings(max_depth=4)
    nx = ny = 8
    spp = 2
    a = renderer.render(None, nx, ny, spp, settings=s, seed=3,
                        mode="simple", context=ctx)
    run = ctx.mega_runner(nx, ny, spp, s, interpret=True)
    from izpi_tpu.core import rng

    acc, nrays = run(rng.render_key(3), 0)
    img = (np.asarray(acc) / spp).reshape(ny, nx, 3)[::-1]
    assert int(nrays) == a.rays_traced
    np.testing.assert_allclose(img, a.image, atol=1e-5)


def test_megakernel_refill_matches_oracle(ctx, monkeypatch):
    """Without replica slots each slot walks all 3 samples of its pixel,
    refilling in the kernel: the sums still match the oracle's."""
    from izpi_tpu.core import rng
    from izpi_tpu.ops import megakernel

    monkeypatch.setattr(megakernel, "MIN_SLOTS", 1)
    s = path_mod.RenderSettings(max_depth=4)
    nx = ny = 6
    spp = 3
    assert megakernel.plan_launch(nx * ny, spp, megakernel.BLOCK,
                                  megakernel.NUM_WARPS, 1).repl == 1
    a = renderer.render(None, nx, ny, spp, settings=s, seed=3,
                        mode="simple", context=ctx)
    acc, nrays = jax.jit(megakernel.build_renderer(
        ctx.cs, ctx.meta, s, nx, ny, spp, interpret=True))(
            rng.render_key(3), 0)
    img = (np.asarray(acc) / spp).reshape(ny, nx, 3)[::-1]
    assert int(nrays) == a.rays_traced
    np.testing.assert_allclose(img, a.image, atol=1e-5)


def _sphere_field(n_spheres: int):
    from izpi_tpu.scene import types as st

    rs = np.random.RandomState(4)
    world = [st.Sphere((0, -1000, 0), (0, -1000, 0), 0, 1, 1000,
                       st.Lambertian(albedo=st.ConstantTexture(
                           (0.5, 0.5, 0.5))))]
    for i in range(n_spheres):
        c = ((rs.rand(3) - 0.5) * np.array([20, 0, 20])
             + np.array([0, 0.4, 0]))
        world.append(st.Sphere(tuple(c), tuple(c), 0, 1, 0.4,
                               st.Metal(albedo=(0.8, 0.6, 0.4), fuzz=0.1)
                               if i % 3 else
                               st.Lambertian(albedo=st.ConstantTexture(
                                   tuple(rs.rand(3))))))
    cam = st.Camera(look_from=(13, 2, 3), look_at=(0, 0, 0), vfov=20,
                    aspect=1.0)
    return st.Scene(world=world, camera=cam)


def test_megakernel_clustered_matches_flat(monkeypatch):
    """Cluster-skipped unrolled scan (>= CLUSTER_MIN_PRIMS prims) must match
    the flat unrolled scan bit-for-bit — cluster culling may only skip
    primitives whose slab window is empty for every lane. (Compared against
    the flat MEGAKERNEL, not the matrix-brute oracle: the sphere quadratic
    is formulated differently there and near-tangent hits legitimately
    flip, PERF.md.)"""
    from izpi_tpu.core import rng
    from izpi_tpu.ops import megakernel

    scene = _sphere_field(80)   # > CLUSTER_MIN_PRIMS -> clustered scan
    s = path_mod.RenderSettings(max_depth=4, background=(0.7, 0.8, 1.0))
    nx = ny = 8
    spp = 2
    key = rng.render_key(5)

    monkeypatch.setattr(megakernel, "CLUSTER_MIN_PRIMS", 64)
    ctx_c = renderer.RenderContext(scene)
    static = megakernel.extract_static(ctx_c.cs, ctx_c.meta)
    assert len(static.prims) >= megakernel.CLUSTER_MIN_PRIMS
    acc_c, n_c = ctx_c.mega_runner(nx, ny, spp, s, interpret=True)(key, 0)

    monkeypatch.setattr(megakernel, "CLUSTER_MIN_PRIMS", 10_000)
    ctx_f = renderer.RenderContext(scene)
    acc_f, n_f = ctx_f.mega_runner(nx, ny, spp, s, interpret=True)(key, 0)

    assert int(n_c) == int(n_f)
    np.testing.assert_allclose(np.asarray(acc_c), np.asarray(acc_f),
                               atol=1e-6)


def test_build_clusters_partition_and_bounds():
    """Clusters partition the prims into 16-prim chunks, and each chunk's
    box holds every prim's padded box."""
    from izpi_tpu.ops import megakernel

    ctx = renderer.RenderContext(_sphere_field(40))
    prims = megakernel.extract_static(ctx.cs, ctx.meta).prims
    clusters = megakernel.build_clusters(prims, (13.0, 2.0, 3.0))
    assert [len(c) for _, c in clusters].count(16) == len(prims) // 16
    assert sorted(id(p) for _, c in clusters for p in c) == sorted(
        id(p) for p in prims)
    for box, cprims in clusters:
        for pr in cprims:
            lo, hi = megakernel._prim_aabb(pr)
            assert (np.asarray(box[:3]) <= lo).all()
            assert (hi <= np.asarray(box[3:])).all()


def test_megakernel_sample_offset_chunks(ctx):
    """Two chunked runs (offset 0 and 2) must sum to one 4-spp run —
    the checkpoint/resume contract."""
    s = path_mod.RenderSettings(max_depth=3)
    nx = ny = 8
    from izpi_tpu.core import rng

    key = rng.render_key(7)
    full = ctx.mega_runner(nx, ny, 4, s, interpret=True)(key, 0)
    half = ctx.mega_runner(nx, ny, 2, s, interpret=True)
    a0, n0 = half(key, 0)
    a1, n1 = half(key, 2)
    np.testing.assert_allclose(np.asarray(a0) + np.asarray(a1),
                               np.asarray(full[0]), atol=1e-5)
    assert int(n0) + int(n1) == int(full[1])


@pytest.mark.parametrize("n_pix,spp,block,min_slots,want", [
    # (repl, n_slots, n_grid): padding lanes fill the last block
    (64, 2, 128, 1 << 16, (2, 128, 1)),
    (100, 4, 128, 1 << 16, (4, 400, 4)),
    (65536, 1024, 128, 1 << 16, (1, 65536, 512)),
    (250000, 256, 256, 1 << 16, (1, 250000, 977)),
    (4096, 6, 64, 1 << 16, (2, 8192, 128)),   # stops where spp stops halving
])
def test_plan_launch_padding(n_pix, spp, block, min_slots, want):
    from izpi_tpu.ops import megakernel

    lp = megakernel.plan_launch(n_pix, spp, block, 4, min_slots)
    assert (lp.repl, lp.n_slots, lp.n_grid) == want
    assert lp.n_grid * lp.block >= lp.n_slots > (lp.n_grid - 1) * lp.block
    assert spp % lp.repl == 0


def test_plan_launch_rejects_non_power_of_two_block():
    from izpi_tpu.ops import megakernel

    with pytest.raises(ValueError):
        megakernel.plan_launch(64, 2, 96, 4, 1 << 16)


@pytest.mark.parametrize("block", [32, 256])
def test_megakernel_block_size_invariant(ctx, block, monkeypatch):
    """The block only regroups slots: any block gives the default's
    per-pixel sums and ray count."""
    from izpi_tpu.core import rng
    from izpi_tpu.ops import megakernel

    s = path_mod.RenderSettings(max_depth=3)
    key = rng.render_key(9)
    ref = ctx.mega_runner(6, 6, 2, s, interpret=True)(key, 0)
    monkeypatch.setattr(megakernel, "BLOCK", block)
    got = jax.jit(megakernel.build_renderer(
        ctx.cs, ctx.meta, s, 6, 6, 2, interpret=True))(key, 0)
    assert int(got[1]) == int(ref[1])
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                               atol=1e-6)


@pytest.mark.parametrize("scene_name,spectral", [
    ("cornell_box", False),
    ("random_scene", False),   # cut to the unroll budget
    ("cornell_box_pyramid_spectral", True),
])
def test_megakernel_lowers_to_triton_for_cuda(scene_name, spectral):
    """On the CPU, lowering for "cuda" runs the Pallas→Triton step for the
    real scene: the module holds the Triton custom call and no TPU one."""
    from izpi_tpu.core import rng
    from izpi_tpu.ops import megakernel, megakernel_spectral
    from izpi_tpu.scene.library import get_scene

    scene = get_scene(scene_name, aspect=1.0)
    if scene_name == "random_scene":
        budget = megakernel.MAX_UNROLL_PRIMS
        scene.world = scene.world[:budget - 3] + scene.world[-3:]
    ctx = renderer.RenderContext(scene)
    mk = megakernel_spectral if spectral else megakernel
    assert mk.eligible(ctx.cs, ctx.meta)
    fn = mk.build_renderer(ctx.cs, ctx.meta,
                           path_mod.RenderSettings(max_depth=8), 8, 8, 2)
    text = jax.jit(fn).trace(rng.render_key(0), 0).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert "tpu_custom_call" not in text


def test_clustered_megakernel_lowers_to_triton_for_cuda(monkeypatch):
    """The cluster-skipping scan (lax.cond per cluster inside the kernel)
    also lowers through Triton."""
    from izpi_tpu.core import rng
    from izpi_tpu.ops import megakernel

    monkeypatch.setattr(megakernel, "CLUSTER_MIN_PRIMS", 64)
    ctx = renderer.RenderContext(_sphere_field(80))
    fn = megakernel.build_renderer(ctx.cs, ctx.meta,
                                   path_mod.RenderSettings(max_depth=4),
                                   8, 8, 2)
    text = jax.jit(fn).trace(rng.render_key(0), 0).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text


@pytest.mark.parametrize("backend,scene_name,want", [
    ("gpu", "cornell_box", "mega"),
    ("cpu", "cornell_box", "pool"),
    ("gpu", "pbr_ibl", "pool"),       # PBR: not megakernel-eligible
    ("gpu", "random_scene", "pool"),  # 485 prims: above the unroll budget
])
def test_engine_choice(monkeypatch, backend, scene_name, want):
    from izpi_tpu.scene.library import get_scene

    ctx = renderer.RenderContext(get_scene(scene_name, aspect=1.0))
    monkeypatch.setattr(renderer.jax, "default_backend", lambda: backend)
    assert renderer.engine(ctx, "wavefront") == want
    assert renderer.engine(ctx, "pool") == "pool"
    assert renderer.engine(ctx, "simple") == "simple"


def test_failing_megakernel_raises_without_fallback(ctx, monkeypatch):
    """On a GPU the renderer runs the megakernel it chose; if that fails,
    the render raises instead of quietly switching to the pool."""
    monkeypatch.setattr(renderer.jax, "default_backend", lambda: "gpu")

    def broken(*args, **kwargs):
        raise RuntimeError("kernel failed to compile")

    def no_pool(*args, **kwargs):
        raise AssertionError("fell back to the XLA pool")

    monkeypatch.setattr(ctx, "mega_runner", broken)
    monkeypatch.setattr(ctx, "pool_runner", no_pool)
    with pytest.raises(RuntimeError, match="kernel failed"):
        renderer.render(None, 4, 4, 1, context=ctx,
                        settings=path_mod.RenderSettings(max_depth=2))


def test_prepare_routes_large_scenes_to_traverse_on_gpu(monkeypatch):
    """Above BVH_THRESHOLD every backend takes accel.traverse."""
    from izpi_tpu.accel import traverse

    calls = []
    real_attach = traverse.attach

    def spy(cs, seed=1):
        calls.append(seed)
        return real_attach(cs, seed=seed)

    monkeypatch.setattr(renderer.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(renderer, "BVH_THRESHOLD", 8)
    monkeypatch.setattr(traverse, "attach", spy)
    ctx = renderer.RenderContext(cornell_box(aspect=1.0))
    assert ctx.meta.n_prims > renderer.BVH_THRESHOLD
    assert ctx.intersector == "bvh" and calls == [1]


@pytest.mark.gpu
def test_compiled_megakernel_matches_interpret(gpu, ctx):
    """The Triton-compiled kernel gives the interpreter's sums (GPU only)."""
    from izpi_tpu.core import rng

    s = path_mod.RenderSettings(max_depth=4)
    key = rng.render_key(1)
    a = ctx.mega_runner(16, 16, 4, s)(key, 0)
    b = ctx.mega_runner(16, 16, 4, s, interpret=True)(key, 0)
    assert int(a[1]) == int(b[1])
    np.testing.assert_allclose(np.asarray(a[0]), np.asarray(b[0]),
                               rtol=1e-4, atol=1e-4)
