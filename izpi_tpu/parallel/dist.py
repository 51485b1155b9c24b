"""Multi-device scale-out: shard_map over a device mesh.

Replaces the reference's entire distribution stack (gRPC leader/worker tile
streaming, mDNS discovery, asset streaming — internal/leader, internal/worker,
internal/transport; SURVEY.md §2.6) with a JAX design:

- work is sharded over the mesh axis 'tiles' — the data-parallel axis. The
  production path (`render_distributed`) shards SAMPLES: every device runs
  the same persistent-pool wavefront over the whole frame on a disjoint
  sample range (sample_offset = device_index·spp_local) and the canvases
  psum at the end — one (n_pix, 3) all-reduce replaces the
  reference's per-row gRPC streaming (render/remote.go:31-44). The simple
  lockstep sampler keeps the pixel-sharded variant as an oracle,
- the compiled scene is replicated to every device (the analog of each worker
  fetching the whole scene and building its own BVH, worker/setup.go:155-388),
- the ray counter is a psum (the analog of RenderEnd stats collection,
  renderer.go:203-211),
- the differentiable path all-reduces parameter gradients
  (jax.grad over shard_map inserts the psum automatically).

Multi-host: `initialize_multihost` wraps jax.distributed.initialize();
run one process per host (cli.py --role leader/worker with --coordinator)
and jax.devices() spans every host's devices — the same mesh code scales,
with XLA's collectives carrying the canvas psum. No bespoke RPC
layer (leader/worker/assetprovider/discovery in the reference) is needed.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from izpi_tpu.core import rng
from izpi_tpu.integrator import path as path_mod
from izpi_tpu.render import renderer as renderer_mod
from izpi_tpu.scene import types as st
from izpi_tpu.scene.compiler import compile_scene

TILE_AXIS = "tiles"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (TILE_AXIS,))


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> int:
    """Join (or form) a multi-host cluster — the JAX replacement for
    the reference's mDNS discovery + gRPC setup handshake
    (discovery/discovery.go, leader/setup.go:22-131). Pass the leader's
    address, the process count and this process's rank. Returns the
    process count."""
    kwargs = {}
    if coordinator:
        kwargs["coordinator_address"] = coordinator
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    return jax.process_count()


def _pad_to(x, n, fill=0):
    pad = (-x.shape[0]) % n
    if pad == 0:
        return x, 0
    widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, widths, constant_values=fill), pad


def build_sharded_sampler(cs, meta, settings, intersect, nx, ny, mesh: Mesh):
    """Returns a jitted fn(xs, ys, key, n_spp) -> (color (N,3), rays ())
    with pixels sharded over the mesh and the scene replicated."""

    @partial(jax.jit, static_argnames=("n_spp",))
    def run(xs, ys, key, n_spp):
        def shard_body(cs_rep, xs, ys, key):
            def body(s, carry):
                acc, rays = carry
                color, nrays = renderer_mod.sample_pass(
                    cs_rep, meta, settings, intersect, nx, ny, xs, ys, key, s
                )
                return acc + color, rays + nrays

            acc0 = jnp.zeros((xs.shape[0], 3), jnp.float32) + (
                xs * 0
            ).astype(jnp.float32)[:, None]
            rays0 = jnp.sum(xs * 0)
            acc, rays = jax.lax.fori_loop(0, n_spp, body, (acc0, rays0))
            # Total ray count over the mesh (RenderEnd psum analog).
            rays = jax.lax.psum(rays, TILE_AXIS)
            return acc / n_spp, rays

        fn = shard_map(
            shard_body, mesh=mesh,
            in_specs=(P(), P(TILE_AXIS), P(TILE_AXIS), P()),
            out_specs=(P(TILE_AXIS), P()),
        )
        return fn(cs, xs, ys, key)

    return run


def build_pool_renderer(cs, meta, settings, intersect, nx: int, ny: int,
                        mesh: Mesh, spp_local: int,
                        spectral: bool = False,
                        pool_size: int = 1 << 16):
    """Sample-sharded production renderer: every device runs the persistent
    wavefront pool (integrator.wavefront.trace_pool) over the WHOLE frame on
    its own sample range, then the canvases and ray counters all-reduce.

    Returns jitted fn(key) -> (acc (n_pix, 3) summed radiance — RGB or XYZ,
    rays ()); divide acc by n_dev·spp_local for the image."""
    from izpi_tpu.integrator import wavefront

    bg_spd_id = meta.spectral_background_spd or 0
    pool = min(pool_size, nx * ny * spp_local)

    def shard_body(cs_rep, key):
        dev = jax.lax.axis_index(TILE_AXIS)
        acc, nrays = wavefront.trace_pool(
            cs_rep, meta, settings, intersect, nx, ny, spp_local, key, pool,
            spectral=spectral, bg_spd_id=bg_spd_id,
            sample_offset=dev * spp_local,
        )
        # One canvas all-reduce replaces the reference's row streaming
        # (render/remote.go:46-89); counter psum = RenderEnd stats.
        return (jax.lax.psum(acc, TILE_AXIS),
                jax.lax.psum(nrays, TILE_AXIS))

    @jax.jit
    def run(key):
        fn = shard_map(shard_body, mesh=mesh,
                       in_specs=(P(), P()), out_specs=(P(), P()))
        return fn(cs, key)

    return run


def build_pool_renderer_prim_sharded(cs, meta, settings, nx: int, ny: int,
                                     mesh: Mesh, spp: int,
                                     spectral: bool = False,
                                     pool_size: int = 1 << 16,
                                     use_bvh: Optional[bool] = None,
                                     shard_textures: bool = False):
    """Primitive-sharded production renderer — the >HBM-scene path (the
    reference streams triangles so every worker holds the whole scene,
    worker/setup.go:97-153 + 292-306; on a device mesh the natural
    inversion shards the primitive SoA so each chip holds 1/N of the
    geometry AND builds a
    per-shard BVH4 over its local slice — the sharded analog of each
    worker's post-streaming NewBVH4 build).

    Unlike sample sharding, RAYS ARE REPLICATED: every device runs the
    identical pool over the full sample range against its local prims, the
    closest hit reduces across devices inside every bounce
    (make_sharded_intersector), and the identical replicated loop keeps the
    while-loop condition in lockstep — collectives inside the bounce loop
    would deadlock otherwise. PBR is supported: the winner's GLOBAL prim id
    (via the shard's local→global map) indexes the small replicated shading
    tables (kind + tangent frames) that strip_replicated_geometry keeps."""
    from izpi_tpu.integrator import wavefront

    shard_args, intersect_local = make_sharded_intersector(cs, mesh,
                                                           use_bvh=use_bvh)
    cs_rep = strip_replicated_geometry(cs)
    if shard_textures:
        # >HBM texture sets: the image/combined stacks shard over the mesh
        # too; lookups mask + psum inside the bounce (texture.tables).
        tex_shards, cs_rep = make_sharded_textures(cs_rep, mesh)
        meta = dataclasses.replace(meta, tex_shard_axis=TILE_AXIS)
    else:
        tex_shards = jnp.zeros((mesh.devices.size, 1), jnp.float32)
    bg_spd_id = meta.spectral_background_spd or 0
    pool = min(pool_size, nx * ny * spp)

    def shard_body(local, tex_local, cs_rep, key):
        if shard_textures:
            cs_rep = apply_texture_shard(cs_rep, tex_local)
        intersect = partial(intersect_local, local)
        acc, nrays = wavefront.trace_pool(
            cs_rep, meta, settings, intersect, nx, ny, spp, key, pool,
            spectral=spectral, bg_spd_id=bg_spd_id)
        # acc/nrays come out identical on every device (replicated rays,
        # psum'd hit records), so out_specs P() just reads them off.
        return acc, nrays

    @jax.jit
    def run(key):
        fn = shard_map(
            shard_body, mesh=mesh,
            in_specs=(P(TILE_AXIS), P(TILE_AXIS), P(), P()),
            out_specs=(P(), P()),
            check_vma=False)
        return fn(shard_args, tex_shards, cs_rep, key)

    return run


def strip_replicated_geometry(cs):
    """The replicated CompiledScene for prim-sharded rendering: the
    geometry SoA lives sharded (make_sharded_intersector), so its
    replicated copy shrinks to 1-row dummies. Only the post-intersect
    shading tables stay full: `kind` (triangle check) and `tb` (tangent
    frames), which _pbr_normals gathers by GLOBAL prim id — 7 floats/prim
    replicated vs ~27 sharded."""
    p = cs.prims

    def one(x):
        return x[:1] * 0

    return cs._replace(prims=p._replace(
        g0=one(p.g0), g1=one(p.g1), g2=one(p.g2), g3=one(p.g3),
        mat_id=one(p.mat_id), flip=one(p.flip), uv=one(p.uv),
        vn=one(p.vn), has_vn=one(p.has_vn)))


def build_distributed_runner(context, nx: int, ny: int, spp: int,
                             mesh: Mesh,
                             settings: path_mod.RenderSettings,
                             sampler_type: str = "colour",
                             shard_prims: bool = False,
                             shard_textures: bool = False):
    """The jitted fn(key) -> (acc, rays) that render_distributed runs, and
    the spp it renders (rounded up to a multiple of the device count when
    samples are sharded). Compiling it ahead (`run.lower(key).compile()`)
    fills the persistent compile cache for a later render."""
    cs, meta, intersect = context.cs, context.meta, context.intersect
    spectral = meta.spectral or sampler_type == "spectral"
    if shard_prims:
        # Geometry sharded 1/N per chip, samples replicated (SURVEY §2.6
        # "geometry streaming"): the >HBM-scene mode.
        return build_pool_renderer_prim_sharded(
            cs, meta, settings, nx, ny, mesh, spp, spectral=spectral,
            shard_textures=shard_textures), spp
    n_dev = mesh.devices.size
    spp_eff = -(-spp // n_dev) * n_dev
    return build_pool_renderer(cs, meta, settings, intersect, nx, ny, mesh,
                               spp_eff // n_dev, spectral=spectral), spp_eff


def render_distributed(scene: st.Scene, nx: int, ny: int, spp: int,
                       mesh: Optional[Mesh] = None,
                       settings: Optional[path_mod.RenderSettings] = None,
                       seed: int = 0,
                       sampler_type: str = "colour",
                       context=None,
                       shard_prims: bool = False,
                       shard_textures: bool = False,
                       warmup: bool = False) -> renderer_mod.RenderResult:
    """Whole-image render with samples sharded across the mesh (the
    wavefront pool on every device; spectral supported).

    spp is rounded UP to a multiple of the device count (every device must
    run the same static-shape pool; the extra samples only reduce variance).
    The single production run is timed including compile (reported in
    RenderResult.phases like renderer.render); pass warmup=True only for
    benchmarking, where a separate compile run keeps the timing honest —
    it doubles the device work, so it is never the CLI path."""
    import time as time_mod

    settings = settings or path_mod.RenderSettings()
    mesh = mesh or make_mesh()
    if context is None:
        context = renderer_mod.RenderContext(scene)
    meta = context.meta
    spectral = meta.spectral or sampler_type == "spectral"
    run, spp_eff = build_distributed_runner(
        context, nx, ny, spp, mesh, settings, sampler_type=sampler_type,
        shard_prims=shard_prims, shard_textures=shard_textures)
    key = rng.render_key(seed)
    if warmup:
        jax.block_until_ready(run(key))
    t0 = time_mod.perf_counter()
    acc, rays = run(key)
    acc = np.asarray(acc)
    seconds = time_mod.perf_counter() - t0
    phases = {"render_incl_compile" if not warmup else "render":
              round(seconds, 4)}

    canvas = (acc / spp_eff).reshape(ny, nx, 3)[::-1]
    if spectral:
        from izpi_tpu.spectral import convert

        xyz = convert.firefly_rejection(canvas.astype(np.float64))
        image = convert.xyz_to_acescg(xyz, meta.exposure).astype(np.float32)
        return renderer_mod.RenderResult(
            image=image, rays_traced=int(rays), seconds=seconds,
            xyz=xyz.astype(np.float32), phases=phases)
    return renderer_mod.RenderResult(
        image=canvas, rays_traced=int(rays), seconds=seconds, phases=phases)


class PrimShards:
    """Device arrays for the prim-sharded intersector, each with a leading
    axis of n_dev equal chunks (shard with in_specs=P(TILE_AXIS)):
    the local primitive SoA (per-shard-BVH-reordered), the local→ORIGINAL
    global prim id map, and the per-shard BVH4 node tables."""

    def __init__(self, prims, gmap, bounds, child, count):
        self.prims = prims
        self.gmap = gmap
        self.bounds = bounds
        self.child = child
        self.count = count

    def tree_flatten(self):
        return ((self.prims, self.gmap, self.bounds, self.child,
                 self.count), None)

    @classmethod
    def tree_unflatten(cls, _aux, children):
        return cls(*children)


jax.tree_util.register_pytree_node(
    PrimShards, lambda s: s.tree_flatten(),
    lambda aux, ch: PrimShards.tree_unflatten(aux, ch))


class TexShards:
    """Texture stacks split over the mesh — the >HBM-texture-set path (the
    reference streams texture planes to workers in 64 KiB chunks so every
    worker holds them all, assetprovider.go:122-198 + worker/setup.go:48-95;
    on a device mesh the natural inversion shards the image/combined stacks
    over the device axis and merges lookups with one psum per evaluation —
    texture.tables.eval_rgb sharded mode). Leading axis: n_dev."""

    def __init__(self, images, combined, img_base, combo_base):
        # Leading axes are n_dev*rows concatenations (shard_map splits the
        # leading axis in equal chunks without squeezing, so stacking would
        # leave a size-1 axis in the shard body).
        self.images = images        # (n_dev*I_s, H, W, 3)
        self.combined = combined    # (n_dev*C_s, h, w, 8)
        self.img_base = img_base    # (n_dev,) i32 global start of slice
        self.combo_base = combo_base

    def tree_flatten(self):
        return ((self.images, self.combined, self.img_base,
                 self.combo_base), None)

    @classmethod
    def tree_unflatten(cls, _aux, children):
        return cls(*children)


jax.tree_util.register_pytree_node(
    TexShards, lambda s: s.tree_flatten(),
    lambda aux, ch: TexShards.tree_unflatten(aux, ch))


def make_sharded_textures(cs, mesh: Mesh):
    """Split cs.textures' image + combined stacks into n_dev contiguous
    index ranges (padded to equal size). Returns (tex_shards, cs_rep) where
    cs_rep's stacks are 1-row dummies; inside a shard_map body, install the
    local slice with `apply_texture_shard` and set meta.tex_shard_axis so
    the evaluators mask + psum. Metadata tables (per-texture w/h) stay
    replicated — bytes, not megabytes."""
    tex = cs.textures
    images = np.asarray(tex.images)
    combined = np.asarray(tex.combined)
    n_dev = mesh.devices.size

    def split(stack, min_rows):
        n = max(stack.shape[0], 1)
        per = max(-(-n // n_dev), min_rows)
        pad = n_dev * per - stack.shape[0]
        if pad:
            stack = np.pad(stack,
                           [(0, pad)] + [(0, 0)] * (stack.ndim - 1))
        base = np.arange(n_dev, dtype=np.int32) * per
        return jnp.asarray(stack), jnp.asarray(base)

    img_s, img_base = split(images, 1)
    com_s, com_base = split(combined, 1) if combined.shape[0] else (
        jnp.zeros((n_dev * 0,) + combined.shape[1:], jnp.float32),
        jnp.zeros((n_dev,), jnp.int32))
    shards = TexShards(images=img_s, combined=com_s, img_base=img_base,
                       combo_base=com_base)
    cs_rep = cs._replace(textures=tex._replace(
        images=jnp.zeros((1, 1, 1, 3), jnp.float32),
        combined=jnp.zeros((0, 1, 1, 8), jnp.float32)))
    return shards, cs_rep


def apply_texture_shard(cs_rep, local: TexShards):
    """Install one device's texture slice into the replicated scene (call
    inside the shard_map body; `local` arrives with the leading n_dev axis
    already consumed by in_specs=P(TILE_AXIS))."""
    return cs_rep._replace(textures=cs_rep.textures._replace(
        images=local.images, combined=local.combined,
        img_base=local.img_base.reshape(()),
        combo_base=local.combo_base.reshape(())))


def make_sharded_intersector(cs, mesh: Mesh, use_bvh: Optional[bool] = None,
                             seed: int = 1):
    """Primitive-sharded closest hit — the >HBM-scene path (SURVEY §2.6
    "geometry streaming": the reference streams triangles to every worker
    which then builds its own BVH4, leader/leader.go:34 +
    worker/setup.go:97-153,292-306; on a device mesh the natural design
    shards the primitive SoA across the mesh so each chip holds 1/N of the
    scene and
    traverses a BVH4 built over its local slice).

    Usable INSIDE a shard_map body whose rays are replicated over
    TILE_AXIS: each shard intersects its local prims (per-shard BVH4
    traversal for big slices, brute force for small ones), the winning t
    reduces with a pmin across devices, ties break to the lowest shard (exactly
    one winner), and the winner's full shading record psums to everyone.
    prim_idx comes back in the ORIGINAL global numbering, so the small
    replicated shading tables (strip_replicated_geometry) index directly.

    Returns (shard_args: PrimShards, intersect_fn(local, o, d, time, t_min,
    t_max)). Pass shard_args through shard_map with in_specs P(TILE_AXIS)."""
    from izpi_tpu.accel import bvh_build, traverse
    from izpi_tpu.geometry import primitives as prim
    from izpi_tpu.scene import compiler as compiler_mod

    n_dev = mesh.devices.size
    host = compiler_mod.host_prims_for(cs.prims)
    if host is None:
        host = prim.Prims(*jax.device_get(list(cs.prims)))
    host = prim.Prims(*[np.asarray(f) for f in host])
    p_total = host.count
    if use_bvh is None:
        use_bvh = p_total >= 1024
    per = -(-p_total // n_dev)

    prim_fields = [[] for _ in host]
    gmaps, node_b, node_c, node_n = [], [], [], []
    nn_max = 1
    for dv in range(n_dev):
        lo, hi = dv * per, min((dv + 1) * per, p_total)
        loc = prim.Prims(*[f[lo:hi] for f in host])
        gidx = np.arange(lo, hi, dtype=np.int32)
        if use_bvh and loc.count > 0:
            arrays = bvh_build.build_bvh4(loc, seed, method="sah")
            errors = bvh_build.validate(arrays, loc.count,
                                        stack_depth=traverse.STACK_DEPTH)
            if errors:
                raise AssertionError(
                    f"shard {dv} BVH4 validation failed: {errors[:3]}")
            order = np.asarray(arrays.prim_order)
            loc = prim.Prims(*[np.asarray(f)[order] for f in loc])
            gidx = gidx[order]
            b, c, n_ = (np.asarray(arrays.bounds),
                        np.asarray(arrays.child), np.asarray(arrays.count))
        else:
            # single always-miss node: brute mode never reads it
            b = np.zeros((1, 24), np.float32)
            c = np.zeros((1, 4), np.int32)
            n_ = np.full((1, 4), -1, np.int32)
        pad = per - loc.count
        if pad:
            fills = dict(kind=prim.KIND_NONE, mat_id=-1)
            loc = prim.Prims(*[
                np.pad(np.asarray(f), [(0, pad)] + [(0, 0)] * (f.ndim - 1),
                       constant_values=fills.get(name, 0))
                for name, f in zip(prim.Prims._fields, loc)])
            gidx = np.pad(gidx, (0, pad), constant_values=-1)
        for i, f in enumerate(loc):
            prim_fields[i].append(np.asarray(f))
        gmaps.append(gidx)
        node_b.append(b)
        node_c.append(c)
        node_n.append(n_)
        nn_max = max(nn_max, b.shape[0])

    def pad_nodes(arrs, fill):
        out = []
        for a in arrs:
            p = nn_max - a.shape[0]
            out.append(np.pad(a, [(0, p), (0, 0)], constant_values=fill))
        return np.concatenate(out)

    shard_args = PrimShards(
        prims=prim.Prims(*[jnp.asarray(np.concatenate(fs))
                           for fs in prim_fields]),
        gmap=jnp.asarray(np.concatenate(gmaps)),
        bounds=jnp.asarray(pad_nodes(node_b, 0.0)),
        child=jnp.asarray(pad_nodes(node_c, 0)),
        count=jnp.asarray(pad_nodes(node_n, -1)),
    )

    def intersect_local(local: PrimShards, o, d, time, t_min, t_max):
        # Rays arrive replicated; the local prims are device-varying, so
        # promote the rays too or the traversal loop carries mixed types.
        o, d, time = jax.lax.pvary((o, d, time), (TILE_AXIS,))
        if use_bvh:
            bvh = traverse.BVH4Device(local.bounds, local.child, local.count)
            rec = traverse.intersect_bvh(local.prims, bvh, o, d, time,
                                         t_min, t_max)
        else:
            rec = prim.intersect_brute(local.prims, o, d, time, t_min, t_max)
        me = jax.lax.axis_index(TILE_AXIS)
        big = jnp.float32(prim.T_MAX)
        key = jnp.where(rec.hit, rec.t, big)
        t_global = jax.lax.pmin(key, TILE_AXIS)
        tied = rec.hit & (key == t_global)
        rank = jax.lax.pmin(
            jnp.where(tied, me, jnp.int32(1 << 30)), TILE_AXIS)
        win = tied & (me == rank)

        def red(x, fill=0.0):
            masked = jnp.where(
                win if x.ndim == 1 else win[:, None],
                x, jnp.asarray(fill, x.dtype))
            return jax.lax.psum(masked, TILE_AXIS)

        any_hit = jax.lax.pmax(rec.hit.astype(jnp.int32), TILE_AXIS) > 0
        # Local → ORIGINAL global primitive index via the shard's map
        # (mat ids are already global); PBR's post-intersect gathers index
        # the replicated kind/tb tables with it.
        gidx = local.gmap[jnp.maximum(rec.prim_idx, 0)]
        return prim.Hit(
            t=red(rec.t), u=red(rec.u), v=red(rec.v), p=red(rec.p),
            normal=red(rec.normal),
            prim_idx=jnp.where(any_hit, red(gidx), -1),
            mat_id=jnp.where(any_hit, red(rec.mat_id), -1),
            hit=any_hit,
        )

    return shard_args, intersect_local


def scaling_efficiency(scene: st.Scene, nx: int, ny: int, spp: int,
                       device_counts=None, seed: int = 0,
                       settings: Optional[path_mod.RenderSettings] = None,
                       mode: str = "strong"):
    """Rays/s at 1..N devices with the production (pool) renderer — the
    BASELINE scaling harness (target ≥0.9 efficiency 1→N). Returns
    {n_devices: {"mrays": .., "efficiency": ..}}.

    mode="strong": a FIXED frame (nx·ny·spp) is divided across devices —
    per-device work shrinks with N, so fixed per-render costs erode
    efficiency (the production single-frame latency question).
    mode="weak": spp GROWS with the device count (spp per device fixed) —
    the sample-throughput question (renders are sample-parallel, so weak
    scaling is the honest capacity number for N chips; the reference's
    remote workers likewise each carry a full tile stream,
    render/remote.go:31-44).

    On a CPU-emulated mesh the absolute numbers are meaningless but the
    collective structure and work division are the real ones."""
    if device_counts is None:
        n = len(jax.devices())
        device_counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= n]
    out = {}
    base = None
    context = renderer_mod.RenderContext(scene)
    for c in device_counts:
        mesh = make_mesh(c)
        spp_c = spp * c if mode == "weak" else spp
        res = render_distributed(scene, nx, ny, spp_c, mesh=mesh, seed=seed,
                                 settings=settings, context=context,
                                 warmup=True)
        m = res.mrays_per_sec
        if base is None:
            base = m
        out[c] = {"mrays": round(m, 3),
                  "efficiency": round(m / (base * c), 4)}
    return out


# ---------------------------------------------------------------------------
# Differentiable render step (the "training step" of this framework): render
# sharded pixels, compare to a target, all-reduce parameter gradients.
# ---------------------------------------------------------------------------


def extract_params(cs):
    """The differentiable parameter pytree: material/texture/light knobs
    (BASELINE: 'differentiable w.r.t. material/texture/light parameters')."""
    return {
        "tex_c0": cs.textures.c0,
        "tex_c1": cs.textures.c1,
        "tex_images": cs.textures.images,
        "mat_absorption": cs.materials.absorption,
        "mat_fuzz": cs.materials.fuzz,
        "spd_table": cs.spd_table,
    }


def inject_params(cs, params):
    textures = cs.textures._replace(
        c0=params["tex_c0"], c1=params["tex_c1"], images=params["tex_images"]
    )
    materials = cs.materials._replace(
        absorption=params["mat_absorption"], fuzz=params["mat_fuzz"]
    )
    return cs._replace(
        textures=textures, materials=materials, spd_table=params["spd_table"]
    )


def build_train_step(cs, meta, settings, intersect, nx, ny, mesh: Mesh,
                     spp: int = 1):
    """Returns jitted fn(params, xs, ys, target, key) -> (loss, grads).

    Pixels sharded over 'tiles'; loss is the global mean squared error; grads
    are identical (all-reduced) on every device — the gradient
    all-reduce that replaces nothing in izpi (it has no differentiable path)
    but fulfils the BASELINE contract.
    """

    def local_loss(params, xs, ys, target, key):
        cs_p = inject_params(cs, params)

        def body(s, acc):
            color, _ = renderer_mod.sample_pass(
                cs_p, meta, settings, intersect, nx, ny, xs, ys, key, s,
                differentiable=True,
            )
            return acc + color

        acc0 = jnp.zeros((xs.shape[0], 3), jnp.float32) + (
            xs * 0
        ).astype(jnp.float32)[:, None]
        acc = jax.lax.fori_loop(0, spp, body, acc0)
        color = acc / spp
        # Global mean: sum locally, psum, divide by global count.
        se = jnp.sum((color - target) ** 2)
        n_total = jax.lax.psum(jnp.float32(xs.shape[0] * 3), TILE_AXIS)
        return jax.lax.psum(se, TILE_AXIS) / n_total

    def shard_body(params, xs, ys, target, key):
        loss, grads = jax.value_and_grad(local_loss)(params, xs, ys, target, key)
        # value_and_grad of a psum'd loss already yields summed gradients;
        # psum again is NOT needed — grads of replicated params under
        # shard_map are averaged via the psum inside the loss.
        return loss, grads

    @jax.jit
    def step(params, xs, ys, target, key):
        fn = shard_map(
            shard_body, mesh=mesh,
            in_specs=(P(), P(TILE_AXIS), P(TILE_AXIS), P(TILE_AXIS), P()),
            out_specs=(P(), P()),
        )
        return fn(params, xs, ys, target, key)

    return step
