"""Render driver: pixels → ray batches → accumulated image.

The analog of internal/render/renderer.go + rgb.go, redesigned for an
accelerator:
instead of goroutines pulling spiral-ordered tiles from a channel
(renderer.go:112-151), the whole image is one ray wavefront (optionally
chunked by rows to bound memory), and samples-per-pixel is a host loop of
jitted passes accumulating on device. Tiles reappear only as the sharding
axis in izpi_tpu.parallel.

Pixel convention matches render/rgb.go:30-40: film coords u=(x+ξ)/nx,
v=(y+ξ)/ny with v up; the canvas is row-flipped so image[0] is the top row.
Every per-sample color is DeNAN'd before accumulation (rgb.go:36).
"""

from __future__ import annotations

import dataclasses
import time as time_mod
from functools import partial
from typing import Optional, Tuple

from izpi_tpu.integrator import aov as aov_mod

import jax
import jax.numpy as jnp
import numpy as np

from izpi_tpu import camera as camera_mod
from izpi_tpu.core import rng
from izpi_tpu.core import vecmath as vm
from izpi_tpu.geometry import primitives as prim_mod
from izpi_tpu.integrator import path as path_mod
from izpi_tpu.scene import types as st
from izpi_tpu.scene.compiler import CompiledScene, SceneMeta, compile_scene

CAMERA_SALT = 0x5EED


@dataclasses.dataclass
class RenderResult:
    image: np.ndarray      # (ny, nx, 3) float32, linear (ACEScg if spectral)
    rays_traced: int
    seconds: float
    xyz: Optional[np.ndarray] = None  # raw CIE XYZ canvas (spectral renders)
    # Per-phase wall-clock (the analog of the reference's ad-hoc phase logs:
    # BVH build at bvh4.go:519-522, tessellation, texture streaming, and the
    # end-of-render summary at renderer.go:213).
    phases: Optional[dict] = None

    @property
    def mrays_per_sec(self) -> float:
        return self.rays_traced / max(self.seconds, 1e-9) / 1e6


def sample_pass(cs: CompiledScene, meta: SceneMeta,
                settings: path_mod.RenderSettings, intersect,
                nx: int, ny: int, xs, ys, base_key, sample_id,
                differentiable: bool = False):
    """One sample for a batch of pixels. xs, ys: (N,) int32 pixel coords.
    Returns (color (N,3) DeNAN'd, rays ())."""
    pixel_ids = ys * nx + xs
    keys = rng.path_keys(base_key, pixel_ids, sample_id)
    cam_u = rng.bounce_uniforms(keys, jnp.int32(0), 5, salt=CAMERA_SALT)
    s = (xs.astype(jnp.float32) + cam_u[:, 0]) / nx
    t = (ys.astype(jnp.float32) + cam_u[:, 1]) / ny
    o, d, tme = camera_mod.get_rays(cs.camera, s, t, cam_u[:, 2:5])
    color, nrays = path_mod.trace(cs, meta, settings, intersect, o, d, tme,
                                  keys, differentiable=differentiable)
    return vm.de_nan(color), nrays


def _render_aov(cs, meta, settings, intersect, nx, ny, spp, seed,
                sampler_type: str, ink) -> RenderResult:
    """First-hit AOV render (albedo/normal/wireframe samplers,
    internal/sampler/{albedo,normal,wireframe}.go): jittered camera rays,
    one intersection each, averaged over spp."""
    base_key = rng.render_key(seed)
    paper = settings.background

    @partial(jax.jit, static_argnames=("n_spp",))
    def run(key, n_spp):
        ys = jnp.repeat(jnp.arange(ny, dtype=jnp.int32), nx)
        xs = jnp.tile(jnp.arange(nx, dtype=jnp.int32), ny)
        pixel_ids = ys * nx + xs

        def body(s, acc):
            keys = rng.path_keys(key, pixel_ids, s)
            cam_u = rng.bounce_uniforms(keys, jnp.int32(0), 5,
                                        salt=CAMERA_SALT)
            u = (xs.astype(jnp.float32) + cam_u[:, 0]) / nx
            v = (ys.astype(jnp.float32) + cam_u[:, 1]) / ny
            o, d, tme = camera_mod.get_rays(cs.camera, u, v, cam_u[:, 2:5])
            if sampler_type == "albedo":
                c = aov_mod.sample_albedo(cs, meta, intersect, o, d, tme)
            elif sampler_type == "normal":
                c = aov_mod.sample_normal(cs, meta, intersect, o, d, tme)
            else:
                c = aov_mod.sample_wireframe(cs, meta, intersect, o, d, tme,
                                             ink, paper)
            return acc + vm.de_nan(c)

        acc = jax.lax.fori_loop(
            0, n_spp, body, jnp.zeros((nx * ny, 3), jnp.float32))
        return acc / n_spp

    t0 = time_mod.perf_counter()
    acc = np.asarray(run(base_key, spp))
    seconds = time_mod.perf_counter() - t0
    image = acc.reshape(ny, nx, 3)[::-1]
    return RenderResult(image=image, rays_traced=nx * ny * spp,
                        seconds=seconds)


# Above this primitive count the scene is traversed through a BVH4
# (accel.traverse); at or below it small scenes use the unrolled
# intersector and mid-size ones the matrix-form brute force. Set on the
# previous accelerator; untuned on this card.
BVH_THRESHOLD = 16384


def intersector_kind(n_prims: int, use_bvh: Optional[bool] = None) -> str:
    """Which intersector `prepare` builds: "bvh" (accel.traverse),
    "unrolled" (baked per-prim tests) or "brute" (matrix-form brute force)."""
    if use_bvh is None:
        use_bvh = n_prims > BVH_THRESHOLD
    if use_bvh:
        return "bvh"
    if n_prims <= prim_mod.UNROLL_MAX_PRIMS:
        return "unrolled"
    return "brute"


def prepare(scene: st.Scene, use_bvh: Optional[bool] = None, seed: int = 1):
    """Compile a scene and pick/build its intersector.
    Returns (cs, meta, intersect)."""
    cs, meta = compile_scene(scene)
    kind = intersector_kind(meta.n_prims, use_bvh)
    if kind == "bvh":
        from izpi_tpu.accel import traverse

        cs, intersect = traverse.attach(cs, seed=seed)
    elif kind == "unrolled":
        # Tiny scenes: python-unrolled per-prim tests with baked constants —
        # finalize_hit's gathers alone cost more than the whole scene's
        # t-tests at this size (geometry.primitives.make_unrolled_intersector).
        intersect = prim_mod.make_unrolled_intersector(cs.prims)
    else:
        # Brute force written as matrix products over the primitive tables
        # (geometry.mxu_intersect).
        from izpi_tpu.geometry import mxu_intersect

        tables = mxu_intersect.build_tables(cs.prims)
        intersect = mxu_intersect.make_intersector(cs.prims, tables)
    return cs, meta, intersect


class RenderContext:
    """Compiled scene + a cache of jitted runners.

    Re-running `render()` on a bare Scene re-traces and re-compiles the
    wavefront loop every call (the runner closure captures fresh device
    arrays). Callers that render the same scene repeatedly (benchmarks,
    progressive/preview loops, the CLI's checkpoint chunks) build one
    context and pass it to `render(context=...)` so the XLA executable is
    reused — the analog of the reference building its scene/BVH once per
    process (leader.go:111-115) rather than per tile."""

    def __init__(self, scene: st.Scene, use_bvh: Optional[bool] = None,
                 seed: int = 1):
        t0 = time_mod.perf_counter()
        self.cs, self.meta, self.intersect = prepare(scene, use_bvh=use_bvh,
                                                     seed=seed)
        self.intersector = intersector_kind(self.meta.n_prims, use_bvh)
        self.build_seconds = time_mod.perf_counter() - t0
        self._runners = {}

    def pool_runner(self, nx: int, ny: int, spectral: bool, bg_spd_id: int,
                    settings: path_mod.RenderSettings):
        cache_key = (nx, ny, spectral, bg_spd_id, settings)
        run = self._runners.get(cache_key)
        if run is None:
            import os

            from izpi_tpu.integrator import wavefront

            cs, meta, intersect = self.cs, self.meta, self.intersect
            # Env knobs resolve HERE, at runner-build time, and ride the
            # closure as explicit arguments: reading os.environ inside the
            # traced function meant a change after first compile silently
            # did nothing (advisor round 4).
            scheduler = os.environ.get("IZPI_POOL_SCHED", "") or "auto"
            loop = os.environ.get("IZPI_POOL_LOOP", "while")

            @partial(jax.jit, static_argnames=("n_spp", "pool"))
            def run(key, n_spp, pool, sample_offset):
                return wavefront.trace_pool(
                    cs, meta, settings, intersect, nx, ny, n_spp, key, pool,
                    spectral=spectral, bg_spd_id=bg_spd_id,
                    sample_offset=sample_offset, scheduler=scheduler,
                    loop=loop,
                )

            self._runners[cache_key] = run
        return run

    def mega_supported(self, spectral: bool = False) -> bool:
        if spectral:
            from izpi_tpu.ops import megakernel_spectral

            return megakernel_spectral.eligible(self.cs, self.meta)
        from izpi_tpu.ops import megakernel

        return megakernel.eligible(self.cs, self.meta)

    def mega_runner(self, nx: int, ny: int, n_spp: int,
                    settings: path_mod.RenderSettings,
                    interpret: bool = False,
                    spectral: bool = False):
        """Pallas megakernel runner (ops.megakernel / megakernel_spectral):
        whole pool loop in one Triton kernel, scene baked in as constants.
        interpret=True runs it in the Pallas interpreter (CPU tests).
        Returns fn(key, offset)."""
        cache_key = ("mega", nx, ny, n_spp, settings, interpret, spectral)
        run = self._runners.get(cache_key)
        if run is None:
            if spectral:
                from izpi_tpu.ops import megakernel_spectral as mk
            else:
                from izpi_tpu.ops import megakernel as mk

            run = jax.jit(mk.build_renderer(
                self.cs, self.meta, settings, nx, ny, n_spp,
                interpret=interpret))
            self._runners[cache_key] = run
        return run


def engine(context: RenderContext, mode: str = "wavefront",
           spectral: bool = False) -> str:
    """The engine `render` runs for this context and mode: "mega" (Pallas
    megakernel), "pool" (XLA wavefront pool) or "simple" (lockstep
    oracle). mode="wavefront" picks the megakernel on a GPU when the scene
    qualifies; there is no fallback if it then fails."""
    if mode == "mega":
        if not context.mega_supported(spectral=spectral):
            raise ValueError("scene not supported by the megakernel "
                             "(media/PBR/image/noise or too many primitives)")
        return "mega"
    if (mode == "wavefront" and jax.default_backend() == "gpu"
            and context.mega_supported(spectral=spectral)):
        return "mega"
    if mode in ("wavefront", "pool") or spectral:
        return "pool"
    return "simple"


def render(scene: Optional[st.Scene], nx: int, ny: int, spp: int,
           settings: Optional[path_mod.RenderSettings] = None,
           seed: int = 0, use_bvh: Optional[bool] = None,
           row_chunk: Optional[int] = None,
           mode: str = "wavefront",
           pool_size: Optional[int] = None,
           sampler_type: str = "colour",
           ink: Tuple[float, float, float] = (0.0, 0.0, 0.0),
           checkpoint_path: Optional[str] = None,
           checkpoint_interval: int = 0,
           preview_path: Optional[str] = None,
           context: Optional[RenderContext] = None,
           verbose: bool = False) -> RenderResult:
    """Render a scene on the current default device.

    mode: "wavefront" (persistent path pool; upgrades to the Pallas
    megakernel on a GPU when the scene qualifies), "mega" (megakernel,
    required), "pool" (XLA wavefront pool, megakernel upgrade disabled —
    for engine-policy measurement), or "simple" (lockstep batch per sample
    — the straightforward analog of path.trace, kept as the oracle and for
    row-chunked very large frames).
    sampler_type ∈ {colour, spectral, albedo, normal, wireframe}
    (sampler/sampler.go:13-28); spectral scenes auto-upgrade colour→spectral
    like the reference (leader.go:78-81).
    """
    settings = settings or path_mod.RenderSettings()
    if context is None:
        context = RenderContext(scene, use_bvh=use_bvh)
    cs, meta, intersect = context.cs, context.meta, context.intersect

    if meta.placeholder_assets and not getattr(context, "_warned_assets", False):
        import sys as _sys

        print("NOTE: this render substitutes procedural placeholders for "
              "missing assets:\n  " + "\n  ".join(meta.placeholder_assets),
              file=_sys.stderr)
        context._warned_assets = True

    if sampler_type in ("albedo", "normal", "wireframe"):
        return _render_aov(cs, meta, settings, intersect, nx, ny, spp, seed,
                           sampler_type, ink)

    spectral = meta.spectral or sampler_type == "spectral"
    eng = engine(context, mode, spectral)
    if eng != "simple":
        if pool_size is None:
            # Larger pools amortize per-iteration fixed costs; per-bounce
            # state is ~100 B/ray so even 1<<18 slots is ~25 MB. The cap was
            # set on the previous accelerator; untuned on this card.
            pool_size = min(nx * ny * spp, 1 << 18)
        base_key = rng.render_key(seed)
        bg_spd_id = meta.spectral_background_spd or 0
        if eng == "mega":
            def run(key, n_spp, pool, sample_offset):
                mega = context.mega_runner(nx, ny, n_spp, settings,
                                           spectral=spectral)
                return mega(key, sample_offset)
        else:
            run = context.pool_runner(nx, ny, spectral, bg_spd_id, settings)

        fingerprint = None
        if checkpoint_path:
            from izpi_tpu.render import checkpoint as ckpt_mod

            fingerprint = ckpt_mod.config_fingerprint(
                nx, ny, spp, seed, meta, settings)

        chunk_spp = checkpoint_interval if checkpoint_interval else spp
        if preview_path and chunk_spp == spp and spp > 1:
            # Progressive preview needs chunks (the analog of the live
            # SDL/Fyne tile stream, internal/display — headless here).
            chunk_spp = max(1, spp // 8)
        if verbose and chunk_spp == spp and spp >= 8:
            # Live progress during long renders (the reference's pb
            # progress bar, renderer.go:110-121): chunk so something
            # prints; per-chunk estimates are offset-exact by design
            # (checkpoint tests pin this).
            chunk_spp = max(1, spp // 8)
        # float64 host accumulator: chunked renders (verbose/preview/
        # checkpoint) would otherwise reorder float32 sums relative to a
        # single-pass run of identical parameters (advisor round 4); f64
        # absorbs the per-chunk rounding so chunking is sum-order invariant
        # to float32 resolution.
        acc_total = np.zeros((nx * ny, 3), np.float64)
        total_rays = 0
        start = 0
        if checkpoint_path:
            resumed = ckpt_mod.load(checkpoint_path, fingerprint)
            if resumed is not None:
                acc_total, start, total_rays = resumed
                acc_total = acc_total.astype(np.float64)
                if verbose:
                    print(f"resumed at sample {start}/{spp}")

        t0 = time_mod.perf_counter()
        first_chunk_seconds = None
        for off in range(start, spp, chunk_spp):
            n_chunk = min(chunk_spp, spp - off)
            tc = time_mod.perf_counter()
            acc, nrays = run(base_key, n_chunk, pool_size, jnp.int32(off))
            acc_total = acc_total + np.asarray(acc)
            if first_chunk_seconds is None:
                # First chunk includes trace+compile.
                first_chunk_seconds = time_mod.perf_counter() - tc
            total_rays += int(nrays)
            if checkpoint_path:
                ckpt_mod.save(checkpoint_path, acc_total, off + n_chunk,
                              total_rays, fingerprint)
            if preview_path:
                from izpi_tpu.io import output as output_mod

                snap = (acc_total / (off + n_chunk)).reshape(ny, nx, 3)[::-1]
                if spectral:
                    from izpi_tpu.spectral import convert as conv_mod

                    snap = conv_mod.xyz_to_acescg(
                        snap.astype(np.float64), meta.exposure)
                output_mod.write_png(preview_path, snap)
            if verbose:
                done = off + n_chunk - start
                elapsed = time_mod.perf_counter() - t0
                eta = elapsed / max(done, 1) * (spp - off - n_chunk)
                print(f"samples {off + n_chunk}/{spp} | "
                      f"{total_rays / 1e6:.1f}M rays | "
                      f"{total_rays / max(elapsed, 1e-9) / 1e6:.1f} Mrays/s"
                      f" | eta {eta:.0f}s", flush=True)
        acc = acc_total
        nrays = total_rays
        seconds = time_mod.perf_counter() - t0
        phases = {
            "scene_build": round(getattr(context, "build_seconds", 0.0), 4),
            "first_chunk_incl_compile": round(first_chunk_seconds or 0.0, 4),
            "render": round(seconds, 4),
        }
        canvas = (acc / spp).reshape(ny, nx, 3)[::-1].astype(np.float32)
        if spectral:
            # Post pipeline for spectral renders (leader.go:216-219):
            # firefly rejection on XYZ, then XYZ→ACEScg with exposure.
            from izpi_tpu.spectral import convert

            tp = time_mod.perf_counter()
            xyz = convert.firefly_rejection(canvas.astype(np.float64))
            image = convert.xyz_to_acescg(xyz, meta.exposure).astype(
                np.float32)
            phases["postprocess"] = round(time_mod.perf_counter() - tp, 4)
            if verbose:
                print(f"phases: {phases}")
            return RenderResult(image=image, rays_traced=int(nrays),
                                seconds=seconds, xyz=xyz.astype(np.float32),
                                phases=phases)
        if verbose:
            print(f"phases: {phases}")
        return RenderResult(image=canvas, rays_traced=int(nrays),
                            seconds=seconds, phases=phases)

    if row_chunk is None:
        row_chunk = max(1, min(ny, (1 << 20) // nx))

    base_key = rng.render_key(seed)

    # The whole spp loop runs on-device (one dispatch per row chunk): a
    # fori_loop over samples accumulating into the canvas block. This is the
    # device answer to the reference's per-pixel `for s in spp` (rgb.go:32-38).
    @partial(jax.jit, static_argnames=("n_rows", "n_spp"))
    def chunk_fn(y0, key, n_rows, n_spp):
        ys = y0 + jnp.repeat(jnp.arange(n_rows, dtype=jnp.int32), nx)
        xs = jnp.tile(jnp.arange(nx, dtype=jnp.int32), n_rows)

        def body(s, carry):
            acc, rays = carry
            color, nrays = sample_pass(
                cs, meta, settings, intersect, nx, ny, xs, ys, key, s
            )
            return acc + color, rays + nrays

        acc0 = jnp.zeros((n_rows * nx, 3), jnp.float32)
        acc, rays = jax.lax.fori_loop(0, n_spp, body, (acc0, jnp.int32(0)))
        return acc / n_spp, rays

    t0 = time_mod.perf_counter()
    image = np.zeros((ny, nx, 3), np.float32)
    total_rays = 0
    for y0 in range(0, ny, row_chunk):
        n_rows = min(row_chunk, ny - y0)
        acc, nrays = chunk_fn(jnp.int32(y0), base_key, n_rows=n_rows,
                              n_spp=spp)
        total_rays += int(nrays)
        block = np.asarray(acc).reshape(n_rows, nx, 3)
        # v-up → row flip (rgb.go:40: canvas.Set(x, ny-y)).
        image[ny - y0 - n_rows: ny - y0] = block[::-1]
        if verbose:
            print(f"rows {y0}..{y0 + n_rows} done")
    seconds = time_mod.perf_counter() - t0
    return RenderResult(image=image, rays_traced=total_rays, seconds=seconds)
