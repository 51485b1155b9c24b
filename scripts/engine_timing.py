"""Time the render engines at the bench frames on a GPU.

The measurements behind the engine and launch choices in PERF.md:

    python scripts/engine_timing.py engines [SCENE ...]
        megakernel vs the XLA pool (mode="mega" vs "pool") through
        renderer.render at each bench scene's frame (bench.CONFIGS);
    python scripts/engine_timing.py launch SCENE BLOCK/WARPS/MIN_SLOTS ...
        the scene's megakernel at its bench frame for each launch geometry,
        in the order given (repeat one to see the drift within a call);
    python scripts/engine_timing.py traversal
        the dragon's BVH traversal with the chunked loop vs a plain
        lax.while_loop, per 64k camera rays and per bench frame;
    python scripts/engine_timing.py unroll P [P ...] [--clustered]
        compile and kernel time of the RGB megakernel on random_scene cut to
        P prims, 256x256@128, optionally with the cluster-skipping scan.

Every line is prefixed with the card's name and power limit. Kernel times
are the median of --repeat calls after a first (compiling) call.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

import bench  # noqa: E402
from izpi_tpu.core import rng  # noqa: E402
from izpi_tpu.integrator import path as path_mod  # noqa: E402
from izpi_tpu.ops import megakernel, megakernel_spectral  # noqa: E402
from izpi_tpu.render import renderer  # noqa: E402
from izpi_tpu.scene.library import get_scene  # noqa: E402

CONFIGS = {c[0]: c for c in bench.CONFIGS}
CARD = ""


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def log(msg: str):
    print(f"[{CARD}] {msg}", flush=True)


def timed(fn, repeat: int):
    """(first call s, median of `repeat` later calls s, last output)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    ts = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return first, statistics.median(ts), out


def scene_ctx(name):
    _, scene_name, nx, ny, spp, depth, sampler, bg = CONFIGS[name]
    ctx = renderer.RenderContext(get_scene(scene_name, aspect=nx / ny))
    settings = path_mod.RenderSettings(max_depth=depth, background=tuple(bg))
    return ctx, settings, nx, ny, spp, sampler


def engines(args):
    for name in args.scenes or ["cornell", "spectral_pyramid"]:
        ctx, settings, nx, ny, spp, sampler = scene_ctx(name)
        for mode in ("mega", "pool"):
            kw = dict(settings=settings, seed=0, context=ctx, mode=mode,
                      sampler_type=sampler)
            t0 = time.perf_counter()
            renderer.render(None, nx, ny, spp, **kw)
            first = time.perf_counter() - t0
            secs = [renderer.render(None, nx, ny, spp, **kw)
                    for _ in range(args.repeat)]
            med = statistics.median(r.seconds for r in secs)
            log(f"{name} {mode} {nx}x{ny}@{spp}: first call {first:.2f} s, "
                f"render {med * 1e3:.2f} ms, "
                f"{secs[0].rays_traced / med / 1e6:.2f} Mrays/s")


def launch(args):
    ctx, settings, nx, ny, spp, sampler = scene_ctx(args.scene)
    mod = megakernel_spectral if sampler == "spectral" else megakernel
    saved = (mod.BLOCK, mod.NUM_WARPS, mod.MIN_SLOTS)
    try:
        for geom in args.geometry:
            block, warps, min_slots = (int(x) for x in geom.split("/"))
            mod.BLOCK, mod.NUM_WARPS, mod.MIN_SLOTS = block, warps, min_slots
            lp = megakernel.plan_launch(nx * ny, spp, block, warps, min_slots)
            fn = jax.jit(mod.build_renderer(ctx.cs, ctx.meta, settings,
                                            nx, ny, spp))
            first, med, out = timed(lambda: fn(rng.render_key(0), 0),
                                    args.repeat)
            log(f"{args.scene} {nx}x{ny}@{spp} block {block} warps {warps} "
                f"min_slots {min_slots} (repl {lp.repl}, "
                f"{spp // lp.repl} samples per slot): first call "
                f"{first:.2f} s, kernel {med * 1e3:.2f} ms, "
                f"{int(out[1]) / med / 1e6:.1f} Mrays/s")
    finally:
        mod.BLOCK, mod.NUM_WARPS, mod.MIN_SLOTS = saved


def traversal(args):
    import jax.numpy as jnp
    import numpy as np

    from izpi_tpu import camera as camera_mod
    from izpi_tpu.accel import traverse
    from izpi_tpu.geometry import primitives as prim

    ctx, settings, nx, ny, spp, sampler = scene_ctx("dragon")
    n = 1 << 16
    rs = np.random.RandomState(0)
    rays = camera_mod.get_rays(
        ctx.cs.camera, jnp.asarray(rs.rand(n), jnp.float32),
        jnp.asarray(rs.rand(n), jnp.float32),
        jnp.asarray(rs.rand(n, 3), jnp.float32))
    for chunk in (traverse.LOOP_CHUNK, 1):
        traverse.LOOP_CHUNK = chunk
        ctx._runners.clear()
        trav = jax.jit(
            lambda o, d, tm: ctx.intersect(o, d, tm, 1e-3, prim.T_MAX))
        first, med, _ = timed(lambda: trav(*rays), args.repeat)
        kw = dict(settings=settings, seed=0, context=ctx, mode="pool")
        renderer.render(None, nx, ny, spp, **kw)
        frame = statistics.median(
            renderer.render(None, nx, ny, spp, **kw).seconds
            for _ in range(args.repeat))
        log(f"dragon traversal, loop chunk {chunk}: {n} camera rays "
            f"{med * 1e3:.2f} ms; frame {nx}x{ny}@{spp} {frame:.3f} s")


def unroll(args):
    saved = megakernel.CLUSTER_MIN_PRIMS
    if args.clustered:
        megakernel.CLUSTER_MIN_PRIMS = 0
    try:
        for p in args.prims:
            scene = get_scene("random_scene", aspect=1.0)
            scene.world = scene.world[:p - 3] + scene.world[-3:]
            ctx = renderer.RenderContext(scene)
            settings = path_mod.RenderSettings(max_depth=50,
                                               background=(0.7, 0.8, 1.0))
            fn = jax.jit(megakernel.build_renderer(ctx.cs, ctx.meta,
                                                   settings, 256, 256, 128))
            t0 = time.perf_counter()
            compiled = fn.lower(rng.render_key(0), 0).compile()
            t_compile = time.perf_counter() - t0
            _, med, out = timed(lambda: compiled(rng.render_key(0), 0),
                                args.repeat)
            log(f"unroll {ctx.meta.n_prims} prims"
                f"{' clustered' if args.clustered else ''}: compile "
                f"{t_compile:.1f} s, 256x256@128 kernel {med * 1e3:.1f} ms, "
                f"{int(out[1]) / med / 1e6:.1f} Mrays/s")
    finally:
        megakernel.CLUSTER_MIN_PRIMS = saved


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeat", type=int, default=3)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("engines")
    p.add_argument("scenes", nargs="*")
    p.set_defaults(fn=engines)
    p = sub.add_parser("launch")
    p.add_argument("scene", choices=["cornell", "spectral_pyramid"])
    p.add_argument("geometry", nargs="+", help="BLOCK/WARPS/MIN_SLOTS")
    p.set_defaults(fn=launch)
    p = sub.add_parser("traversal")
    p.set_defaults(fn=traversal)
    p = sub.add_parser("unroll")
    p.add_argument("prims", nargs="+", type=int)
    p.add_argument("--clustered", action="store_true")
    p.set_defaults(fn=unroll)
    args = ap.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        sys.exit("engine_timing: needs a GPU")
    global CARD
    CARD = card()
    args.fn(args)


if __name__ == "__main__":
    main()
