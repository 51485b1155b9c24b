"""Benchmark: the five BASELINE config scenes on the current device.

Prints the device (platform, kind, count) first, then one JSON line per
scene, then ONE aggregate line: the geometric mean of the five Mrays/s
numbers. Exits non-zero if any scene fails.

Engines exercised per config on a GPU:
  cornell          — RGB Pallas megakernel (ops.megakernel)
  spectral_pyramid — spectral Pallas megakernel (ops.megakernel_spectral)
  shirley          — wavefront pool + matrix-form brute force (485 prims,
                     above the megakernel's unroll budget)
  dragon           — wavefront pool + BVH4 traversal (accel.traverse)
  pbr_ibl          — wavefront pool (PBR + image textures)
"""

from __future__ import annotations

import json
import math
import sys

# (name, scene constructor name, nx, ny, spp, max_depth, sampler, background)
# spp values are production-scale (the reference default is 1000 spp) so
# that a render measures the renderer, not the per-launch fixed cost.
CONFIGS = [
    ("cornell", "cornell_box", 256, 256, 1024, 50, "colour", (0, 0, 0)),
    ("spectral_pyramid", "cornell_box_pyramid_spectral",
     500, 500, 256, 50, "spectral", (0, 0, 0)),
    # the Shirley scene has no emitters; the book's sky gradient is the
    # renderer background flag in izpi (black by default)
    ("shirley", "random_scene", 256, 256, 128, 50, "colour",
     (0.7, 0.8, 1.0)),
    ("dragon", "cornell_box_pbr_stanford_dragon_spectral",
     256, 256, 8, 16, "colour", (0, 0, 0)),
    # ~75% of pbr_ibl paths end on the dome after one bounce, so a small
    # frame traces few rays; production scale makes the number a measurement.
    ("pbr_ibl", "pbr_ibl", 256, 256, 256, 16, "colour", (0, 0, 0)),
]


def run_config(name, scene_name, nx, ny, spp, depth, sampler, background):
    from izpi_tpu.integrator import path as path_mod
    from izpi_tpu.render import renderer
    from izpi_tpu.scene.library import get_scene

    import os
    import statistics

    scene = get_scene(scene_name, aspect=nx / ny)
    settings = path_mod.RenderSettings(max_depth=depth,
                                       background=tuple(background))
    ctx = renderer.RenderContext(scene)
    kwargs = dict(settings=settings, seed=0, context=ctx,
                  sampler_type=sampler)
    renderer.render(None, nx, ny, spp, **kwargs)  # warmup/compile
    # IZPI_BENCH_REPEATS>1 reports the median of that many timed renders.
    reps = max(1, int(os.environ.get("IZPI_BENCH_REPEATS", "1")))
    vals = []
    for _ in range(reps):
        res = renderer.render(None, nx, ny, spp, **kwargs)
        vals.append(res.mrays_per_sec)
    # Surface procedural stand-ins IN the parsed record, not just stderr:
    # a BENCH line for a placeholder scene must say so itself.
    placeholder = bool(ctx.meta.placeholder_assets)
    engine = renderer.engine(ctx, "wavefront", sampler == "spectral")
    return statistics.median(vals), placeholder, engine


def main():
    import os
    import time

    import jax

    devices = jax.devices()
    print(json.dumps({"device": {"platform": devices[0].platform,
                                 "kind": devices[0].device_kind,
                                 "count": len(devices)}}), flush=True)
    only = sys.argv[1:] or None
    # Wall-clock budget: skip remaining configs (noting which) rather than
    # get killed mid-run without the aggregate line.
    budget = float(os.environ.get("IZPI_BENCH_BUDGET_SEC", "3000"))
    t_start = time.time()
    results = {}
    failed = []
    for name, scene_name, nx, ny, spp, depth, sampler, bg in CONFIGS:
        if only and name not in only:
            continue
        if time.time() - t_start > budget:
            print(json.dumps({"metric": f"{name}_mrays_per_sec",
                              "skipped": "bench budget exhausted"}),
                  flush=True)
            continue
        try:
            m, placeholder, engine = run_config(
                name, scene_name, nx, ny, spp, depth, sampler, bg)
        except Exception as exc:  # noqa: BLE001 — report, fail at the end
            print(json.dumps({"metric": f"{name}_mrays_per_sec",
                              "error": f"{type(exc).__name__}: {exc}"[:200]}),
                  flush=True)
            failed.append(name)
            continue
        results[name] = m
        rec = {
            "metric": f"{name}_mrays_per_sec",
            "value": round(m, 3),
            "unit": "Mrays/s",
            "engine": engine,
        }
        if placeholder:
            rec["placeholder"] = True
        print(json.dumps(rec), flush=True)

    if results:
        geo = math.exp(sum(math.log(max(v, 1e-9)) for v in results.values())
                       / len(results))
        print(json.dumps({
            "metric": f"baseline_{len(results)}_scene_geomean_mrays_per_sec",
            "value": round(geo, 3),
            "unit": "Mrays/s",
        }), flush=True)
    if failed:
        sys.exit(f"bench: {len(failed)} scene(s) failed: {', '.join(failed)}")


if __name__ == "__main__":
    main()
