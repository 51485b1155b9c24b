"""Generate golden regression images (tests/data/goldens/*.npz).

Renders each config with the persistent-pool estimator (stream-identical to
the lockstep oracle) at high spp and stores the converged mean canvas plus
the per-pixel sample variance, so tests can assert new renders fall within
Monte-Carlo noise bounds of the committed golden (SURVEY §4: golden-image
allclose tests — the reference has none; Go-parity regeneration procedure is
documented in the module docstring of tests/test_golden.py).

Run on any backend (a GPU is much faster): python scripts/make_goldens.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "..", "tests", "data",
                          "goldens")

# name, scene, nx, ny, spp, depth, sampler, background
CONFIGS = [
    ("cornell", "cornell_box", 32, 32, 2048, 16, "colour", (0, 0, 0)),
    ("shirley", "random_scene", 32, 32, 1024, 12, "colour",
     (0.7, 0.8, 1.0)),
    ("dragon_lite", None, 32, 32, 1024, 8, "colour", (0, 0, 0)),
    ("pbr_ibl", "pbr_ibl", 32, 32, 1024, 8, "colour", (0, 0, 0)),
    ("spectral_pyramid", "cornell_box_pyramid_spectral",
     32, 32, 2048, 16, "spectral", (0, 0, 0)),
]


def dragon_lite_scene(aspect: float = 1.0, n_tris: int = 20000):
    """Dragon-class code paths (big triangle mesh + BVH) at test scale."""
    from izpi_tpu.scene.library.extracted import (
        cornell_box_pbr_stanford_dragon_spectral)

    return cornell_box_pbr_stanford_dragon_spectral(aspect, n_tris=n_tris)


def render_config(name, scene_name, nx, ny, spp, depth, sampler,
                  background=(0, 0, 0), seed=12345):
    from izpi_tpu.integrator import path as path_mod
    from izpi_tpu.render import renderer
    from izpi_tpu.scene.library import get_scene

    scene = (dragon_lite_scene(nx / ny) if scene_name is None
             else get_scene(scene_name, aspect=nx / ny))
    settings = path_mod.RenderSettings(max_depth=depth,
                                       background=tuple(background))
    ctx = renderer.RenderContext(scene)
    # Two independent half-renders give a cheap variance estimate of the
    # per-pixel mean at this spp.
    res_a = renderer.render(None, nx, ny, spp // 2, settings=settings,
                            seed=seed, context=ctx, sampler_type=sampler,
                            mode="wavefront")
    res_b = renderer.render(None, nx, ny, spp // 2, settings=settings,
                            seed=seed + 1, context=ctx, sampler_type=sampler,
                            mode="wavefront")
    img_a = res_a.xyz if res_a.xyz is not None else res_a.image
    img_b = res_b.xyz if res_b.xyz is not None else res_b.image
    mean = (img_a + img_b) / 2.0
    half_sigma = np.abs(img_a - img_b) / 2.0  # ~σ of a half-spp render
    return mean.astype(np.float32), half_sigma.astype(np.float32)


def main():
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    only = set(sys.argv[1:])
    for name, scene_name, nx, ny, spp, depth, sampler, bg in CONFIGS:
        if only and name not in only:
            continue
        print(f"rendering golden {name} ({nx}x{ny}@{spp}spp)...", flush=True)
        mean, half_sigma = render_config(name, scene_name, nx, ny, spp,
                                         depth, sampler, background=bg)
        path = os.path.join(GOLDEN_DIR, f"{name}.npz")
        np.savez_compressed(
            path, mean=mean, half_sigma=half_sigma, spp=spp, depth=depth,
            nx=nx, ny=ny, sampler=sampler, background=np.asarray(bg),
            scene=scene_name or "dragon_lite")
        print(f"  wrote {path}: mean lum {mean.mean():.4f}", flush=True)


if __name__ == "__main__":
    main()
