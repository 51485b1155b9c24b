"""Smoke test of the render path on an NVIDIA GPU.

Drives the renderer through the entry points a user calls
(`renderer.render`, the CLI, `dist.build_train_step`,
`dist.render_distributed`) and checks what comes out against the repo's
plain references, on the card.

    python chip_smoke.py               # phases a-d on one GPU
    python chip_smoke.py --four-cards  # render_distributed over 4 GPUs vs 1

Phases (one card):
  a. the five bench scenes (bench.CONFIGS) at their frame sizes and depths
     through renderer.render, spp reduced where SPP_REDUCED says; the
     dragon with its full 871k-triangle mesh;
  b. the CLI in-process on cornell, writing a PNG, checked against the
     Cornell facts (green wall left, red wall right, light patch at 15);
  c. each engine against the plain reference on the card (the megakernels
     at their bench frames, spp cut so that slots still refill), the
     spectral engines against the independent float64 spectral model, and
     the BVH traversal against brute force on 64k dragon camera and bounce
     rays;
  d. one step of dist.build_train_step on cornell.

Exits non-zero, and prints no result line, when JAX finds no GPU or any
phase fails. The last line of a passing run is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "build", "chip_smoke")

# Phase a: spp rendered where it is below the bench's. Phase c compares the
# pool scenes with the lockstep oracle at this frame, and the oracle's
# lockstep batch costs about a second per 65k paths on an H100.
SPP_REDUCED = {"shirley": 4, "dragon": 2, "pbr_ibl": 4}

# Phase c spp for the megakernel scenes, at their bench frames: cut only so
# far that each slot still walks several samples (the in-kernel refill) at
# the launch geometry the bench frame gets.
MEGA_CMP_SPP = {"cornell": 16, "spectral_pyramid": 8}

# Phase c: an engine shares the reference's sample streams, so all but the
# pixels where a last-bit difference flips a path must agree to 1e-3. Such
# flips touch about 1% of the pixels (cornell megakernel vs the oracle,
# whose sphere test is formulated differently: 0.8% at 16x16@4 in
# interpret mode); a biased or lower-precision engine moves nearly all.
CMP_TOL = 1e-3
CMP_MIN_SHARE = 0.95

# Phase c: pixels of the independent float64 spectral model
# (tests/test_exact_path_spectral.py) per scene, at spp 1.
MODEL_NX = MODEL_NY = 16


def card_name() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def luminance(img):
    return float(np.mean(0.2126 * img[..., 0] + 0.7152 * img[..., 1]
                         + 0.0722 * img[..., 2]))


def rmse(a, b):
    return float(np.sqrt(np.mean((a.astype(np.float64) - b) ** 2)))


def close_share(a, b):
    """Share of pixels whose three channels agree to CMP_TOL."""
    return float(np.isclose(a, b, rtol=CMP_TOL, atol=CMP_TOL)
                 .all(-1).mean())


class Smoke:
    def __init__(self, card: str):
        import jax

        self.card = card
        self.jax = jax
        self.contexts = {}
        self.images = {}

    def log(self, msg: str):
        print(f"[{self.card}] {msg}", flush=True)

    def scene_config(self, name):
        import bench

        for cfg in bench.CONFIGS:
            if cfg[0] == name:
                return cfg
        raise KeyError(name)

    def context(self, name):
        """One RenderContext per bench scene, built once (set-up time)."""
        from izpi_tpu.accel import native
        from izpi_tpu.render import renderer
        from izpi_tpu.scene.library import get_scene

        if name not in self.contexts:
            _, scene_name, nx, ny, *_ = self.scene_config(name)
            t0 = time.perf_counter()
            ctx = renderer.RenderContext(get_scene(scene_name,
                                                   aspect=nx / ny))
            self.log(f"{name}: scene build {time.perf_counter() - t0:.2f} s,"
                     f" {ctx.meta.n_prims} prims, intersector "
                     f"{ctx.intersector}"
                     + (f", BVH builder "
                        f"{'native' if native.available() else 'numpy'}"
                        if ctx.intersector == "bvh" else ""))
            self.contexts[name] = ctx
        return self.contexts[name]

    def settings(self, name):
        from izpi_tpu.integrator import path as path_mod

        _, _, _, _, _, depth, _, bg = self.scene_config(name)
        return path_mod.RenderSettings(max_depth=depth, background=tuple(bg))

    # --- a. bench scenes -------------------------------------------------
    def phase_a(self):
        import bench
        from izpi_tpu.render import renderer

        for name, _, nx, ny, spp, depth, sampler, _ in bench.CONFIGS:
            ctx = self.context(name)
            run_spp = SPP_REDUCED.get(name, spp)
            if run_spp != spp:
                self.log(f"{name}: reduced spp {spp} -> {run_spp}")
            eng = renderer.engine(ctx, "wavefront", sampler == "spectral")
            kw = dict(settings=self.settings(name), seed=0, context=ctx,
                      sampler_type=sampler)
            t0 = time.perf_counter()
            first = renderer.render(None, nx, ny, run_spp, **kw)
            t_first = time.perf_counter() - t0
            res = renderer.render(None, nx, ny, run_spp, **kw)
            img = res.image
            assert img.shape == (ny, nx, 3), img.shape
            assert np.isfinite(img).all(), f"{name}: non-finite pixels"
            assert res.rays_traced == first.rays_traced > nx * ny * run_spp
            assert luminance(img) > 0.0, f"{name}: black frame"
            self.images[name] = img
            self.log(f"{name}: engine {eng}/{ctx.intersector} "
                     f"{nx}x{ny}@{run_spp} depth {depth}: first call "
                     f"{t_first:.2f} s (compile ~{t_first - res.seconds:.2f}"
                     f" s), render {res.seconds:.3f} s, "
                     f"{res.mrays_per_sec:.2f} Mrays/s, "
                     f"{res.rays_traced} rays, mean lum {luminance(img):.4f}")
        # The ceiling light reads its emission, 15, wherever a pixel sees
        # only the light: a patch of ~0.5% of this frame, near the top
        # middle.
        m = self.images["cornell"].max(axis=-1)
        rows, cols = np.nonzero(np.abs(m - 15.0) < 0.15)
        assert rows.size > 0.002 * m.size, rows.size
        self.log(f"cornell: light patch {rows.size} pixels at 15 +- 1%, "
                 f"rows {rows.min()}-{rows.max()}, "
                 f"cols {cols.min()}-{cols.max()}")
        assert rows.max() < m.shape[0] // 4, "light patch not at the top"
        assert abs(cols.mean() - m.shape[1] / 2) < m.shape[1] / 8

    # --- b. CLI ----------------------------------------------------------
    def phase_b(self):
        from izpi_tpu import cli
        from izpi_tpu.io import output

        os.makedirs(OUT_DIR, exist_ok=True)
        out = os.path.join(OUT_DIR, "cornell_cli.png")
        t0 = time.perf_counter()
        rc = cli.main(["--scene", "cornell_box", "-x", "256", "-y", "256",
                       "--samples", "64", "--sampler", "colour",
                       "--max-depth", "50", "--output-file", out])
        assert rc == 0, rc
        img = output.read_image(out)
        assert img.shape == (256, 256, 3), img.shape
        mid = img[96:160]
        left, right = mid[:, 8:32].mean((0, 1)), mid[:, -32:-8].mean((0, 1))
        self.log(f"cli: {time.perf_counter() - t0:.2f} s incl. compile, "
                 f"left wall rgb {np.round(left, 3)}, right wall rgb "
                 f"{np.round(right, 3)}")
        assert left[1] > 1.5 * left[0], "green wall is not on the left"
        assert right[0] > 1.5 * right[1], "red wall is not on the right"

    # --- c. engines vs the plain reference -------------------------------
    def phase_c(self):
        """Same-seed streams are Threefry-identical across engines, but an
        exact match cannot be required on the card: libdevice and XLA's own
        math differ in the last bits, a last-bit difference can flip a
        reflect/refract choice, and the pool's scatter-add deposit order is
        not deterministic. So an engine passes when its image is closer to
        the reference on the same seed than seeds of the reference are to
        each other (the median over three seeds' pairs), in RMSE and in
        mean luminance, and when at least CMP_MIN_SHARE of its pixels agree
        with the same-seed reference to CMP_TOL. The spectral engines are
        also held to the independent float64 spectral model. The scenes run
        in threads so that their compiles overlap."""
        import bench

        tasks = [lambda n=cfg[0]: self.compare(n) for cfg in bench.CONFIGS]
        run_threads(tasks + [self.traversal_vs_brute,
                             lambda: self.spectral_vs_model(False),
                             lambda: self.spectral_vs_model(True)])

    def compare(self, name):
        from izpi_tpu.ops import megakernel, megakernel_spectral
        from izpi_tpu.render import renderer

        _, _, nx, ny, spp, _, sampler, _ = self.scene_config(name)
        ctx = self.context(name)
        spectral = sampler == "spectral"
        mode = renderer.engine(ctx, "wavefront", spectral)
        # The lockstep oracle is RGB only; the spectral reference is the
        # XLA spectral pool. Pool scenes compare at their phase-a frame,
        # whose compiled pool (and seed-0 image) phase a left behind; the
        # megakernel scenes at their bench frame with spp cut.
        ref_mode = "pool" if spectral else "simple"
        launch = ""
        if mode == "mega":
            spp = MEGA_CMP_SPP[name]
            mk = megakernel_spectral if spectral else megakernel
            lp = megakernel.plan_launch(nx * ny, spp, mk.BLOCK, mk.NUM_WARPS,
                                        mk.MIN_SLOTS)
            launch = (f" (block {lp.block}, {lp.repl} slots per pixel, "
                      f"{spp // lp.repl} samples per slot)")
            assert spp // lp.repl > 1, f"{name}: slots never refill"
        else:
            spp = SPP_REDUCED.get(name, spp)
        kw = dict(settings=self.settings(name), context=ctx,
                  sampler_type=sampler)

        def img(m, seed):
            return renderer.render(None, nx, ny, spp, mode=m, seed=seed,
                                   **kw).image

        got = img(mode, 0) if mode == "mega" else self.images[name]
        refs = [img(ref_mode, seed) for seed in (0, 1, 2)]
        pairs = [(0, 1), (0, 2), (1, 2)]
        e_rmse = rmse(got, refs[0])
        s_rmse = float(np.median([rmse(refs[i], refs[j]) for i, j in pairs]))
        e_lum = abs(luminance(got) - luminance(refs[0]))
        s_lum = float(np.median([abs(luminance(refs[i]) - luminance(refs[j]))
                                 for i, j in pairs]))
        e_share = close_share(got, refs[0])
        s_share = close_share(refs[1], refs[0])
        self.log(f"{name}: {mode}/{ctx.intersector} vs {ref_mode} "
                 f"{nx}x{ny}@{spp}{launch}: rmse {e_rmse:.3e} (seeds "
                 f"{s_rmse:.3e}, ratio {e_rmse / s_rmse:.1e}), |d lum| "
                 f"{e_lum:.3e} (seeds {s_lum:.3e}), pixels within "
                 f"{CMP_TOL:g}: {e_share:.6f} (seeds {s_share:.6f}, "
                 f"need {CMP_MIN_SHARE})")
        assert np.isfinite(got).all()
        assert e_rmse < s_rmse and e_lum < s_lum, (name, mode)
        assert e_share >= CMP_MIN_SHARE, (name, mode, e_share)

    def spectral_vs_model(self, with_sphere: bool):
        """Both spectral engines, compiled for the card, against the
        independent float64 spectral estimator of
        tests/test_exact_path_spectral.py, pixel by pixel at spp 1, on one
        of its two scenes (with or without the dispersive glass sphere)."""
        import importlib.util

        import jax.numpy as jnp

        from izpi_tpu.core import rng
        from izpi_tpu.integrator import path as path_mod
        from izpi_tpu.ops import megakernel_spectral
        from izpi_tpu.render import renderer

        spec = importlib.util.spec_from_file_location(
            "spectral_model",
            os.path.join(HERE, "tests", "test_exact_path_spectral.py"))
        model = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(model)
        model.NX, model.NY = MODEL_NX, MODEL_NY
        nx, ny = MODEL_NX, MODEL_NY
        key = rng.render_key(model.SEED)
        settings = path_mod.RenderSettings(max_depth=model.DEPTH)
        ctx = renderer.RenderContext(model._scene(with_sphere),
                                     use_bvh=False)
        t0 = time.perf_counter()
        want = model._expected_acc(key, with_sphere)
        t_model = time.perf_counter() - t0
        got = {"pool": ctx.pool_runner(
            nx, ny, True, ctx.meta.spectral_background_spd, settings)(
                key, 1, nx * ny, 0)[0]}
        if megakernel_spectral.eligible(ctx.cs, ctx.meta):
            got["mega"] = self.jax.jit(megakernel_spectral.build_renderer(
                ctx.cs, ctx.meta, settings, nx, ny, 1))(key, 0)[0]
        else:
            assert not with_sphere, "sphere scene not megakernel-eligible"
        for eng, acc in got.items():
            acc = np.asarray(jnp.asarray(acc))
            err = float(np.abs(acc - want).max())
            self.log(f"spectral model scene (sphere={with_sphere}): {eng} "
                     f"vs float64 model ({t_model:.1f} s), {nx * ny} pixels "
                     f"at spp 1: max |d| {err:.2e}, mean XYZ "
                     f"{acc.mean():.4f} vs {want.mean():.4f}")
            model._check(acc, want, f"{eng} (sphere={with_sphere})")

    def traversal_vs_brute(self):
        import jax.numpy as jnp

        from izpi_tpu import camera as camera_mod
        from izpi_tpu.geometry import primitives as prim

        ctx = self.context("dragon")
        assert ctx.intersector == "bvh"
        cs, n = ctx.cs, 1 << 16
        rs = np.random.RandomState(0)
        o, d, tm = camera_mod.get_rays(
            cs.camera, jnp.asarray(rs.rand(n), jnp.float32),
            jnp.asarray(rs.rand(n), jnp.float32),
            jnp.asarray(rs.rand(n, 3), jnp.float32))
        trav = self.jax.jit(
            lambda o, d, tm: ctx.intersect(o, d, tm, 1e-3, prim.T_MAX))
        brute = self.jax.jit(lambda o, d, tm: prim.intersect_brute(
            cs.prims, o, d, tm, 1e-3, prim.T_MAX))
        cam = trav(o, d, tm)
        # Bounce rays: from every camera hit into the normal's hemisphere.
        w = rs.randn(n, 3).astype(np.float32)
        w /= np.linalg.norm(w, axis=-1, keepdims=True)
        nrm = np.asarray(cam.normal)
        w = np.where((w * nrm).sum(-1, keepdims=True) < 0, -w, w)
        bounce = (cam.p, jnp.asarray(w), tm)
        for label, rays in (("camera", (o, d, tm)), ("bounce", bounce)):
            t0 = time.perf_counter()
            got = self.jax.block_until_ready(trav(*rays))
            t_trav = time.perf_counter() - t0
            want = brute(*rays)
            h = np.asarray(want.hit)
            assert (np.asarray(got.hit) == h).all(), f"{label}: hit masks"
            gt, wt = np.asarray(got.t)[h], np.asarray(want.t)[h]
            rel = np.abs(gt - wt) / np.maximum(np.abs(wt), 1e-30)
            gi = np.asarray(got.prim_idx)[h]
            wi = np.asarray(want.prim_idx)[h]
            ties = int(((gi != wi) & (rel <= 1e-5)).sum())
            self.log(f"dragon: traversal vs brute, {n} {label} rays: "
                     f"{int(h.sum())} hits, max t rel err {rel.max():.2e}, "
                     f"{ties} ties with other prim ids, traversal "
                     f"{t_trav * 1e3:.1f} ms")
            assert rel.max() <= 1e-5, label
            assert ((gi == wi) | (rel <= 1e-5)).all(), label

    # --- d. train step ---------------------------------------------------
    def phase_d(self):
        import jax.numpy as jnp

        from izpi_tpu.core import rng
        from izpi_tpu.integrator import path as path_mod
        from izpi_tpu.parallel import dist
        from izpi_tpu.scene.compiler import compile_scene
        from izpi_tpu.scene.library.cornell import cornell_box

        nx = ny = 64
        cs, meta = compile_scene(cornell_box(aspect=1.0))
        step = dist.build_train_step(
            cs, meta, path_mod.RenderSettings(max_depth=4),
            path_mod.make_brute_intersector(cs), nx, ny,
            dist.make_mesh(1), spp=1)
        ys = jnp.repeat(jnp.arange(ny, dtype=jnp.int32), nx)
        xs = jnp.tile(jnp.arange(nx, dtype=jnp.int32), ny)
        target = jnp.zeros((nx * ny, 3), jnp.float32)
        t0 = time.perf_counter()
        loss, grads = step(dist.extract_params(cs), xs, ys, target,
                           rng.render_key(0))
        loss = float(loss)
        leaves = [np.asarray(g) for g in self.jax.tree_util.tree_leaves(grads)]
        self.log(f"train step {nx}x{ny}: loss {loss:.6f}, "
                 f"{sum(g.size for g in leaves)} grads, "
                 f"{time.perf_counter() - t0:.2f} s incl. compile")
        assert np.isfinite(loss) and loss > 0.0
        assert all(np.isfinite(g).all() for g in leaves)
        assert any(np.abs(g).max() > 0 for g in leaves)

    # --- four cards ------------------------------------------------------
    def phase_four_cards(self):
        """render_distributed over four local cards against a one-card
        render of the same samples. Sample sharding only regroups the
        per-sample sums; prim sharding picks the same closest hits from
        per-shard trees. Agreement is not exact on a GPU: the pool's
        scatter-add order is not deterministic, and the four-card and
        one-card programs are compiled apart, so one can round an operation
        differently and flip a rare path (one path in 1.4M on pbr_ibl on
        an H100). So at most 1e-4 of the rays and 1e-3 of the pixels may
        differ, and mean luminance by 1e-3 relative. The six programs
        compile ahead in threads, so that their compiles overlap; they then
        run one at a time, because programs with collectives that run at
        once on the same cards can deadlock."""
        from izpi_tpu.core import rng
        from izpi_tpu.parallel import dist

        assert len(self.jax.devices()) >= 4, "needs four GPUs"
        meshes = {4: dist.make_mesh(4), 1: dist.make_mesh(1)}
        cases = [("cornell", 64, False), ("pbr_ibl", 16, False),
                 ("dragon", 2, True)]
        runs = [(name, spp, shard_prims and n > 1, n)
                for name, spp, shard_prims in cases for n in (4, 1)]

        def kwargs(name, spp, shard_prims, n):
            _, _, nx, ny, _, _, sampler, _ = self.scene_config(name)
            return dict(nx=nx, ny=ny, spp=spp, mesh=meshes[n],
                        settings=self.settings(name), sampler_type=sampler,
                        shard_prims=shard_prims)

        def precompile(*r):
            run, _ = dist.build_distributed_runner(self.context(r[0]),
                                                   **kwargs(*r))
            run.lower(rng.render_key(0)).compile()

        for name, _, _ in cases:
            self.context(name)
        t0 = time.perf_counter()
        run_threads([lambda r=r: precompile(*r) for r in runs])
        self.log(f"four cards: compiled {len(runs)} programs in "
                 f"{time.perf_counter() - t0:.1f} s (in parallel)")
        results = {(r[0], r[3]): dist.render_distributed(
            None, seed=0, context=self.contexts[r[0]], warmup=True,
            **kwargs(*r)) for r in runs}
        failed = []
        for name, spp, shard_prims in cases:
            _, _, nx, ny, _, depth, _, _ = self.scene_config(name)
            four, one = results[name, 4], results[name, 1]
            a, b = four.image, one.image
            close = float(np.isclose(a, b, rtol=1e-3, atol=1e-3)
                          .all(-1).mean())
            d_lum = abs(luminance(a) - luminance(b)) / luminance(b)
            self.log(f"{name}: {'prim' if shard_prims else 'sample'}-"
                     f"sharded 4 cards vs 1, {nx}x{ny}@{spp} depth {depth}: "
                     f"{four.seconds:.3f} s vs {one.seconds:.3f} s "
                     f"({four.mrays_per_sec:.2f} vs {one.mrays_per_sec:.2f} "
                     f"Mrays/s), pixels within 1e-3: {close:.6f}, "
                     f"rel d lum {d_lum:.2e}, rays {four.rays_traced} vs "
                     f"{one.rays_traced}")
            d_rays = abs(four.rays_traced - one.rays_traced)
            if not (np.isfinite(a).all() and four.rays_traced > 0
                    and d_rays <= 1e-4 * one.rays_traced
                    and close >= 0.999 and d_lum < 1e-3):
                failed.append(name)
        assert not failed, f"four-card renders disagree: {failed}"


def run_threads(tasks):
    """Run callables in threads; re-raise the first failure after all end.
    XLA compiles outside the GIL, so independent compiles overlap."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(tasks)) as pool:
        futures = [pool.submit(t) for t in tasks]
    errors = [f.exception() for f in futures if f.exception() is not None]
    for exc in errors:
        traceback.print_exception(exc)
    if errors:
        raise errors[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only render_distributed over four local GPUs "
                         "against one-card renders")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found "
              f"{devices[0].platform} ({devices[0].device_kind})",
              file=sys.stderr)
        return 2
    card = card_name()
    print(card, flush=True)
    smoke = Smoke(card)
    phases = ([smoke.phase_four_cards] if args.four_cards else
              [smoke.phase_a, smoke.phase_b, smoke.phase_c, smoke.phase_d])
    failed = []
    t_start = time.perf_counter()
    for phase in phases:
        t0 = time.perf_counter()
        try:
            phase()
        except Exception:
            traceback.print_exc()
            failed.append(phase.__name__)
        smoke.log(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
    smoke.log(f"total {time.perf_counter() - t_start:.1f} s")
    if failed:
        print(f"chip_smoke: FAILED {', '.join(failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
