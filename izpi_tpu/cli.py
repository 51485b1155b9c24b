"""Command-line interface.

Mirrors the reference's flag surface (cmd/izpi/main.go:31-66, kong tags):
scene, x/y, samples, sampler, max-depth, output-mode, output-file, verbose,
role, cpu-profile/instrument (mapped to the JAX profiler). The scene argument
accepts a built-in scene name (izpi_tpu.scene.library) or a .pbtxt scene
file (izpi_tpu.scene.pbtxt).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="izpi-tpu",
        description="differentiable spectral path tracer on JAX",
    )
    p.add_argument("--scene", default="cornell_box_pyramid_spectral",
                   help="built-in scene name or .pbtxt scene file")
    p.add_argument("-x", type=int, default=500, help="output width")
    p.add_argument("-y", type=int, default=500, help="output height")
    p.add_argument("--samples", type=int, default=1000,
                   help="samples per pixel")
    p.add_argument("--sampler", default="spectral",
                   choices=["spectral", "colour", "albedo", "normal",
                            "wireframe"])
    p.add_argument("--max-depth", type=int, default=50)
    p.add_argument("--output-mode", default="png",
                   choices=["png", "exr", "hdr", "pfm"])
    p.add_argument("--output-file", default="output.png")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--background", default="0,0,0",
                   help="background colour r,g,b")
    p.add_argument("--ink", default="0,0,0", help="wireframe ink colour")
    p.add_argument("--verbose", "-v", action="store_true")
    p.add_argument("--role", default="standalone",
                   choices=["standalone", "leader", "worker"])
    p.add_argument("--coordinator", default=None,
                   help="leader address host:port for multi-host rendering "
                        "(jax.distributed); leader and workers all pass the "
                        "same address")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total process count for multi-host rendering")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank (leader = 0)")
    p.add_argument("--shard-prims", action="store_true",
                   help="shard the primitive SoA 1/N per device instead of "
                        "replicating the scene (the >HBM-scene mode; "
                        "samples replicated, closest hit reduced across "
                        "devices)")
    p.add_argument("--num-workers", type=int, default=0,
                   help="devices to use (0 = all)")
    p.add_argument("--profile-dir", default=None,
                   help="write a JAX profiler trace (the analog of "
                        "--cpu-profile/--instrument)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file for resumable renders")
    p.add_argument("--checkpoint-interval", type=int, default=0,
                   help="samples between checkpoint writes (0 = off)")
    p.add_argument("--preview", default=None,
                   help="write a progressive preview PNG to this path "
                        "(the headless analog of the live display window)")
    p.add_argument("--preview-serve", type=int, default=None, metavar="PORT",
                   help="serve the live preview at http://localhost:PORT "
                        "(the analog of the reference's SDL/Fyne display; "
                        "implies --preview)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from izpi_tpu.integrator import path as path_mod
    from izpi_tpu.io import output as output_mod
    from izpi_tpu.render import renderer
    from izpi_tpu.scene.library import REGISTRY, get_scene

    aspect = args.x / args.y
    if args.scene.endswith((".pbtxt", ".izpi")):
        from izpi_tpu.scene import pbtxt

        scene = pbtxt.load_scene(args.scene, aspect=aspect)
    else:
        scene = get_scene(args.scene, aspect=aspect)

    bg = tuple(float(v) for v in args.background.split(","))
    ink = tuple(float(v) for v in args.ink.split(","))
    settings = path_mod.RenderSettings(max_depth=args.max_depth,
                                       background=bg)

    distributed = args.role in ("leader", "worker")
    if distributed:
        # Multi-host: one process per host joins the cluster (the JAX
        # replacement for mDNS discovery + the gRPC setup handshake,
        # leader/setup.go:22-131). leader = process 0.
        from izpi_tpu.parallel import dist

        pid = args.process_id
        if pid is None:
            pid = 0 if args.role == "leader" else None
        if pid is None and args.coordinator:
            # A worker needs an explicit rank: fail with the fix instead of
            # a deep runtime error.
            if not os.environ.get("JAX_PROCESS_ID"):
                raise SystemExit(
                    "--role worker with --coordinator on a bare host needs "
                    "an explicit rank: pass --process-id <rank> (1..N-1; "
                    "the leader is 0), or set JAX_PROCESS_ID")
        n_proc = dist.initialize_multihost(
            coordinator=args.coordinator,
            num_processes=args.num_processes, process_id=pid)
        if args.verbose:
            print(f"joined cluster: {n_proc} processes, "
                  f"{len(__import__('jax').devices())} devices",
                  file=sys.stderr)

    preview_server = None
    if args.preview_serve is not None:
        from izpi_tpu.io import display as display_mod

        if not args.preview:
            args.preview = os.path.join(
                os.path.dirname(os.path.abspath(args.output_file)) or ".",
                ".izpi_preview.png")
        preview_server = display_mod.PreviewServer(
            args.preview, port=args.preview_serve).start()
        print(f"live preview: http://localhost:{preview_server.port}/",
              file=sys.stderr)

    profile_ctx = None
    if args.profile_dir:
        import jax

        os.makedirs(args.profile_dir, exist_ok=True)
        profile_ctx = jax.profiler.trace(args.profile_dir)
        profile_ctx.__enter__()

    t0 = time.time()
    if distributed:
        from izpi_tpu.parallel import dist

        mesh = dist.make_mesh(args.num_workers or None)
        res = dist.render_distributed(
            scene, args.x, args.y, args.samples, mesh=mesh,
            settings=settings, seed=args.seed, sampler_type=args.sampler,
            shard_prims=args.shard_prims)
    else:
        res = renderer.render(
            scene, args.x, args.y, args.samples, settings=settings,
            seed=args.seed, sampler_type=args.sampler, ink=ink,
            checkpoint_path=args.checkpoint,
            checkpoint_interval=args.checkpoint_interval,
            preview_path=args.preview,
            verbose=args.verbose,
        )
    if profile_ctx is not None:
        profile_ctx.__exit__(None, None, None)

    aces = scene.spectral and args.output_mode == "exr"
    output_mod.write(args.output_file, res.image, mode=args.output_mode,
                     aces=aces)
    # End-of-render summary (renderer.go:213).
    print(f"Rendering completed in {time.time() - t0:.1f}s using "
          f"{res.rays_traced} rays ({res.mrays_per_sec:.2f} Mrays/s); "
          f"wrote {args.output_file}")
    if preview_server is not None:
        preview_server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
