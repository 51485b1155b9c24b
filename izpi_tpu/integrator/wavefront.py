"""Persistent-pool wavefront scheduler (RGB and spectral).

The bounce kernels live in izpi_tpu.integrator.path (shared with the
lockstep oracle and the differentiable scan). This module only schedules:
a fixed pool of N path slots; each iteration advances every live path one
bounce, deposits the radiance of finished paths, and refills freed slots
with fresh camera samples — the device answer to izpi's work-stealing
goroutine pool (render/renderer.go:112-147).

Two schedulers:

- QUEUE (default since round 4): freed slots pull global sample ids from
  an on-device counter via a cumsum ranking, deposits scatter-add into
  the pixel accumulator. Occupancy stays ~100% regardless of per-pixel
  depth variance.
- SLOT-PINNED (selectable; also the Pallas megakernel's scheme): slot s
  serves pixel s mod n_pix forever and walks its replica's strided sample
  indices (replica k of r handles samples k, k+r, k+2r, …). The radiance
  deposit is a pure per-slot accumulator and the refill a per-slot
  counter — ZERO scatter-adds and ZERO cumsum queues per bounce. The
  catch: it CONVOYS on per-pixel depth variance — a slot pinned to a deep
  pixel runs long after shallow slots drain, which on the previous
  accelerator outweighed the queue's scatter+cumsum cost.

Both enumerate exactly the (pixel, sample) pairs of the lockstep renderer
and key them identically, so estimates match it up to fp accumulation order.

Spectral mode follows render/spectral.go:71-106: λ importance-sampled by
CIE-Y per sample, scalar radiance transport, XYZ deposit
radiance·(x̄,ȳ,z̄)(λ)/pdf(λ). Deposits ARE DeNAN'd — a deliberate deviation:
the reference's spectral path lacks the RGB path's per-sample DeNAN and
NaNs its canvas on degenerate pdfs (see path.bounce_spectral).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from izpi_tpu import camera as camera_mod
from izpi_tpu.core import rng
from izpi_tpu.core import vecmath as vm
from izpi_tpu.core.loops import chunked_while, guarded_fori
from izpi_tpu.integrator import path as path_mod
from izpi_tpu.spectral import cie

LAMBDA_SALT = 0x7A3B
# Iteration-bound ceiling for the all-static guarded fori scheduler: below
# this the whole pool loop compiles to a fixed trip count with no
# data-dependent predicate.
# ceil(total·max_depth/pool)+max_depth bounds the true count (every non-tail
# iteration runs all slots; the tail is ≤ max_depth deep). The bound is
# pessimistic by the avg-depth/max-depth ratio, and each skipped 8-iteration
# guard chunk still costs one lax.cond state copy (core.loops), so past this
# ceiling an adaptive chunked while is used.
MAX_STATIC_ITERS = 256


def _run_scheduler(cond, body, state0, total, n, max_depth,
                   loop: str = None):
    """Pick the loop structure (core.loops).

    loop="while" (the default) is a plain lax.while_loop; the guarded
    forms stay selectable until they are measured on this card. Callers
    resolve IZPI_POOL_LOOP at
    build time and pass it here (renderer.pool_runner); the env is read at
    trace time only for direct callers that pass nothing."""
    if loop is None:
        import os

        loop = os.environ.get("IZPI_POOL_LOOP", "while")
    if loop == "while":
        return jax.lax.while_loop(cond, body, state0)
    bound = -(-total * max_depth // n) + max_depth
    if bound <= MAX_STATIC_ITERS:
        return guarded_fori(bound, cond, body, state0)
    generations = -(-total // n)
    chunk = max(16, min(256, 2 * generations, bound))
    return chunked_while(cond, body, state0, chunk=chunk, guard=True)


def trace_pool(cs, meta, settings, intersect, nx: int, ny: int, spp: int,
               base_key, pool_size: int, spectral: bool = False,
               bg_spd_id: int = 0, sample_offset: int = 0,
               scheduler: str = "auto", loop: str = None):
    """Render nx×ny@spp with a persistent path pool.

    Returns (acc (nx*ny, 3) summed radiance — RGB, or CIE XYZ in spectral
    mode; divide by spp for the image — and the total ray count).
    sample_offset lets callers render in resumable chunks (checkpointing):
    the chunk covers per-pixel samples [offset, offset + spp).

    scheduler: "pinned" (per-slot accumulators, zero scatters — best when
    per-pixel path depth is uniform), "queue" (global sample counter +
    scatter-add deposits — immune to the pinned pool's convoy on deep
    pixels: a slot pinned to a deep pixel runs long after sky-pixel slots
    drain), or "auto": queue for scenes with strongly nonuniform
    depth (PBR under an enclosing emissive dome), pinned otherwise.
    Frames larger than the pool always queue."""
    n_pix = nx * ny
    if scheduler == "auto":
        # Direct callers get the env fallback at trace time; the renderer
        # resolves IZPI_POOL_SCHED once at runner-build time instead.
        import os

        scheduler = os.environ.get("IZPI_POOL_SCHED", "")
        if not scheduler:
            # The pinned pool convoys on per-pixel depth variance (a slot
            # pinned to a deep pixel runs long after shallow slots drain),
            # so queue is the default; pinned stays selectable for
            # depth-uniform frames. Both are untuned on this card.
            scheduler = "queue"
    if n_pix <= pool_size and scheduler == "pinned":
        return _trace_pool_pinned(
            cs, meta, settings, intersect, nx, ny, spp, base_key, pool_size,
            spectral=spectral, bg_spd_id=bg_spd_id,
            sample_offset=sample_offset, loop=loop)
    return _trace_pool_queue(
        cs, meta, settings, intersect, nx, ny, spp, base_key, pool_size,
        spectral=spectral, bg_spd_id=bg_spd_id, sample_offset=sample_offset,
        loop=loop)


def _make_ray_fns(cs, base_key, nx, ny, n_pix, spectral, sample_offset):
    """Shared sample→ray generation: keys and camera rays for a (pix, samp)
    batch, identical streams to the lockstep renderer's sample_pass."""

    def gen(pix, samp, issued):
        samp = jnp.where(issued, samp, 0) + sample_offset
        keys = rng.path_keys_perray(base_key, pix, samp)
        cam_u = rng.bounce_uniforms_perray(
            keys, jnp.zeros_like(pix), 5, salt=0x5EED)
        xs = (pix % nx).astype(jnp.float32)
        ys = (pix // nx).astype(jnp.float32)
        s = (xs + cam_u[:, 0]) / nx
        t = (ys + cam_u[:, 1]) / ny
        o, d, tme = camera_mod.get_rays(cs.camera, s, t, cam_u[:, 2:5])
        if spectral:
            u_lam = rng.bounce_uniforms_perray(
                keys, jnp.zeros_like(pix), 1, salt=LAMBDA_SALT)[:, 0]
            lam, lam_pdf = cie.sample_wavelength(u_lam)
        else:
            lam = jnp.zeros_like(s)
            lam_pdf = jnp.ones_like(s)
        return o, d, tme, keys, lam, lam_pdf

    return gen


def _bounce_step(cs, meta, settings, intersect, st, spectral, bg_spd_id):
    """Advance the pool one bounce; returns (state updates dict, died mask,
    per-path contribution)."""
    if spectral:
        o, d, thru, rad, active, nrays, bg_val = path_mod.bounce_spectral(
            cs, meta, settings, intersect,
            st["o"], st["d"], st["time"], st["lam"], st["keys"],
            st["depth"], st["thru"], st["rad"], st["active"], bg_spd_id,
        )
    else:
        o, d, thru, rad, active, nrays = path_mod.bounce_rgb(
            cs, meta, settings, intersect,
            st["o"], st["d"], st["time"], st["keys"], st["depth"],
            st["thru"], st["rad"], st["active"],
        )
    depth = st["depth"] + 1
    capped = active & (depth >= settings.max_depth)
    if spectral:
        # Depth cap returns the background SPD at λ (spectral.go:48-52).
        rad = rad + jnp.where(capped, thru * bg_val, 0.0)
    else:
        sentinel = jnp.array([0.0, 0.0, 1.0], jnp.float32)
        rad = rad + jnp.where(capped[:, None], thru * sentinel[None, :], 0.0)
    active = active & ~capped

    died = st["active"] & ~active
    if spectral:
        x, y, z = cie.get_cie_values(st["lam"])
        xyz = jnp.stack([x, y, z], axis=-1)
        # pdf(λ)=0 only when u drew exactly 0 and landed on CIE_Y[0]=0
        # — a measure-zero event the reference divides into Inf
        # (render/spectral.go:95); zeroing it keeps the estimator
        # unbiased and the canvas finite for firefly rejection. The
        # final de_nan mirrors the RGB path's per-sample DeNAN
        # (render/rgb.go:36) which the reference's spectral path lacks.
        w = jnp.where(st["lam_pdf"] > 0.0, rad / st["lam_pdf"], 0.0)
        contrib = vm.de_nan(xyz * w[:, None])
    else:
        contrib = vm.de_nan(rad)
    return (dict(o=o, d=d, thru=thru, rad=rad, active=active, depth=depth,
                 nrays=nrays), died, contrib)


def _trace_pool_pinned(cs, meta, settings, intersect, nx, ny, spp, base_key,
                       pool_size, spectral, bg_spd_id, sample_offset,
                       loop=None):
    """Slot-pinned pool: n_pix·r slots, replica k strided over samples
    {k, k+r, …} ∩ [0, spp). No scatters, no queues."""
    n_pix = nx * ny
    r = max(1, min(pool_size // n_pix, spp))
    n = n_pix * r
    total = n_pix * spp

    gen = _make_ray_fns(cs, base_key, nx, ny, n_pix, spectral, sample_offset)
    slot = jnp.arange(n, dtype=jnp.int32)
    pix = slot % n_pix
    replica = slot // n_pix

    def slot_rays(samp_ctr, issued):
        # per-pixel sample index for this slot's samp_ctr-th path
        return gen(pix, samp_ctr * r + replica, issued)

    samp0 = jnp.zeros(n, jnp.int32)
    issued0 = replica < spp
    o0, d0, t0, keys0, lam0, lpdf0 = slot_rays(samp0, issued0)

    # Carry inits derived from the ray arrays so every carry has the
    # varying-manual-axes type under shard_map (sample_offset is
    # device-varying in the distributed pool).
    zf = t0 * 0.0
    rad0 = zf if spectral else zf[:, None] + jnp.zeros(3, jnp.float32)
    state0 = dict(
        o=o0, d=d0, time=t0, keys=keys0, lam=lam0, lam_pdf=lpdf0,
        depth=zf.astype(jnp.int32),
        thru=rad0 + 1.0, rad=rad0,
        active=issued0 & (zf == 0.0),
        samp=samp0 + zf.astype(jnp.int32),
        # per-slot accumulator, always (n, 3) — XYZ in spectral mode
        acc=jnp.zeros((n, 3), jnp.float32) + jnp.sum(zf),
        nrays=jnp.sum(zf).astype(jnp.int32),
    )

    def cond(st):
        return jnp.any(st["active"])

    def body(st):
        upd, died, contrib = _bounce_step(
            cs, meta, settings, intersect, st, spectral, bg_spd_id)
        acc = st["acc"] + jnp.where(died[:, None], contrib, 0.0)

        samp = jnp.where(died, st["samp"] + 1, st["samp"])
        issue = died & (samp * r + replica < spp)
        o_n, d_n, t_n, k_n, lam_n, lpdf_n = slot_rays(samp, issue)
        sel = issue[:, None]
        sel_r = issue if spectral else sel
        return dict(
            o=jnp.where(sel, o_n, upd["o"]),
            d=jnp.where(sel, d_n, upd["d"]),
            time=jnp.where(issue, t_n, st["time"]),
            keys=jnp.where(sel, k_n, st["keys"]),
            lam=jnp.where(issue, lam_n, st["lam"]),
            lam_pdf=jnp.where(issue, lpdf_n, st["lam_pdf"]),
            depth=jnp.where(issue, 0, upd["depth"]),
            thru=jnp.where(sel_r, 1.0, upd["thru"]),
            rad=jnp.where(sel_r, 0.0, upd["rad"]),
            active=upd["active"] | issue,
            samp=samp, acc=acc,
            nrays=st["nrays"] + upd["nrays"],
        )

    final = _run_scheduler(cond, body, state0, total, n, settings.max_depth,
                           loop=loop)
    acc = final["acc"].reshape(r, n_pix, 3).sum(axis=0)
    return acc, final["nrays"]


def _trace_pool_queue(cs, meta, settings, intersect, nx, ny, spp, base_key,
                      pool_size, spectral, bg_spd_id, sample_offset,
                      loop=None):
    """Queue pool for frames larger than the pool: freed slots pull global
    sample ids (pixel-major) from an on-device counter."""
    n_pix = nx * ny
    total = n_pix * spp
    n = pool_size
    gen = _make_ray_fns(cs, base_key, nx, ny, n_pix, spectral, sample_offset)

    def sample_to_ray(sample_ids, issued):
        sid = jnp.where(issued, sample_ids, 0)
        pix = sid % n_pix
        samp = sid // n_pix
        o, d, tme, keys, lam, lpdf = gen(pix, samp, issued)
        return o, d, tme, keys, pix, lam, lpdf

    init_ids = jnp.arange(n, dtype=jnp.int32)
    issued0 = init_ids < total
    o0, d0, t0, keys0, pix0, lam0, lpdf0 = sample_to_ray(init_ids, issued0)

    zf = t0 * 0.0
    zs = jnp.sum(zf)
    rad0 = zf if spectral else zf[:, None] + jnp.zeros(3, jnp.float32)
    state0 = dict(
        o=o0, d=d0, time=t0, keys=keys0,
        pix=pix0 + zf.astype(jnp.int32), lam=lam0, lam_pdf=lpdf0,
        depth=zf.astype(jnp.int32),
        thru=rad0 + 1.0, rad=rad0,
        active=issued0 & (zf == 0.0),
        next_sample=jnp.int32(min(n, total)) + zs.astype(jnp.int32),
        acc=jnp.zeros((n_pix, 3), jnp.float32) + zs,
        nrays=zs.astype(jnp.int32),
    )

    def cond(st):
        return jnp.any(st["active"])

    def body(st):
        upd, died, contrib = _bounce_step(
            cs, meta, settings, intersect, st, spectral, bg_spd_id)
        acc = st["acc"].at[st["pix"]].add(
            jnp.where(died[:, None], contrib, 0.0))

        free = ~upd["active"]
        slot_rank = jnp.cumsum(free.astype(jnp.int32)) - 1
        new_ids = st["next_sample"] + slot_rank
        issue = free & (new_ids < total)
        o_n, d_n, t_n, k_n, pix_n, lam_n, lpdf_n = sample_to_ray(new_ids,
                                                                 issue)
        sel = issue[:, None]
        sel_r = issue if spectral else sel
        return dict(
            o=jnp.where(sel, o_n, upd["o"]),
            d=jnp.where(sel, d_n, upd["d"]),
            time=jnp.where(issue, t_n, st["time"]),
            keys=jnp.where(sel, k_n, st["keys"]),
            pix=jnp.where(issue, pix_n, st["pix"]),
            lam=jnp.where(issue, lam_n, st["lam"]),
            lam_pdf=jnp.where(issue, lpdf_n, st["lam_pdf"]),
            depth=jnp.where(issue, 0, upd["depth"]),
            thru=jnp.where(sel_r, 1.0, upd["thru"]),
            rad=jnp.where(sel_r, 0.0, upd["rad"]),
            active=upd["active"] | issue,
            next_sample=st["next_sample"] + jnp.sum(issue.astype(jnp.int32)),
            acc=acc,
            nrays=st["nrays"] + upd["nrays"],
        )

    final = _run_scheduler(cond, body, state0, total, n, settings.max_depth,
                           loop=loop)
    return final["acc"], final["nrays"]
