"""Flat texture table + batched RGB evaluation.

The reference dispatches `Texture.Value(u,v,p)` virtually per hit
(internal/texture/api.go). Here all textures in a scene are one SoA table and
evaluation is tagged selects over the whole ray batch. Image textures live in
one zero-padded (I, maxH, maxW, 3) stack so a lookup is a single gather.

Kinds: 0 CONSTANT, 1 CHECKER (two constant children), 2 IMAGE, 3 NOISE.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from izpi_tpu.texture import perlin as perlin_mod

TEX_CONSTANT = 0
TEX_CHECKER = 1
TEX_IMAGE = 2
TEX_NOISE = 3


class Textures(NamedTuple):
    kind: jax.Array    # (T,) int32
    c0: jax.Array      # (T, 3) const color / checker odd
    c1: jax.Array      # (T, 3) checker even
    scale: jax.Array   # (T,) noise scale
    img_id: jax.Array  # (T,) int32, -1 if not an image
    images: jax.Array  # (I, maxH, maxW, 3) f32 (I>=1; dummy if unused)
    img_w: jax.Array   # (I,) int32
    img_h: jax.Array   # (I,) int32
    perlin: perlin_mod.PerlinTables
    # Per-material COMBINED map stack (albedo.rgb, normal.xyz, mean rough,
    # mean metal): big-table gathers cost ~13 ns/index on this backend
    # regardless of payload width (docs/PERF.md round 4), so the hot bounce
    # does ONE (N, 8) row gather instead of four. Built by the compiler;
    # (0, 1, 1, 8) when the scene has no image textures on materials.
    combined: jax.Array  # (Ic, maxH, maxW, 8) f32
    combo_w: jax.Array   # (Ic,) int32
    combo_h: jax.Array   # (Ic,) int32
    # Texture-sharded mode (>HBM texture sets, parallel.dist): `images` /
    # `combined` hold only this shard's slice of the stacks and these give
    # the slice's global starting index. None (the default) = replicated
    # stacks — the bases are compiled out. The metadata tables (img_w/h,
    # combo_w/h) stay replicated everywhere: they are bytes per texture,
    # not megabytes.
    img_base: object = None    # () int32 or None
    combo_base: object = None  # () int32 or None


def image_lookup(images, img_w, img_h, img_id, u, v, local_id=None):
    """Nearest-neighbor with V flip, exactly the reference's index math
    (texture/image.go:73-101): i=int(u·W), j=int((1-v)·(H-0.001)), clamped.
    local_id (sharded mode): index into the local `images` slice, while
    img_id still indexes the replicated w/h metadata tables."""
    w = img_w[img_id].astype(jnp.float32)
    h = img_h[img_id].astype(jnp.float32)
    i = (u * w).astype(jnp.int32)
    j = ((1.0 - v) * (h - 0.001)).astype(jnp.int32)
    i = jnp.clip(i, 0, jnp.maximum(img_w[img_id] - 1, 0))
    j = jnp.clip(j, 0, jnp.maximum(img_h[img_id] - 1, 0))
    return images[img_id if local_id is None else local_id, j, i]


def eval_rgb(tex: Textures, tex_id, u, v, p,
             has_checker: bool = True, has_image: bool = True,
             has_noise: bool = True, shard_axis: str = None):
    """Evaluate RGB textures for a ray batch.

    tex_id: (N,) int32 (>=0); u, v: (N,); p: (N,3). Returns (N,3).
    All kinds present in the scene are computed and selected — a handful of
    elementwise ops plus one gather each, instead of divergent control
    flow. The has_* flags are STATIC scene facts (SceneMeta) that let XLA
    drop whole evaluators: Perlin turbulence in particular costs ~56 gathers
    per ray and must be compiled out of noise-free scenes.
    """
    tid = jnp.maximum(tex_id, 0)
    kind = tex.kind[tid]
    c0 = tex.c0[tid]
    out = c0

    if has_checker:
        # CHECKER: sign of sin(10x)sin(10y)sin(10z) picks odd/even
        # (texture/checker.go:26).
        c1 = tex.c1[tid]
        sines = (
            jnp.sin(10.0 * p[..., 0])
            * jnp.sin(10.0 * p[..., 1])
            * jnp.sin(10.0 * p[..., 2])
        )
        checker = jnp.where((sines < 0.0)[..., None], c0, c1)
        out = jnp.where((kind == TEX_CHECKER)[..., None], checker, out)

    if has_image:
        gid = jnp.maximum(tex.img_id[tid], 0)
        if shard_axis is None:
            img = image_lookup(tex.images, tex.img_w, tex.img_h, gid, u, v)
        else:
            # Sharded stack: each shard resolves the ids it owns, everyone
            # else contributes zero, one psum merges — the device answer to
            # the reference's per-worker 64 KiB texture streaming
            # (assetprovider.go:122-198): the set never has to fit on one
            # chip. Only the image-branch tensor reduces; constant/checker/
            # noise values are computed replicated and selected after.
            local = gid - tex.img_base
            n_loc = tex.images.shape[0]
            owned = (local >= 0) & (local < n_loc)
            img = image_lookup(tex.images, tex.img_w, tex.img_h, gid, u, v,
                               local_id=jnp.clip(local, 0, n_loc - 1))
            img = jax.lax.psum(jnp.where(owned[..., None], img, 0.0),
                               shard_axis)
        out = jnp.where((kind == TEX_IMAGE)[..., None], img, out)

    if has_noise:
        # NOISE marble: 0.5·(1+sin(scale·z + 10·turb(p)))
        # (texture/noise.go:27).
        t = perlin_mod.turb(tex.perlin, p, 7)
        marble = 0.5 * (1.0 + jnp.sin(tex.scale[tid] * p[..., 2] + 10.0 * t))
        out = jnp.where((kind == TEX_NOISE)[..., None],
                        jnp.ones_like(c0) * marble[..., None], out)

    return out
