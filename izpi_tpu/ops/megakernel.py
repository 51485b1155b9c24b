"""Pallas wavefront megakernel: the whole render loop in one GPU kernel.

The XLA wavefront scheduler (integrator/wavefront.py) advances the pool one
bounce per loop iteration: every iteration launches several fused kernels
and moves the whole pool state through device memory. This kernel keeps
each path's state in registers and runs bounces and refills inside one
Triton kernel; device memory is touched once at the end to write the
per-slot accumulators.

Design (vs the reference's architecture, internal/render/renderer.go:112-147):
- goroutine pool pulling tiles from a channel  →  grid of programs, each
  owning BLOCK path slots (one per thread) for the kernel's whole lifetime;
- per-pixel loop over spp (render/rgb.go:32-38)  →  slot-pinned pixels: slot
  s serves pixel (s mod n_pix) and walks its sample indices sequentially, so
  the radiance deposit is a pure per-slot accumulator — no scatter at all;
- virtual Hitable/Material dispatch  →  the scene is BAKED INTO THE KERNEL
  as compile-time constants (the scene is fixed for a render anyway): the
  primitive loop unrolls with immediate operands, zero gathers, zero branch
  divergence;
- per-goroutine LCG (fastrandom)  →  the shared Threefry derivation
  (ops.threefry == core.rng), so sample streams are bit-identical to the XLA
  oracle's and images match it to fp accumulation order.

Eligibility is checked by `eligible()`: RGB colour sampler, no participating
media, no PBR, no image/noise textures, and a bounded static primitive count
(the unroll budget). Every other scene renders on the XLA wavefront pool.

Estimator identity: see integrator/path.py docstring — this kernel reproduces
bounce_rgb + wavefront.trace_pool semantics op-for-op (sampler/colour.go:33-65
NEE mixture estimator, depth-cap {Z:1} sentinel, DeNAN'd deposits).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from izpi_tpu.materials import tables as mt
from izpi_tpu.ops import threefry as tf
from izpi_tpu.texture import tables as tt

T_MIN = 1e-3
T_MAX = 3.0e38
MT_EPS = 1e-8
TWO_PI = 2.0 * math.pi
CAMERA_SALT = 0x5EED
# Unroll budget: every primitive is baked into the kernel, and the Triton
# compile grows faster than linearly with the count. Measured on an H100:
# 13 prims 5 s, 64 prims 15 s, 128 prims 38 s, 485 (Shirley) > 5 min.
MAX_UNROLL_PRIMS = 128
# Bounces between block-drained checks. A large chunk quantizes the drain
# tail into up to chunk-1 wasted iterations of the whole block.
LOOP_CHUNK = 8


# --------------------------------------------------------------------------
# Static scene extraction (host side, numpy → python floats baked as consts)
# --------------------------------------------------------------------------

class StaticScene(NamedTuple):
    prims: list       # dicts: kind, g0..g3, uv, vn, has_vn, flip, mat index
    mats: list        # dicts: kind, col0, col1, is_checker, fuzz, ref_idx,
                      #        absorption, has_absorption
    lights: list      # dicts: kind, l0, l1, l2, normal, area, radius
    cam: dict
    has_absorbing: bool


def eligible(cs, meta) -> bool:
    if meta.spectral or meta.has_pbr or meta.n_media > 0:
        return False
    if meta.has_image or meta.has_noise:
        return False
    if meta.n_prims == 0 or meta.n_prims > MAX_UNROLL_PRIMS:
        return False
    return True


def extract_static(cs, meta) -> StaticScene:
    v3 = lambda a: tuple(float(x) for x in np.asarray(a, np.float64))
    pk = np.asarray(cs.prims.kind)
    g0 = np.asarray(cs.prims.g0, np.float64)
    g1 = np.asarray(cs.prims.g1, np.float64)
    g2 = np.asarray(cs.prims.g2, np.float64)
    g3 = np.asarray(cs.prims.g3, np.float64)
    uv = np.asarray(cs.prims.uv, np.float64)
    vn = np.asarray(cs.prims.vn, np.float64)
    hv = np.asarray(cs.prims.has_vn)
    fl = np.asarray(cs.prims.flip)
    pm = np.asarray(cs.prims.mat_id)
    prims = [
        dict(kind=int(pk[i]), g0=v3(g0[i]), g1=v3(g1[i]), g2=v3(g2[i]),
             g3=v3(g3[i]), uv=tuple(map(float, uv[i])),
             vn=tuple(map(float, vn[i])), has_vn=bool(hv[i]),
             flip=bool(fl[i]), mat=int(pm[i]))
        for i in range(pk.shape[0])
    ]

    m = cs.materials
    tex = cs.textures
    t_kind = np.asarray(tex.kind)
    t_c0 = np.asarray(tex.c0, np.float64)
    t_c1 = np.asarray(tex.c1, np.float64)
    mats = []
    for i in range(int(np.asarray(m.kind).shape[0])):
        tid = int(np.asarray(m.tex_albedo)[i])
        tid_safe = max(tid, 0)
        mats.append(dict(
            kind=int(np.asarray(m.kind)[i]),
            col0=v3(t_c0[tid_safe]), col1=v3(t_c1[tid_safe]),
            is_checker=bool(tid >= 0 and t_kind[tid_safe] == tt.TEX_CHECKER),
            fuzz=float(np.asarray(m.fuzz)[i]),
            ref_idx=float(np.asarray(m.ref_idx)[i]),
            absorption=v3(np.asarray(m.absorption, np.float64)[i]),
            has_absorption=bool(np.asarray(m.has_absorption)[i]),
        ))

    li = cs.lights
    lights = [
        dict(kind=int(np.asarray(li.kind)[j]),
             l0=v3(np.asarray(li.l0, np.float64)[j]),
             l1=v3(np.asarray(li.l1, np.float64)[j]),
             l2=v3(np.asarray(li.l2, np.float64)[j]),
             normal=v3(np.asarray(li.normal, np.float64)[j]),
             area=float(np.asarray(li.area)[j]),
             radius=float(np.asarray(li.radius)[j]))
        for j in range(int(np.asarray(li.kind).shape[0]))
    ]

    c = cs.camera
    cam = dict(origin=v3(c.origin), lower_left=v3(c.lower_left),
               horizontal=v3(c.horizontal), vertical=v3(c.vertical),
               u=v3(c.u), v=v3(c.v),
               lens_radius=float(c.lens_radius),
               time0=float(c.time0), time1=float(c.time1))

    has_absorbing = bool(meta.has_absorbing_dielectric) and any(
        mt_["has_absorption"] for mt_ in mats)
    return StaticScene(prims, mats, lights, cam, has_absorbing)


# --------------------------------------------------------------------------
# Plane-SoA vec3 helpers: a vector is a tuple (x, y, z) of (S, 128) arrays.
# --------------------------------------------------------------------------

def _c(v):
    return (jnp.float32(v[0]), jnp.float32(v[1]), jnp.float32(v[2]))


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _mul(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _sel(m, a, b):
    return (jnp.where(m, a[0], b[0]), jnp.where(m, a[1], b[1]),
            jnp.where(m, a[2], b[2]))


def _norm(a):
    inv = 1.0 / jnp.sqrt(_dot(a, a))
    return _scale(a, inv)


def _reflect(v, n):
    return _sub(v, _scale(n, 2.0 * _dot(v, n)))


# --------------------------------------------------------------------------
# In-kernel geometry tests against one STATIC primitive
# --------------------------------------------------------------------------

def _tri_test(pr, o, d, t_min, t_max):
    """Möller–Trumbore vs static triangle (primitives.triangle_t)."""
    v0, e1, e2 = _c(pr["g0"]), _c(pr["g1"]), _c(pr["g2"])
    h = _cross(d, e2)
    a = _dot(e1, h)
    parallel = jnp.abs(a) < MT_EPS
    f = 1.0 / jnp.where(parallel, 1.0, a)
    s = _sub(o, v0)
    u = f * _dot(s, h)
    q = _cross(s, e1)
    v = f * _dot(d, q)
    t = f * _dot(e2, q)
    ok = ((~parallel)
          & (u >= -MT_EPS) & (u <= 1.0 + MT_EPS)
          & (v >= -MT_EPS) & (u + v <= 1.0 + MT_EPS)
          & (t >= t_min) & (t <= t_max))
    # normal: interpolated vertex normals (renormalized barycentrics,
    # primitives.finalize_hit) or the static geometric normal.
    if pr["has_vn"]:
        w = 1.0 - u - v
        ssum = u + v + w
        inv = 1.0 / jnp.where(ssum == 0.0, 1.0, ssum)
        bu, bv, bw = u * inv, v * inv, w * inv
        vn = pr["vn"]
        n = _add(_add(_scale(_c(vn[0:3]), bw), _scale(_c(vn[3:6]), bu)),
                 _scale(_c(vn[6:9]), bv))
        inv_l = 1.0 / jnp.maximum(jnp.sqrt(_dot(n, n)), 1e-12)
        n = _scale(n, inv_l)
    else:
        n = _c(pr["g3"])
        n = (jnp.broadcast_to(n[0], t.shape), jnp.broadcast_to(n[1], t.shape),
             jnp.broadcast_to(n[2], t.shape))
    return t, ok, n


def _rect_test(pr, o, d, t_min, t_max):
    p0, e1, e2, nrm = _c(pr["g0"]), _c(pr["g1"]), _c(pr["g2"]), _c(pr["g3"])
    denom = _dot(d, nrm)
    degenerate = denom == 0.0
    t = _dot(_sub(p0, o), nrm) / jnp.where(degenerate, 1.0, denom)
    p = _add(o, _scale(d, t))
    rel = _sub(p, p0)
    ee1 = pr["g1"][0] ** 2 + pr["g1"][1] ** 2 + pr["g1"][2] ** 2
    ee2 = pr["g2"][0] ** 2 + pr["g2"][1] ** 2 + pr["g2"][2] ** 2
    u = _dot(rel, e1) * jnp.float32(1.0 / ee1)
    v = _dot(rel, e2) * jnp.float32(1.0 / ee2)
    ok = ((~degenerate) & (t >= t_min) & (t <= t_max)
          & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0))
    n = (jnp.broadcast_to(nrm[0], t.shape), jnp.broadcast_to(nrm[1], t.shape),
         jnp.broadcast_to(nrm[2], t.shape))
    return t, ok, n


def _sphere_center(pr, time):
    c0 = _c(pr["g0"])
    if pr["g0"] == pr["g1"]:
        return c0
    st0, st1 = pr["g2"][1], pr["g2"][2]
    denom = st1 - st0
    frac = (time - st0) * (1.0 / denom if denom != 0.0 else 0.0)
    if denom == 0.0:
        frac = jnp.zeros_like(time)
    return _add(c0, _scale(_sub(_c(pr["g1"]), c0), frac))


def _sphere_test_t(pr, o, d, time, t_min, t_max, aa=None):
    """Quadratic root test only — the normal is DEFERRED to the post-scan
    epilogue (_scan_prims carries the winner's center instead): the
    p/outward/flip chain is ~23 of the ~48 ops per sphere and only the
    winning primitive's normal is ever used. aa: optional hoisted
    (d·d, 1/max(d·d,eps)-style safe reciprocal) pair shared across the
    scan — d is loop-invariant, so these are per-bounce not per-prim.
    Returns (t, ok, far_ok, center)."""
    radius = pr["g2"][0]
    center = _sphere_center(pr, time)
    oc = _sub(o, center)
    if aa is None:
        a = _dot(d, d)
        inv_a = 1.0 / jnp.where(a == 0.0, 1.0, a)
    else:
        a, inv_a = aa
    b = _dot(oc, d)
    cq = _dot(oc, oc) - radius * radius
    disc = b * b - a * cq
    has = disc > 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t_near = (-b - sq) * inv_a
    t_far = (-b + sq) * inv_a
    near_ok = has & (t_near < t_max) & (t_near > t_min)
    far_ok = has & (t_far < t_max) & (t_far > t_min) & ~near_ok
    t = jnp.where(near_ok, t_near, t_far)
    ok = near_ok | far_ok
    return t, ok, far_ok, center


def _sphere_test(pr, o, d, time, t_min, t_max, aa=None):
    """Quadratic + reference root/normal quirks (primitives.sphere_t +
    finalize_hit: record normal unflipped on the far root)."""
    t, ok, far_ok, center = _sphere_test_t(pr, o, d, time, t_min, t_max,
                                           aa=aa)
    radius = pr["g2"][0]
    p = _add(o, _scale(d, t))
    inv_r = 1.0 / radius if radius != 0.0 else 1.0
    outward = _scale(_sub(p, center), jnp.float32(inv_r))
    flip_n = _dot(d, outward) >= 0.0
    flipped = _sel(flip_n, _scale(outward, -1.0), outward)
    n = _sel(far_ok, outward, flipped)
    return t, ok, n


def _prim_aabb(pr):
    """Conservative f64 AABB of one static primitive, padded so f32 slab
    arithmetic can never cull a primitive the exact test would hit."""
    k = pr["kind"]
    if k == 0:       # triangle: v0, e1, e2
        v0 = np.asarray(pr["g0"])
        pts = np.stack([v0, v0 + pr["g1"], v0 + pr["g2"]])
    elif k == 1:     # rect: p0, e1, e2
        p0 = np.asarray(pr["g0"])
        e1 = np.asarray(pr["g1"])
        e2 = np.asarray(pr["g2"])
        pts = np.stack([p0, p0 + e1, p0 + e2, p0 + e1 + e2])
    else:            # sphere: both motion endpoints ± radius
        c0 = np.asarray(pr["g0"])
        c1 = np.asarray(pr["g1"])
        r = abs(pr["g2"][0])
        pts = np.stack([c0 - r, c0 + r, c1 - r, c1 + r])
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    pad = 1e-4 + 1e-4 * np.maximum(hi - lo, np.abs(lo) + np.abs(hi))
    return lo - pad, hi + pad


def build_clusters(prims, cam_origin, csize: int = 16):
    """Spatial clusters of `csize` prims for the unrolled scan: prims are
    Morton-ordered by centroid, chunked, and the chunks sorted by distance
    from the camera origin (primary rays shrink t earliest, narrowing every
    later cluster's slab window). Returns [(aabb6, [prim,...]), ...]."""
    los, his = zip(*[_prim_aabb(pr) for pr in prims])
    los = np.stack(los)
    his = np.stack(his)
    cent = (los + his) * 0.5
    lo = los.min(axis=0)
    span = np.maximum(his.max(axis=0) - lo, 1e-9)
    cell = np.clip(((cent - lo) / span * 32).astype(np.int64), 0, 31)

    def spread(v):
        v = (v | (v << 10)) & 0x30000FF
        v = (v | (v << 4)) & 0x30C30C3
        return (v | (v << 2)) & 0x9249249

    code = spread(cell[:, 0]) | (spread(cell[:, 1]) << 1) | (
        spread(cell[:, 2]) << 2)
    order = np.argsort(code, kind="stable")
    clusters = []
    cam = np.asarray(cam_origin)
    for i in range(0, len(prims), csize):
        ids = order[i: i + csize]
        box = np.concatenate([los[ids].min(axis=0), his[ids].max(axis=0)])
        clusters.append((tuple(float(x) for x in box),
                         [prims[j] for j in ids]))
    clusters.sort(key=lambda c: float(np.linalg.norm(
        (np.asarray(c[0][:3]) + np.asarray(c[0][3:])) * 0.5 - cam)))
    return clusters


# Deferred sphere normals pay per SPHERE in the scan but cost two extra
# loop-carried values; with few spheres the carries cost more than they
# save. The threshold was set on the previous accelerator and is untuned
# on this card.
DEFER_MIN_SPHERES = 16


def _scan_prims(prims, o, d, time, t_min, carry, want_mat, defer=True):
    """Unrolled closest-hit update over `prims` against the running carry
    (best_t f32, hit i32, nx, ny, nz f32, mat i32, rr f32, code i32).
    Sphere winners carry their CENTER in the normal slots plus a
    code/inverse-radius pair; the actual normal (p, outward, far-root and
    flip quirks) is resolved once after the scan — ~23 ops saved per
    sphere per lane in the hot scan."""
    best_t, hit_i, nx, ny, nz, mat_idx, rr, code = carry
    n = (nx, ny, nz)
    a_h = _dot(d, d)
    aa = (a_h, 1.0 / jnp.where(a_h == 0.0, 1.0, a_h))
    for pr in prims:
        if pr["kind"] == 0:
            t, ok, nn = _tri_test(pr, o, d, t_min, best_t)
        elif pr["kind"] == 1:
            t, ok, nn = _rect_test(pr, o, d, t_min, best_t)
        elif pr["kind"] == 2 and defer:
            t, ok, far_ok, center = _sphere_test_t(pr, o, d, time, t_min,
                                                    best_t, aa=aa)
            better = ok & (t < best_t)
            best_t = jnp.where(better, t, best_t)
            hit_i = jnp.where(better, 1, hit_i)
            n = _sel(better, center, n)
            radius = pr["g2"][0]
            inv_r = 1.0 / radius if radius != 0.0 else 1.0
            rr = jnp.where(better, jnp.float32(inv_r), rr)
            pcode = 1 + far_ok.astype(jnp.int32) + (2 if pr["flip"] else 0)
            code = jnp.where(better, pcode, code)
            if want_mat:
                mat_idx = jnp.where(better, pr["mat"], mat_idx)
            continue
        elif pr["kind"] == 2:
            t, ok, nn = _sphere_test(pr, o, d, time, t_min, best_t, aa=aa)
        else:
            continue
        if pr["flip"]:
            nn = _scale(nn, -1.0)
        better = ok & (t < best_t)
        best_t = jnp.where(better, t, best_t)
        hit_i = jnp.where(better, 1, hit_i)
        n = _sel(better, nn, n)
        if defer:
            code = jnp.where(better, 0, code)
        if want_mat:
            mat_idx = jnp.where(better, pr["mat"], mat_idx)
    return (best_t, hit_i, n[0], n[1], n[2], mat_idx, rr, code)


# Cluster-skipping gate, off by default: a block-union slab test per
# 16-prim cluster costs more than the primitives it skips on Shirley's
# incoherent bounce rays (H100, 128 prims, 256²@128: 57.3 ms clustered vs
# 40.4 ms flat), though the clustered kernel compiled in 18.6 s vs 44.9 s.
# The path and its differential test stay for scenes with real spatial
# separation.
CLUSTER_MIN_PRIMS = 1 << 30


def _intersect_static(prims, o, d, time, t_min, t_max_init, want_mat=True,
                      clusters=None):
    """Closest hit vs the static scene, unrolled. Returns dict of per-lane
    hit data (t, hit, normal, p, mat index as int32).

    With `clusters`, each 16-prim chunk is guarded by a block-union slab
    test against the chunk's AABB and skipped via lax.cond when no lane's
    [t_min, best_t) window can enter it — the two-level answer to the
    reference's per-ray BVH descent (bvh4.go:49-163) at unroll scale. The
    per-lane best_t feeds the slab far plane, so clusters behind every
    lane's current hit are skipped too (tMax shrink, bvh4.go:130)."""
    shape = o[0].shape
    defer = sum(1 for pr in prims if pr["kind"] == 2) >= DEFER_MIN_SPHERES
    zf0 = jnp.zeros(shape, jnp.float32)
    zi0 = jnp.zeros(shape, jnp.int32)
    carry = (jnp.full(shape, t_max_init, jnp.float32),
             zi0,
             zf0, zf0, zf0,
             jnp.full(shape, -1, jnp.int32),
             zf0 + 1.0 if defer else zf0,
             zi0)
    if clusters is None:
        carry = _scan_prims(prims, o, d, time, t_min, carry, want_mat,
                            defer=defer)
    else:
        inv = tuple(1.0 / jnp.where(dc == 0.0, 1e-30, dc) for dc in d)
        for bbox, cprims in clusters:
            tn = jnp.full(shape, t_min, jnp.float32)
            tf_ = carry[0]
            for ax in range(3):
                t0b = (jnp.float32(bbox[ax]) - o[ax]) * inv[ax]
                t1b = (jnp.float32(bbox[3 + ax]) - o[ax]) * inv[ax]
                tn = jnp.maximum(tn, jnp.minimum(t0b, t1b))
                tf_ = jnp.minimum(tf_, jnp.maximum(t0b, t1b))
            anyhit = jnp.max(jnp.where(tf_ > tn, 1, 0)) > 0
            carry = jax.lax.cond(
                anyhit,
                lambda c, cp=cprims: _scan_prims(cp, o, d, time, t_min, c,
                                                 want_mat, defer=defer),
                lambda c: c,
                carry)
    best_t, hit_i, nx, ny, nz, mat_idx, rr, code = carry
    p = _add(o, _scale(d, best_t))
    # Resolve deferred sphere normals: code 0 = literal normal in n; else
    # n holds the winner's center and code packs (far_root, flip).
    n = (nx, ny, nz)
    is_sph = code > 0
    if defer and any(pr["kind"] == 2 for pr in prims):
        codem = code - 1
        far = (codem & 1) == 1
        flip = (codem & 2) != 0
        outward = _scale(_sub(p, n), rr)
        flip_n = _dot(d, outward) >= 0.0
        flipped = _sel(flip_n, _scale(outward, -1.0), outward)
        n_sph = _sel(far, outward, flipped)
        n_sph = _sel(flip, _scale(n_sph, -1.0), n_sph)
        n = _sel(is_sph, n_sph, n)
    return dict(t=best_t, hit=hit_i != 0, n=n, p=p, mat=mat_idx)


# --------------------------------------------------------------------------
# Lights (static member list): NEE sample + mixture PDF (integrator/lights.py)
# --------------------------------------------------------------------------

def _onb_from_w(w_raw):
    inv = 1.0 / jnp.sqrt(_dot(w_raw, w_raw))
    w = _scale(w_raw, inv)
    big_x = jnp.abs(w[0]) > 0.9
    ax = jnp.where(big_x, 0.0, 1.0)
    ay = jnp.where(big_x, 1.0, 0.0)
    a = (ax, ay, jnp.zeros_like(ax))
    v = _cross(w, a)
    v = _scale(v, 1.0 / jnp.sqrt(_dot(v, v)))
    u = _cross(w, v)
    return u, v, w


def _lights_sample(lights, o, u0, u1, u2, u3):
    n_l = len(lights)
    idx = jnp.minimum((u0 * n_l).astype(jnp.int32), n_l - 1)
    out = (jnp.ones_like(u0), jnp.zeros_like(u0), jnp.zeros_like(u0))
    for j, li in enumerate(lights):
        if li["kind"] == 0:      # rect: uniform point (xzrect.go:118)
            point = _add(_add(_c(li["l0"]), _scale(_c(li["l1"]), u1)),
                         _scale(_c(li["l2"]), u2))
            dirj = _sub(point, o)
        elif li["kind"] == 1:    # triangle: reference lerp-lerp quirk
            l0, l1, l2 = _c(li["l0"]), _c(li["l1"]), _c(li["l2"])
            p01 = _add(l0, _scale(_sub(l1, l0), u1))
            p02 = _add(l0, _scale(_sub(l2, l0), u2))
            dirj = _sub(_add(p01, _scale(_sub(p02, p01), u3)), o)
        elif li["kind"] == 2:    # sphere: cone sample (sphere.go:139)
            to_c = _sub(_c(li["l0"]), o)
            dist2 = _dot(to_c, to_c)
            bu, bv, bw = _onb_from_w(to_c)
            r = li["radius"]
            z = 1.0 + u2 * (jnp.sqrt(1.0 - r * r / dist2) - 1.0)
            phi = TWO_PI * u1
            s = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
            lx, ly = jnp.cos(phi) * s, jnp.sin(phi) * s
            dirj = _add(_add(_scale(bu, lx), _scale(bv, ly)), _scale(bw, z))
        else:
            continue
        out = _sel(idx == j, dirj, out)
    return out


def _lights_pdf(lights, o, v):
    n_l = len(lights)
    v_len2 = _dot(v, v)
    v_len = jnp.sqrt(v_len2)
    total = jnp.zeros_like(v_len)
    for li in lights:
        if li["kind"] == 0:
            t, ok, _ = _rect_test(
                dict(g0=li["l0"], g1=li["l1"], g2=li["l2"],
                     g3=li["normal"]), o, v, 1e-3, T_MAX)
            cos = jnp.abs(_dot(v, _c(li["normal"]))) / v_len
            pdf = jnp.where(ok, t * t * v_len2 / (cos * li["area"]), 0.0)
        elif li["kind"] == 1:
            l0 = li["l0"]
            e1 = tuple(li["l1"][k] - l0[k] for k in range(3))
            e2 = tuple(li["l2"][k] - l0[k] for k in range(3))
            t, ok, _ = _tri_test(
                dict(g0=l0, g1=e1, g2=e2, g3=li["normal"], has_vn=False),
                o, v, 1e-3, T_MAX)
            cos = jnp.abs(_dot(v, _c(li["normal"]))) / v_len
            pdf = jnp.where(ok, t * t * v_len2 / (cos * li["area"]), 0.0)
        elif li["kind"] == 2:
            pr = dict(g0=li["l0"], g1=li["l0"],
                      g2=(li["radius"], 0.0, 0.0), g3=(0.0, 0.0, 0.0))
            t, ok, _ = _sphere_test(pr, o, v, v_len * 0.0, 1e-3, T_MAX)
            to_c = _sub(_c(li["l0"]), o)
            dist2 = _dot(to_c, to_c)
            # clamped: interior origins get the hemisphere pdf 1/2π
            # (see integrator.lights.pdf_value — the reference NaNs here)
            cos_max = jnp.sqrt(jnp.maximum(
                1.0 - li["radius"] ** 2 / dist2, 0.0))
            solid = TWO_PI * (1.0 - cos_max)
            pdf = jnp.where(ok, 1.0 / solid, 0.0)
        else:
            pdf = jnp.zeros_like(v_len)
        total = total + pdf
    return total / n_l


# --------------------------------------------------------------------------
# The kernel: launch geometry shared with ops.megakernel_spectral
# --------------------------------------------------------------------------

# One path slot per thread: a lane carries ~40 live f32/u32 values, so a
# program of BLOCK lanes over NUM_WARPS warps keeps them in registers (two
# lanes per thread measured 30% slower). Frames with fewer than MIN_SLOTS
# pixels get replica slots (the same pixel on disjoint sample ranges) so
# more programs share the drain tail; 1<<18 beat 1<<16 by 7% on cornell.
# Swept on cornell 256²@1024 (scripts/engine_timing.py); the spectral
# kernel keeps its own values.
BLOCK = 128
NUM_WARPS = 4
MIN_SLOTS = 1 << 18


class Launch(NamedTuple):
    block: int       # lanes (path slots) per program, a power of two
    num_warps: int
    repl: int        # slots per pixel
    n_slots: int     # n_pix · repl
    n_grid: int      # programs; n_grid · block ≥ n_slots (tail lanes idle)


def _pick_replication(n_pix: int, spp: int, min_slots: int) -> int:
    """Replicas per pixel (extra slots working the same pixel on disjoint
    sample ranges) to keep enough lanes in flight on small frames."""
    r = 1
    while r < spp and n_pix * r < min_slots and spp % (r * 2) == 0:
        r *= 2
    return r


def plan_launch(n_pix: int, spp: int, block: int, num_warps: int,
                min_slots: int) -> Launch:
    if block <= 0 or block & (block - 1):
        raise ValueError(f"block must be a power of two, got {block}")
    repl = _pick_replication(n_pix, spp, min_slots)
    n_slots = n_pix * repl
    return Launch(block, num_warps, repl, n_slots, -(-n_slots // block))


def slot_lanes(lp: Launch, nx: int, n_pix: int):
    """This program's lanes: (valid, pix, replica, px, py) per lane."""
    slot = (pl.program_id(0) * lp.block
            + jax.lax.broadcasted_iota(jnp.int32, (lp.block,), 0))
    valid = slot < lp.n_slots
    pix = jnp.where(valid, slot % n_pix, 0)
    replica = jnp.where(valid, slot // n_pix, 0)
    px = (pix % nx).astype(jnp.float32)
    py = (pix // nx).astype(jnp.float32)
    return valid, pix, replica, px, py


def run_while_live(bounce, state0):
    """Bounce until no lane of the program is live, checking every
    LOOP_CHUNK bounces. The live mask rides as int32 so the predicate is a
    max-reduce over the block."""
    def outer_body(st):
        return jax.lax.fori_loop(0, LOOP_CHUNK, lambda _, s: bounce(s), st)

    return jax.lax.while_loop(lambda st: jnp.max(st["live"]) > 0,
                              outer_body, state0)


def launch(kernel, lp: Launch, n_pix: int, interpret: bool, name: str):
    """pallas_call through Triton: kernel(seed_ref, off_ref, a0, a1, a2,
    cnt) writes three per-slot f32 sums and a per-slot ray count. Returns
    fn(base_key, sample_offset) → (acc (n_pix, 3), nrays ())."""
    n_out = lp.n_grid * lp.block
    lane = pl.BlockSpec((lp.block,), lambda i: (i,))
    scalar = pl.BlockSpec((1, 1), lambda i: (0, 0))
    call = pl.pallas_call(
        kernel,
        grid=(lp.n_grid,),
        in_specs=[pl.BlockSpec((1, 2), lambda i: (0, 0)), scalar],
        out_specs=[lane, lane, lane, lane],
        out_shape=[jax.ShapeDtypeStruct((n_out,), jnp.float32)] * 3
        + [jax.ShapeDtypeStruct((n_out,), jnp.int32)],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=lp.num_warps,
                                           num_stages=1),
        interpret=interpret,
        name=name,
    )

    def run(base_key, sample_offset):
        seed = jnp.asarray(base_key, jnp.uint32).reshape(1, 2)
        offa = jnp.asarray(sample_offset, jnp.uint32).reshape(1, 1)
        a0, a1, a2, cnt = call(seed, offa)
        flat = jnp.stack([a0[:lp.n_slots], a1[:lp.n_slots],
                          a2[:lp.n_slots]], axis=-1)
        acc = jnp.sum(flat.reshape(lp.repl, n_pix, 3), axis=0)
        return acc, jnp.sum(cnt[:lp.n_slots])

    return run


def build_renderer(cs, meta, settings, nx: int, ny: int, spp: int,
                   interpret: bool = False):
    """Compile-time closure: returns fn(base_key, sample_offset) →
    (acc (n_pix, 3) f32 summed radiance, nrays ()). Jittable.
    interpret=True runs the kernel in the Pallas interpreter (CPU tests)."""
    static = extract_static(cs, meta)
    n_pix = nx * ny
    max_depth = int(settings.max_depth)
    bg = tuple(float(x) for x in settings.background)
    book = bool(settings.exact_book_cosine)

    lp = plan_launch(n_pix, spp, BLOCK, NUM_WARPS, MIN_SLOTS)
    spp_slot = spp // lp.repl
    shape = (lp.block,)

    cam = static.cam
    prims = static.prims
    mats = static.mats
    lights = static.lights
    sentinel = (0.0, 0.0, 1.0)
    clusters = (build_clusters(prims, cam["origin"])
                if len(prims) >= CLUSTER_MIN_PRIMS else None)

    any_metal = any(m["kind"] == mt.MAT_METAL for m in mats)
    any_diel = any(m["kind"] == mt.MAT_DIELECTRIC for m in mats)
    any_checker = any(m["is_checker"] for m in mats)

    def kernel(seed_ref, off_ref,
               acc_r_ref, acc_g_ref, acc_b_ref, cnt_ref):
        valid, pix, replica, px, py = slot_lanes(lp, nx, n_pix)
        b0 = jnp.full(shape, seed_ref[0, 0], jnp.uint32)
        b1 = jnp.full(shape, seed_ref[0, 1], jnp.uint32)
        off = off_ref[0, 0]

        def make_ray(samp):
            """Fresh camera path for per-slot sample counter `samp`.
            Streams identical to wavefront.sample_to_ray."""
            sid = (replica * spp_slot + samp + off).astype(jnp.uint32)
            s0, s1 = tf.fold_in(b0, b1, sid)
            k0, k1 = tf.fold_in(s0, s1, pix.astype(jnp.uint32))
            c0, c1 = tf.fold_in(k0, k1, jnp.zeros_like(k0))  # depth 0
            c0, c1 = tf.fold_in(c0, c1, jnp.full_like(k0, CAMERA_SALT))
            u = tf.uniforms_n(c0, c1, 5)
            s = (px + u[0]) * jnp.float32(1.0 / nx)
            t = (py + u[1]) * jnp.float32(1.0 / ny)
            # thin lens (camera.go:61-69)
            r = jnp.sqrt(u[2]) * cam["lens_radius"]
            phi = TWO_PI * u[3]
            rdx = r * jnp.cos(phi)
            rdy = r * jnp.sin(phi)
            offset = _add(_scale(_c(cam["u"]), rdx), _scale(_c(cam["v"]), rdy))
            tme = cam["time0"] + u[4] * (cam["time1"] - cam["time0"])
            o = _add(_c(cam["origin"]), offset)
            d = _sub(_sub(_add(_c(cam["lower_left"]),
                               _add(_scale(_c(cam["horizontal"]), s),
                                    _scale(_c(cam["vertical"]), t))),
                          _c(cam["origin"])), offset)
            return o, d, tme, k0, k1

        o0, d0, tme0, k00, k10 = make_ray(jnp.zeros(shape, jnp.int32))
        live0 = valid & (spp_slot > 0)
        zf = jnp.zeros(shape, jnp.float32)
        zi = jnp.zeros(shape, jnp.int32)

        state0 = dict(
            o=o0, d=d0, tme=tme0, k0=k00, k1=k10,
            depth=zi, samp=zi,
            thru=(zf + 1.0, zf + 1.0, zf + 1.0),
            rad=(zf, zf, zf),
            acc=(zf, zf, zf),
            cnt=zi, live=live0.astype(jnp.int32),
        )

        def bounce(st):
            o, d, tme = st["o"], st["d"], st["tme"]
            live = st["live"] != 0
            thru = st["thru"]
            rad = st["rad"]
            cnt = st["cnt"] + live.astype(jnp.int32)

            rec = _intersect_static(prims, o, d, tme, T_MIN, T_MAX,
                                    clusters=clusters)
            hit = rec["hit"]
            nrm = rec["n"]
            p = rec["p"]
            mat_idx = rec["mat"]

            miss = live & ~hit
            rad = _add(rad, _sel(miss, _mul(thru, _c(bg)), (zf, zf, zf)))
            active = live & hit

            # --- material row (static selects over the baked table) ---
            alb = (zf, zf, zf)
            col1 = (zf, zf, zf)
            checker = jnp.zeros_like(hit)
            kindv = jnp.zeros(shape, jnp.int32)
            fuzz = zf
            ref_idx = zf + 1.0
            absorb = (zf, zf, zf)
            has_abs = jnp.zeros_like(hit)
            for mi, mrow in enumerate(mats):
                sel = mat_idx == mi
                alb = _sel(sel, _c(mrow["col0"]), alb)
                kindv = jnp.where(sel, mrow["kind"], kindv)
                if mrow["is_checker"]:
                    col1 = _sel(sel, _c(mrow["col1"]), col1)
                    checker = checker | sel
                if mrow["kind"] == mt.MAT_METAL:
                    fuzz = jnp.where(sel, mrow["fuzz"], fuzz)
                if mrow["kind"] == mt.MAT_DIELECTRIC:
                    ref_idx = jnp.where(sel, mrow["ref_idx"], ref_idx)
                    if mrow["has_absorption"]:
                        absorb = _sel(sel, _c(mrow["absorption"]), absorb)
                        has_abs = has_abs | sel
            if any_checker:
                # 3D sine checker on the hit point (texture/checker.go:26)
                sines = (jnp.sin(10.0 * p[0]) * jnp.sin(10.0 * p[1])
                         * jnp.sin(10.0 * p[2]))
                alb = _sel(checker & (sines >= 0.0), col1, alb)

            facing = _dot(nrm, d) < 0.0
            is_light = kindv == mt.MAT_DIFFUSE_LIGHT
            emit_on = active & is_light & facing
            rad = _add(rad, _sel(emit_on, _mul(thru, alb), (zf, zf, zf)))
            active = active & ~is_light

            # --- bounce uniforms: fold depth, fold salt 0, 12 words ---
            u0_, u1_ = tf.fold_in(st["k0"], st["k1"],
                                  st["depth"].astype(jnp.uint32))
            u0_, u1_ = tf.fold_in(u0_, u1_, jnp.zeros_like(u0_))
            us = tf.uniforms_n(u0_, u1_, 12)

            # --- metal (metal.go:34-40) ---
            if any_metal:
                d_unit = _norm(d)
                refl = _reflect(d_unit, nrm)
                # uniform in unit ball (sampling.random_in_unit_sphere)
                zb = 1.0 - 2.0 * us[0]
                phib = TWO_PI * us[1]
                sb = jnp.sqrt(jnp.maximum(1.0 - zb * zb, 0.0))
                # cbrt via exp/log, as in sampling.random_in_unit_sphere;
                # u ∈ [0,1) so the clamp only moves exact 0 to 1e-10, far
                # below the fuzz scale.
                rb = jnp.exp(jnp.log(jnp.maximum(us[2], 1e-30))
                             * jnp.float32(1.0 / 3.0))
                fv = (sb * jnp.cos(phib) * rb, sb * jnp.sin(phib) * rb,
                      zb * rb)
                d_metal = _add(refl, _scale(fv, fuzz))
            else:
                d_metal = d

            # --- dielectric (dielectric.go:66-102, raw direction) ---
            if any_diel:
                reflected = _reflect(d, nrm)
                d_dot_n = _dot(d, nrm)
                exiting = d_dot_n > 0.0
                outward = _sel(exiting, _scale(nrm, -1.0), nrm)
                ni_over_nt = jnp.where(exiting, ref_idx, 1.0 / ref_idx)
                dlen = jnp.sqrt(_dot(d, d))
                cosine = jnp.where(exiting, ref_idx * d_dot_n / dlen,
                                   -d_dot_n / dlen)
                uvn = _norm(d)
                dt = _dot(uvn, outward)
                disc = 1.0 - ni_over_nt * ni_over_nt * (1.0 - dt * dt)
                can = disc > 0.0
                refr = _sub(_scale(_sub(uvn, _scale(outward, dt)), ni_over_nt),
                            _scale(outward, jnp.sqrt(jnp.maximum(disc, 0.0))))
                r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
                r0 = r0 * r0
                schl = r0 + (1.0 - r0) * jnp.power(1.0 - cosine, 5.0)
                reflect_prob = jnp.where(can, schl, 1.0)
                is_refl = us[3] < reflect_prob
                d_diel = _sel(is_refl, reflected, refr)
                diel_att = (zf + 1.0, zf + 1.0, zf + 1.0)
                if static.has_absorbing:
                    # Beer–Lambert exit re-trace (dielectric.go:118-153)
                    start = _add(p, _scale(d_diel, 1e-3))
                    ex = _intersect_static(prims, start, d_diel, tme,
                                           0.0, 1000.0, want_mat=False,
                                           clusters=clusters)
                    dl = _sub(ex["p"], p)
                    plen = jnp.sqrt(_dot(dl, dl))
                    plen = jnp.clip(plen, 0.1, 100.0)
                    plen = jnp.where(ex["hit"], plen, 10.0)
                    ab = (jnp.exp(-absorb[0] * plen),
                          jnp.exp(-absorb[1] * plen),
                          jnp.exp(-absorb[2] * plen))
                    diel_att = _sel(has_abs & ~is_refl, ab, diel_att)
            else:
                d_diel = d
                diel_att = (zf + 1.0, zf + 1.0, zf + 1.0)

            # --- diffuse NEE mixture (colour.go:48-57) ---
            choose_light = us[4] < 0.5
            d_light = _lights_sample(lights, p, us[5], us[6], us[7], us[8])
            # cosine lobe (pdf/cosine.go; book 2·sqrt(r2) quirk)
            ou, ov, ow = _onb_from_w(nrm)
            scale_q = 2.0 if book else 1.0
            zc = jnp.sqrt(1.0 - us[10])
            phic = TWO_PI * us[9]
            rc = scale_q * jnp.sqrt(us[10])
            local = (jnp.cos(phic) * rc, jnp.sin(phic) * rc, zc)
            d_cos = _add(_add(_scale(ou, local[0]), _scale(ov, local[1])),
                         _scale(ow, local[2]))
            d_diff = _sel(choose_light, d_light, d_cos)
            pdf_light = _lights_pdf(lights, p, d_diff)
            dd_unit = _norm(d_diff)
            nrm_unit = _norm(nrm)
            cos_p = _dot(dd_unit, nrm_unit)
            pdf_cos = jnp.where(cos_p > 0, cos_p / jnp.pi, 0.0)
            pdf_val = 0.5 * pdf_light + 0.5 * pdf_cos
            cos_out = _dot(nrm, dd_unit)
            spdf_cos = jnp.maximum(cos_out, 0.0) / jnp.pi
            diffuse_like = kindv == mt.MAT_LAMBERT
            spdf = jnp.where(diffuse_like, spdf_cos, 0.0)
            ratio = spdf / pdf_val
            diff_mult = _scale(alb, ratio)

            is_metal = kindv == mt.MAT_METAL
            is_diel = kindv == mt.MAT_DIELECTRIC
            d_new = _sel(is_metal, d_metal, _sel(is_diel, d_diel, d_diff))
            mult = _sel(is_metal, alb, _sel(is_diel, diel_att, diff_mult))

            thru = _sel(active, _mul(thru, mult), thru)
            o = _sel(active, p, o)
            d = _sel(active, d_new, d)

            depth = st["depth"] + 1
            capped = active & (depth >= max_depth)
            rad = _add(rad, _sel(capped, _mul(thru, _c(sentinel)),
                                 (zf, zf, zf)))
            active = active & ~capped

            # --- deposit + refill (wavefront.trace_pool body) ---
            died = live & ~active
            # de_nan per component (vec3.DeNAN, render/rgb.go:36)
            contrib = (jnp.where(jnp.isfinite(rad[0]), rad[0], 0.0),
                       jnp.where(jnp.isfinite(rad[1]), rad[1], 0.0),
                       jnp.where(jnp.isfinite(rad[2]), rad[2], 0.0))
            acc = _add(st["acc"], _sel(died, contrib, (zf, zf, zf)))

            samp = jnp.where(died, st["samp"] + 1, st["samp"])
            issue = died & (samp < spp_slot)
            o_n, d_n, t_n, k0n, k1n = make_ray(samp)
            one3 = (zf + 1.0, zf + 1.0, zf + 1.0)
            return dict(
                o=_sel(issue, o_n, o), d=_sel(issue, d_n, d),
                tme=jnp.where(issue, t_n, tme),
                k0=jnp.where(issue, k0n, st["k0"]),
                k1=jnp.where(issue, k1n, st["k1"]),
                depth=jnp.where(issue, 0, depth),
                samp=samp,
                thru=_sel(issue, one3, thru),
                rad=_sel(issue, (zf, zf, zf), rad),
                acc=acc, cnt=cnt,
                live=(active | issue).astype(jnp.int32),
            )

        final = run_while_live(bounce, state0)
        acc_r_ref[...] = final["acc"][0]
        acc_g_ref[...] = final["acc"][1]
        acc_b_ref[...] = final["acc"][2]
        cnt_ref[...] = final["cnt"]

    return launch(kernel, lp, n_pix, interpret, "izpi_megakernel_rgb")
