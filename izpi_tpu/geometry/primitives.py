"""Primitive SoA and batched intersection kernels.

The reference dispatches `Hitable.Hit` virtually per object (internal/hitable).
Here every primitive lives in one flat struct-of-arrays and intersection is a
data-parallel computation over (ray, primitive) pairs — integer-tagged selects
instead of virtual calls, so XLA vectorizes everything.

Primitive kinds:
  0 TRIANGLE  g0=v0, g1=edge1, g2=edge2, g3=geometric normal
  1 RECT      g0=corner, g1=edge1, g2=edge2, g3=unit normal  (axis-aligned
              rects AND their baked rotations/translations — a parallelogram;
              reference: xyrect.go / xzrect.go / yzrect.go)
  2 SPHERE    g0=center0, g1=center1, g2=(radius, time0, time1)
              (reference: sphere.go; center lerps with ray time)
  3 NONE      padding, never hits

Semantics preserved from the reference (these are load-bearing for parity):
- Möller–Trumbore with ε=1e-8 and the -ε..1+ε barycentric tolerance
  (triangle.go:193-231) plus barycentric renormalization.
- Sphere near root: outward normal flipped toward the ray if needed; far
  root: UV from the flipped normal but the *record* normal left unflipped
  (sphere.go:70-100 — a reference quirk).
- Rect hit: plane intersection then parametric inside test; UV is the
  parallelogram parameter, identical to the reference's (x-x0)/(x1-x0) for
  axis-aligned rects.
- Closest hit keeps the *first* primitive in insertion order on exact ties,
  like HitableSlice's strict `t < closest` scan (hitable_slice.go:30-45).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from izpi_tpu.core import vecmath as vm

KIND_TRIANGLE = 0
KIND_RECT = 1
KIND_SPHERE = 2
KIND_NONE = 3

MT_EPS = 1e-8  # Möller–Trumbore epsilon (triangle.go:196)
T_MAX = 3.0e38  # stand-in for math.MaxFloat64 in f32


class Prims(NamedTuple):
    """Flat primitive SoA. All arrays share leading dim P."""

    kind: jax.Array      # (P,) int32
    g0: jax.Array        # (P, 3) f32
    g1: jax.Array        # (P, 3) f32
    g2: jax.Array        # (P, 3) f32
    g3: jax.Array        # (P, 3) f32
    mat_id: jax.Array    # (P,) int32
    flip: jax.Array      # (P,) bool — FlipNormals wrapper (flip_normals.go:27)
    uv: jax.Array        # (P, 6) f32 — (u0,v0,u1,v1,u2,v2) for triangles
    vn: jax.Array        # (P, 9) f32 — per-vertex normals for triangles
    has_vn: jax.Array    # (P,) bool
    tb: jax.Array        # (P, 6) f32 — tangent(3) + bitangent(3) for normal maps

    @property
    def count(self) -> int:
        return self.kind.shape[0]


class Hit(NamedTuple):
    """Batched hit record (the SoA HitRecord, reference:
    internal/hitrecord/hitrecord.go). All arrays share the ray batch shape."""

    t: jax.Array         # (N,)
    u: jax.Array         # (N,)
    v: jax.Array         # (N,)
    p: jax.Array         # (N, 3)
    normal: jax.Array    # (N, 3)
    prim_idx: jax.Array  # (N,) int32, -1 on miss
    mat_id: jax.Array    # (N,) int32, -1 on miss
    hit: jax.Array       # (N,) bool


# --------------------------------------------------------------------------
# Per-kind t-tests. All broadcast: rays (..., 3) against prim fields (..., 3).
# --------------------------------------------------------------------------


def triangle_t(o, d, v0, e1, e2, t_min, t_max):
    """Möller–Trumbore t-only test. Returns (t, hit_mask, bary_u, bary_v)."""
    h = vm.cross(d, e2)
    a = vm.dot(e1, h)
    parallel = jnp.abs(a) < MT_EPS
    f = 1.0 / jnp.where(parallel, 1.0, a)
    s = o - v0
    u = f * vm.dot(s, h)
    q = vm.cross(s, e1)
    v = f * vm.dot(d, q)
    t = f * vm.dot(e2, q)
    ok = (
        (~parallel)
        & (u >= -MT_EPS) & (u <= 1.0 + MT_EPS)
        & (v >= -MT_EPS) & (u + v <= 1.0 + MT_EPS)
        & (t >= t_min) & (t <= t_max)
    )
    return t, ok, u, v


def rect_t(o, d, p0, e1, e2, n, t_min, t_max):
    """Parallelogram test: plane hit then parametric inside test.
    Returns (t, hit_mask, param_u, param_v)."""
    denom = vm.dot(d, n)
    degenerate = denom == 0.0
    t = vm.dot(p0 - o, n) / jnp.where(degenerate, 1.0, denom)
    p = o + t[..., None] * d
    rel = p - p0
    ee1 = vm.squared_length(e1)
    ee2 = vm.squared_length(e2)
    u = vm.dot(rel, e1) / ee1
    v = vm.dot(rel, e2) / ee2
    ok = (
        (~degenerate)
        & (t >= t_min) & (t <= t_max)
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (v <= 1.0)
    )
    return t, ok, u, v


def sphere_center(c0, c1, s_time0, s_time1, time):
    """center0 + ((time-t0)/(t1-t0))·(center1-center0)  (sphere.go:125)."""
    denom = s_time1 - s_time0
    frac = (time - s_time0) / jnp.where(denom == 0.0, 1.0, denom)
    frac = jnp.where(denom == 0.0, 0.0, frac)
    return c0 + frac[..., None] * (c1 - c0)


def sphere_t(o, d, center, radius, t_min, t_max):
    """Sphere quadratic; reference root selection (sphere.go:70-100).
    Returns (t, hit_mask, is_far_root)."""
    oc = o - center
    a = vm.dot(d, d)
    b = vm.dot(oc, d)
    c = vm.dot(oc, oc) - radius * radius
    disc = b * b - a * c
    has = disc > 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    a_safe = jnp.where(a == 0.0, 1.0, a)
    t_near = (-b - sq) / a_safe
    t_far = (-b + sq) / a_safe
    near_ok = has & (t_near < t_max) & (t_near > t_min)
    far_ok = has & (t_far < t_max) & (t_far > t_min) & ~near_ok
    t = jnp.where(near_ok, t_near, t_far)
    ok = near_ok | far_ok
    return t, ok, far_ok


def sphere_uv(p_unit):
    """Polar UV from a unit point on the sphere (sphere.go:29-36)."""
    phi = jnp.arctan2(p_unit[..., 2], p_unit[..., 0])
    theta = jnp.arcsin(jnp.clip(p_unit[..., 1], -1.0, 1.0))
    u = 1.0 - (phi + jnp.pi) / (2.0 * jnp.pi)
    v = (theta + jnp.pi / 2.0) / jnp.pi
    return u, v


# --------------------------------------------------------------------------
# Unified any-kind t test (broadcast over (ray, prim) pairs)
# --------------------------------------------------------------------------


def prim_t(kind, g0, g1, g2, g3, o, d, time, t_min, t_max):
    """t-test for mixed-kind primitive arrays. Shapes broadcast; `time` is the
    per-ray time. Returns (t, hit_mask)."""
    t_tri, ok_tri, _, _ = triangle_t(o, d, g0, g1, g2, t_min, t_max)
    t_rect, ok_rect, _, _ = rect_t(o, d, g0, g1, g2, g3, t_min, t_max)
    radius = g2[..., 0]
    s_t0 = g2[..., 1]
    s_t1 = g2[..., 2]
    center = sphere_center(g0, g1, s_t0, s_t1, time)
    t_sph, ok_sph, _ = sphere_t(o, d, center, radius, t_min, t_max)

    is_tri = kind == KIND_TRIANGLE
    is_rect = kind == KIND_RECT
    is_sph = kind == KIND_SPHERE

    t = jnp.where(is_tri, t_tri, jnp.where(is_rect, t_rect, t_sph))
    ok = (is_tri & ok_tri) | (is_rect & ok_rect) | (is_sph & ok_sph)
    return t, ok


# --------------------------------------------------------------------------
# Brute-force closest hit — the correctness oracle and the fast path for
# small scenes (a dense (N rays × P prims) computation with zero
# divergence).
# --------------------------------------------------------------------------


def intersect_brute(prims: Prims, o, d, time, t_min, t_max, chunk: int = 512):
    """Closest-hit of N rays against all P primitives.

    o, d: (N, 3); time: (N,); returns Hit with full shading record.
    Chunked over primitives to bound the (N, chunk) live set.
    """
    n = o.shape[0]
    p_total = prims.count
    chunk = min(chunk, max(p_total, 1))
    n_chunks = -(-p_total // chunk)
    pad = n_chunks * chunk - p_total

    def padded(x, fill=0):
        if pad == 0:
            return x
        pad_width = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, pad_width, constant_values=fill)

    kind = padded(prims.kind, KIND_NONE)
    g0 = padded(prims.g0)
    g1 = padded(prims.g1)
    g2 = padded(prims.g2)
    g3 = padded(prims.g3)

    o_b = o[:, None, :]
    d_b = d[:, None, :]
    time_b = time[:, None]

    def body(i, carry):
        best_t, best_idx = carry
        sl = i * chunk
        k_c = jax.lax.dynamic_slice_in_dim(kind, sl, chunk)
        g0_c = jax.lax.dynamic_slice_in_dim(g0, sl, chunk)
        g1_c = jax.lax.dynamic_slice_in_dim(g1, sl, chunk)
        g2_c = jax.lax.dynamic_slice_in_dim(g2, sl, chunk)
        g3_c = jax.lax.dynamic_slice_in_dim(g3, sl, chunk)

        t, ok = prim_t(
            k_c[None, :], g0_c[None], g1_c[None], g2_c[None], g3_c[None],
            o_b, d_b, time_b, t_min, t_max,
        )  # (N, chunk)
        t = jnp.where(ok, t, T_MAX)
        # First-minimum within chunk preserves insertion order on ties.
        arg = jnp.argmin(t, axis=1)
        tmin_c = jnp.take_along_axis(t, arg[:, None], axis=1)[:, 0]
        idx_c = sl + arg
        better = tmin_c < best_t
        best_t = jnp.where(better, tmin_c, best_t)
        best_idx = jnp.where(better, idx_c, best_idx)
        return best_t, best_idx

    # Derive carry inits from the (possibly device-varying) ray arrays so the
    # loop carry keeps shard_map's varying-manual-axes type (plain constants
    # would be "unvarying" and fail the carry type check under shard_map).
    zero = o[:, 0] * 0.0
    init = (zero + T_MAX, zero.astype(jnp.int32) - 1)
    best_t, best_idx = jax.lax.fori_loop(0, n_chunks, body, init)
    hit = best_idx >= 0
    return finalize_hit(prims, o, d, time, best_t, best_idx.astype(jnp.int32), hit)


def finalize_hit(prims: Prims, o, d, time, t, idx, hit) -> Hit:
    """Recompute the full shading record for the winning primitive per ray.

    The per-prim fields are packed into ONE (P, 32) f32 row and gathered
    with a single row lookup per ray: big-table gathers on this backend are
    index-count bound (~13 ns/lookup regardless of payload width,
    docs/PERF.md round 4), so one 32-wide row gather costs what one scalar
    gather does — the previous ten per-field gathers cost ~10x that at
    dragon scale. The pack itself is loop-invariant (prims don't change
    across bounces) and hoists out of the wavefront while-loop.
    """
    idx_safe = jnp.maximum(idx, 0)
    packed = jnp.concatenate([
        prims.g0, prims.g1, prims.g2, prims.g3,            # 0:12
        prims.uv, prims.vn,                                # 12:18, 18:27
        prims.kind.astype(jnp.float32)[:, None],           # 27
        prims.has_vn.astype(jnp.float32)[:, None],         # 28
        prims.flip.astype(jnp.float32)[:, None],           # 29
        prims.mat_id.astype(jnp.float32)[:, None],         # 30
        jnp.zeros((prims.kind.shape[0], 1), jnp.float32),  # pad to 32
    ], axis=1)
    row = packed[idx_safe]
    g0 = row[..., 0:3]
    g1 = row[..., 3:6]
    g2 = row[..., 6:9]
    g3 = row[..., 9:12]
    uv6 = row[..., 12:18]
    vn9 = row[..., 18:27]
    kind = row[..., 27].astype(jnp.int32)
    has_vn = row[..., 28] != 0.0
    flip = row[..., 29] != 0.0
    mat_id = jnp.where(hit, row[..., 30].astype(jnp.int32), -1)

    p = o + t[..., None] * d

    # Triangle record (recompute barycentrics at the known t).
    _, _, bu, bv = triangle_t(o, d, g0, g1, g2, -T_MAX, T_MAX)
    bw = 1.0 - bu - bv
    s = bu + bv + bw
    renorm = jnp.abs(s - 1.0) > MT_EPS
    s_safe = jnp.where(s == 0.0, 1.0, s)
    bu = jnp.where(renorm, bu / s_safe, bu)
    bv = jnp.where(renorm, bv / s_safe, bv)
    bw = jnp.where(renorm, bw / s_safe, bw)
    tri_u = bw * uv6[..., 0] + bu * uv6[..., 2] + bv * uv6[..., 4]
    tri_v = bw * uv6[..., 1] + bu * uv6[..., 3] + bv * uv6[..., 5]
    vn_interp = (
        bw[..., None] * vn9[..., 0:3]
        + bu[..., None] * vn9[..., 3:6]
        + bv[..., None] * vn9[..., 6:9]
    )
    tri_n = jnp.where(
        has_vn[..., None], vm.safe_normalize(vn_interp), g3
    )

    # Rect record.
    _, _, ru, rv = rect_t(o, d, g0, g1, g2, g3, -T_MAX, T_MAX)
    rect_n = g3

    # Sphere record.
    radius = g2[..., 0]
    center = sphere_center(g0, g1, g2[..., 1], g2[..., 2], time)
    _, _, far_root = sphere_t(o, d, center, radius, 1e-3, T_MAX)
    r_safe = jnp.where(radius == 0.0, 1.0, radius)
    outward = (p - center) / r_safe[..., None]
    flip_n = vm.dot(d, outward) >= 0.0
    flipped = jnp.where(flip_n[..., None], -outward, outward)
    # UV always from the flipped normal; record normal unflipped on the far
    # root (sphere.go:88-99 quirk).
    sph_u, sph_v = sphere_uv(flipped)
    sph_n = jnp.where(far_root[..., None], outward, flipped)

    is_tri = kind == KIND_TRIANGLE
    is_rect = kind == KIND_RECT
    u = jnp.where(is_tri, tri_u, jnp.where(is_rect, ru, sph_u))
    v = jnp.where(is_tri, tri_v, jnp.where(is_rect, rv, sph_v))
    n = jnp.where(
        is_tri[..., None], tri_n, jnp.where(is_rect[..., None], rect_n, sph_n)
    )
    n = jnp.where(flip[..., None], -n, n)

    return Hit(
        t=t, u=u, v=v, p=p, normal=n,
        prim_idx=jnp.where(hit, idx, -1), mat_id=mat_id, hit=hit,
    )


# --------------------------------------------------------------------------
# Gather-free unrolled closest hit for small scenes.
#
# finalize_hit's per-field gathers dominated small-scene intersection on
# the previous accelerator; argmin/take_along_axis over a tiny (N, P) minor
# axis is similarly mis-laid-out. For P <= ~64 the whole closest-hit
# unrolls over the primitives with every constant baked as an XLA
# immediate — pure (N,)-planar elementwise work, zero gathers, zero
# argmins — the XLA-level sibling of the Pallas megakernel's _scan_prims.
# --------------------------------------------------------------------------


UNROLL_MAX_PRIMS = 64


def make_unrolled_intersector(prims: Prims, host: Optional[Prims] = None):
    """IntersectFn over python-unrolled per-primitive tests (P small).

    Semantics identical to intersect_brute + finalize_hit: strict `t <
    best_t` keeps the first primitive on ties (hitable_slice.go:30-45), the
    record pass recomputes u/v/normal with finalize_hit's fixed windows,
    including the sphere far-root normal quirk (sphere.go:88-99)."""
    import numpy as np

    if host is None:
        from izpi_tpu.scene import compiler as compiler_mod

        host = compiler_mod.host_prims_for(prims)
    if host is None:
        host = Prims(*jax.device_get(list(prims)))
    kind = np.asarray(host.kind)
    g0 = np.asarray(host.g0, np.float64)
    g1 = np.asarray(host.g1, np.float64)
    g2 = np.asarray(host.g2, np.float64)
    g3 = np.asarray(host.g3, np.float64)
    uv = np.asarray(host.uv, np.float64)
    vn = np.asarray(host.vn, np.float64)
    has_vn = np.asarray(host.has_vn)
    flip = np.asarray(host.flip)
    mat_id = np.asarray(host.mat_id)
    p_total = kind.shape[0]
    assert p_total <= UNROLL_MAX_PRIMS, p_total

    def c3(a):
        return jnp.asarray(np.asarray(a, np.float32))

    def _sphere_center_i(i, time):
        st0, st1 = float(g2[i, 1]), float(g2[i, 2])
        if np.array_equal(g0[i], g1[i]) or st0 == st1:
            return c3(g0[i])[None, :]
        frac = (time - st0) / (st1 - st0)
        return c3(g0[i])[None, :] + frac[:, None] * (c3(g1[i] - g0[i])[None, :])

    def intersect(o, d, time, t_min, t_max):
        zero = o[:, 0] * 0.0
        t_cap = jnp.minimum(jnp.asarray(t_max, jnp.float32), T_MAX)
        best_t = zero + t_cap
        best_i = zero.astype(jnp.int32) - 1

        for i in range(p_total):
            k = int(kind[i])
            if k == KIND_TRIANGLE:
                t, ok, _, _ = triangle_t(o, d, c3(g0[i]), c3(g1[i]),
                                         c3(g2[i]), t_min, best_t)
            elif k == KIND_RECT:
                t, ok, _, _ = rect_t(o, d, c3(g0[i]), c3(g1[i]), c3(g2[i]),
                                     c3(g3[i]), t_min, best_t)
            elif k == KIND_SPHERE:
                center = _sphere_center_i(i, time)
                t, ok, _ = sphere_t(o, d, center, float(g2[i, 0]),
                                    t_min, best_t)
            else:
                continue
            better = ok & (t < best_t)
            best_t = jnp.where(better, t, best_t)
            best_i = jnp.where(better, i, best_i)

        hit = best_i >= 0
        p = o + best_t[:, None] * d
        u = zero
        v = zero
        nrm = o * 0.0
        mat = jnp.full_like(best_i, -1)

        # Record pass: finalize_hit's formulas with baked constants.
        for i in range(p_total):
            sel = best_i == i
            k = int(kind[i])
            if k == KIND_TRIANGLE:
                _, _, bu, bv = triangle_t(o, d, c3(g0[i]), c3(g1[i]),
                                          c3(g2[i]), -T_MAX, T_MAX)
                bw = 1.0 - bu - bv
                s = bu + bv + bw
                renorm = jnp.abs(s - 1.0) > MT_EPS
                s_safe = jnp.where(s == 0.0, 1.0, s)
                bu_r = jnp.where(renorm, bu / s_safe, bu)
                bv_r = jnp.where(renorm, bv / s_safe, bv)
                bw_r = jnp.where(renorm, bw / s_safe, bw)
                u_i = (bw_r * float(uv[i, 0]) + bu_r * float(uv[i, 2])
                       + bv_r * float(uv[i, 4]))
                v_i = (bw_r * float(uv[i, 1]) + bu_r * float(uv[i, 3])
                       + bv_r * float(uv[i, 5]))
                if bool(has_vn[i]):
                    n_i = vm.safe_normalize(
                        bw_r[:, None] * c3(vn[i, 0:3])[None, :]
                        + bu_r[:, None] * c3(vn[i, 3:6])[None, :]
                        + bv_r[:, None] * c3(vn[i, 6:9])[None, :])
                else:
                    n_i = jnp.broadcast_to(c3(g3[i])[None, :], o.shape)
            elif k == KIND_RECT:
                _, _, u_i, v_i = rect_t(o, d, c3(g0[i]), c3(g1[i]),
                                        c3(g2[i]), c3(g3[i]), -T_MAX, T_MAX)
                n_i = jnp.broadcast_to(c3(g3[i])[None, :], o.shape)
            elif k == KIND_SPHERE:
                center = _sphere_center_i(i, time)
                radius = float(g2[i, 0])
                _, _, far = sphere_t(o, d, center, radius, 1e-3, T_MAX)
                r_safe = radius if radius != 0.0 else 1.0
                outward = (p - center) * (1.0 / r_safe)
                flip_n = vm.dot(d, outward) >= 0.0
                flipped = jnp.where(flip_n[:, None], -outward, outward)
                u_i, v_i = sphere_uv(flipped)
                n_i = jnp.where(far[:, None], outward, flipped)
            else:
                continue
            if bool(flip[i]):
                n_i = -n_i
            u = jnp.where(sel, u_i, u)
            v = jnp.where(sel, v_i, v)
            nrm = jnp.where(sel[:, None], n_i, nrm)
            mat = jnp.where(sel, int(mat_id[i]), mat)

        return Hit(t=best_t, u=u, v=v, p=p, normal=nrm,
                   prim_idx=jnp.where(hit, best_i, -1), mat_id=mat, hit=hit)

    return intersect
