"""Matrix-form brute-force intersection.

This module rewrites the ray×primitive t-tests as ONE batched matrix
product per primitive chunk:

    A = F @ K,   F = [o, d, o×d, 1] ∈ (N, 10),   K ∈ (10, 6·P)

using the multilinearity of the scalar triple products in Möller–Trumbore:
    a   = det[e1, d, e2]            =  d·(e2×e1)
    u·a = det[o−v0, d, e2]          =  (o×d)·e2 + d·(v0×e2)
    v·a = det[d, o−v0, e1]          = −(o×d)·e1 − d·(v0×e1)
    t·a = det[e2, o−v0, e1]         =  o·(e1×e2) − v0·(e1×e2)
(rects: plane/param dots against n, e1/|e1|², e2/|e2|²; static spheres:
center dots; moving spheres fall back to the elementwise path — their
center depends on the per-ray time, which breaks the shared-matrix
factorization).

Only the O(N·P) reduction work changes form; the algebra is identical to
primitives.triangle_t/rect_t/sphere_t up to fp reassociation, so results
agree to ~1e-6 relative — covered by differential tests.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from izpi_tpu.core import vecmath as vm
from izpi_tpu.geometry import primitives as prim


class MxuTables(NamedTuple):
    k: jax.Array            # (10, P, 6) f32 feature matrix
    kind: jax.Array         # (P,) int32
    moving_idx: jax.Array   # (Pm,) int32 — moving spheres (elementwise)
    sph_r2: jax.Array       # (P,) radius² for spheres (0 otherwise)


def build_tables(prims: prim.Prims) -> MxuTables:
    """Host-side construction of the per-primitive feature matrix."""
    kind = np.asarray(prims.kind)
    g0 = np.asarray(prims.g0, np.float64)
    g1 = np.asarray(prims.g1, np.float64)
    g2 = np.asarray(prims.g2, np.float64)
    g3 = np.asarray(prims.g3, np.float64)
    p = kind.shape[0]

    k = np.zeros((10, p, 6), np.float64)
    sph_r2 = np.zeros(p, np.float64)
    moving = []

    for i in range(p):
        if kind[i] == prim.KIND_TRIANGLE:
            v0, e1, e2 = g0[i], g1[i], g2[i]
            n_u = np.cross(e1, e2)
            # col 0: a — d block gets e2×e1
            k[3:6, i, 0] = np.cross(e2, e1)
            # col 1: u·a — (o×d) block gets e2; d block gets v0×e2
            k[6:9, i, 1] = e2
            k[3:6, i, 1] = np.cross(v0, e2)
            # col 2: v·a — (o×d) block gets −e1; d block gets −(v0×e1)
            k[6:9, i, 2] = -e1
            k[3:6, i, 2] = -np.cross(v0, e1)
            # col 3: t·a — o block gets n_u; const gets −v0·n_u
            k[0:3, i, 3] = n_u
            k[9, i, 3] = -float(v0 @ n_u)
        elif kind[i] == prim.KIND_RECT:
            p0, e1, e2, n = g0[i], g1[i], g2[i], g3[i]
            e1h = e1 / float(e1 @ e1)
            e2h = e2 / float(e2 @ e2)
            # col 0: d·n ; col 1: (p0−o)·n
            k[3:6, i, 0] = n
            k[0:3, i, 1] = -n
            k[9, i, 1] = float(p0 @ n)
            # col 2: d·ê1 ; col 3: (o−p0)·ê1
            k[3:6, i, 2] = e1h
            k[0:3, i, 3] = e1h
            k[9, i, 3] = -float(p0 @ e1h)
            # col 4: d·ê2 ; col 5: (o−p0)·ê2
            k[3:6, i, 4] = e2h
            k[0:3, i, 5] = e2h
            k[9, i, 5] = -float(p0 @ e2h)
        elif kind[i] == prim.KIND_SPHERE:
            c0, c1 = g0[i], g1[i]
            radius = g2[i, 0]
            if not np.allclose(c0, c1):
                moving.append(i)
                continue
            # col 0: c·d ; col 1: c·o ; col 2 const: |c|²
            k[3:6, i, 0] = c0
            k[0:3, i, 1] = c0
            k[9, i, 2] = float(c0 @ c0)
            sph_r2[i] = radius * radius

    return MxuTables(
        k=jnp.asarray(k, jnp.float32),
        kind=jnp.asarray(kind, jnp.int32),
        moving_idx=jnp.asarray(np.asarray(moving, np.int64), jnp.int32),
        sph_r2=jnp.asarray(sph_r2, jnp.float32),
    )


def _chunk_t(tables: MxuTables, sl: int, chunk: int, f, o, d, t_min, t_max):
    """t-test for one primitive chunk via the shared matmul.
    f: (N, 10); returns (t (N,C), ok (N,C))."""
    kc = jax.lax.dynamic_slice_in_dim(tables.k, sl, chunk, axis=1)
    kind = jax.lax.dynamic_slice_in_dim(tables.kind, sl, chunk)
    r2 = jax.lax.dynamic_slice_in_dim(tables.sph_r2, sl, chunk)

    # precision=HIGHEST: reduced-precision products (bf16 passes, or TF32
    # on a GPU) flip near-tangent hit decisions (small spheres in
    # Shirley-scale scenes went visibly dark), so the product runs in f32.
    a_mat = jnp.einsum("nf,fpc->npc", f, kc,
                       precision=jax.lax.Precision.HIGHEST,
                       preferred_element_type=jnp.float32)  # (N, C, 6)

    # ---- triangles (same epsilon semantics as primitives.triangle_t) ----
    det = a_mat[..., 0]
    parallel = jnp.abs(det) < prim.MT_EPS
    inv = 1.0 / jnp.where(parallel, 1.0, det)
    u = a_mat[..., 1] * inv
    v = a_mat[..., 2] * inv
    t_tri = a_mat[..., 3] * inv
    ok_tri = (
        (~parallel)
        & (u >= -prim.MT_EPS) & (u <= 1.0 + prim.MT_EPS)
        & (v >= -prim.MT_EPS) & (u + v <= 1.0 + prim.MT_EPS)
        & (t_tri >= t_min) & (t_tri <= t_max)
    )

    # ---- rects ----
    den = a_mat[..., 0]
    degenerate = den == 0.0
    t_rect = a_mat[..., 1] / jnp.where(degenerate, 1.0, den)
    ur = a_mat[..., 3] + t_rect * a_mat[..., 2]
    vr = a_mat[..., 5] + t_rect * a_mat[..., 4]
    ok_rect = (
        (~degenerate)
        & (t_rect >= t_min) & (t_rect <= t_max)
        & (ur >= 0.0) & (ur <= 1.0) & (vr >= 0.0) & (vr <= 1.0)
    )

    # ---- static spheres ----
    o_dot_d = vm.dot(o, d)[:, None]
    o_dot_o = vm.squared_length(o)[:, None]
    d_dot_d = vm.squared_length(d)[:, None]
    b = o_dot_d - a_mat[..., 0]                    # (o−c)·d
    c_term = o_dot_o - 2.0 * a_mat[..., 1] + a_mat[..., 2] - r2[None, :]
    disc = b * b - d_dot_d * c_term
    has = disc > 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    a_safe = jnp.where(d_dot_d == 0.0, 1.0, d_dot_d)
    t_near = (-b - sq) / a_safe
    t_far = (-b + sq) / a_safe
    near_ok = has & (t_near < t_max) & (t_near > t_min)
    far_ok = has & (t_far < t_max) & (t_far > t_min) & ~near_ok
    t_sph = jnp.where(near_ok, t_near, t_far)
    ok_sph = near_ok | far_ok

    kindb = kind[None, :]
    t = jnp.where(kindb == prim.KIND_TRIANGLE, t_tri,
                  jnp.where(kindb == prim.KIND_RECT, t_rect, t_sph))
    ok = ((kindb == prim.KIND_TRIANGLE) & ok_tri) \
        | ((kindb == prim.KIND_RECT) & ok_rect) \
        | ((kindb == prim.KIND_SPHERE) & ok_sph)
    return t, ok


def make_intersector(prims: prim.Prims, tables: MxuTables,
                     chunk: int = 512):
    """Closest-hit intersector using the matrix tables; returns the same Hit
    as primitives.intersect_brute."""
    p_total = int(prims.count)
    n_moving = int(tables.moving_idx.shape[0])
    chunk = min(chunk, max(p_total, 1))
    n_chunks = -(-p_total // chunk)
    pad = n_chunks * chunk - p_total

    if pad:
        k_pad = jnp.pad(tables.k, ((0, 0), (0, pad), (0, 0)))
        kind_pad = jnp.pad(tables.kind, (0, pad),
                           constant_values=prim.KIND_NONE)
        r2_pad = jnp.pad(tables.sph_r2, (0, pad))
        tables = tables._replace(k=k_pad, kind=kind_pad, sph_r2=r2_pad)

    def intersect(o, d, time, t_min, t_max):
        f = jnp.concatenate(
            [o, d, vm.cross(o, d), jnp.ones_like(o[:, :1])], axis=1)

        t_cap = jnp.minimum(jnp.asarray(t_max, jnp.float32), prim.T_MAX)
        zero = o[:, 0] * 0.0
        best_t = zero + t_cap
        best_idx = zero.astype(jnp.int32) - 1

        def body(i, carry):
            best_t, best_idx = carry
            sl = i * chunk
            t, ok = _chunk_t(tables, sl, chunk, f, o, d, t_min, best_t[:, None])
            t = jnp.where(ok, t, prim.T_MAX)
            arg = jnp.argmin(t, axis=1)
            tmin_c = jnp.take_along_axis(t, arg[:, None], axis=1)[:, 0]
            idx_c = sl + arg
            better = tmin_c < best_t
            return (jnp.where(better, tmin_c, best_t),
                    jnp.where(better, idx_c, best_idx))

        best_t, best_idx = jax.lax.fori_loop(0, n_chunks, body,
                                             (best_t, best_idx))

        if n_moving:
            # Moving spheres: per-ray centers, elementwise over the few.
            mi = tables.moving_idx
            t_m, ok_m = prim.prim_t(
                prims.kind[mi][None, :], prims.g0[mi][None],
                prims.g1[mi][None], prims.g2[mi][None], prims.g3[mi][None],
                o[:, None, :], d[:, None, :], time[:, None],
                t_min, best_t[:, None],
            )
            t_m = jnp.where(ok_m, t_m, prim.T_MAX)
            arg = jnp.argmin(t_m, axis=1)
            tmin_m = jnp.take_along_axis(t_m, arg[:, None], axis=1)[:, 0]
            idx_m = mi[arg]
            better = tmin_m < best_t
            best_t = jnp.where(better, tmin_m, best_t)
            best_idx = jnp.where(better, idx_m, best_idx)

        hit = best_idx >= 0
        return prim.finalize_hit(prims, o, d, time, best_t, best_idx, hit)

    return intersect
