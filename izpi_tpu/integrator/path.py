"""Path-tracing estimator core + the lockstep reference integrator.

`bounce_rgb` / `bounce_spectral` advance a ray batch one bounce — the single
shared implementation used by the lockstep oracle (`trace`, the analog of the
reference's recursive sampler internal/sampler/colour.go:33-65 /
spectral.go:47-80), the persistent-pool wavefront scheduler
(izpi_tpu.integrator.wavefront), and the differentiable fixed-depth scan.

Estimator identity with the reference (colour.go:44-57):
    L = Σ_k T_k·emitted_k (+ T·background on miss, + T·(0,0,1) at depth cap)
    T_{k+1} = T_k · attenuation · ScatteringPDF / pdfValue   (diffuse)
    T_{k+1} = T_k · attenuation                              (specular)
Division by a zero pdf produces Inf/NaN that the caller's DeNAN zeroes,
exactly like the Go chain (vec3.DeNAN at render/rgb.go:36).

Quirks preserved for converged-image parity:
- depth-cap sentinel {Z:1} (colour.go:34-36),
- book cosine sampling with its 2·sqrt(r2) factor (vec3.go:119),
- one-sided lights keyed on the *record* normal (diffuselight.go:49-63),
- isotropic's ScatteringPDF()==0 (isotropic.go:54),
- unnormalized scattered directions (colour.go:50),
- PBR's double normal mapping (triangle TBN map in triangle.go:234-248, then
  the ad-hoc tangent frame again in pbr.go:65-91 with z left unremapped),
  fresnel = 0.04+0.96(1-cosθ)^5 + 0.5·metalness, P(spec)=fresnel·(1-rough)
  (pbr.go:123-137), cosine mixture PDF on the PBR-mapped normal but
  ScatteringPDF on the record normal (pbr.go:150,249).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, Tuple

import jax
import jax.numpy as jnp

from izpi_tpu.core import rng, sampling
from izpi_tpu.core import vecmath as vm
from izpi_tpu.geometry import primitives as prim
from izpi_tpu.integrator import lights as lights_mod
from izpi_tpu.materials import spectral_eval
from izpi_tpu.materials import tables as mt
from izpi_tpu.texture import tables as tex_tables

if TYPE_CHECKING:  # avoid a circular import with scene.compiler
    from izpi_tpu.scene.compiler import CompiledScene, SceneMeta

T_MIN = 1e-3  # world-hit epsilon (colour.go:40)


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static integrator configuration (the renderer-level knobs the
    reference passes into render.New, renderer.go:73)."""

    max_depth: int = 50
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    exact_book_cosine: bool = True


IntersectFn = Callable[..., prim.Hit]


def make_brute_intersector(cs: "CompiledScene") -> IntersectFn:
    def intersect(o, d, time, t_min, t_max):
        return prim.intersect_brute(cs.prims, o, d, time, t_min, t_max)

    return intersect


def _gather_mat(cs, mat_id):
    """One packed-row gather instead of nine per-field gathers: the pool
    body's sequential gathers serialize at ~0.3-0.5 ms each on this backend
    (docs/PERF.md), so the per-bounce gather COUNT is the cost. The (M, 11)
    pack is loop-invariant (XLA hoists it out of the bounce loop); int/bool
    fields ride as exact f32 (all values < 2^24). Gradients to fuzz and
    absorption flow through the pack (differentiable path)."""
    safe = jnp.maximum(mat_id, 0)
    m = cs.materials
    f32 = lambda x: x.astype(jnp.float32)  # noqa: E731
    packed = jnp.stack([
        f32(m.kind), f32(m.tex_albedo), m.fuzz, m.ref_idx,
        m.absorption[:, 0], m.absorption[:, 1], m.absorption[:, 2],
        f32(m.has_absorption), f32(m.tex_rough), f32(m.tex_metal),
        f32(m.tex_normal), f32(m.combo_id),
    ], axis=1)
    row = packed[safe]
    i32 = lambda c: row[:, c].astype(jnp.int32)  # noqa: E731
    return {
        "kind": i32(0),
        "tex_albedo": i32(1),
        "fuzz": row[:, 2],
        "ref_idx": row[:, 3],
        "absorption": row[:, 4:7],
        "has_absorption": row[:, 7] > 0.5,
        "tex_rough": i32(8),
        "tex_metal": i32(9),
        "tex_normal": i32(10),
        "combo_id": i32(11),
    }


def _gather_mat_spectral(cs, mat_id):
    """Spectral variant of the packed material gather: one (M, 24) row."""
    safe = jnp.maximum(mat_id, 0)
    m = cs.materials
    f32 = lambda x: x.astype(jnp.float32)  # noqa: E731
    packed = jnp.stack([
        f32(m.kind), f32(m.tex_albedo), m.fuzz, m.ref_idx,
        m.absorption[:, 0], m.absorption[:, 1], m.absorption[:, 2],
        f32(m.has_absorption), f32(m.tex_rough), f32(m.tex_metal),
        f32(m.tex_normal),
        f32(m.combo_id),
        f32(m.spec_albedo_id),
        m.spec_albedo_gauss[:, 0], m.spec_albedo_gauss[:, 1],
        m.spec_albedo_gauss[:, 2],
        f32(m.spec_ref_idx_id), f32(m.spec_absorb_id), f32(m.spec_checker),
        f32(m.spec_albedo_id2),
        m.spec_albedo_gauss2[:, 0], m.spec_albedo_gauss2[:, 1],
        m.spec_albedo_gauss2[:, 2],
        f32(m.spec_albedo_uplift),
    ], axis=1)
    row = packed[safe]
    i32 = lambda c: row[:, c].astype(jnp.int32)  # noqa: E731
    return {
        "kind": i32(0),
        "tex_albedo": i32(1),
        "fuzz": row[:, 2],
        "ref_idx": row[:, 3],
        "absorption": row[:, 4:7],
        "has_absorption": row[:, 7] > 0.5,
        "tex_rough": i32(8),
        "tex_metal": i32(9),
        "tex_normal": i32(10),
        "combo_id": i32(11),
        "spec_albedo_id": i32(12),
        "spec_albedo_gauss": row[:, 13:16],
        "spec_ref_idx_id": i32(16),
        "spec_absorb_id": i32(17),
        "spec_checker": row[:, 18] > 0.5,
        "spec_albedo_id2": i32(19),
        "spec_albedo_gauss2": row[:, 20:23],
        "spec_albedo_uplift": row[:, 23] > 0.5,
    }


def _dielectric_scatter(o_dir, normal, ref_idx, u_reflect):
    """Schlick-probabilistic reflect/refract (dielectric.go:66-102).
    Works on the RAW (unnormalized) incoming direction like the reference.
    Returns (new_dir, is_reflected)."""
    reflected = vm.reflect(o_dir, normal)
    d_dot_n = vm.dot(o_dir, normal)
    exiting = d_dot_n > 0.0
    outward = jnp.where(exiting[..., None], -normal, normal)
    ni_over_nt = jnp.where(exiting, ref_idx, 1.0 / ref_idx)
    dlen = vm.length(o_dir)
    cosine = jnp.where(
        exiting, ref_idx * d_dot_n / dlen, -d_dot_n / dlen
    )
    refracted, can_refract = vm.refract(o_dir, outward, ni_over_nt)
    reflect_prob = jnp.where(can_refract, vm.schlick(cosine, ref_idx), 1.0)
    is_reflected = u_reflect < reflect_prob
    new_dir = jnp.where(is_reflected[..., None], reflected, refracted)
    return new_dir, is_reflected


def _apply_media(cs, meta, rec: prim.Hit, o, d, time, keys, depth):
    """Stochastic participating-media hits (constant_medium.go:36-66).

    For each compiled medium: find the boundary entry/exit span along the
    ray, draw an exponential free-flight distance -ln(U)/ρ, and if it lands
    inside the span before the current closest surface, the medium wins the
    closest-hit with the arbitrary record normal (1,0,0) and the Isotropic
    phase material. One deliberate deviation from the reference: its
    `rec2t = tMax` clamp (constant_medium.go:46-48, an inverted comparison)
    extends every medium infinitely behind its boundary and makes results
    depend on HitableSlice scan order; we use the clearly-intended
    min(exit, closest) span instead.
    """
    n_media = meta.n_media
    u_med = rng.bounce_uniforms_perray(keys, depth, n_media, salt=0x4D45)
    d_len = vm.length(d)
    cur_t = jnp.where(rec.hit, rec.t, prim.T_MAX)

    t = rec.t
    hit = rec.hit
    mat_id = rec.mat_id
    normal = rec.normal
    p = rec.p
    u = rec.u
    v = rec.v
    prim_idx = rec.prim_idx

    for m in range(n_media):
        rot = cs.media.rot_w2o[m]
        trans = cs.media.trans[m]
        o_obj = jnp.matmul(o - trans[None, :], rot.T,
                           precision=jax.lax.Precision.HIGHEST)
        d_obj = jnp.matmul(d, rot.T, precision=jax.lax.Precision.HIGHEST)
        if meta.media_is_sphere[m]:  # static scene fact
            center = cs.media.p0[m][None, :]
            radius = cs.media.p1[m][0]
            oc = o_obj - center
            a = vm.dot(d_obj, d_obj)
            bq = vm.dot(oc, d_obj)
            c = vm.dot(oc, oc) - radius * radius
            disc = bq * bq - a * c
            ok = disc > 0.0
            sq = jnp.sqrt(jnp.maximum(disc, 0.0))
            a_safe = jnp.where(a == 0.0, 1.0, a)
            t1 = (-bq - sq) / a_safe
            t2 = (-bq + sq) / a_safe
        else:
            lo = cs.media.p0[m][None, :]
            hi = cs.media.p1[m][None, :]
            inv = 1.0 / d_obj
            ta = (lo - o_obj) * inv
            tb = (hi - o_obj) * inv
            near = jnp.minimum(ta, tb)
            far = jnp.maximum(ta, tb)
            t1 = jnp.max(near, axis=-1)
            t2 = jnp.min(far, axis=-1)
            ok = t2 > t1

        rec1t = jnp.maximum(t1, T_MIN)
        rec2t = jnp.minimum(t2, cur_t)
        ok = ok & (rec1t < rec2t)
        rec1t = jnp.maximum(rec1t, 0.0)
        dist_inside = (rec2t - rec1t) * d_len
        hit_dist = -(1.0 / cs.media.density[m]) * jnp.log(
            jnp.maximum(u_med[:, m], 1e-12))
        t_med = rec1t + hit_dist / d_len
        med_hit = ok & (hit_dist < dist_inside)
        better = med_hit & (t_med < cur_t)

        t = jnp.where(better, t_med, t)
        cur_t = jnp.minimum(cur_t, jnp.where(better, t_med, cur_t))
        hit = hit | better
        mat_id = jnp.where(better, cs.media.mat_id[m], mat_id)
        normal = jnp.where(
            better[:, None],
            jnp.array([1.0, 0.0, 0.0], jnp.float32)[None, :], normal)
        p = jnp.where(better[:, None], o + t_med[:, None] * d, p)
        u = jnp.where(better, 0.0, u)
        v = jnp.where(better, 0.0, v)
        prim_idx = jnp.where(better, -1, prim_idx)

    return prim.Hit(t=t, u=u, v=v, p=p, normal=normal, prim_idx=prim_idx,
                    mat_id=mat_id, hit=hit)


def _eval_tex(cs, meta, tex_id, u, v, p):
    return tex_tables.eval_rgb(
        cs.textures, tex_id, u, v, p,
        has_checker=meta.has_checker, has_image=meta.has_image,
        has_noise=meta.has_noise,
        shard_axis=getattr(meta, "tex_shard_axis", None),
    )


def _mean3(rgb):
    return (rgb[..., 0] + rgb[..., 1] + rgb[..., 2]) / 3.0


def _eval_pbr_texs(cs, meta, mat, rec, differentiable: bool = False):
    """The four per-bounce material texture lookups (albedo + normal +
    roughness + metalness) via ONE big-table gather: big-table gathers are
    index-count bound at ~13 ns/lookup on this backend regardless of
    payload width (docs/PERF.md round 4 — the 4N form was 10.4 of pbr_ibl's
    12.8 ms bounce), so the compiler bakes each material's image maps into
    an 8-channel combined row (scene/compiler.py) and the bounce gathers it
    once. Non-image slots (constant/checker/noise) come from the generic
    evaluator with the image branch compiled out. Returns
    (albedo (N,3), normal_rgb (N,3), rough (N,), metal (N,)) — rough/metal
    already mean3'd (pbr.go:109-116 samples then averages; the bake stores
    the per-texel mean, which is the same value).

    differentiable=True keeps the generic 4N image path: texture images
    are trainable parameters and the baked stack carries no gradients."""
    n = rec.u.shape[0]
    tex = cs.textures
    shard_axis = getattr(meta, "tex_shard_axis", None)
    use_combined = (not differentiable) and tex.combined.shape[0] > 0

    if not use_combined:
        tids = jnp.concatenate([mat["tex_albedo"], mat["tex_normal"],
                                mat["tex_rough"], mat["tex_metal"]])
        u4 = jnp.tile(rec.u, 4)
        v4 = jnp.tile(rec.v, 4)
        p4 = jnp.tile(rec.p, (4, 1))
        tex4 = _eval_tex(cs, meta, tids, u4, v4, p4).reshape(4, n, 3)
        return tex4[0], tex4[1], _mean3(tex4[2]), _mean3(tex4[3])

    combo = mat["combo_id"]
    valid = combo >= 0
    safe = jnp.maximum(combo, 0)
    w = tex.combo_w[safe]
    h = tex.combo_h[safe]
    i = jnp.clip((rec.u * w.astype(jnp.float32)).astype(jnp.int32),
                 0, jnp.maximum(w - 1, 0))
    j = jnp.clip(((1.0 - rec.v) * (h.astype(jnp.float32) - 0.001))
                 .astype(jnp.int32), 0, jnp.maximum(h - 1, 0))
    if shard_axis is None:
        row = tex.combined[safe, j, i]                  # (N, 8) ONE gather
    else:
        # Sharded combined stack: local slice lookup + one psum (see
        # texture.tables.eval_rgb for the design note).
        local = safe - tex.combo_base
        n_loc = tex.combined.shape[0]
        owned = valid & (local >= 0) & (local < n_loc)
        row = tex.combined[jnp.clip(local, 0, n_loc - 1), j, i]
        row = jax.lax.psum(jnp.where(owned[:, None], row, 0.0), shard_axis)

    # generic values for non-image slots — no image gathers compiled in
    def gen(tid):
        return tex_tables.eval_rgb(
            cs.textures, jnp.maximum(tid, 0), rec.u, rec.v, rec.p,
            has_checker=meta.has_checker, has_image=False,
            has_noise=meta.has_noise)

    tkind = tex.kind
    def is_img(tid):
        return valid & (tid >= 0) & (tkind[jnp.maximum(tid, 0)]
                                     == tex_tables.TEX_IMAGE)

    albedo = jnp.where(is_img(mat["tex_albedo"])[:, None], row[:, 0:3],
                       gen(mat["tex_albedo"]))
    nm_rgb = jnp.where(is_img(mat["tex_normal"])[:, None], row[:, 3:6],
                       gen(mat["tex_normal"]))
    rough = jnp.where(is_img(mat["tex_rough"]), row[:, 6],
                      _mean3(gen(mat["tex_rough"])))
    metal = jnp.where(is_img(mat["tex_metal"]), row[:, 7],
                      _mean3(gen(mat["tex_metal"])))
    return albedo, nm_rgb, rough, metal


def _pbr_normals(cs, meta, mat, rec, d, nm_rgb):
    """The two normals PBR uses (see module docstring quirk list):
    - rec_n: the record normal after the triangle-TBN normal-map step the
      reference applies inside triangle.Hit (triangles only),
    - pbr_n: rec_n pushed through the ad-hoc tangent frame AGAIN
      (pbr.go:65-91; note z is NOT remapped there).
    nm_rgb: the pre-evaluated normal-map texture (_eval_pbr_texs).
    Returns (rec_n, pbr_n, is_pbr)."""
    is_pbr = mat["kind"] == mt.MAT_PBR
    has_nm = mat["tex_normal"] >= 0

    pidx = jnp.maximum(rec.prim_idx, 0)
    prim_kind = cs.prims.kind[pidx]
    tb = cs.prims.tb[pidx]
    tangent = tb[:, 0:3]
    bitangent = tb[:, 3:6]

    # Triangle TBN map: all three components remapped (triangle.go:240-248).
    t_n = 2.0 * nm_rgb - 1.0
    mapped = vm.safe_normalize(
        tangent * t_n[:, 0:1] + bitangent * t_n[:, 1:2]
        + rec.normal * t_n[:, 2:3]
    )
    use_tbn = is_pbr & has_nm & (prim_kind == prim.KIND_TRIANGLE)
    rec_n = jnp.where(use_tbn[:, None], mapped, rec.normal)

    # Ad-hoc frame (pbr.go:73-91): t = n×(0,1,0) (or n×(1,0,0) when
    # degenerate), b = n×t; z component NOT remapped.
    up = jnp.array([0.0, 1.0, 0.0], jnp.float32)
    right = jnp.array([1.0, 0.0, 0.0], jnp.float32)
    t_ad = vm.cross(rec_n, jnp.broadcast_to(up, rec_n.shape))
    degenerate = vm.dot(t_ad, t_ad) < 0.001
    t_ad = jnp.where(
        degenerate[:, None],
        vm.cross(rec_n, jnp.broadcast_to(right, rec_n.shape)), t_ad)
    t_ad = vm.safe_normalize(t_ad)
    b_ad = vm.safe_normalize(vm.cross(rec_n, t_ad))
    t_n2 = jnp.stack(
        [2.0 * nm_rgb[:, 0] - 1.0, 2.0 * nm_rgb[:, 1] - 1.0, nm_rgb[:, 2]],
        axis=-1,
    )
    pbr_mapped = vm.safe_normalize(
        t_ad * t_n2[:, 0:1] + b_ad * t_n2[:, 1:2] + rec_n * t_n2[:, 2:3]
    )
    pbr_n = jnp.where((is_pbr & has_nm)[:, None], pbr_mapped, rec_n)
    return rec_n, pbr_n, is_pbr


def _pbr_lobes(cs, meta, mat, rec, d, pbr_n, us, rough_val, metal_val):
    """PBR stochastic lobe choice (pbr.go:94-145). rough_val/metal_val are
    the pre-evaluated mean3'd textures (_eval_pbr_texs). Returns
    (is_specular_choice, specular_dir, roughness, metalness)."""
    rough = jnp.where(mat["tex_rough"] >= 0, rough_val, 0.5)
    metal = jnp.where(mat["tex_metal"] >= 0, metal_val, 0.0)

    d_unit = vm.normalize(d)
    cos_theta = jnp.abs(vm.dot(d_unit, pbr_n))
    fresnel = 0.04 + 0.96 * jnp.power(1.0 - cos_theta, 5.0) + metal * 0.5
    p_spec = fresnel * (1.0 - rough)
    choose_spec = us[:, 11] < p_spec

    rf = jnp.maximum(0.01, rough * 0.3)
    rand_dir = sampling.random_in_unit_sphere(us[:, 0], us[:, 1], us[:, 2])
    spec_dir = vm.normalize(
        vm.reflect(d_unit, pbr_n) + rf[:, None] * rand_dir
    )
    return choose_spec, spec_dir, rough, metal


def bounce_rgb(cs, meta, settings, intersect, o, d, time, keys, depth, thru,
               rad, active, differentiable: bool = False):
    """Advance every live RGB path one bounce (per-ray depth (N,)).
    Returns (o, d, thru, rad, active, n_rays_this_iter)."""
    n = o.shape[0]
    bg = jnp.asarray(settings.background, jnp.float32)

    # Dead pool slots carry their last ray; traversal would still pay full
    # price for them (the union kernel in particular). Park them far outside
    # every scene so they miss instantly — all their outputs are masked by
    # `active` below anyway.
    o = jnp.where(active[:, None], o, jnp.float32(3e30))
    rec = intersect(o, d, time, T_MIN, prim.T_MAX)
    if meta.n_media > 0:
        rec = _apply_media(cs, meta, rec, o, d, time, keys, depth)
    nrays = jnp.sum(active.astype(jnp.int32))

    miss = active & ~rec.hit
    rad = rad + jnp.where(miss[:, None], thru * bg[None, :], 0.0)
    active = active & rec.hit

    mat = _gather_mat(cs, rec.mat_id)
    kind = mat["kind"]

    if meta.has_pbr:
        emit_rgb, nm_rgb, rough_val, metal_val = _eval_pbr_texs(
            cs, meta, mat, rec, differentiable=differentiable)
    else:
        emit_rgb = _eval_tex(cs, meta, mat["tex_albedo"], rec.u, rec.v,
                             rec.p)
    facing = vm.dot(rec.normal, d) < 0.0
    is_light = kind == mt.MAT_DIFFUSE_LIGHT
    emitted = jnp.where((is_light & facing)[:, None], emit_rgb, 0.0)
    rad = rad + jnp.where(active[:, None], thru * emitted, 0.0)
    active = active & ~is_light

    us = rng.bounce_uniforms_perray(keys, depth, 12)

    is_metal = kind == mt.MAT_METAL
    is_diel = kind == mt.MAT_DIELECTRIC

    # ---- metal (metal.go:34-40): unit-direction mirror + fuzz ----
    refl_unit = vm.reflect(vm.normalize(d), rec.normal)
    fuzz_vec = sampling.random_in_unit_sphere(us[:, 0], us[:, 1], us[:, 2])
    d_metal = refl_unit + mat["fuzz"][:, None] * fuzz_vec

    # ---- dielectric ----
    d_diel, is_refl = _dielectric_scatter(d, rec.normal, mat["ref_idx"],
                                          us[:, 3])
    diel_att = jnp.ones((n, 3), jnp.float32)
    if meta.has_absorbing_dielectric:
        # Beer–Lambert with exit re-trace (dielectric.go:118-153). The
        # second traversal is the bounce's single most expensive op on big
        # scenes, so it only runs when some live ray actually refracted
        # into an absorbing dielectric this bounce.
        apply = active & is_diel & mat["has_absorption"] & ~is_refl
        start = rec.p + 1e-3 * d_diel

        def _trace_exit(_):
            exit_rec = intersect(start, d_diel, time, 0.0, 1000.0)
            return exit_rec.p, exit_rec.hit

        def _skip(_):
            return start, jnp.zeros(n, bool)

        exit_p, exit_hit = jax.lax.cond(jnp.any(apply), _trace_exit, _skip,
                                        None)
        path_len = vm.length(exit_p - rec.p)
        path_len = jnp.clip(path_len, 0.1, 100.0)
        path_len = jnp.where(exit_hit, path_len, 10.0)
        absorbed = jnp.exp(-mat["absorption"] * path_len[:, None])
        diel_att = jnp.where(apply[:, None], absorbed, diel_att)

    # ---- PBR (gated: compiled out of PBR-free scenes) ----
    if meta.has_pbr:
        rec_n, pbr_n, is_pbr = _pbr_normals(cs, meta, mat, rec, d, nm_rgb)
        pbr_spec_choice, d_pbr_spec, _, _ = _pbr_lobes(
            cs, meta, mat, rec, d, pbr_n, us, rough_val, metal_val)
        is_pbr_spec = is_pbr & pbr_spec_choice
    else:
        rec_n = rec.normal
        pbr_n = rec.normal
        is_pbr = jnp.zeros(n, bool)
        is_pbr_spec = jnp.zeros(n, bool)
        d_pbr_spec = d

    # ---- diffuse: mixture of light PDF and cosine PDF (colour.go:48-57).
    # Cosine lobe axis: the PBR-mapped normal for PBR, the record normal
    # otherwise (srec.PDF() is built on the material's normal).
    cos_axis = jnp.where(is_pbr[:, None], pbr_n, rec.normal)
    choose_light = us[:, 4] < 0.5  # mixture.go:27
    d_light = lights_mod.sample(cs.lights, rec.p, us[:, 5:9])
    d_cos = sampling.cosine_pdf_generate(
        cos_axis, us[:, 9], us[:, 10], settings.exact_book_cosine
    )
    d_diff = jnp.where(choose_light[:, None], d_light, d_cos)
    if differentiable:
        d_diff = jax.lax.stop_gradient(d_diff)
    pdf_val = 0.5 * lights_mod.pdf_value(cs.lights, rec.p, d_diff) + \
        0.5 * sampling.cosine_pdf_value(cos_axis, d_diff)
    if differentiable:
        pdf_val = jax.lax.stop_gradient(pdf_val)

    albedo = emit_rgb  # same texture slot; one evaluation per bounce
    # ScatteringPDF axis: the RECORD normal (triangle-TBN-mapped for PBR
    # triangles, pbr.go:249; plain record normal for Lambert).
    spdf_axis = jnp.where(is_pbr[:, None], rec_n, rec.normal)
    cos_out = vm.dot(spdf_axis, vm.normalize(d_diff))
    spdf_cos = jnp.maximum(cos_out, 0.0) / jnp.pi
    # Isotropic: ScatteringPDF()==0 (isotropic.go:54) — contributes 0.
    diffuse_like = (kind == mt.MAT_LAMBERT) | is_pbr
    spdf = jnp.where(diffuse_like, spdf_cos, 0.0)
    ratio = spdf / pdf_val
    if differentiable:
        # The forward path keeps the reference's NaN/Inf-on-zero-pdf chain
        # (DeNAN'd at the sample level); in the differentiable estimator a
        # single Inf would poison every parameter gradient, so dead samples
        # are zeroed instead.
        ratio = jnp.where((pdf_val > 0.0) & jnp.isfinite(ratio), ratio, 0.0)
    diff_mult = albedo * ratio[:, None]

    # ---- combine ----
    d_new = jnp.where(
        is_metal[:, None], d_metal,
        jnp.where(is_diel[:, None], d_diel,
                  jnp.where(is_pbr_spec[:, None], d_pbr_spec, d_diff)),
    )
    mult = jnp.where(
        is_metal[:, None], albedo,
        jnp.where(is_diel[:, None], diel_att,
                  jnp.where(is_pbr_spec[:, None], albedo, diff_mult)),
    )

    thru = jnp.where(active[:, None], thru * mult, thru)
    o = jnp.where(active[:, None], rec.p, o)
    d = jnp.where(active[:, None], d_new, d)
    return o, d, thru, rad, active, nrays


def bounce_spectral(cs, meta, settings, intersect, o, d, time, lam, keys,
                    depth, thru, rad, active, bg_spd_id: int):
    """Advance every live spectral path one bounce. thru/rad are scalar (N,).
    Reference: sampler/spectral.go:47-80. Returns
    (o, d, thru, rad, active, nrays, bg_val)."""
    from izpi_tpu.spectral import spd as spd_mod

    # Park dead slots outside the scene (see bounce_rgb).
    o = jnp.where(active[:, None], o, jnp.float32(3e30))
    rec = intersect(o, d, time, T_MIN, prim.T_MAX)
    if meta.n_media > 0:
        rec = _apply_media(cs, meta, rec, o, d, time, keys, depth)
    nrays = jnp.sum(active.astype(jnp.int32))

    bg_val = spd_mod.device_spd_value(
        cs.spd_table, jnp.full_like(rec.mat_id, bg_spd_id), lam
    )
    miss = active & ~rec.hit
    rad = rad + jnp.where(miss, thru * bg_val, 0.0)
    active = active & rec.hit

    mat = _gather_mat_spectral(cs, rec.mat_id)
    kind = mat["kind"]

    if meta.has_pbr:
        rgb, nm_rgb, rough_val, metal_val = _eval_pbr_texs(cs, meta, mat,
                                                           rec)
    else:
        rgb = _eval_tex(cs, meta, mat["tex_albedo"], rec.u, rec.v, rec.p)
    luma = spectral_eval.luminance(rgb)
    spec_a = spectral_eval.spectral_value(
        cs.spd_table, mat["spec_albedo_id"], mat["spec_albedo_gauss"],
        lam, luma,
    )
    # Spectral checker: the 3D sine pattern picks the odd/even branch
    # (spectral_checker.go:33-40).
    spec_b = spectral_eval.spectral_value(
        cs.spd_table, mat["spec_albedo_id2"], mat["spec_albedo_gauss2"],
        lam, luma,
    )
    sines = (jnp.sin(10.0 * rec.p[:, 0]) * jnp.sin(10.0 * rec.p[:, 1])
             * jnp.sin(10.0 * rec.p[:, 2]))
    spec_val = jnp.where(mat["spec_checker"] & (sines >= 0.0), spec_b, spec_a)
    # RGB→spectral uplift (SpectralImage semantics) from the RGB texture.
    from izpi_tpu.texture import uplift as uplift_mod

    spec_val = jnp.where(mat["spec_albedo_uplift"],
                         uplift_mod.eval_bucketed(rgb, lam), spec_val)

    facing = vm.dot(rec.normal, d) < 0.0
    is_light = kind == mt.MAT_DIFFUSE_LIGHT
    emitted = jnp.where(is_light & facing, spec_val, 0.0)
    rad = rad + jnp.where(active, thru * emitted, 0.0)

    # Lights don't scatter; metals' SpectralScatter is the nonSpectral stub
    # returning false (non_spectral.go:18-21) → terminate.
    is_metal = kind == mt.MAT_METAL
    active = active & ~is_light & ~is_metal

    us = rng.bounce_uniforms_perray(keys, depth, 12)

    # Dielectric with η(λ) → dispersion (dielectric.go:186).
    eta = jnp.where(
        mat["spec_ref_idx_id"] >= 0,
        spd_mod.device_spd_value(
            cs.spd_table, jnp.maximum(mat["spec_ref_idx_id"], 0), lam),
        mat["ref_idx"],
    )
    is_diel = kind == mt.MAT_DIELECTRIC
    d_diel, is_refl = _dielectric_scatter(d, rec.normal, eta, us[:, 3])
    diel_att = jnp.ones_like(thru)
    if meta.has_absorbing_dielectric:
        # Spectral Beer–Lambert (dielectric.go:104-115, 190-199); the exit
        # re-trace only runs when some live ray refracted into an absorbing
        # dielectric (see bounce_rgb).
        apply = active & is_diel & (mat["spec_absorb_id"] >= 0) & ~is_refl
        start = rec.p + 1e-3 * d_diel

        def _trace_exit(_):
            exit_rec = intersect(start, d_diel, time, 0.0, 1000.0)
            return exit_rec.p, exit_rec.hit

        def _skip(_):
            return start, jnp.zeros_like(is_refl)

        exit_p, exit_hit = jax.lax.cond(jnp.any(apply), _trace_exit, _skip,
                                        None)
        path_len = vm.length(exit_p - rec.p)
        path_len = jnp.clip(path_len, 0.1, 100.0)
        path_len = jnp.where(exit_hit, path_len, 10.0)
        alpha = spd_mod.device_spd_value(
            cs.spd_table, jnp.maximum(mat["spec_absorb_id"], 0), lam)
        absorbed = jnp.exp(-alpha * path_len)
        diel_att = jnp.where(apply, absorbed, diel_att)

    if meta.has_pbr:
        rec_n, pbr_n, is_pbr = _pbr_normals(cs, meta, mat, rec, d, nm_rgb)
        pbr_spec_choice, d_pbr_spec, _, _ = _pbr_lobes(
            cs, meta, mat, rec, d, pbr_n, us, rough_val, metal_val)
        is_pbr_spec = is_pbr & pbr_spec_choice
    else:
        rec_n = rec.normal
        pbr_n = rec.normal
        is_pbr = jnp.zeros_like(is_metal)
        is_pbr_spec = jnp.zeros_like(is_metal)
        d_pbr_spec = d

    cos_axis = jnp.where(is_pbr[:, None], pbr_n, rec.normal)
    choose_light = us[:, 4] < 0.5
    d_light = lights_mod.sample(cs.lights, rec.p, us[:, 5:9])
    d_cos = sampling.cosine_pdf_generate(
        cos_axis, us[:, 9], us[:, 10], settings.exact_book_cosine
    )
    d_diff = jnp.where(choose_light[:, None], d_light, d_cos)
    pdf_val = 0.5 * lights_mod.pdf_value(cs.lights, rec.p, d_diff) + \
        0.5 * sampling.cosine_pdf_value(cos_axis, d_diff)

    spdf_axis = jnp.where(is_pbr[:, None], rec_n, rec.normal)
    cos_out = vm.dot(spdf_axis, vm.normalize(d_diff))
    spdf_cos = jnp.maximum(cos_out, 0.0) / jnp.pi
    diffuse_like = (kind == mt.MAT_LAMBERT) | is_pbr
    spdf = jnp.where(diffuse_like, spdf_cos, 0.0)
    # pdf==0 (degenerate sample, e.g. in-plane light directions) divides to
    # NaN in the reference's spectral sampler (spectral.go:70, no DeNAN
    # downstream unlike the RGB path) — zero the sample instead.
    diff_mult = spec_val * jnp.where(pdf_val > 0.0, spdf / pdf_val, 0.0)

    # Spectral PBR specular gets the ×1.5 albedo boost (pbr.go:253-259).
    pbr_spec_mult = spec_val * 1.5

    d_new = jnp.where(is_diel[:, None], d_diel,
                      jnp.where(is_pbr_spec[:, None], d_pbr_spec, d_diff))
    mult = jnp.where(is_diel, diel_att,
                     jnp.where(is_pbr_spec, pbr_spec_mult, diff_mult))

    thru = jnp.where(active, thru * mult, thru)
    o = jnp.where(active[:, None], rec.p, o)
    d = jnp.where(active[:, None], d_new, d)
    return o, d, thru, rad, active, nrays, bg_val


def trace(
    cs: "CompiledScene",
    meta: "SceneMeta",
    settings: RenderSettings,
    intersect: IntersectFn,
    o, d, time, keys,
    differentiable: bool = False,
):
    """Trace a ray batch to completion (lockstep; the correctness oracle).

    o, d: (N,3); time: (N,); keys: (N,2) per-path RNG keys.
    Returns (color (N,3) — NOT DeNAN'd, caller applies it per the reference's
    render/rgb.go:36 — and rays_traced: () int32 total Sample-call count).

    differentiable=True swaps the early-exit `while_loop` for a fixed-depth
    `lax.scan` with per-bounce rematerialization: the radiance estimate
    becomes reverse-mode differentiable w.r.t. material/texture/light
    parameters with detached sampling (directions and pdfs stop-gradiented).
    """
    n = o.shape[0]

    def cond(state):
        depth, *_rest, active, _nrays = state
        return (depth < settings.max_depth) & jnp.any(active)

    def body(state):
        depth, o, d, time, thru, rad, active, nrays = state
        depth_vec = jnp.zeros(n, jnp.int32) + depth
        o, d, thru, rad, active, nr = bounce_rgb(
            cs, meta, settings, intersect, o, d, time, keys, depth_vec,
            thru, rad, active, differentiable=differentiable,
        )
        return (depth + 1, o, d, time, thru, rad, active, nrays + nr)

    # Carry inits derived from ray inputs → correct varying-manual-axes type
    # under shard_map (see primitives.intersect_brute).
    zero3 = o * 0.0
    zero1 = time * 0.0
    state0 = (
        jnp.int32(0), o, d, time,
        zero3 + 1.0,                       # throughput
        zero3,                             # radiance
        ~zero1.astype(bool),               # active = all True
        jnp.sum(zero1).astype(jnp.int32),  # ray counter
    )
    if differentiable:
        # Fixed trip count (masking already handles dead rays); remat each
        # bounce so backward memory is O(1) in depth instead of O(depth).
        def scan_body(state, _):
            return body(state), None

        final, _ = jax.lax.scan(
            jax.checkpoint(scan_body), state0, None,
            length=settings.max_depth,
        )
        depth, o, d, time, thru, rad, active, nrays = final
    else:
        depth, o, d, time, thru, rad, active, nrays = jax.lax.while_loop(
            cond, body, state0)
    # Depth cap: the next Sample call would return {Z:1} (colour.go:34-36).
    sentinel = jnp.array([0.0, 0.0, 1.0], jnp.float32)
    rad = rad + jnp.where(active[:, None], thru * sentinel[None, :], 0.0)
    return rad, nrays
