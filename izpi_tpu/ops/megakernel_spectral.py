"""Pallas spectral wavefront megakernel — the fast path for the reference's
DEFAULT workload (spectral Cornell pyramid, cmd/izpi/main.go:22-28).

Same architecture as ops.megakernel (slot-pinned pixels, on-chip bounce+
refill loop, Threefry streams shared with the XLA oracle), with the spectral
transport of internal/sampler/spectral.go:47-80 instead of RGB:

- every path carries a wavelength λ importance-sampled by CIE-Y
  (spectral.go:184-224) and scalar radiance/throughput at that λ,
- dielectrics read η(λ) → dispersion (dielectric.go:186); Beer–Lambert uses
  the spectral absorption coefficient at λ,
- deposits are XYZ: radiance · (x̄,ȳ,z̄)(λ) / pdf(λ) (render/spectral.go:95).

The key trick: every λ-dependent TABLE value is a PATH CONSTANT —
λ changes only when a slot starts a fresh camera sample. make_ray therefore
evaluates all of them once per refill (each scene SPD at λ, the CIE triple,
the background SPD, the λ-pdf) and the bounce loop carries them as per-lane
scalars; the hot loop never gathers. Tables are evaluated as their exact
piecewise-linear form: knots reconstructed from the 1 nm device grid
(spd.to_device_grid) are unrolled as compare/fma segments, which
reproduces the oracle's device_spd_value up to f32 rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from izpi_tpu.materials import tables as mt
from izpi_tpu.ops import threefry as tf
from izpi_tpu.ops.megakernel import (
    MAX_UNROLL_PRIMS, T_MIN, T_MAX, TWO_PI, CAMERA_SALT, _add, _c, _dot,
    _intersect_static, _lights_pdf, _lights_sample, _norm, _onb_from_w,
    _reflect, _scale, _sel, _sub, extract_static, launch, plan_launch,
    run_while_live, slot_lanes,
)
from izpi_tpu.spectral import cie

LAMBDA_SALT = 0x7A3B  # wavefront.py LAMBDA_SALT — same λ stream as the pool
MAX_KNOTS = 128       # SPD segment budget before falling back to full grid

# Launch geometry (ops.megakernel.plan_launch), swept on its own bench frame
# (spectral_pyramid 500²@256) with scripts/engine_timing.py on an H100:
# 256 lanes over 8 warps 107.7 ms, the RGB kernel's 128/4 with two replicas
# 120-122 ms; replicas change nothing at 256/8 (108.7 ms).
BLOCK = 256
NUM_WARPS = 8
MIN_SLOTS = 1 << 16


# --------------------------------------------------------------------------
# Host-side: piecewise-linear knot extraction + eligibility
# --------------------------------------------------------------------------


def _extract_knots(row: np.ndarray, rtol: float = 1e-6):
    """Reconstruct piecewise-linear knots (x, v) from a 1 nm grid row so the
    in-kernel segment evaluation reproduces the grid lerp. Collinear interior
    samples are dropped (within rtol of the chord)."""
    grid = np.arange(row.shape[0], dtype=np.float64)
    v = np.asarray(row, np.float64)
    keep = [0]
    i = 0
    n = row.shape[0]
    while i < n - 1:
        j = i + 1
        # extend the segment while all interior points sit on the chord
        while j + 1 < n:
            jj = j + 1
            xs = grid[i + 1:jj]
            chord = v[i] + (v[jj] - v[i]) * (xs - grid[i]) / (grid[jj] - grid[i])
            scale = max(np.abs(v[i:jj + 1]).max(), 1e-12)
            if np.abs(chord - v[i + 1:jj]).max() <= rtol * scale:
                j = jj
            else:
                break
        keep.append(j)
        i = j
    xs = grid[keep] + 380.0
    vs = v[keep]
    return xs, vs


class SpectralStatic(NamedTuple):
    spd_knots: list      # per carried SPD: (xs, vs) numpy knot arrays
    spd_slot: dict       # scene spd_id -> carried slot index
    mat_spec: list       # per material: dict(albedo_slot, gauss, luma,
                         #   eta_slot, absorb_slot)
    bg_slot: int


def eligible(cs, meta) -> bool:
    """Spectral scenes the kernel covers: the reference default workload
    class. PBR/media/image/noise/uplift/spectral-checker fall back to the
    XLA pool."""
    if not meta.spectral or meta.has_pbr or meta.n_media > 0:
        return False
    if meta.has_image or meta.has_noise or meta.has_checker:
        return False
    if meta.n_prims == 0 or meta.n_prims > MAX_UNROLL_PRIMS:
        return False
    m = cs.materials
    if bool(np.asarray(m.spec_checker).any()):
        return False
    if bool(np.asarray(m.spec_albedo_uplift).any()):
        return False
    if meta.spectral_background_spd is None:
        return False
    n_knots = 0
    for sid in _used_spd_ids(cs, meta):
        xs, _ = _extract_knots(np.asarray(cs.spd_table)[sid])
        n_knots += len(xs)
        if len(xs) > MAX_KNOTS:
            return False
    return True


def _used_spd_ids(cs, meta):
    m = cs.materials
    ids = set()
    for field in (m.spec_albedo_id, m.spec_ref_idx_id, m.spec_absorb_id):
        for v in np.asarray(field):
            if v >= 0:
                ids.add(int(v))
    ids.add(int(meta.spectral_background_spd or 0))
    return sorted(ids)


def extract_spectral(cs, meta) -> SpectralStatic:
    table = np.asarray(cs.spd_table)
    ids = _used_spd_ids(cs, meta)
    spd_slot = {sid: k for k, sid in enumerate(ids)}
    spd_knots = [_extract_knots(table[sid]) for sid in ids]

    m = cs.materials
    g = np.asarray(m.spec_albedo_gauss, np.float64)
    aid = np.asarray(m.spec_albedo_id)
    eid = np.asarray(m.spec_ref_idx_id)
    bid = np.asarray(m.spec_absorb_id)
    tex = cs.textures
    t_c0 = np.asarray(tex.c0, np.float64)
    ta = np.asarray(m.tex_albedo)

    mat_spec = []
    for i in range(aid.shape[0]):
        tid = max(int(ta[i]), 0)
        rgb = t_c0[tid]
        luma = 0.299 * rgb[0] + 0.587 * rgb[1] + 0.114 * rgb[2]
        mat_spec.append(dict(
            albedo_slot=spd_slot.get(int(aid[i]), -1) if aid[i] >= 0 else -1,
            gauss=(float(g[i, 0]), float(g[i, 1]), float(g[i, 2])),
            luma=float(luma),
            eta_slot=spd_slot.get(int(eid[i]), -1) if eid[i] >= 0 else -1,
            absorb_slot=spd_slot.get(int(bid[i]), -1) if bid[i] >= 0 else -1,
        ))
    return SpectralStatic(
        spd_knots=spd_knots, spd_slot=spd_slot, mat_spec=mat_spec,
        bg_slot=spd_slot[int(meta.spectral_background_spd or 0)],
    )


# --------------------------------------------------------------------------
# In-kernel λ machinery (all static-unrolled math, no gathers)
# --------------------------------------------------------------------------


def _piecewise_eval(xs, vs, lam):
    """Evaluate piecewise-linear knots at per-lane λ with endpoint clamping
    (spectral.go:151-182 semantics; matches spd.device_spd_value)."""
    val = jnp.full_like(lam, float(vs[0]))
    for j in range(len(xs) - 1):
        x0, x1 = float(xs[j]), float(xs[j + 1])
        v0, v1 = float(vs[j]), float(vs[j + 1])
        slope = (v1 - v0) / (x1 - x0)
        seg = v0 + (lam - x0) * slope
        val = jnp.where(lam >= x0, seg, val)
    return jnp.where(lam >= float(xs[-1]), float(vs[-1]), val)


def _cie_eval(lam):
    """x̄, ȳ, z̄ at λ — 5 nm grid lerp, clamped (cie.get_cie_values)."""
    x = (lam - cie.WAVELENGTH_MIN) * jnp.float32(1.0 / cie.CIE_STEP)
    x = jnp.clip(x, 0.0, cie.N_CIE - 1.0)
    outs = [jnp.zeros_like(lam) for _ in range(3)]
    tabs = (cie.CIE_X, cie.CIE_Y, cie.CIE_Z)
    for i in range(cie.N_CIE - 1):
        m = x >= i
        t = x - i
        for k in range(3):
            v0, v1 = float(tabs[k][i]), float(tabs[k][i + 1])
            outs[k] = jnp.where(m, v0 + t * (v1 - v0), outs[k])
    return outs


_CIE_CUM = np.cumsum(cie.CIE_Y)


def _sample_wavelength(u):
    """CIE-Y CDF inversion (spectral.go:184-224 == cie.sample_wavelength),
    static-unrolled. Returns (λ, pdf)."""
    target = u * jnp.float32(cie.CIE_Y_INTEGRAL)
    # i = first index with cum[i] >= target (searchsorted 'left').
    i = jnp.zeros_like(u, jnp.int32)
    for k in range(cie.N_CIE):
        i = i + (jnp.float32(_CIE_CUM[k]) < target).astype(jnp.int32)

    w = cie.CIE_WAVELENGTHS
    y = cie.CIE_Y
    # Gather w[i], y[i], w[i-1], y[i-1], cum[i-1] with one one-hot sweep.
    zero = jnp.zeros_like(u)
    wi = zero
    yi = zero
    wim = zero
    yim = zero
    prev = zero
    for k in range(cie.N_CIE):
        m = (i == k)
        km = max(k - 1, 0)
        wi = jnp.where(m, float(w[k]), wi)
        yi = jnp.where(m, float(y[k]), yi)
        wim = jnp.where(m, float(w[km]), wim)
        yim = jnp.where(m, float(y[km]), yim)
        prev = jnp.where(m, float(_CIE_CUM[km]) if k > 0 else 0.0, prev)

    in_range = i < cie.N_CIE
    i_gt0 = i > 0
    t = (target - prev) / jnp.maximum(yi, 1e-20)
    lam = jnp.where(i_gt0, wim + t * (wi - wim), wi)
    pdf = jnp.where(i_gt0, yim + t * (yi - yim), yi) * jnp.float32(
        1.0 / cie.CIE_Y_INTEGRAL)
    lam = jnp.where(in_range, lam, jnp.float32(cie.WAVELENGTH_MAX))
    pdf = jnp.where(in_range, pdf,
                    jnp.float32(cie.CIE_Y[-1] / cie.CIE_Y_INTEGRAL))
    return lam, pdf


# --------------------------------------------------------------------------
# The spectral kernel
# --------------------------------------------------------------------------


def build_renderer(cs, meta, settings, nx: int, ny: int, spp: int,
                   interpret: bool = False):
    """Compile-time closure: fn(base_key, sample_offset) →
    (acc (n_pix, 3) f32 summed XYZ, nrays ()). Jittable. Streams match the
    XLA spectral pool (wavefront.trace_pool spectral=True) per-sample.
    interpret=True runs the kernel in the Pallas interpreter (CPU tests)."""
    static = extract_static(cs, meta)
    spec = extract_spectral(cs, meta)
    n_pix = nx * ny
    max_depth = int(settings.max_depth)

    lp = plan_launch(n_pix, spp, BLOCK, NUM_WARPS, MIN_SLOTS)
    spp_slot = spp // lp.repl
    shape = (lp.block,)

    cam = static.cam
    prims = static.prims
    mats = static.mats
    lights = static.lights
    n_spd = len(spec.spd_knots)
    any_diel = any(m["kind"] == mt.MAT_DIELECTRIC for m in mats)
    has_absorbing = any(ms["absorb_slot"] >= 0 for ms in spec.mat_spec)

    def kernel(seed_ref, off_ref, acc_x_ref, acc_y_ref, acc_z_ref, cnt_ref):
        valid, pix, replica, px, py = slot_lanes(lp, nx, n_pix)
        b0 = jnp.full(shape, seed_ref[0, 0], jnp.uint32)
        b1 = jnp.full(shape, seed_ref[0, 1], jnp.uint32)
        off = off_ref[0, 0]

        def make_ray(samp):
            """Camera ray + λ + all λ-dependent path constants. Streams
            identical to wavefront.sample_to_ray (spectral=True)."""
            sid = (replica * spp_slot + samp + off).astype(jnp.uint32)
            s0, s1 = tf.fold_in(b0, b1, sid)
            k0, k1 = tf.fold_in(s0, s1, pix.astype(jnp.uint32))
            c0, c1 = tf.fold_in(k0, k1, jnp.zeros_like(k0))  # depth 0
            cc0, cc1 = tf.fold_in(c0, c1, jnp.full_like(k0, CAMERA_SALT))
            u = tf.uniforms_n(cc0, cc1, 5)
            s = (px + u[0]) * jnp.float32(1.0 / nx)
            t = (py + u[1]) * jnp.float32(1.0 / ny)
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
            # λ stream: fold depth 0, then LAMBDA_SALT (wavefront.py:62).
            l0, l1 = tf.fold_in(c0, c1, jnp.full_like(k0, LAMBDA_SALT))
            u_lam = tf.uniforms_n(l0, l1, 1)[0]
            lam, lam_pdf = _sample_wavelength(u_lam)
            # λ path constants: every carried SPD + CIE triple.
            spdv = [
                _piecewise_eval(xs, vs, lam) for xs, vs in spec.spd_knots
            ]
            cx, cy, cz = _cie_eval(lam)
            return o, d, tme, k0, k1, lam, lam_pdf, spdv, (cx, cy, cz)

        zi = jnp.zeros(shape, jnp.int32)
        zf = jnp.zeros(shape, jnp.float32)
        (o0, d0, tme0, k00, k10, lam0, lpdf0, spdv0, cie0) = make_ray(zi)
        live0 = valid & (spp_slot > 0)

        state0 = dict(
            o=o0, d=d0, tme=tme0, k0=k00, k1=k10,
            lam=lam0, lpdf=lpdf0,
            depth=zi, samp=zi,
            thru=zf + 1.0, rad=zf,
            acc=(zf, zf, zf),
            cnt=zi, live=live0.astype(jnp.int32),
        )
        for j in range(n_spd):
            state0[f"spd{j}"] = spdv0[j]
        state0["cie_x"], state0["cie_y"], state0["cie_z"] = cie0

        def bounce(st):
            o, d, tme, lam = st["o"], st["d"], st["tme"], st["lam"]
            live = st["live"] != 0
            thru = st["thru"]
            rad = st["rad"]
            cnt = st["cnt"] + live.astype(jnp.int32)
            spdv = [st[f"spd{j}"] for j in range(n_spd)]
            bg_val = spdv[spec.bg_slot]

            rec = _intersect_static(prims, o, d, tme, T_MIN, T_MAX)
            hit = rec["hit"]
            nrm = rec["n"]
            p = rec["p"]
            mat_idx = rec["mat"]

            miss = live & ~hit
            rad = rad + jnp.where(miss, thru * bg_val, 0.0)
            active = live & hit

            # --- material row: spectral albedo value at λ + params ---
            spec_val = zf
            kindv = jnp.zeros(shape, jnp.int32)
            eta = zf + 1.0
            alpha = zf
            has_abs = jnp.zeros_like(hit)
            for mi, mrow in enumerate(mats):
                ms = spec.mat_spec[mi]
                sel = mat_idx == mi
                kindv = jnp.where(sel, mrow["kind"], kindv)
                if ms["albedo_slot"] >= 0:
                    sv = spdv[ms["albedo_slot"]]
                elif ms["gauss"][2] > 0.0:
                    peak, center, width = ms["gauss"]
                    ratio = (lam - center) * jnp.float32(1.0 / width)
                    sv = peak * jnp.exp(-(ratio * ratio))
                else:
                    sv = zf + ms["luma"]
                spec_val = jnp.where(sel, sv, spec_val)
                if mrow["kind"] == mt.MAT_DIELECTRIC:
                    if ms["eta_slot"] >= 0:
                        eta = jnp.where(sel, spdv[ms["eta_slot"]], eta)
                    else:
                        eta = jnp.where(sel, mrow["ref_idx"], eta)
                    if ms["absorb_slot"] >= 0:
                        alpha = jnp.where(sel, spdv[ms["absorb_slot"]], alpha)
                        has_abs = has_abs | sel

            facing = _dot(nrm, d) < 0.0
            is_light = kindv == mt.MAT_DIFFUSE_LIGHT
            emit_on = active & is_light & facing
            rad = rad + jnp.where(emit_on, thru * spec_val, 0.0)
            # Lights don't scatter; metal's SpectralScatter is the
            # nonSpectral stub → terminate (non_spectral.go:18-21).
            is_metal = kindv == mt.MAT_METAL
            active = active & ~is_light & ~is_metal

            u0_, u1_ = tf.fold_in(st["k0"], st["k1"],
                                  st["depth"].astype(jnp.uint32))
            u0_, u1_ = tf.fold_in(u0_, u1_, jnp.zeros_like(u0_))
            us = tf.uniforms_n(u0_, u1_, 12)

            # --- dielectric with η(λ) → dispersion (dielectric.go:186) ---
            if any_diel:
                reflected = _reflect(d, nrm)
                d_dot_n = _dot(d, nrm)
                exiting = d_dot_n > 0.0
                outward = _sel(exiting, _scale(nrm, -1.0), nrm)
                ni_over_nt = jnp.where(exiting, eta, 1.0 / eta)
                dlen = jnp.sqrt(_dot(d, d))
                cosine = jnp.where(exiting, eta * d_dot_n / dlen,
                                   -d_dot_n / dlen)
                uvn = _norm(d)
                dt = _dot(uvn, outward)
                disc = 1.0 - ni_over_nt * ni_over_nt * (1.0 - dt * dt)
                can = disc > 0.0
                refr = _sub(_scale(_sub(uvn, _scale(outward, dt)), ni_over_nt),
                            _scale(outward, jnp.sqrt(jnp.maximum(disc, 0.0))))
                r0 = (1.0 - eta) / (1.0 + eta)
                r0 = r0 * r0
                schl = r0 + (1.0 - r0) * jnp.power(1.0 - cosine, 5.0)
                reflect_prob = jnp.where(can, schl, 1.0)
                is_refl = us[3] < reflect_prob
                d_diel = _sel(is_refl, reflected, refr)
                diel_att = zf + 1.0
                if has_absorbing:
                    # spectral Beer–Lambert exit re-trace
                    # (dielectric.go:104-115, 190-199)
                    start = _add(p, _scale(d_diel, 1e-3))
                    ex = _intersect_static(prims, start, d_diel, tme,
                                           0.0, 1000.0, want_mat=False)
                    dl = _sub(ex["p"], p)
                    plen = jnp.sqrt(_dot(dl, dl))
                    plen = jnp.clip(plen, 0.1, 100.0)
                    plen = jnp.where(ex["hit"], plen, 10.0)
                    ab = jnp.exp(-alpha * plen)
                    diel_att = jnp.where(has_abs & ~is_refl, ab, diel_att)
            else:
                d_diel = d
                diel_att = zf + 1.0

            # --- diffuse NEE mixture at λ (spectral.go:61-76) ---
            choose_light = us[4] < 0.5
            d_light = _lights_sample(lights, p, us[5], us[6], us[7], us[8])
            ou, ov, ow = _onb_from_w(nrm)
            scale_q = 2.0 if bool(settings.exact_book_cosine) else 1.0
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
            # zero-pdf guard — see path.bounce_spectral
            diff_mult = spec_val * jnp.where(pdf_val > 0.0,
                                             spdf / pdf_val, 0.0)

            is_diel = kindv == mt.MAT_DIELECTRIC
            d_new = _sel(is_diel, d_diel, d_diff)
            mult = jnp.where(is_diel, diel_att, diff_mult)

            thru = jnp.where(active, thru * mult, thru)
            o = _sel(active, p, o)
            d = _sel(active, d_new, d)

            depth = st["depth"] + 1
            capped = active & (depth >= max_depth)
            # Spectral depth cap: background SPD at λ (spectral.go:48-52,
            # wavefront.py:108).
            rad = rad + jnp.where(capped, thru * bg_val, 0.0)
            active = active & ~capped

            # --- deposit + refill ---
            died = live & ~active
            # XYZ deposit, DeNAN'd like the pool (wavefront.trace_pool).
            w = jnp.where(st["lpdf"] > 0.0, rad / st["lpdf"], 0.0)
            w = jnp.where(jnp.isfinite(w), w, 0.0)
            acc = (st["acc"][0] + jnp.where(died, st["cie_x"] * w, 0.0),
                   st["acc"][1] + jnp.where(died, st["cie_y"] * w, 0.0),
                   st["acc"][2] + jnp.where(died, st["cie_z"] * w, 0.0))

            samp = jnp.where(died, st["samp"] + 1, st["samp"])
            issue = died & (samp < spp_slot)
            (o_n, d_n, t_n, k0n, k1n, lam_n, lpdf_n, spdv_n,
             cie_n) = make_ray(samp)
            out = dict(
                o=_sel(issue, o_n, o), d=_sel(issue, d_n, d),
                tme=jnp.where(issue, t_n, tme),
                k0=jnp.where(issue, k0n, st["k0"]),
                k1=jnp.where(issue, k1n, st["k1"]),
                lam=jnp.where(issue, lam_n, lam),
                lpdf=jnp.where(issue, lpdf_n, st["lpdf"]),
                depth=jnp.where(issue, 0, depth),
                samp=samp,
                thru=jnp.where(issue, 1.0, thru),
                rad=jnp.where(issue, 0.0, rad),
                acc=acc, cnt=cnt,
                live=(active | issue).astype(jnp.int32),
            )
            for j in range(n_spd):
                out[f"spd{j}"] = jnp.where(issue, spdv_n[j], spdv[j])
            out["cie_x"] = jnp.where(issue, cie_n[0], st["cie_x"])
            out["cie_y"] = jnp.where(issue, cie_n[1], st["cie_y"])
            out["cie_z"] = jnp.where(issue, cie_n[2], st["cie_z"])
            return out

        final = run_while_live(bounce, state0)
        acc_x_ref[...] = final["acc"][0]
        acc_y_ref[...] = final["acc"][1]
        acc_z_ref[...] = final["acc"][2]
        cnt_ref[...] = final["cnt"]

    return launch(kernel, lp, n_pix, interpret, "izpi_megakernel_spectral")
