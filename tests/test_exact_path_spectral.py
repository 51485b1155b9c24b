"""Exact per-engine SPECTRAL estimator tests.

An INDEPENDENT float64 scalar reimplementation of the reference's spectral
estimator chain — CIE-Y wavelength importance sampling by CDF inversion
(spectral/spectral.go:184-224), Gaussian SPD evaluation
(texture/spectral_constant.go:75-79), η(λ) dispersion through a dielectric
(material/dielectric.go:40,66-102,186), the NEE mixture with the
dielectric-IsEmitter light-list quirk (dielectric.go:215,
hitable_slice.go:98-115), and the XYZ deposit radiance·(x̄,ȳ,z̄)(λ)/pdf(λ)
(render/spectral.go:71-106) — sharing ONLY the Threefry uniform streams with
the production code, pins every pixel of a tiny spectral scene at spp=1.

Both spectral engines (the XLA wavefront pool and the Pallas spectral
megakernel in interpret mode) must reproduce it to f32 tolerance: any
formula drift anywhere in the spectral estimator breaks this exactly,
closing the gap the 8%-band golden tests cannot see.
"""

import math

import numpy as np
import jax.numpy as jnp

from izpi_tpu.core import rng
from izpi_tpu.integrator import path as path_mod
from izpi_tpu.integrator import wavefront
from izpi_tpu.render import renderer
from izpi_tpu.scene import types as st
from izpi_tpu.scene.compiler import compile_scene
from izpi_tpu.spectral import cie

NX = NY = 8
SPP = 1
DEPTH = 4
SEED = 13

# Wide Gaussians so the f32-vs-f64 λ interpolation difference (~0.03 nm)
# stays far below the comparison tolerance.
ALBEDO_G = (0.8, 550.0, 120.0)    # peak, center, width
EMIT_G = (10.0, 560.0, 150.0)
BG_VAL = 0.02                     # SpectralNeutral flat background
ETA_KNOTS = ((380.0, 1.60), (750.0, 1.45))  # linear η(λ) → dispersion

FLOOR = dict(p0=(-2.0, 0.0, -2.0), e1=(4.0, 0.0, 0.0), e2=(0.0, 0.0, 4.0),
             n=(0.0, 1.0, 0.0))
LIGHT = dict(p0=(-1.0, 3.0, -1.0), e1=(2.0, 0.0, 0.0), e2=(0.0, 0.0, 2.0),
             n=(0.0, -1.0, 0.0), area=4.0)   # flipped: emits downward
SPH_C = np.array([0.8, 0.5, 0.0])
SPH_R = 0.5
LOOK_FROM = (0.0, 2.0, 0.001)
LOOK_AT = (0.0, 0.0, 0.0)
VFOV = 60.0


def _scene(with_sphere: bool):
    lam_mat = st.Lambertian(st.ConstantTexture((0.5, 0.5, 0.5)),
                            spectral_albedo=st.SpectralGaussian(*ALBEDO_G))
    light = st.DiffuseLight(emit=st.ConstantTexture((10.0, 10.0, 10.0)),
                            spectral_emit=st.SpectralGaussian(*EMIT_G))
    world = [
        st.XZRect(-2, 2, -2, 2, 0.0, lam_mat),
        st.FlipNormals(st.XZRect(-1, 1, -1, 1, 3.0, light)),
    ]
    if with_sphere:
        glass = st.Dielectric(
            ref_idx=1.5,
            spectral_ref_idx=st.SpectralTabulated(
                wavelengths=tuple(k[0] for k in ETA_KNOTS),
                values=tuple(k[1] for k in ETA_KNOTS)))
        world.append(st.Sphere(tuple(SPH_C), tuple(SPH_C), 0.0, 1.0, SPH_R,
                               glass))
    from izpi_tpu.spectral import spd as spd_mod

    return st.Scene(
        world=world,
        camera=st.Camera(look_from=LOOK_FROM, look_at=LOOK_AT, vfov=VFOV,
                         aspect=NX / NY),
        spectral=True,
        spectral_background=spd_mod.SPD.constant(BG_VAL),
    )


# ---------------- independent f64 model ----------------

def _sample_wavelength_f64(u):
    """CDF inversion over CIE_Y, reference edge cases (spectral.go:184-224)."""
    I = cie.CIE_Y_INTEGRAL
    y = np.asarray(cie.CIE_Y, np.float64)
    w = np.asarray(cie.CIE_WAVELENGTHS, np.float64)
    cum = np.cumsum(y)
    target = u * I
    i = int(np.searchsorted(cum, target, side="left"))
    if i >= len(y):
        return 750.0, y[-1] / I
    if i == 0:
        return w[0], y[0] / I
    prev = cum[i - 1]
    t = (target - prev) / max(y[i], 1e-20)
    lam = w[i - 1] + t * (w[i] - w[i - 1])
    pdf = (y[i - 1] + t * (y[i] - y[i - 1])) / I
    return lam, pdf


def _cie_xyz_f64(lam):
    x = (lam - 380.0) / 5.0
    x = min(max(x, 0.0), 74.0)
    i0 = min(int(math.floor(x)), 73)
    t = x - i0
    out = []
    for tab in (cie.CIE_X, cie.CIE_Y, cie.CIE_Z):
        out.append(tab[i0] * (1.0 - t) + tab[i0 + 1] * t)
    return np.array(out)


def _gauss(lam, params):
    peak, center, width = params
    return peak * math.exp(-(((lam - center) / width) ** 2))


def _eta_f64(lam):
    (x0, v0), (x1, v1) = ETA_KNOTS
    t = min(max((lam - x0) / (x1 - x0), 0.0), 1.0)
    return v0 + t * (v1 - v0)


def _camera_frame():
    lf = np.array(LOOK_FROM)
    la = np.array(LOOK_AT)
    vup = np.array([0.0, 1.0, 0.0])
    half_h = math.tan(VFOV * math.pi / 360.0)
    half_w = (NX / NY) * half_h
    w = lf - la
    w /= np.linalg.norm(w)
    u = np.cross(vup, w)
    u /= np.linalg.norm(u)
    v = np.cross(w, u)
    lower_left = lf - half_w * u - half_h * v - w
    return lf, lower_left, 2.0 * half_w * u, 2.0 * half_h * v


def _rect_hit(rect, o, d, t_min, t_max):
    n = np.array(rect["n"])
    denom = d @ n
    if denom == 0.0:
        return None
    t = (np.array(rect["p0"]) - o) @ n / denom
    if not (t_min <= t <= t_max):
        return None
    rel = o + t * d - np.array(rect["p0"])
    e1, e2 = np.array(rect["e1"]), np.array(rect["e2"])
    uu = rel @ e1 / (e1 @ e1)
    vv = rel @ e2 / (e2 @ e2)
    if not (0.0 <= uu <= 1.0 and 0.0 <= vv <= 1.0):
        return None
    return t


def _sphere_hit(o, d, t_min, t_max):
    """Reference root selection (sphere.go:70-127): near root first."""
    oc = o - SPH_C
    a = d @ d
    b = oc @ d
    c = oc @ oc - SPH_R * SPH_R
    disc = b * b - a * c
    if disc <= 0.0:
        return None
    sq = math.sqrt(disc)
    for t in ((-b - sq) / a, (-b + sq) / a):
        if t_min < t < t_max:
            return t
    return None


def _onb_f64(n):
    w = n / np.linalg.norm(n)
    a = np.array([0.0, 1.0, 0.0]) if abs(w[0]) > 0.9 else \
        np.array([1.0, 0.0, 0.0])
    v = np.cross(w, a)
    v /= np.linalg.norm(v)
    u = np.cross(w, v)
    return u, v, w


def _light_pdf(with_sphere, o, v):
    """Mean member pdf; members = [light rect, glass sphere] (the
    dielectric-IsEmitter quirk). Sphere pdf clamps the inside-origin sqrt
    to 0 like the production deviation (integrator/lights.py)."""
    members = []
    t = _rect_hit(LIGHT, o, v, 1e-3, 3.0e38)
    if t is None:
        members.append(0.0)
    else:
        v_len2 = v @ v
        cos = abs(v @ np.array(LIGHT["n"])) / math.sqrt(v_len2)
        members.append(t * t * v_len2 / (cos * LIGHT["area"]))
    if with_sphere:
        if _sphere_hit(o, v, 1e-3, 3.0e38) is None:
            members.append(0.0)
        else:
            dist2 = (SPH_C - o) @ (SPH_C - o)
            ctm = math.sqrt(max(1.0 - SPH_R * SPH_R / dist2, 0.0))
            members.append(1.0 / (2.0 * math.pi * (1.0 - ctm)))
    return sum(members) / len(members)


def _dielectric_scatter_f64(d, n, eta, u_reflect):
    """material/dielectric.go:66-102 on the RAW direction."""
    reflected = d - 2.0 * (d @ n) * n
    d_dot_n = d @ n
    exiting = d_dot_n > 0.0
    outward = -n if exiting else n
    ni_over_nt = eta if exiting else 1.0 / eta
    dlen = np.linalg.norm(d)
    cosine = eta * d_dot_n / dlen if exiting else -d_dot_n / dlen
    uv = d / dlen
    dt = uv @ outward
    disc = 1.0 - ni_over_nt * ni_over_nt * (1.0 - dt * dt)
    if disc > 0.0:
        refracted = ni_over_nt * (uv - outward * dt) - outward * \
            math.sqrt(disc)
        r0 = ((1.0 - eta) / (1.0 + eta)) ** 2
        reflect_prob = r0 + (1.0 - r0) * (1.0 - cosine) ** 5
    else:
        refracted = None
        reflect_prob = 1.0
    if u_reflect < reflect_prob:
        return reflected
    return refracted


def _expected_pixel(base_key, px, py, with_sphere):
    pix = py * NX + px
    keys = rng.path_keys(base_key, jnp.asarray([pix], jnp.int32), 0)
    cam_u = np.asarray(rng.bounce_uniforms(keys, jnp.int32(0), 5,
                                           salt=0x5EED), np.float64)[0]
    u_lam = float(np.asarray(rng.bounce_uniforms(
        keys, jnp.int32(0), 1, salt=wavefront.LAMBDA_SALT))[0, 0])
    lam, lam_pdf = _sample_wavelength_f64(u_lam)

    origin, lower_left, horizontal, vertical = _camera_frame()
    s = (px + cam_u[0]) / NX
    t = (py + cam_u[1]) / NY
    o = origin.copy()
    d = lower_left + s * horizontal + t * vertical - origin

    rad = 0.0
    thru = 1.0
    depth = 0
    while depth < DEPTH:
        hits = [(_rect_hit(FLOOR, o, d, 1e-3, 3.0e38), "floor"),
                (_rect_hit(LIGHT, o, d, 1e-3, 3.0e38), "light")]
        if with_sphere:
            hits.append((_sphere_hit(o, d, 1e-3, 3.0e38), "sphere"))
        hits = [(tt, who) for tt, who in hits if tt is not None]
        if not hits:
            rad += thru * BG_VAL
            break
        t_hit, who = min(hits, key=lambda x: x[0])
        p = o + t_hit * d
        if who == "light":
            if d @ np.array(LIGHT["n"]) < 0.0:   # one-sided emission
                rad += thru * _gauss(lam, EMIT_G)
            break
        us = np.asarray(rng.bounce_uniforms(
            keys, jnp.int32(depth), 12), np.float64)[0]
        if who == "sphere":
            nrm = (p - SPH_C) / SPH_R
            d_new = _dielectric_scatter_f64(d, nrm, _eta_f64(lam), us[3])
            o, d = p, d_new
            depth += 1
            continue
        # Lambert floor: NEE mixture (spectral.go:56-75)
        nrm = np.array(FLOOR["n"])
        n_members = 2 if with_sphere else 1
        member = min(int(us[5] * n_members), n_members - 1)
        if member == 0:
            lp = (np.array(LIGHT["p0"]) + us[6] * np.array(LIGHT["e1"])
                  + us[7] * np.array(LIGHT["e2"]))
            d_light = lp - p
        else:
            to_c = SPH_C - p
            dist2 = to_c @ to_c
            bu, bv, bw = _onb_f64(to_c)
            z = 1.0 + us[7] * (math.sqrt(1.0 - SPH_R * SPH_R / dist2) - 1.0)
            phi = 2.0 * math.pi * us[6]
            sq = math.sqrt(max(1.0 - z * z, 0.0))
            local = np.array([math.cos(phi) * sq, math.sin(phi) * sq, z])
            d_light = local[0] * bu + local[1] * bv + local[2] * bw
        # book cosine lobe on the floor normal's ONB
        bu, bv, bw = _onb_f64(nrm)
        z = math.sqrt(1.0 - us[10])
        phi = 2.0 * math.pi * us[9]
        r = 2.0 * math.sqrt(us[10])
        local = np.array([math.cos(phi) * r, math.sin(phi) * r, z])
        d_cos = local[0] * bu + local[1] * bv + local[2] * bw
        d_new = d_light if us[4] < 0.5 else d_cos
        pdf = 0.5 * _light_pdf(with_sphere, p, d_new) + 0.5 * max(
            (d_new / np.linalg.norm(d_new)) @ nrm, 0.0) / math.pi
        spdf = max((d_new / np.linalg.norm(d_new)) @ nrm, 0.0) / math.pi
        albedo = _gauss(lam, ALBEDO_G)
        # pdf==0 zeroes the sample (production deviation from the
        # reference's NaN, integrator/path.py bounce_spectral)
        thru = thru * albedo * (spdf / pdf if pdf > 0.0 else 0.0)
        o, d = p, d_new
        depth += 1
    else:
        rad += thru * BG_VAL   # depth cap → background SPD (spectral.go:48)

    xyz = _cie_xyz_f64(lam)
    w = rad / lam_pdf if lam_pdf > 0.0 else 0.0
    contrib = xyz * w
    return np.where(np.isfinite(contrib), contrib, 0.0)


def _expected_acc(base_key, with_sphere):
    acc = np.zeros((NY * NX, 3))
    for py in range(NY):
        for px in range(NX):
            acc[py * NX + px] = _expected_pixel(base_key, px, py, with_sphere)
    return acc


def _check(got, want, tag):
    np.testing.assert_allclose(
        got, want, rtol=1e-3, atol=1e-3,
        err_msg=f"{tag}: spectral engine diverges from the f64 model")


def test_spectral_pool_matches_model():
    scene = _scene(with_sphere=False)
    ctx = renderer.RenderContext(scene, use_bvh=False)
    # the derived light list is exactly [light rect]
    assert ctx.meta.n_lights == 1
    settings = path_mod.RenderSettings(max_depth=DEPTH)
    key = rng.render_key(SEED)
    want = _expected_acc(key, with_sphere=False)
    pool = ctx.pool_runner(NX, NY, True, ctx.meta.spectral_background_spd,
                           settings)
    acc, _ = pool(key, SPP, NX * NY * SPP, 0)
    _check(np.asarray(acc), want, "spectral pool")


def test_spectral_pool_dispersion_matches_model():
    scene = _scene(with_sphere=True)
    ctx = renderer.RenderContext(scene, use_bvh=False)
    # the dielectric IsEmitter quirk puts the glass sphere in the lights
    from izpi_tpu.integrator import lights as lm
    kinds = np.asarray(ctx.cs.lights.kind)
    assert list(kinds) == [lm.LIGHT_RECT, lm.LIGHT_SPHERE]
    settings = path_mod.RenderSettings(max_depth=DEPTH)
    key = rng.render_key(SEED)
    want = _expected_acc(key, with_sphere=True)
    pool = ctx.pool_runner(NX, NY, True, ctx.meta.spectral_background_spd,
                           settings)
    acc, _ = pool(key, SPP, NX * NY * SPP, 0)
    _check(np.asarray(acc), want, "spectral pool (dispersion)")


def test_spectral_megakernel_matches_model():
    from izpi_tpu.ops import megakernel_spectral

    for with_sphere in (False, True):
        scene = _scene(with_sphere=with_sphere)
        cs, meta = compile_scene(scene)
        if not megakernel_spectral.eligible(cs, meta):
            assert not with_sphere, "sphere scene unexpectedly ineligible"
            continue
        settings = path_mod.RenderSettings(max_depth=DEPTH)
        key = rng.render_key(SEED)
        want = _expected_acc(key, with_sphere=with_sphere)
        run = megakernel_spectral.build_renderer(
            cs, meta, settings, NX, NY, SPP, interpret=True)
        acc, _ = run(key, 0)
        _check(np.asarray(acc), want,
               f"spectral megakernel (sphere={with_sphere})")
