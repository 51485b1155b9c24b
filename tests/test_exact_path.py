"""Exact per-engine estimator tests.

An INDEPENDENT float64 scalar reimplementation of the reference estimator
(sampler/colour.go:33-65 NEE mixture chain, camera.go:28-69 thin lens,
xzrect.go hit/pdf/sample, pdf/cosine.go book lobe) — sharing ONLY the
Threefry uniform streams with the production code — pins the radiance of
every pixel of a tiny scene at spp=1. The lockstep oracle, the XLA wavefront
pool, and the Pallas RGB megakernel (interpret mode) must all reproduce it to
f32 tolerance, so a estimator bias smaller than the goldens' 8% MC band
cannot hide: any formula drift (pdf, cosine factor, one-sided emission,
sentinel, DeNAN) breaks this exactly.
"""

import math

import numpy as np
import jax.numpy as jnp

from izpi_tpu.core import rng
from izpi_tpu.integrator import path as path_mod
from izpi_tpu.render import renderer
from izpi_tpu.scene import types as st
from izpi_tpu.scene.compiler import compile_scene

NX = NY = 8
SPP = 1
DEPTH = 4
BG = (0.05, 0.10, 0.15)
ALBEDO = (0.6, 0.5, 0.4)
EMIT = (10.0, 10.0, 10.0)
SEED = 11

# Scene geometry (all exact in f64): floor y=0, light y=3 (flipped, emits
# down), camera above looking down.
FLOOR = dict(p0=(-2.0, 0.0, -2.0), e1=(4.0, 0.0, 0.0), e2=(0.0, 0.0, 4.0),
             n=(0.0, 1.0, 0.0))
LIGHT = dict(p0=(-1.0, 3.0, -1.0), e1=(2.0, 0.0, 0.0), e2=(0.0, 0.0, 2.0),
             n=(0.0, -1.0, 0.0), area=4.0)
LOOK_FROM = (0.0, 2.0, 0.001)
LOOK_AT = (0.0, 0.0, 0.0)
VFOV = 60.0


def _scene():
    lam = st.Lambertian(st.ConstantTexture(ALBEDO))
    light = st.DiffuseLight(emit=st.ConstantTexture(EMIT))
    return st.Scene(
        world=[
            st.XZRect(-2, 2, -2, 2, 0.0, lam),
            st.FlipNormals(st.XZRect(-1, 1, -1, 1, 3.0, light)),
        ],
        camera=st.Camera(look_from=LOOK_FROM, look_at=LOOK_AT, vfov=VFOV,
                         aspect=NX / NY),
    )


# ---------------- independent f64 model ----------------

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
    fd = 1.0  # focus_dist default
    lower_left = lf - half_w * fd * u - half_h * fd * v - fd * w
    return lf, lower_left, 2.0 * half_w * fd * u, 2.0 * half_h * fd * v


def _rect_hit(rect, o, d, t_min, t_max):
    n = np.array(rect["n"])
    p0 = np.array(rect["p0"])
    e1 = np.array(rect["e1"])
    e2 = np.array(rect["e2"])
    denom = d @ n
    if denom == 0.0:
        return None
    t = (p0 - o) @ n / denom
    if not (t_min <= t <= t_max):
        return None
    rel = o + t * d - p0
    uu = rel @ e1 / (e1 @ e1)
    vv = rel @ e2 / (e2 @ e2)
    if not (0.0 <= uu <= 1.0 and 0.0 <= vv <= 1.0):
        return None
    return t


def _light_pdf(o, v):
    """Mean member pdf over the 1-member light list (xzrect.go:106-116)."""
    t = _rect_hit(LIGHT, o, v, 1e-3, 3.0e38)
    if t is None:
        return 0.0
    v_len2 = v @ v
    cos = abs(v @ np.array(LIGHT["n"])) / math.sqrt(v_len2)
    return t * t * v_len2 / (cos * LIGHT["area"])


def _expected_pixel(base_key, px, py):
    pix = py * NX + px
    keys = rng.path_keys(base_key, jnp.asarray([pix], jnp.int32), 0)
    cam_u = np.asarray(rng.bounce_uniforms(keys, jnp.int32(0), 5,
                                           salt=0x5EED), np.float64)[0]
    origin, lower_left, horizontal, vertical = _camera_frame()
    s = (px + cam_u[0]) / NX
    t = (py + cam_u[1]) / NY
    o = origin.copy()
    d = lower_left + s * horizontal + t * vertical - origin

    rad = np.zeros(3)
    thru = np.ones(3)
    for depth in range(DEPTH):
        t_f = _rect_hit(FLOOR, o, d, 1e-3, 3.0e38)
        t_l = _rect_hit(LIGHT, o, d, 1e-3, 3.0e38)
        hits = [(t_f, "floor"), (t_l, "light")]
        hits = [(tt, who) for tt, who in hits if tt is not None]
        if not hits:
            rad += thru * np.array(BG)
            return rad
        t_hit, who = min(hits, key=lambda x: x[0])
        p = o + t_hit * d
        if who == "light":
            if d @ np.array(LIGHT["n"]) < 0.0:  # one-sided emission
                rad += thru * np.array(EMIT)
            return rad
        # Lambert floor: NEE mixture (colour.go:48-57)
        us = np.asarray(rng.bounce_uniforms(
            keys, jnp.int32(depth), 12), np.float64)[0]
        nrm = np.array(FLOOR["n"])
        # light sample (member pick us[5], point us[6], us[7])
        lp = (np.array(LIGHT["p0"]) + us[6] * np.array(LIGHT["e1"])
              + us[7] * np.array(LIGHT["e2"]))
        d_light = lp - p
        # book cosine lobe on ONB of nrm=(0,1,0): w=nrm, a=(1,0,0),
        # v=norm(w×a), u=w×v (onb.go:41-63)
        w = nrm
        a = np.array([1.0, 0.0, 0.0])
        v_ = np.cross(w, a)
        v_ /= np.linalg.norm(v_)
        u_ = np.cross(w, v_)
        z = math.sqrt(1.0 - us[10])
        phi = 2.0 * math.pi * us[9]
        r = 2.0 * math.sqrt(us[10])  # the book's 2·sqrt(r2) quirk
        local = np.array([math.cos(phi) * r, math.sin(phi) * r, z])
        d_cos = local[0] * u_ + local[1] * v_ + local[2] * w
        d_new = d_light if us[4] < 0.5 else d_cos
        pdf = 0.5 * _light_pdf(p, d_new) + 0.5 * max(
            (d_new / np.linalg.norm(d_new)) @ nrm, 0.0) / math.pi
        cos_out = (d_new / np.linalg.norm(d_new)) @ nrm
        spdf = max(cos_out, 0.0) / math.pi
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = spdf / pdf if pdf != 0.0 else math.inf * spdf
        thru = thru * np.array(ALBEDO) * ratio
        o, d = p, d_new
    rad += thru * np.array([0.0, 0.0, 1.0])  # depth-cap sentinel
    return rad


def _expected_image(base_key):
    img = np.zeros((NY, NX, 3))
    for py in range(NY):
        for px in range(NX):
            c = _expected_pixel(base_key, px, py)
            c = np.where(np.isfinite(c), c, 0.0)  # DeNAN (rgb.go:36)
            img[NY - 1 - py, px] = c  # canvas row flip
    return img


def _check(got, want, tag):
    np.testing.assert_allclose(
        got, want, rtol=2e-4, atol=2e-4,
        err_msg=f"{tag}: engine diverges from the independent f64 model")


def test_oracle_matches_model():
    settings = path_mod.RenderSettings(max_depth=DEPTH, background=BG)
    want = _expected_image(rng.render_key(SEED))
    res = renderer.render(_scene(), NX, NY, SPP, settings=settings,
                          seed=SEED, mode="simple")
    _check(res.image, want, "lockstep oracle")


def test_pool_matches_model():
    settings = path_mod.RenderSettings(max_depth=DEPTH, background=BG)
    want = _expected_image(rng.render_key(SEED))
    res = renderer.render(_scene(), NX, NY, SPP, settings=settings,
                          seed=SEED, mode="wavefront")
    _check(res.image, want, "wavefront pool")


def test_megakernel_matches_model():
    from izpi_tpu.ops import megakernel

    settings = path_mod.RenderSettings(max_depth=DEPTH, background=BG)
    want = _expected_image(rng.render_key(SEED))
    cs, meta = compile_scene(_scene())
    assert megakernel.eligible(cs, meta)
    run = megakernel.build_renderer(cs, meta, settings, NX, NY, SPP,
                                    interpret=True)
    acc, _ = run(rng.render_key(SEED), 0)
    img = np.asarray(acc).reshape(NY, NX, 3)[::-1] / SPP
    _check(img, want, "RGB megakernel")
