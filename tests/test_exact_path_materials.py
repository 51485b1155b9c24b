"""Exact-path pins for the remaining materials.

Extends tests/test_exact_path.py's strategy — an INDEPENDENT float64 scalar
reimplementation of the estimator sharing only the Threefry streams — to the
materials the original model didn't cover:

- metal with fuzz (metal.go:34-40; Scatter always succeeds, no cos check)
- RGB absorbing dielectric on a SPHERE with the Beer–Lambert exit re-trace
  (dielectric.go:104-153) — also pins the sphere primitive record (far-root
  normal quirk, sphere.go:88-99) and the dielectric-IsEmitter-in-lights
  quirk (the glass sphere joins the light list, dielectric.go:215)
- PBR lobe selection + the ad-hoc tangent-frame normal map on a rect
  (pbr.go:65-150) and the DOUBLE normal map on a triangle (triangle-TBN
  map at triangle.go:234-248, then the ad-hoc frame again)
- isotropic / constant-medium exponential free flight
  (constant_medium.go:36-66) with the ScatteringPDF()==0 quirk
  (isotropic.go:54)

Every material tag thus appears in an exact-path assertion. The scalar
model mirrors izpi_tpu.integrator.path.bounce_rgb formula-for-formula in
f64; engines must reproduce it to f32 tolerance at spp=1.
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
EMIT = (10.0, 10.0, 10.0)
SEED = 23
LOOK_FROM = (0.0, 2.0, 0.001)
LOOK_AT = (0.0, 0.0, 0.0)
VFOV = 60.0

LIGHT = dict(p0=(-1.0, 3.0, -1.0), e1=(2.0, 0.0, 0.0), e2=(0.0, 0.0, 2.0),
             n=(0.0, -1.0, 0.0), area=4.0)


def _v(x):
    return np.asarray(x, np.float64)


def _camera_frame():
    lf, la = _v(LOOK_FROM), _v(LOOK_AT)
    vup = _v([0.0, 1.0, 0.0])
    half_h = math.tan(VFOV * math.pi / 360.0)
    half_w = (NX / NY) * half_h
    w = lf - la
    w /= np.linalg.norm(w)
    u = np.cross(vup, w)
    u /= np.linalg.norm(u)
    v = np.cross(w, u)
    lower_left = lf - half_w * u - half_h * v - w
    return lf, lower_left, 2.0 * half_w * u, 2.0 * half_h * v


# ---------------- f64 primitive hits ----------------

def _rect_hit(p0, e1, e2, n, flip, o, d, t_min, t_max):
    p0, e1, e2, n = _v(p0), _v(e1), _v(e2), _v(n)
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
    nn = -n if flip else n
    return dict(t=t, normal=nn, u=uu, v=vv)


def _sphere_hit(c, r, o, d, t_min, t_max):
    c = _v(c)
    oc = o - c
    a = d @ d
    b = oc @ d
    cq = oc @ oc - r * r
    disc = b * b - a * cq
    if disc <= 0.0 or a == 0.0:
        return None
    sq = math.sqrt(disc)
    t_near = (-b - sq) / a
    t_far = (-b + sq) / a
    near_ok = t_min < t_near < t_max
    far_ok = (t_min < t_far < t_max) and not near_ok
    if not (near_ok or far_ok):
        return None
    t = t_near if near_ok else t_far
    p = o + t * d
    outward = (p - c) / r
    flipped = -outward if (d @ outward) >= 0.0 else outward
    # record normal unflipped on the far root (sphere.go:88-99 quirk)
    nn = outward if far_ok else flipped
    return dict(t=t, normal=nn, u=0.0, v=0.0)


def _tri_hit(v0, e1, e2, o, d, t_min, t_max):
    v0, e1, e2 = _v(v0), _v(e1), _v(e2)
    h = np.cross(d, e2)
    a = e1 @ h
    eps = 1e-8
    if abs(a) < eps:
        return None
    f = 1.0 / a
    s = o - v0
    u = f * (s @ h)
    q = np.cross(s, e1)
    v = f * (d @ q)
    t = f * (e2 @ q)
    if not ((u >= -eps) and (u <= 1 + eps) and (v >= -eps)
            and (u + v <= 1 + eps) and (t_min <= t <= t_max)):
        return None
    n = np.cross(e1, e2)
    n /= np.linalg.norm(n)
    return dict(t=t, normal=n, u=u, v=v)


# ---------------- f64 sampling helpers (stream-identical formulas) -------

def _ball(u1, u2, u3):
    z = 1.0 - 2.0 * u1
    phi = 2.0 * math.pi * u2
    s = math.sqrt(max(1.0 - z * z, 0.0))
    r = math.exp(math.log(max(u3, 1e-30)) / 3.0)
    return np.array([s * math.cos(phi), s * math.sin(phi), z]) * r


def _onb(n):
    w = n / np.linalg.norm(n)
    a = _v([0.0, 1.0, 0.0]) if abs(w[0]) > 0.9 else _v([1.0, 0.0, 0.0])
    v = np.cross(w, a)
    v /= np.linalg.norm(v)
    u = np.cross(w, v)
    return u, v, w


def _cosine_gen(axis, u1, u2):
    u, v, w = _onb(axis)
    z = math.sqrt(1.0 - u2)
    phi = 2.0 * math.pi * u1
    r = 2.0 * math.sqrt(u2)     # book 2*sqrt(r2) quirk
    return math.cos(phi) * r * u + math.sin(phi) * r * v + z * w


def _cosine_pdf(axis, dvec):
    c = (dvec / np.linalg.norm(dvec)) @ (axis / np.linalg.norm(axis))
    return c / math.pi if c > 0 else 0.0


def _reflect(v, n):
    return v - 2.0 * (v @ n) * n


# ---------------- scene-driven f64 model ----------------
#
# A scene here is a dict:
#   prims: list of dicts {kind: rect|sphere|tri, geometry..., mat: name,
#                         flip: bool}
#   mats:  name -> {kind: lambert|metal|dielectric|light|pbr,
#                   albedo/fuzz/ref_idx/absorption/rough/metal/nm/...}
#   lights: list of dicts {kind: rect|sphere, ...} (mirror of the compiled
#           light list INCLUDING the dielectric-IsEmitter quirk members)
#   media: list of dicts {lo, hi, density} (box constant media)


def _model_intersect(prims, o, d, t_min, t_max):
    best = None
    for pr in prims:
        if pr["kind"] == "rect":
            h = _rect_hit(pr["p0"], pr["e1"], pr["e2"], pr["n"],
                          pr.get("flip", False), o, d, t_min, t_max)
        elif pr["kind"] == "sphere":
            h = _sphere_hit(pr["c"], pr["r"], o, d, t_min, t_max)
        elif pr["kind"] == "tri":
            h = _tri_hit(pr["v0"], pr["e1"], pr["e2"], o, d, t_min, t_max)
        if h is not None and (best is None or h["t"] < best["t"]):
            h["prim"] = pr
            best = h
    return best


def _light_pdf_sum(lights, o, v):
    total = 0.0
    for li in lights:
        if li["kind"] == "rect":
            h = _rect_hit(li["p0"], li["e1"], li["e2"], li["n"], False,
                          o, v, 1e-3, 3.0e38)
            if h is None:
                continue
            v_len2 = v @ v
            cos = abs(v @ _v(li["n"])) / math.sqrt(v_len2)
            total += h["t"] * h["t"] * v_len2 / (cos * li["area"])
        else:   # sphere member (the dielectric-IsEmitter quirk)
            h = _sphere_hit(li["c"], li["r"], o, v, 1e-3, 3.0e38)
            if h is None:
                continue
            dist2 = (_v(li["c"]) - o) @ (_v(li["c"]) - o)
            cos_max = math.sqrt(max(1.0 - li["r"] ** 2 / dist2, 0.0))
            solid = 2.0 * math.pi * (1.0 - cos_max)
            total += 1.0 / solid if solid > 0 else 0.0
    return total / len(lights)


def _light_sample(lights, o, us):
    idx = min(int(us[5] * len(lights)), len(lights) - 1)
    li = lights[idx]
    if li["kind"] == "rect":
        point = _v(li["p0"]) + us[6] * _v(li["e1"]) + us[7] * _v(li["e2"])
        return point - o
    to_c = _v(li["c"]) - o
    dist2 = to_c @ to_c
    bu, bv, bw = _onb(to_c)
    z = 1.0 + us[7] * (math.sqrt(1.0 - li["r"] ** 2 / dist2) - 1.0)
    phi = 2.0 * math.pi * us[6]
    s = math.sqrt(max(1.0 - z * z, 0.0))
    return math.cos(phi) * s * bu + math.sin(phi) * s * bv + z * bw


def _pbr_frames(rec, mat):
    """(rec_n, pbr_n) per integrator/path._pbr_normals."""
    nm = _v(mat["nm"])
    if rec["prim"]["kind"] == "tri" and "tb" in rec["prim"]:
        tangent, bitangent = rec["prim"]["tb"]
        t_n = 2.0 * nm - 1.0
        mapped = (tangent * t_n[0] + bitangent * t_n[1]
                  + rec["normal"] * t_n[2])
        mapped /= np.linalg.norm(mapped)
        rec_n = mapped
    else:
        rec_n = rec["normal"]
    up = _v([0.0, 1.0, 0.0])
    right = _v([1.0, 0.0, 0.0])
    t_ad = np.cross(rec_n, up)
    if t_ad @ t_ad < 0.001:
        t_ad = np.cross(rec_n, right)
    t_ad /= np.linalg.norm(t_ad)
    b_ad = np.cross(rec_n, t_ad)
    b_ad /= np.linalg.norm(b_ad)
    t_n2 = np.array([2.0 * nm[0] - 1.0, 2.0 * nm[1] - 1.0, nm[2]])
    pbr_n = t_ad * t_n2[0] + b_ad * t_n2[1] + rec_n * t_n2[2]
    pbr_n /= np.linalg.norm(pbr_n)
    return rec_n, pbr_n


def _expected_pixel(model, base_key, px, py):
    pix = py * NX + px
    keys = rng.path_keys(base_key, jnp.asarray([pix], jnp.int32), 0)
    cam_u = np.asarray(rng.bounce_uniforms(keys, jnp.int32(0), 5,
                                           salt=0x5EED), np.float64)[0]
    origin, lower_left, horizontal, vertical = _camera_frame()
    s = (px + cam_u[0]) / NX
    t = (py + cam_u[1]) / NY
    o = origin.copy()
    d = lower_left + s * horizontal + t * vertical - origin

    prims, mats, lights = model["prims"], model["mats"], model["lights"]
    media = model.get("media", [])
    rad = np.zeros(3)
    thru = np.ones(3)
    for depth in range(DEPTH):
        rec = _model_intersect(prims, o, d, 1e-3, 3.0e38)

        # constant media override (integrator/path._apply_media)
        if media:
            u_med = np.asarray(rng.bounce_uniforms(
                keys, jnp.int32(depth), len(media), salt=0x4D45),
                np.float64)[0]
            d_len = np.linalg.norm(d)
            cur_t = rec["t"] if rec is not None else 3.0e38
            for m_i, med in enumerate(media):
                lo, hi = _v(med["lo"]), _v(med["hi"])
                with np.errstate(divide="ignore"):
                    inv = 1.0 / d
                ta = (lo - o) * inv
                tb = (hi - o) * inv
                t1 = np.minimum(ta, tb).max()
                t2 = np.maximum(ta, tb).min()
                ok = t2 > t1
                rec1t = max(t1, 1e-3)
                rec2t = min(t2, cur_t)
                ok = ok and (rec1t < rec2t)
                rec1t = max(rec1t, 0.0)
                dist_inside = (rec2t - rec1t) * d_len
                hit_dist = -(1.0 / med["density"]) * math.log(
                    max(u_med[m_i], 1e-12))
                t_med = rec1t + hit_dist / d_len
                if ok and hit_dist < dist_inside and t_med < cur_t:
                    rec = dict(t=t_med, normal=_v([1.0, 0.0, 0.0]),
                               u=0.0, v=0.0,
                               prim=dict(kind="medium", mat=med["mat"]))
                    cur_t = t_med

        if rec is None:
            rad += thru * _v(BG)
            return rad
        p = o + rec["t"] * d
        nrm = rec["normal"]
        mat = mats[rec["prim"]["mat"]]

        if mat["kind"] == "light":
            if d @ nrm < 0.0:     # one-sided (record normal incl. flip)
                rad += thru * _v(EMIT)
            return rad

        us = np.asarray(rng.bounce_uniforms(
            keys, jnp.int32(depth), 12), np.float64)[0]

        if mat["kind"] == "metal":
            d_new = (_reflect(d / np.linalg.norm(d), nrm)
                     + mat["fuzz"] * _ball(us[0], us[1], us[2]))
            thru = thru * _v(mat["albedo"])
            o, d = p, d_new
            continue

        if mat["kind"] == "dielectric":
            ri = mat["ref_idx"]
            reflected = _reflect(d, nrm)
            d_dot_n = d @ nrm
            exiting = d_dot_n > 0.0
            outward = -nrm if exiting else nrm
            ni = ri if exiting else 1.0 / ri
            dlen = np.linalg.norm(d)
            cosine = (ri * d_dot_n / dlen) if exiting else (-d_dot_n / dlen)
            uvn = d / dlen
            dt = uvn @ outward
            disc = 1.0 - ni * ni * (1.0 - dt * dt)
            can = disc > 0.0
            refr = ni * (uvn - outward * dt) - outward * math.sqrt(
                max(disc, 0.0))
            r0 = ((1.0 - ri) / (1.0 + ri)) ** 2
            schlick = r0 + (1.0 - r0) * (1.0 - cosine) ** 5
            prob = schlick if can else 1.0
            is_refl = us[3] < prob
            d_new = reflected if is_refl else refr
            att = np.ones(3)
            if mat.get("absorption") is not None and not is_refl:
                start = p + 1e-3 * d_new
                ex = _model_intersect(prims, start, d_new, 0.0, 1000.0)
                if ex is not None:
                    plen = np.linalg.norm(start + ex["t"] * d_new - p)
                    plen = min(max(plen, 0.1), 100.0)
                else:
                    plen = 10.0
                att = np.exp(-_v(mat["absorption"]) * plen)
            thru = thru * att
            o, d = p, d_new
            continue

        # diffuse-family: lambert / pbr / isotropic (medium)
        if mat["kind"] == "pbr":
            rec_n, pbr_n = _pbr_frames(rec, mat)
            rough = mat.get("rough", 0.5)
            metal = mat.get("metal", 0.0)
            d_unit = d / np.linalg.norm(d)
            cos_theta = abs(d_unit @ pbr_n)
            fresnel = 0.04 + 0.96 * (1.0 - cos_theta) ** 5 + metal * 0.5
            p_spec = fresnel * (1.0 - rough)
            if us[11] < p_spec:
                rf = max(0.01, rough * 0.3)
                sd = _reflect(d_unit, pbr_n) + rf * _ball(us[0], us[1],
                                                          us[2])
                d_new = sd / np.linalg.norm(sd)
                thru = thru * _v(mat["albedo"])
                o, d = p, d_new
                continue
            cos_axis, spdf_axis = pbr_n, rec_n
        else:
            cos_axis, spdf_axis = nrm, nrm

        d_light = _light_sample(lights, p, us)
        d_cos = _cosine_gen(cos_axis, us[9], us[10])
        d_new = d_light if us[4] < 0.5 else d_cos
        pdf = 0.5 * _light_pdf_sum(lights, p, d_new) + 0.5 * _cosine_pdf(
            cos_axis, d_new)
        cos_out = (d_new / np.linalg.norm(d_new)) @ spdf_axis
        spdf = max(cos_out, 0.0) / math.pi
        if mat["kind"] == "isotropic":
            spdf = 0.0             # isotropic.go:54 quirk
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = spdf / pdf if pdf != 0.0 else math.inf * spdf
        thru = thru * _v(mat["albedo"]) * ratio
        o, d = p, d_new
    rad += thru * _v([0.0, 0.0, 1.0])
    return rad


def _expected_image(model, base_key):
    img = np.zeros((NY, NX, 3))
    for py in range(NY):
        for px in range(NX):
            c = _expected_pixel(model, base_key, px, py)
            c = np.where(np.isfinite(c), c, 0.0)
            img[NY - 1 - py, px] = c
    return img


def _check_engines(scene, model, mega: bool):
    settings = path_mod.RenderSettings(max_depth=DEPTH, background=BG)
    want = _expected_image(model, rng.render_key(SEED))
    for mode in ("simple", "wavefront"):
        res = renderer.render(scene, NX, NY, SPP, settings=settings,
                              seed=SEED, mode=mode)
        np.testing.assert_allclose(
            res.image, want, rtol=3e-4, atol=3e-4,
            err_msg=f"{mode}: diverges from the independent f64 model")
    if mega:
        from izpi_tpu.ops import megakernel

        cs, meta = compile_scene(scene)
        assert megakernel.eligible(cs, meta)
        run = megakernel.build_renderer(cs, meta, settings, NX, NY, SPP,
                                        interpret=True)
        acc, _ = run(rng.render_key(SEED), 0)
        img = np.asarray(acc).reshape(NY, NX, 3)[::-1] / SPP
        np.testing.assert_allclose(
            img, want, rtol=3e-4, atol=3e-4,
            err_msg="megakernel: diverges from the independent f64 model")


def _light_objs():
    lt = st.FlipNormals(st.XZRect(
        -1, 1, -1, 1, 3.0, st.DiffuseLight(emit=st.ConstantTexture(EMIT))))
    model_prim = dict(kind="rect", p0=LIGHT["p0"], e1=LIGHT["e1"],
                      e2=LIGHT["e2"], n=(0.0, 1.0, 0.0), flip=True,
                      mat="light")
    model_light = dict(kind="rect", **LIGHT)
    return lt, model_prim, model_light


def test_metal_fuzz():
    ALB = (0.8, 0.6, 0.4)
    FUZZ = 0.25
    lt, lp, ll = _light_objs()
    scene = st.Scene(
        world=[st.XZRect(-2, 2, -2, 2, 0.0,
                         st.Metal(albedo=ALB, fuzz=FUZZ)), lt],
        camera=st.Camera(look_from=LOOK_FROM, look_at=LOOK_AT, vfov=VFOV,
                         aspect=NX / NY))
    model = dict(
        prims=[dict(kind="rect", p0=(-2.0, 0.0, -2.0),
                    e1=(4.0, 0.0, 0.0), e2=(0.0, 0.0, 4.0),
                    n=(0.0, 1.0, 0.0), mat="m"), lp],
        mats={"m": dict(kind="metal", albedo=ALB, fuzz=FUZZ),
              "light": dict(kind="light")},
        lights=[ll])
    _check_engines(scene, model, mega=True)


def test_dielectric_absorbing_sphere():
    ABSORB = (0.8, 0.3, 0.1)
    C, R = (0.0, 0.7, 0.0), 0.5
    ALB = (0.6, 0.5, 0.4)
    lt, lp, ll = _light_objs()
    scene = st.Scene(
        world=[st.XZRect(-2, 2, -2, 2, 0.0,
                         st.Lambertian(albedo=st.ConstantTexture(ALB))),
               st.Sphere(C, C, 0.0, 1.0, R,
                         st.Dielectric(ref_idx=1.5, absorption=ABSORB)),
               lt],
        camera=st.Camera(look_from=LOOK_FROM, look_at=LOOK_AT, vfov=VFOV,
                         aspect=NX / NY))
    model = dict(
        prims=[dict(kind="rect", p0=(-2.0, 0.0, -2.0),
                    e1=(4.0, 0.0, 0.0), e2=(0.0, 0.0, 4.0),
                    n=(0.0, 1.0, 0.0), mat="floor"),
               dict(kind="sphere", c=C, r=R, mat="glass"), lp],
        mats={"floor": dict(kind="lambert", albedo=ALB),
              "glass": dict(kind="dielectric", ref_idx=1.5,
                            absorption=ABSORB),
              "light": dict(kind="light")},
        # glass sphere joins the light list (dielectric.go:215 IsEmitter
        # quirk) — light member order follows world order
        lights=[dict(kind="sphere", c=C, r=R), ll])
    _check_engines(scene, model, mega=True)


def test_pbr_rect_adhoc_frame():
    ALB = (0.7, 0.5, 0.3)
    NM = (0.6, 0.45, 0.9)
    lt, lp, ll = _light_objs()
    scene = st.Scene(
        world=[st.XZRect(-2, 2, -2, 2, 0.0, st.PBR(
            albedo=st.ConstantTexture(ALB),
            roughness=st.ConstantTexture((0.4, 0.4, 0.4)),
            metalness=st.ConstantTexture((0.2, 0.2, 0.2)),
            normal_map=st.ConstantTexture(NM))), lt],
        camera=st.Camera(look_from=LOOK_FROM, look_at=LOOK_AT, vfov=VFOV,
                         aspect=NX / NY))
    model = dict(
        prims=[dict(kind="rect", p0=(-2.0, 0.0, -2.0),
                    e1=(4.0, 0.0, 0.0), e2=(0.0, 0.0, 4.0),
                    n=(0.0, 1.0, 0.0), mat="m"), lp],
        mats={"m": dict(kind="pbr", albedo=ALB, rough=0.4, metal=0.2,
                        nm=NM),
              "light": dict(kind="light")},
        lights=[ll])
    _check_engines(scene, model, mega=False)


def test_pbr_triangle_double_normal_map():
    ALB = (0.7, 0.5, 0.3)
    NM = (0.6, 0.45, 0.9)
    v0, v1, v2 = (-2.0, 0.0, -2.0), (2.0, 0.0, -2.0), (-2.0, 0.0, 2.0)
    uv0, uv1, uv2 = (0.0, 0.0), (1.0, 0.0), (0.0, 1.0)
    lt, lp, ll = _light_objs()
    mat = st.PBR(albedo=st.ConstantTexture(ALB),
                 roughness=st.ConstantTexture((0.4, 0.4, 0.4)),
                 metalness=st.ConstantTexture((0.2, 0.2, 0.2)),
                 normal_map=st.ConstantTexture(NM))
    scene = st.Scene(
        world=[st.Triangle(v0=v0, v1=v1, v2=v2, material=mat,
                           uv0=uv0, uv1=uv1, uv2=uv2), lt],
        camera=st.Camera(look_from=LOOK_FROM, look_at=LOOK_AT, vfov=VFOV,
                         aspect=NX / NY))
    # tangent frame from UV deltas (compiler mirror of triangle.go:75-98)
    e1 = _v(v1) - _v(v0)
    e2 = _v(v2) - _v(v0)
    du1, dv1 = uv1[0] - uv0[0], uv1[1] - uv0[1]
    du2, dv2 = uv2[0] - uv0[0], uv2[1] - uv0[1]
    f = 1.0 / (du1 * dv2 - du2 * dv1)
    tangent = f * (dv2 * e1 - dv1 * e2)
    tangent /= np.linalg.norm(tangent)
    bitangent = f * (-du2 * e1 + du1 * e2)
    bitangent /= np.linalg.norm(bitangent)
    model = dict(
        prims=[dict(kind="tri", v0=v0, e1=tuple(e1), e2=tuple(e2),
                    mat="m", tb=(tangent, bitangent)), lp],
        mats={"m": dict(kind="pbr", albedo=ALB, rough=0.4, metal=0.2,
                        nm=NM),
              "light": dict(kind="light")},
        lights=[ll])
    _check_engines(scene, model, mega=False)


def test_constant_medium_isotropic():
    ALB = (0.6, 0.5, 0.4)
    ISO = (0.9, 0.8, 0.7)
    DENS = 0.35
    LO, HI = (-2.0, 0.2, -2.0), (2.0, 1.8, 2.0)
    lt, lp, ll = _light_objs()
    scene = st.Scene(
        world=[st.XZRect(-2, 2, -2, 2, 0.0,
                         st.Lambertian(albedo=st.ConstantTexture(ALB))),
               st.ConstantMedium(
                   boundary=st.Box(LO, HI, st.Lambertian(
                       albedo=st.ConstantTexture((1, 1, 1)))),
                   density=DENS,
                   phase=st.Isotropic(albedo=st.ConstantTexture(ISO))),
               lt],
        camera=st.Camera(look_from=LOOK_FROM, look_at=LOOK_AT, vfov=VFOV,
                         aspect=NX / NY))
    model = dict(
        prims=[dict(kind="rect", p0=(-2.0, 0.0, -2.0),
                    e1=(4.0, 0.0, 0.0), e2=(0.0, 0.0, 4.0),
                    n=(0.0, 1.0, 0.0), mat="floor"), lp],
        mats={"floor": dict(kind="lambert", albedo=ALB),
              "light": dict(kind="light"),
              "iso": dict(kind="isotropic", albedo=ISO)},
        lights=[ll],
        media=[dict(lo=LO, hi=HI, density=DENS, mat="iso")])
    _check_engines(scene, model, mega=False)
