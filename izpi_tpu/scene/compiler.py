"""Scene compiler: host-side description → flat device SoA arrays.

The analog of the reference's proto→object-graph compiler
(internal/transport/transport.go:53 `ToScene`), but emitting flat arrays:
primitive SoA, material parameter table, texture table + image stack, light
member SoA, SPD stack, camera arrays. Rigid transforms
(Translate/RotateY/FlipNormals) are baked into geometry; see
izpi_tpu.scene.types.

World/lights derivation matches transport.go:67-80: the world is every
hitable; the light list is every hitable whose material reports IsEmitter()
(DiffuseLight and — deliberately — Dielectric).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from izpi_tpu import camera as camera_mod
from izpi_tpu.geometry import primitives as prim
from izpi_tpu.integrator import lights as lights_mod
from izpi_tpu.materials import tables as mat_tables
from izpi_tpu.scene import types as st
from izpi_tpu.spectral import spd as spd_mod
from izpi_tpu.texture import perlin as perlin_mod
from izpi_tpu.texture import tables as tex_tables


class Media(NamedTuple):
    """Participating media (ConstantMedium boundaries), SoA.

    Boundaries are boxes or spheres in object space with a baked rigid
    transform (rot_w2o/trans: p_obj = rot_w2o @ (p_world - trans)) — the
    analog of the reference wrapping media in Translate/RotateY
    (constant_medium.go + scenes' smoke boxes)."""

    rot_w2o: jax.Array   # (M, 3, 3)
    trans: jax.Array     # (M, 3)
    p0: jax.Array        # (M, 3) box min | sphere center
    p1: jax.Array        # (M, 3) box max | (radius, 0, 0)
    is_sphere: jax.Array # (M,) bool
    density: jax.Array   # (M,)
    mat_id: jax.Array    # (M,) int32 (the Isotropic phase material)


class CompiledScene(NamedTuple):
    """Everything the device needs, as one pytree of arrays."""

    prims: prim.Prims
    materials: mat_tables.Materials
    textures: tex_tables.Textures
    lights: lights_mod.Lights
    camera: camera_mod.CameraArrays
    spd_table: jax.Array  # (S, 371) f32 on the 1nm grid (dummy row 0 = zeros)
    media: Media


@dataclasses.dataclass
class SceneMeta:
    """Static (non-traced) facts about the compiled scene."""

    n_prims: int
    n_materials: int
    n_lights: int
    has_absorbing_dielectric: bool
    spectral: bool
    exposure: float
    spectral_background_spd: Optional[int]  # SPD id or None
    # Static texture-kind facts — let XLA compile out unused evaluators.
    has_checker: bool = True
    has_image: bool = True
    has_noise: bool = True
    has_pbr: bool = True
    n_media: int = 0
    media_is_sphere: tuple = ()
    # Assets replaced by procedural placeholders at load (scene.pbtxt),
    # surfaced in render output so substituted renders are unmistakable.
    placeholder_assets: tuple = ()
    # Mesh axis name when the texture stacks are sharded over devices
    # (parallel.dist.make_sharded_textures); None = replicated textures.
    tex_shard_axis: object = None


@dataclasses.dataclass
class _Transform:
    """Composed rigid transform: p_world = R @ p + t."""

    rot: np.ndarray  # (3,3)
    trans: np.ndarray  # (3,)
    flip: bool

    @staticmethod
    def identity() -> "_Transform":
        return _Transform(np.eye(3), np.zeros(3), False)

    def point(self, p) -> np.ndarray:
        return self.rot @ np.asarray(p, dtype=np.float64) + self.trans

    def vector(self, v) -> np.ndarray:
        return self.rot @ np.asarray(v, dtype=np.float64)

    def then_translate(self, offset) -> "_Transform":
        return _Transform(self.rot, self.trans + self.rot @ np.asarray(offset, np.float64), self.flip)

    def then_rotate_y(self, degrees: float) -> "_Transform":
        # Object→world rotation matching rotate_y.go's inverse ray transform:
        # x' = cosθ·x + sinθ·z ; z' = -sinθ·x + cosθ·z  (rotate_y.go:96-110).
        rad = math.pi / 180.0 * degrees
        c, s = math.cos(rad), math.sin(rad)
        r = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
        return _Transform(self.rot @ r, self.trans, self.flip)

    def then_flip(self) -> "_Transform":
        return _Transform(self.rot, self.trans, not self.flip)


class _Builder:
    def __init__(self) -> None:
        # textures
        self.tex_kind: List[int] = []
        self.tex_c0: List[np.ndarray] = []
        self.tex_c1: List[np.ndarray] = []
        self.tex_scale: List[float] = []
        self.tex_img_id: List[int] = []
        self.images: List[np.ndarray] = []
        self._tex_cache: Dict[int, int] = {}
        self._img_cache: Dict[int, int] = {}
        # materials
        self.mat_rows: List[dict] = []
        self._mat_cache: Dict[int, int] = {}
        # prims
        self.p_kind: List[int] = []
        self.p_g0: List[np.ndarray] = []
        self.p_g1: List[np.ndarray] = []
        self.p_g2: List[np.ndarray] = []
        self.p_g3: List[np.ndarray] = []
        self.p_mat: List[int] = []
        self.p_flip: List[bool] = []
        self.p_uv: List[np.ndarray] = []
        self.p_vn: List[np.ndarray] = []
        self.p_has_vn: List[bool] = []
        self.p_tb: List[np.ndarray] = []
        # lights
        self.l_kind: List[int] = []
        self.l_0: List[np.ndarray] = []
        self.l_1: List[np.ndarray] = []
        self.l_2: List[np.ndarray] = []
        self.l_n: List[np.ndarray] = []
        self.l_area: List[float] = []
        self.l_radius: List[float] = []
        # spectra
        self.spds: List[np.ndarray] = [np.zeros(spd_mod.DEVICE_GRID_N, np.float32)]
        self.has_absorbing_dielectric = False
        # media
        self.med_rot: List[np.ndarray] = []
        self.med_trans: List[np.ndarray] = []
        self.med_p0: List[np.ndarray] = []
        self.med_p1: List[np.ndarray] = []
        self.med_sphere: List[bool] = []
        self.med_density: List[float] = []
        self.med_mat: List[int] = []

    # ---------------- textures ----------------

    def add_constant_color(self, color) -> int:
        return self._add_texture(st.ConstantTexture(tuple(float(x) for x in color)))

    def _add_texture(self, t: st.Texture) -> int:
        key = id(t) if isinstance(t, st.ImageTexture) else hash((type(t).__name__, t if not isinstance(t, st.CheckerTexture) else (id(t.odd), id(t.even))))
        if key in self._tex_cache:
            return self._tex_cache[key]
        if isinstance(t, st.ConstantTexture):
            row = (tex_tables.TEX_CONSTANT, np.array(t.color, np.float64), np.zeros(3), 0.0, -1)
        elif isinstance(t, st.CheckerTexture):
            if not (isinstance(t.odd, st.ConstantTexture) and isinstance(t.even, st.ConstantTexture)):
                raise NotImplementedError("checker children must be constant textures")
            row = (tex_tables.TEX_CHECKER, np.array(t.odd.color, np.float64), np.array(t.even.color, np.float64), 0.0, -1)
        elif isinstance(t, st.ImageTexture):
            img_id = self._add_image(t)
            row = (tex_tables.TEX_IMAGE, np.zeros(3), np.zeros(3), 0.0, img_id)
        elif isinstance(t, st.NoiseTexture):
            row = (tex_tables.TEX_NOISE, np.zeros(3), np.zeros(3), float(t.scale), -1)
        else:
            raise TypeError(f"unknown texture {t!r}")
        tid = len(self.tex_kind)
        self.tex_kind.append(row[0])
        self.tex_c0.append(row[1])
        self.tex_c1.append(row[2])
        self.tex_scale.append(row[3])
        self.tex_img_id.append(row[4])
        self._tex_cache[key] = tid
        return tid

    def _add_image(self, t: st.ImageTexture) -> int:
        key = id(t.data)
        if key in self._img_cache:
            return self._img_cache[key]
        data = np.asarray(t.data, dtype=np.float32)
        if data.ndim == 2:
            data = data[..., None].repeat(3, axis=-1)
        data = data[..., :3]
        # Bake FlipX/FlipY (texture/image.go:104-133) into the stored pixels.
        if t.flip_y:
            data = data[::-1, :, :]
        if t.flip_x:
            data = data[:, ::-1, :]
        iid = len(self.images)
        self.images.append(data)
        self._img_cache[key] = iid
        return iid

    # ---------------- spectra ----------------

    def add_spd(self, spd: spd_mod.SPD) -> int:
        sid = len(self.spds)
        self.spds.append(spd.to_device_grid())
        return sid

    def _fill_spectral_albedo(self, row: dict, t):
        """Route a spectral texture into the material row: constants →
        id/gauss; SpectralChecker → two branches; SpectralImage → the
        uplift flag (evaluated on the fly from the RGB texture)."""
        if t is None:
            return
        if isinstance(t, st.SpectralChecker):
            sid, gauss = self.add_spectral_texture(t.odd)
            row["spec_albedo_id"], row["spec_albedo_gauss"] = sid, gauss
            sid2, gauss2 = self.add_spectral_texture(t.even)
            row["spec_albedo_id2"], row["spec_albedo_gauss2"] = sid2, gauss2
            row["spec_checker"] = True
            return
        if isinstance(t, st.SpectralImage):
            row["tex_albedo"] = self._add_texture(
                st.ImageTexture(data=t.data))
            row["spec_albedo_uplift"] = True
            return
        sid, gauss = self.add_spectral_texture(t)
        row["spec_albedo_id"], row["spec_albedo_gauss"] = sid, gauss

    def add_spectral_texture(self, t: Optional[st.SpectralTexture]):
        """Returns (spd_id, gauss_params). Gaussian spectral constants stay
        parametric (texture/spectral_constant.go:27); tabulated/neutral become
        SPD rows; checker/image handled in later rounds."""
        if t is None:
            return -1, np.zeros(3, np.float64)
        if isinstance(t, st.SpectralGaussian):
            return -1, np.array([t.peak, t.center, t.width], np.float64)
        if isinstance(t, st.SpectralTabulated):
            return self.add_spd(spd_mod.SPD(np.array(t.wavelengths), np.array(t.values))), np.zeros(3, np.float64)
        if isinstance(t, st.SpectralNeutral):
            return self.add_spd(spd_mod.SPD.constant(t.value)), np.zeros(3, np.float64)
        raise NotImplementedError(f"spectral texture {type(t).__name__} not yet compiled")

    # ---------------- materials ----------------

    def add_material(self, m: st.Material) -> int:
        key = id(m)
        if key in self._mat_cache:
            return self._mat_cache[key]
        row = dict(
            kind=mat_tables.MAT_LAMBERT, tex_albedo=-1, fuzz=0.0, ref_idx=1.5,
            absorption=np.zeros(3), has_absorption=False,
            tex_rough=-1, tex_metal=-1, tex_normal=-1, tex_sss=-1,
            sss_radius=0.0,
            spec_albedo_id=-1, spec_albedo_gauss=np.zeros(3),
            spec_ref_idx_id=-1, spec_absorb_id=-1,
            spec_checker=False, spec_albedo_id2=-1,
            spec_albedo_gauss2=np.zeros(3), spec_albedo_uplift=False,
        )
        if isinstance(m, st.Lambertian):
            row["kind"] = mat_tables.MAT_LAMBERT
            if m.albedo is not None:
                row["tex_albedo"] = self._add_texture(m.albedo)
            self._fill_spectral_albedo(row, m.spectral_albedo)
        elif isinstance(m, st.Metal):
            row["kind"] = mat_tables.MAT_METAL
            row["tex_albedo"] = self.add_constant_color(m.albedo)
            row["fuzz"] = float(m.fuzz)
        elif isinstance(m, st.Dielectric):
            row["kind"] = mat_tables.MAT_DIELECTRIC
            row["ref_idx"] = float(m.ref_idx)
            if m.absorption is not None:
                row["absorption"] = np.array(m.absorption, np.float64)
                row["has_absorption"] = True
                self.has_absorbing_dielectric = True
            sid, _ = self.add_spectral_texture(m.spectral_ref_idx)
            row["spec_ref_idx_id"] = sid
            sid, _ = self.add_spectral_texture(m.spectral_absorption)
            row["spec_absorb_id"] = sid
            if sid >= 0:
                self.has_absorbing_dielectric = True
        elif isinstance(m, st.DiffuseLight):
            row["kind"] = mat_tables.MAT_DIFFUSE_LIGHT
            if m.emit is not None:
                row["tex_albedo"] = self._add_texture(m.emit)
            self._fill_spectral_albedo(row, m.spectral_emit)
        elif isinstance(m, st.Isotropic):
            row["kind"] = mat_tables.MAT_ISOTROPIC
            if m.albedo is not None:
                row["tex_albedo"] = self._add_texture(m.albedo)
        elif isinstance(m, st.PBR):
            row["kind"] = mat_tables.MAT_PBR
            for slot, tex in (("tex_albedo", m.albedo), ("tex_rough", m.roughness),
                              ("tex_metal", m.metalness), ("tex_normal", m.normal_map),
                              ("tex_sss", m.sss)):
                if tex is not None:
                    row[slot] = self._add_texture(tex)
            row["sss_radius"] = float(m.sss_radius)
            self._fill_spectral_albedo(row, m.spectral_albedo)
        else:
            raise TypeError(f"unknown material {m!r}")
        mid = len(self.mat_rows)
        self.mat_rows.append(row)
        self._mat_cache[key] = mid
        return mid

    # ---------------- primitives ----------------

    def _push_prim(self, kind, g0, g1, g2, g3, mat_id, flip,
                   uv=None, vn=None, has_vn=False, tb=None):
        # Prim storage is a list of BLOCKS (concatenated at finalize) so bulk
        # meshes can append one (T, …) block instead of T rows.
        self.p_kind.append(np.array([kind], np.int32))
        self.p_g0.append(np.asarray(g0, np.float64)[None])
        self.p_g1.append(np.asarray(g1, np.float64)[None])
        self.p_g2.append(np.asarray(g2, np.float64)[None])
        self.p_g3.append(np.asarray(g3, np.float64)[None])
        self.p_mat.append(np.array([mat_id], np.int32))
        self.p_flip.append(np.array([bool(flip)]))
        self.p_uv.append((np.zeros(6) if uv is None
                          else np.asarray(uv, np.float64))[None])
        self.p_vn.append((np.zeros(9) if vn is None
                          else np.asarray(vn, np.float64))[None])
        self.p_has_vn.append(np.array([bool(has_vn)]))
        self.p_tb.append((np.zeros(6) if tb is None
                          else np.asarray(tb, np.float64))[None])

    def add_rect(self, p0, e1, e2, normal, mat_id, xf: _Transform):
        p0w = xf.point(p0)
        e1w = xf.vector(e1)
        e2w = xf.vector(e2)
        nw = xf.vector(normal)
        self._push_prim(prim.KIND_RECT, p0w, e1w, e2w, nw, mat_id, xf.flip)
        return p0w, e1w, e2w, nw

    def add_triangle_raw(self, v0, v1, v2, uv, vn, has_vn, mat_id, xf: _Transform):
        v0w, v1w, v2w = xf.point(v0), xf.point(v1), xf.point(v2)
        e1 = v1w - v0w
        e2 = v2w - v0w
        n = np.cross(e1, e2)
        n_len = np.linalg.norm(n)
        n = n / n_len if n_len > 0 else np.array([0.0, 0.0, 1.0])
        if has_vn:
            vn = np.concatenate([xf.vector(vn[0:3]), xf.vector(vn[3:6]), xf.vector(vn[6:9])])
        # Tangent/bitangent from UV deltas (triangle.go:75-98).
        du1, dv1 = uv[2] - uv[0], uv[3] - uv[1]
        du2, dv2 = uv[4] - uv[0], uv[5] - uv[1]
        denom = du1 * dv2 - du2 * dv1
        if denom != 0.0:
            f = 1.0 / denom
            tangent = f * (dv2 * e1 - dv1 * e2)
            bitangent = f * (-du2 * e1 + du1 * e2)
            tl = np.linalg.norm(tangent)
            bl = np.linalg.norm(bitangent)
            tangent = tangent / tl if tl > 0 else tangent
            bitangent = bitangent / bl if bl > 0 else bitangent
            tb = np.concatenate([tangent, bitangent])
        else:
            tb = np.zeros(6)
        self._push_prim(prim.KIND_TRIANGLE, v0w, e1, e2, n, mat_id, xf.flip,
                        uv=uv, vn=vn, has_vn=has_vn, tb=tb)
        return v0w, v1w, v2w, n

    def add_triangle_mesh(self, vertices, uvs, normals, mat_id,
                          xf: _Transform):
        """Vectorized add_triangle_raw over a (T, 3, 3) vertex array —
        identical per-triangle results, one block append."""
        v = np.asarray(vertices, np.float64) @ xf.rot.T + xf.trans  # (T,3,3)
        T = v.shape[0]
        v0, e1, e2 = v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
        n = np.cross(e1, e2)
        n_len = np.linalg.norm(n, axis=1, keepdims=True)
        n = np.where(n_len > 0, n / np.where(n_len > 0, n_len, 1.0),
                     np.array([0.0, 0.0, 1.0]))
        uv = (np.asarray(uvs, np.float64).reshape(T, 6)
              if uvs is not None else np.zeros((T, 6)))
        has_vn = normals is not None
        if has_vn:
            vn = np.asarray(normals, np.float64) @ xf.rot.T
            vn = vn.reshape(T, 9)
        else:
            vn = np.zeros((T, 9))
        du1, dv1 = uv[:, 2] - uv[:, 0], uv[:, 3] - uv[:, 1]
        du2, dv2 = uv[:, 4] - uv[:, 0], uv[:, 5] - uv[:, 1]
        denom = du1 * dv2 - du2 * dv1
        f = np.where(denom != 0.0, 1.0 / np.where(denom != 0.0, denom, 1.0),
                     0.0)[:, None]
        tangent = f * (dv2[:, None] * e1 - dv1[:, None] * e2)
        bitangent = f * (-du2[:, None] * e1 + du1[:, None] * e2)

        def _norm(x):
            ln = np.linalg.norm(x, axis=1, keepdims=True)
            return np.where(ln > 0, x / np.where(ln > 0, ln, 1.0), x)

        tb = np.concatenate([_norm(tangent), _norm(bitangent)], axis=1)
        tb = np.where((denom != 0.0)[:, None], tb, 0.0)

        self.p_kind.append(np.full(T, prim.KIND_TRIANGLE, np.int32))
        self.p_g0.append(v0)
        self.p_g1.append(e1)
        self.p_g2.append(e2)
        self.p_g3.append(n)
        self.p_mat.append(np.full(T, mat_id, np.int32))
        self.p_flip.append(np.full(T, bool(xf.flip)))
        self.p_uv.append(uv)
        self.p_vn.append(vn)
        self.p_has_vn.append(np.full(T, has_vn))
        self.p_tb.append(tb)

    def add_sphere(self, c0, c1, t0, t1, radius, mat_id, xf: _Transform):
        c0w = xf.point(c0)
        c1w = xf.point(c1)
        self._push_prim(prim.KIND_SPHERE, c0w, c1w,
                        np.array([radius, t0, t1]), np.zeros(3), mat_id, xf.flip)
        return c0w, c1w

    # ---------------- lights ----------------

    def add_light_rect(self, p0, e1, e2, normal, area):
        self.l_kind.append(lights_mod.LIGHT_RECT)
        self.l_0.append(np.asarray(p0, np.float64))
        self.l_1.append(np.asarray(e1, np.float64))
        self.l_2.append(np.asarray(e2, np.float64))
        self.l_n.append(np.asarray(normal, np.float64))
        self.l_area.append(float(area))
        self.l_radius.append(0.0)

    def add_light_triangle(self, v0, v1, v2, normal, area):
        self.l_kind.append(lights_mod.LIGHT_TRIANGLE)
        self.l_0.append(np.asarray(v0, np.float64))
        self.l_1.append(np.asarray(v1, np.float64))
        self.l_2.append(np.asarray(v2, np.float64))
        self.l_n.append(np.asarray(normal, np.float64))
        self.l_area.append(float(area))
        self.l_radius.append(0.0)

    def add_light_sphere(self, center0, radius):
        self.l_kind.append(lights_mod.LIGHT_SPHERE)
        self.l_0.append(np.asarray(center0, np.float64))
        self.l_1.append(np.zeros(3))
        self.l_2.append(np.zeros(3))
        self.l_n.append(np.zeros(3))
        self.l_area.append(0.0)
        self.l_radius.append(float(radius))

    def add_light_null(self):
        self.l_kind.append(lights_mod.LIGHT_NULL)
        self.l_0.append(np.zeros(3))
        self.l_1.append(np.zeros(3))
        self.l_2.append(np.zeros(3))
        self.l_n.append(np.zeros(3))
        self.l_area.append(0.0)
        self.l_radius.append(0.0)


# Rect construction tables, matching xyrect.go / xzrect.go / yzrect.go UV
# parameterizations and normals.

def _rect_geometry(h: st.Hitable):
    if isinstance(h, st.XYRect):
        p0 = (h.x0, h.y0, h.k)
        e1 = (h.x1 - h.x0, 0.0, 0.0)
        e2 = (0.0, h.y1 - h.y0, 0.0)
        n = (0.0, 0.0, 1.0)
    elif isinstance(h, st.XZRect):
        p0 = (h.x0, h.k, h.z0)
        e1 = (h.x1 - h.x0, 0.0, 0.0)
        e2 = (0.0, 0.0, h.z1 - h.z0)
        n = (0.0, 1.0, 0.0)
    elif isinstance(h, st.YZRect):
        p0 = (h.k, h.y0, h.z0)
        e1 = (0.0, h.y1 - h.y0, 0.0)
        e2 = (0.0, 0.0, h.z1 - h.z0)
        n = (1.0, 0.0, 0.0)
    else:
        raise TypeError(h)
    area = np.linalg.norm(np.cross(e1, e2))
    return np.array(p0), np.array(e1), np.array(e2), np.array(n), float(area)


def _box_sides(b: st.Box):
    """Box = 6 rects, back faces flipped (box.go:27-34)."""
    p0, p1 = b.p0, b.p1
    return [
        (st.XYRect(p0[0], p1[0], p0[1], p1[1], p1[2], b.material), False),
        (st.XYRect(p0[0], p1[0], p0[1], p1[1], p0[2], b.material), True),
        (st.XZRect(p0[0], p1[0], p0[2], p1[2], p1[1], b.material), False),
        (st.XZRect(p0[0], p1[0], p0[2], p1[2], p0[1], b.material), True),
        (st.YZRect(p0[1], p1[1], p0[2], p1[2], p1[0], b.material), False),
        (st.YZRect(p0[1], p1[1], p0[2], p1[2], p0[0], b.material), True),
    ]


def _compile_hitable(b: _Builder, h: st.Hitable, xf: _Transform):
    if isinstance(h, st.Group):
        for child in h.children:
            _compile_hitable(b, child, xf)
    elif isinstance(h, st.FlipNormals):
        _compile_hitable(b, h.inner, xf.then_flip())
    elif isinstance(h, st.Translate):
        _compile_hitable(b, h.inner, xf.then_translate(h.offset))
    elif isinstance(h, st.RotateY):
        _compile_hitable(b, h.inner, xf.then_rotate_y(h.angle_degrees))
    elif isinstance(h, (st.XYRect, st.XZRect, st.YZRect)):
        mat_id = b.add_material(h.material)
        p0, e1, e2, n, _ = _rect_geometry(h)
        b.add_rect(p0, e1, e2, n, mat_id, xf)
    elif isinstance(h, st.Box):
        mat_id = b.add_material(h.material)
        for rect, flipped in _box_sides(h):
            p0, e1, e2, n, _ = _rect_geometry(rect)
            b.add_rect(p0, e1, e2, n, mat_id, xf.then_flip() if flipped else xf)
    elif isinstance(h, st.Sphere):
        mat_id = b.add_material(h.material)
        b.add_sphere(h.center0, h.center1, h.time0, h.time1, h.radius, mat_id, xf)
    elif isinstance(h, st.Triangle):
        mat_id = b.add_material(h.material)
        uv = np.array([*h.uv0, *h.uv1, *h.uv2], np.float64)
        has_vn = h.vn0 is not None
        vn = (np.array([*h.vn0, *h.vn1, *h.vn2], np.float64)
              if has_vn else np.zeros(9))
        b.add_triangle_raw(h.v0, h.v1, h.v2, uv, vn, has_vn, mat_id, xf)
    elif isinstance(h, st.TriangleMesh):
        mat_id = b.add_material(h.material)
        b.add_triangle_mesh(h.vertices, h.uvs, h.normals, mat_id, xf)
    elif isinstance(h, st.ConstantMedium):
        # Resolve the boundary (possibly transform-wrapped box/sphere) into
        # a rigid transform + canonical shape.
        mat_id = b.add_material(h.phase)
        inner = h.boundary
        bxf = xf
        while isinstance(inner, (st.FlipNormals, st.Translate, st.RotateY)):
            if isinstance(inner, st.FlipNormals):
                inner = inner.inner
            elif isinstance(inner, st.Translate):
                bxf = bxf.then_translate(inner.offset)
                inner = inner.inner
            else:
                bxf = bxf.then_rotate_y(inner.angle_degrees)
                inner = inner.inner
        if isinstance(inner, st.Box):
            b.med_rot.append(bxf.rot.T)  # world→object
            b.med_trans.append(bxf.trans)
            b.med_p0.append(np.array(inner.p0, np.float64))
            b.med_p1.append(np.array(inner.p1, np.float64))
            b.med_sphere.append(False)
        elif isinstance(inner, st.Sphere):
            b.med_rot.append(bxf.rot.T)
            b.med_trans.append(bxf.trans)
            b.med_p0.append(np.array(inner.center0, np.float64))
            b.med_p1.append(np.array([inner.radius, 0.0, 0.0]))
            b.med_sphere.append(True)
        else:
            raise NotImplementedError(
                f"ConstantMedium boundary {type(inner).__name__} unsupported")
        b.med_density.append(float(h.density))
        b.med_mat.append(mat_id)
    else:
        raise TypeError(f"unknown hitable {h!r}")


def _compile_light(b: _Builder, h: st.Hitable):
    """Light members at the reference's granularity. Translate/RotateY are
    deliberately ignored (the reference delegates PDFValue/Random to the
    untransformed inner hitable, translate.go:58-64 / rotate_y.go:150-156)."""
    if isinstance(h, (st.FlipNormals, st.Translate, st.RotateY)):
        _compile_light(b, h.inner)
    elif isinstance(h, (st.XYRect, st.XZRect, st.YZRect)):
        p0, e1, e2, n, area = _rect_geometry(h)
        b.add_light_rect(p0, e1, e2, n, area)
    elif isinstance(h, st.Triangle):
        v0 = np.array(h.v0, np.float64)
        v1 = np.array(h.v1, np.float64)
        v2 = np.array(h.v2, np.float64)
        cr = np.cross(v1 - v0, v2 - v0)
        area = np.linalg.norm(cr) / 2.0
        n = cr / np.linalg.norm(cr)
        b.add_light_triangle(v0, v1, v2, n, area)
    elif isinstance(h, st.TriangleMesh):
        for i in range(h.vertices.shape[0]):
            v = h.vertices[i]
            cr = np.cross(v[1] - v[0], v[2] - v[0])
            area = np.linalg.norm(cr) / 2.0
            n = cr / np.linalg.norm(cr)
            b.add_light_triangle(v[0], v[1], v[2], n, area)
    elif isinstance(h, st.Sphere):
        b.add_light_sphere(h.center0, h.radius)
    else:
        # Box and anything else: PDF 0 / Random (1,0,0) (box.go:57-63).
        b.add_light_null()


# Host-side shadow of the last few compiled primitive SoAs. The BVH builders
# need the prims back on the host; re-fetching them with device_get moves
# the whole SoA back from the device at dragon scale, and the numpy
# originals exist right here at compile time. Keyed by the identity of
# the device `kind` array (a strong ref keeps the id stable); tiny FIFO.
_HOST_PRIMS: "List[Tuple[jax.Array, tuple, prim.Prims]]" = []


def _register_host_prims(device_prims: prim.Prims, host: prim.Prims) -> None:
    _HOST_PRIMS.append((device_prims.kind, device_prims.kind.shape, host))
    if len(_HOST_PRIMS) > 4:
        _HOST_PRIMS.pop(0)


def host_prims_for(device_prims: prim.Prims) -> Optional[prim.Prims]:
    """The host numpy mirror of a compiled prim SoA, if this process
    compiled it (None → caller must device_get)."""
    for key, shape, host in _HOST_PRIMS:
        if key is device_prims.kind and shape == device_prims.kind.shape:
            return host
    return None


def compile_scene(scene: st.Scene) -> Tuple[CompiledScene, SceneMeta]:
    b = _Builder()
    for h in scene.world:
        _compile_hitable(b, h, _Transform.identity())
    for h in scene.emitters():
        _compile_light(b, h)
    if not b.l_kind:
        # Keep shapes non-empty; a null member yields pdf 0 everywhere.
        b.add_light_null()

    if not b.p_kind:
        raise ValueError("scene has no primitives")

    f32 = lambda x: jnp.asarray(np.asarray(x, np.float64), jnp.float32)
    i32 = lambda x: jnp.asarray(np.asarray(x), jnp.int32)
    cat = np.concatenate

    f32h = lambda x: np.asarray(np.asarray(x, np.float64), np.float32)
    i32h = lambda x: np.asarray(np.asarray(x), np.int32)
    host_prims = prim.Prims(
        kind=i32h(cat(b.p_kind)),
        g0=f32h(cat(b.p_g0)), g1=f32h(cat(b.p_g1)),
        g2=f32h(cat(b.p_g2)), g3=f32h(cat(b.p_g3)),
        mat_id=i32h(cat(b.p_mat)),
        flip=np.asarray(cat(b.p_flip)),
        uv=f32h(cat(b.p_uv)),
        vn=f32h(cat(b.p_vn)),
        has_vn=np.asarray(cat(b.p_has_vn)),
        tb=f32h(cat(b.p_tb)),
    )
    prims = prim.Prims(*[jnp.asarray(f) for f in host_prims])
    _register_host_prims(prims, host_prims)
    n_p = int(prims.kind.shape[0])

    if not b.tex_kind:
        b.add_constant_color((0.0, 0.0, 0.0))
    if b.images:
        max_h = max(im.shape[0] for im in b.images)
        max_w = max(im.shape[1] for im in b.images)
        stack = np.zeros((len(b.images), max_h, max_w, 3), np.float32)
        ws, hs = [], []
        for i, im in enumerate(b.images):
            stack[i, : im.shape[0], : im.shape[1]] = im
            hs.append(im.shape[0])
            ws.append(im.shape[1])
    else:
        stack = np.zeros((1, 1, 1, 3), np.float32)
        ws, hs = [1], [1]

    # Combined per-material map stack (albedo+normal+rough+metal in one
    # 8-channel row): the hot bounce then does ONE big-table gather per ray
    # instead of four — big-table gathers are index-count bound at
    # ~13 ns/lookup on this backend (docs/PERF.md round 4). Each map is
    # baked at the material's max map resolution with the reference's own
    # nearest-neighbor index math (texture/image.go:73-101) evaluated at
    # the output texel's uv — EXACT for same-resolution maps (the common
    # case), nearest-resampled for mixed resolutions.
    tex_kind_h = np.asarray(b.tex_kind)
    tex_img_h = np.asarray(b.tex_img_id)

    def _img_id_of(tid):
        if tid is None or tid < 0 or tid >= len(tex_kind_h):
            return None
        if tex_kind_h[tid] != tex_tables.TEX_IMAGE:
            return None
        return int(tex_img_h[tid])

    # Combos are deduped by their (albedo, normal, rough, metal) IMAGE-id
    # tuple — the baked row depends only on those images — so materials
    # sharing one PBR map set share one slab instead of each baking a
    # (maxH, maxW, 8) copy. A byte cap bounds the padded stack: materials
    # whose combo would blow it keep combo_id=-1 and take the generic
    # 4-gather path instead (integrator reads combo_id<0 as "no combo").
    combo_bytes_cap = int(os.environ.get("IZPI_COMBO_BYTES_CAP",
                                         str(1 << 29)))
    combo_ids = []
    combos = []
    combo_by_key = {}
    for r in b.mat_rows:
        key = (_img_id_of(r["tex_albedo"]), _img_id_of(r["tex_normal"]),
               _img_id_of(r["tex_rough"]), _img_id_of(r["tex_metal"]))
        if all(iid is None for iid in key):
            combo_ids.append(-1)
            continue
        if key in combo_by_key:
            combo_ids.append(combo_by_key[key])
            continue
        imgs = [None if iid is None else b.images[iid] for iid in key]
        ch = max(im.shape[0] for im in imgs if im is not None)
        cw = max(im.shape[1] for im in imgs if im is not None)
        jj, ii = np.meshgrid(np.arange(ch), np.arange(cw), indexing="ij")
        u_c = (ii + 0.5) / cw
        omv_c = (jj + 0.5) / ch          # 1 - v at the texel center

        def samp(im):
            hm, wm = im.shape[:2]
            i2 = np.clip((u_c * wm).astype(np.int64), 0, wm - 1)
            j2 = np.clip((omv_c * (hm - 0.001)).astype(np.int64), 0, hm - 1)
            return np.asarray(im, np.float32)[j2, i2]

        out = np.zeros((ch, cw, 8), np.float32)
        if imgs[0] is not None:
            out[..., 0:3] = samp(imgs[0])
        if imgs[1] is not None:
            out[..., 3:6] = samp(imgs[1])
        if imgs[2] is not None:
            s3 = samp(imgs[2])
            out[..., 6] = (s3[..., 0] + s3[..., 1] + s3[..., 2]) / 3.0
        if imgs[3] is not None:
            s3 = samp(imgs[3])
            out[..., 7] = (s3[..., 0] + s3[..., 1] + s3[..., 2]) / 3.0
        combo_by_key[key] = len(combos)
        combo_ids.append(len(combos))
        combos.append(out)
    if combos:
        # Enforce the cap on the PADDED stack (every combo pays the global
        # max resolution): evict largest-first until it fits, remapping
        # evicted materials to the generic path.
        while combos:
            c_h = max(c.shape[0] for c in combos)
            c_w = max(c.shape[1] for c in combos)
            if len(combos) * c_h * c_w * 8 * 4 <= combo_bytes_cap:
                break
            biggest = max(range(len(combos)),
                          key=lambda i: combos[i].shape[0]
                          * combos[i].shape[1])
            combos.pop(biggest)
            combo_ids = [-1 if c == biggest else (c - 1 if c > biggest else c)
                         for c in combo_ids]
    if combos:
        c_h = max(c.shape[0] for c in combos)
        c_w = max(c.shape[1] for c in combos)
        cstack = np.zeros((len(combos), c_h, c_w, 8), np.float32)
        c_ws, c_hs = [], []
        for i, c in enumerate(combos):
            cstack[i, : c.shape[0], : c.shape[1]] = c
            c_hs.append(c.shape[0])
            c_ws.append(c.shape[1])
    else:
        cstack = np.zeros((0, 1, 1, 8), np.float32)
        c_ws, c_hs = [], []

    textures = tex_tables.Textures(
        kind=i32(b.tex_kind),
        c0=f32(np.stack(b.tex_c0)), c1=f32(np.stack(b.tex_c1)),
        scale=f32(b.tex_scale), img_id=i32(b.tex_img_id),
        images=jnp.asarray(stack), img_w=i32(ws), img_h=i32(hs),
        perlin=perlin_mod.build_tables(seed=0),
        combined=jnp.asarray(cstack), combo_w=i32(c_ws), combo_h=i32(c_hs),
    )

    if scene.spectral:
        # SPECTRAL scenes uplift PBR RGB albedos automatically, like the
        # transport's textureToSpectralTexture step (transport.go:241-248).
        for r in b.mat_rows:
            if (r["kind"] == mat_tables.MAT_PBR and r["spec_albedo_id"] < 0
                    and r["spec_albedo_gauss"][2] <= 0):
                r["spec_albedo_uplift"] = True

    col = lambda name: [r[name] for r in b.mat_rows]
    materials = mat_tables.Materials(
        kind=i32(col("kind")), tex_albedo=i32(col("tex_albedo")),
        fuzz=f32(col("fuzz")), ref_idx=f32(col("ref_idx")),
        absorption=f32(np.stack(col("absorption"))),
        has_absorption=jnp.asarray(col("has_absorption")),
        tex_rough=i32(col("tex_rough")), tex_metal=i32(col("tex_metal")),
        tex_normal=i32(col("tex_normal")), tex_sss=i32(col("tex_sss")),
        sss_radius=f32(col("sss_radius")),
        spec_albedo_id=i32(col("spec_albedo_id")),
        spec_albedo_gauss=f32(np.stack(col("spec_albedo_gauss"))),
        spec_ref_idx_id=i32(col("spec_ref_idx_id")),
        spec_absorb_id=i32(col("spec_absorb_id")),
        spec_checker=jnp.asarray(col("spec_checker")),
        spec_albedo_id2=i32(col("spec_albedo_id2")),
        spec_albedo_gauss2=f32(np.stack(col("spec_albedo_gauss2"))),
        spec_albedo_uplift=jnp.asarray(col("spec_albedo_uplift")),
        combo_id=i32(combo_ids),
    )

    lights = lights_mod.Lights(
        kind=i32(b.l_kind),
        l0=f32(np.stack(b.l_0)), l1=f32(np.stack(b.l_1)),
        l2=f32(np.stack(b.l_2)), normal=f32(np.stack(b.l_n)),
        area=f32(b.l_area), radius=f32(b.l_radius),
    )

    spectral_bg_id = None
    if scene.spectral_background is not None:
        spectral_bg_id = b.add_spd(scene.spectral_background)

    n_media = len(b.med_density)
    if n_media == 0:
        media = Media(
            rot_w2o=f32(np.eye(3)[None]), trans=f32(np.zeros((1, 3))),
            p0=f32(np.zeros((1, 3))), p1=f32(np.ones((1, 3))),
            is_sphere=jnp.asarray([False]), density=f32([1.0]),
            mat_id=i32([0]),
        )
    else:
        media = Media(
            rot_w2o=f32(np.stack(b.med_rot)), trans=f32(np.stack(b.med_trans)),
            p0=f32(np.stack(b.med_p0)), p1=f32(np.stack(b.med_p1)),
            is_sphere=jnp.asarray(b.med_sphere), density=f32(b.med_density),
            mat_id=i32(b.med_mat),
        )

    cs = CompiledScene(
        prims=prims, materials=materials, textures=textures, lights=lights,
        camera=camera_mod.compile_camera(scene.camera),
        spd_table=jnp.asarray(np.stack(b.spds)),
        media=media,
    )
    kinds_present = set(b.tex_kind)
    meta = SceneMeta(
        n_prims=n_p, n_materials=len(b.mat_rows), n_lights=len(b.l_kind),
        has_absorbing_dielectric=b.has_absorbing_dielectric,
        spectral=scene.spectral,
        exposure=scene.camera.exposure,
        spectral_background_spd=spectral_bg_id,
        has_checker=tex_tables.TEX_CHECKER in kinds_present,
        has_image=tex_tables.TEX_IMAGE in kinds_present,
        has_noise=tex_tables.TEX_NOISE in kinds_present,
        has_pbr=any(r["kind"] == mat_tables.MAT_PBR for r in b.mat_rows),
        n_media=n_media,
        media_is_sphere=tuple(b.med_sphere),
        placeholder_assets=tuple(scene.placeholder_assets),
    )
    return cs, meta
