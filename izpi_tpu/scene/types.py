"""Host-side scene description.

The user-facing scene-building API, mirroring the reference's constructor
vocabulary (internal/hitable, internal/material, internal/texture) so its 26
built-in scenes translate line-for-line — but these objects are inert
descriptions: `izpi_tpu.scene.compiler` flattens them into SoA device arrays
(the analog of internal/transport/transport.go:53 `ToScene`, which builds the
object graph instead).

Geometric wrappers (Translate/RotateY/FlipNormals, reference:
internal/hitable/translate.go, rotate_y.go, flip_normals.go) are *baked* at
compile time: the reference transforms each ray into object space per hit;
here the geometry is transformed once — identical intersections for rigid
transforms, with no per-ray work.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

Vec3 = Tuple[float, float, float]


# --------------------------------------------------------------------------
# Textures (reference: internal/texture)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ConstantTexture:
    """Flat RGB color. Reference: texture/constant.go."""

    color: Vec3


@dataclass(frozen=True)
class CheckerTexture:
    """3D sine checker of two sub-textures. Reference: texture/checker.go:26
    (sign of sin(10x)·sin(10y)·sin(10z) picks odd/even)."""

    odd: "Texture"
    even: "Texture"


@dataclass(frozen=True)
class ImageTexture:
    """Float image texture, nearest-neighbor with V flip.
    Reference: texture/image.go:73-101. `data` is (H, W, 3|4) float."""

    data: np.ndarray
    flip_x: bool = False
    flip_y: bool = False

    def __hash__(self):
        return id(self.data)

    def __eq__(self, other):
        return self is other


@dataclass(frozen=True)
class NoiseTexture:
    """Perlin-turbulence marble. Reference: texture/noise.go:27."""

    scale: float = 1.0


Texture = Union[ConstantTexture, CheckerTexture, ImageTexture, NoiseTexture]


# --------------------------------------------------------------------------
# Spectral textures (reference: internal/texture/spectral_*.go)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class SpectralGaussian:
    """Gaussian λ response: peak·exp(-(λ-center)²/(2σ²)).
    Reference: texture/spectral_constant.go:27."""

    peak: float
    center: float
    width: float


@dataclass(frozen=True)
class SpectralTabulated:
    """Tabulated SPD reflectance/emission.
    Reference: texture/spectral_constant.go:39."""

    wavelengths: Tuple[float, ...]
    values: Tuple[float, ...]


@dataclass(frozen=True)
class SpectralNeutral:
    """Flat reflectance across all λ. Reference: texture/spectral_constant.go:48."""

    value: float


@dataclass(frozen=True)
class SpectralChecker:
    """Checker of two spectral textures. Reference: texture/spectral_checker.go."""

    odd: "SpectralTexture"
    even: "SpectralTexture"
    scale: float = 10.0


@dataclass(frozen=True)
class SpectralImage:
    """RGB image uplifted to λ buckets. Reference: texture/spectral_image.go."""

    data: np.ndarray  # (H, W, 3) float RGB, uplifted by the compiler

    def __hash__(self):
        return id(self.data)

    def __eq__(self, other):
        return self is other


SpectralTexture = Union[
    SpectralGaussian, SpectralTabulated, SpectralNeutral, SpectralChecker,
    SpectralImage,
]


# --------------------------------------------------------------------------
# Materials (reference: internal/material)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Lambertian:
    """Cosine-lobe diffuse. Reference: material/lambertian.go."""

    albedo: Optional[Texture] = None
    spectral_albedo: Optional[SpectralTexture] = None


@dataclass(frozen=True)
class Metal:
    """Mirror + fuzz, always specular. Reference: material/metal.go."""

    albedo: Vec3
    fuzz: float = 0.0


@dataclass(frozen=True)
class Dielectric:
    """Glass with Schlick-probabilistic reflect/refract; optional dispersion
    via η(λ) SPD and Beer–Lambert absorption.
    Reference: material/dielectric.go:33-63."""

    ref_idx: float = 1.5
    # Spectral refractive index (dispersion), overrides ref_idx at λ.
    spectral_ref_idx: Optional[SpectralTexture] = None
    # RGB absorption coefficients (Beer–Lambert), None = clear glass.
    absorption: Optional[Vec3] = None
    # Spectral absorption at λ.
    spectral_absorption: Optional[SpectralTexture] = None


@dataclass(frozen=True)
class DiffuseLight:
    """One-sided emitter. Reference: material/diffuselight.go."""

    emit: Optional[Texture] = None
    spectral_emit: Optional[SpectralTexture] = None


@dataclass(frozen=True)
class Isotropic:
    """Uniform-sphere phase function (for ConstantMedium).
    Reference: material/isotropic.go."""

    albedo: Optional[Texture] = None
    spectral_albedo: Optional[SpectralTexture] = None


@dataclass(frozen=True)
class PBR:
    """Textured PBR material. Reference: material/pbr.go:20-31."""

    albedo: Optional[Texture] = None
    roughness: Optional[Texture] = None
    metalness: Optional[Texture] = None
    normal_map: Optional[Texture] = None
    sss: Optional[Texture] = None
    sss_radius: float = 0.0
    spectral_albedo: Optional[SpectralTexture] = None


Material = Union[Lambertian, Metal, Dielectric, DiffuseLight, Isotropic, PBR]


def is_emitter(mat: Material) -> bool:
    """Reference semantics: DiffuseLight AND Dielectric report IsEmitter()
    (the dielectric hack so glass participates in light-list sampling,
    material/dielectric.go:215)."""
    return isinstance(mat, (DiffuseLight, Dielectric))


# --------------------------------------------------------------------------
# Hitables (reference: internal/hitable)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Sphere:
    """Possibly-moving sphere. Reference: hitable/sphere.go."""

    center0: Vec3
    center1: Vec3
    time0: float
    time1: float
    radius: float
    material: Material


@dataclass(frozen=True)
class XYRect:
    """Axis-aligned rect at z=k, normal +Z. Reference: hitable/xyrect.go."""

    x0: float
    x1: float
    y0: float
    y1: float
    k: float
    material: Material


@dataclass(frozen=True)
class XZRect:
    """Axis-aligned rect at y=k, normal +Y. Reference: hitable/xzrect.go."""

    x0: float
    x1: float
    z0: float
    z1: float
    k: float
    material: Material


@dataclass(frozen=True)
class YZRect:
    """Axis-aligned rect at x=k, normal +X. Reference: hitable/yzrect.go."""

    y0: float
    y1: float
    z0: float
    z1: float
    k: float
    material: Material


@dataclass(frozen=True)
class Box:
    """Six rects with back faces flipped. Reference: hitable/box.go:27-34."""

    p0: Vec3
    p1: Vec3
    material: Material


@dataclass(frozen=True)
class Triangle:
    """Triangle with optional UVs and per-vertex normals.
    Reference: hitable/triangle.go."""

    v0: Vec3
    v1: Vec3
    v2: Vec3
    material: Material
    uv0: Tuple[float, float] = (0.0, 0.0)
    uv1: Tuple[float, float] = (0.0, 0.0)
    uv2: Tuple[float, float] = (0.0, 0.0)
    vn0: Optional[Vec3] = None
    vn1: Optional[Vec3] = None
    vn2: Optional[Vec3] = None


@dataclass(frozen=True)
class TriangleMesh:
    """Bulk triangle soup sharing one material — the SoA-friendly way to add
    meshes (OBJ imports land here instead of 1M Triangle objects).

    vertices: (T, 3, 3); uvs: (T, 3, 2) or None; normals: (T, 3, 3) or None.
    """

    vertices: np.ndarray
    material: Material
    uvs: Optional[np.ndarray] = None
    normals: Optional[np.ndarray] = None

    def __hash__(self):
        return id(self.vertices)

    def __eq__(self, other):
        return self is other


@dataclass(frozen=True)
class ConstantMedium:
    """Participating medium inside a boundary.
    Reference: hitable/constant_medium.go."""

    boundary: "Hitable"
    density: float
    phase: Material  # an Isotropic


@dataclass(frozen=True)
class Group:
    """A geometry-only container so transform wrappers can apply to many
    hitables at once (the analog of wrapping a nested BVH in
    Translate/RotateY, e.g. the Final scene's sphere cluster,
    scenes.go Final)."""

    children: Tuple["Hitable", ...]


@dataclass(frozen=True)
class FlipNormals:
    inner: "Hitable"


@dataclass(frozen=True)
class Translate:
    inner: "Hitable"
    offset: Vec3


@dataclass(frozen=True)
class RotateY:
    inner: "Hitable"
    angle_degrees: float


Hitable = Union[
    Sphere, XYRect, XZRect, YZRect, Box, Triangle, TriangleMesh,
    ConstantMedium, Group, FlipNormals, Translate, RotateY,
]


# --------------------------------------------------------------------------
# Camera & Scene (reference: internal/camera, internal/scene)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Camera:
    """Thin-lens camera parameters. Reference: camera/camera.go:28-58."""

    look_from: Vec3
    look_at: Vec3
    vup: Vec3 = (0.0, 1.0, 0.0)
    vfov: float = 40.0
    aspect: float = 1.0
    aperture: float = 0.0
    focus_dist: float = 10.0
    time0: float = 0.0
    time1: float = 1.0
    exposure: float = 1.0


@dataclass
class Scene:
    """World + camera. Lights are derived (all emitter hitables), matching
    transport.go:67-72; pass `lights` explicitly to override."""

    world: List[Hitable]
    camera: Camera
    lights: Optional[List[Hitable]] = None
    # SPECTRAL or RGB colour representation (transport.proto:269).
    spectral: bool = False
    # Spectral background SPD (scene-level, for spectral renders).
    spectral_background: Optional[object] = None
    # Asset files replaced with deterministic procedural placeholders
    # (missing textures/meshes) — surfaced in render output so a placeholder
    # render cannot masquerade as the reference scene.
    placeholder_assets: List[str] = field(default_factory=list)

    def emitters(self) -> List[Hitable]:
        if self.lights is not None:
            return self.lights
        out = []
        for h in self.world:
            if hitable_is_emitter(h):
                out.append(h)
        return out


def hitable_material(h: Hitable) -> Optional[Material]:
    if isinstance(h, (FlipNormals, Translate, RotateY)):
        return hitable_material(h.inner)
    if isinstance(h, ConstantMedium):
        # IsEmitter delegates to the BOUNDARY's material in the reference
        # (constant_medium.go:86-88) — so a glass-bounded medium joins the
        # light list (as a null member, PDF 0 / Random (1,0,0)).
        return hitable_material(h.boundary)
    return getattr(h, "material", None)


def hitable_is_emitter(h: Hitable) -> bool:
    m = hitable_material(h)
    return m is not None and is_emitter(m)
