"""Thin-lens camera: host-side precompute + batched ray generation.

Reference: internal/camera/camera.go. The per-ray work (defocus disc sample,
shutter-time sample, direction build, camera.go:61-80) is elementwise math over
the whole pixel batch.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from izpi_tpu.core import sampling
from izpi_tpu.scene import types as st


class CameraArrays(NamedTuple):
    origin: jax.Array        # (3,)
    lower_left: jax.Array    # (3,)
    horizontal: jax.Array    # (3,)
    vertical: jax.Array      # (3,)
    u: jax.Array             # (3,)
    v: jax.Array             # (3,)
    lens_radius: jax.Array   # ()
    time0: jax.Array         # ()
    time1: jax.Array         # ()


def compile_camera(c: st.Camera) -> CameraArrays:
    """Precompute the camera frame (camera.go:28-58), on host in float64."""
    look_from = np.array(c.look_from, dtype=np.float64)
    look_at = np.array(c.look_at, dtype=np.float64)
    vup = np.array(c.vup, dtype=np.float64)

    lens_radius = c.aperture / 2.0
    theta = c.vfov * math.pi / 180.0
    half_height = math.tan(theta / 2.0)
    half_width = c.aspect * half_height
    w = look_from - look_at
    w /= np.linalg.norm(w)
    u = np.cross(vup, w)
    u /= np.linalg.norm(u)
    v = np.cross(w, u)

    fd = c.focus_dist
    lower_left = look_from - half_width * fd * u - half_height * fd * v - fd * w
    horizontal = 2.0 * half_width * fd * u
    vertical = 2.0 * half_height * fd * v

    f32 = lambda x: jnp.asarray(x, jnp.float32)
    return CameraArrays(
        origin=f32(look_from), lower_left=f32(lower_left),
        horizontal=f32(horizontal), vertical=f32(vertical),
        u=f32(u), v=f32(v),
        lens_radius=f32(lens_radius),
        time0=f32(c.time0), time1=f32(c.time1),
    )


def get_rays(cam: CameraArrays, s, t, uniforms):
    """Batched GetRay (camera.go:61-69).

    s, t: (N,) film coordinates in [0,1); uniforms: (N, 3) for the defocus
    disc (2) and shutter time (1). Returns (origin (N,3), dir (N,3), time (N,)).
    """
    rd = sampling.random_in_unit_disc(uniforms[:, 0], uniforms[:, 1])
    rd = rd * cam.lens_radius
    offset = rd[:, 0:1] * cam.u[None, :] + rd[:, 1:2] * cam.v[None, :]
    time = cam.time0 + uniforms[:, 2] * (cam.time1 - cam.time0)
    origin = cam.origin[None, :] + offset
    direction = (
        cam.lower_left[None, :]
        + s[:, None] * cam.horizontal[None, :]
        + t[:, None] * cam.vertical[None, :]
        - cam.origin[None, :]
        - offset
    )
    return origin, direction, time
