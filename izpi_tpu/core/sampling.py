"""Batched directional sampling primitives.

These replicate the reference's formulas exactly — including the
`2*sqrt(r2)` factor in cosine sampling inherited from Shirley's book
(reference: vec3.RandomCosineDirection, internal/vec3/vec3.go:119). That
factor makes the sampled vector non-unit and the *normalized* direction
distribution slightly different from a true cosine lobe; the reference
nevertheless evaluates the PDF as cosθ/π. We reproduce the quirk so converged
images match the Go renderer (compat flag `exact_book_cosine`).

All functions consume pre-drawn uniforms (shape (..., k)) instead of an RNG
object, keeping them pure and reusable inside `lax.while_loop`.
"""

from __future__ import annotations

import jax.numpy as jnp

from izpi_tpu.core import onb as onb_mod


TWO_PI = 2.0 * jnp.pi


def random_cosine_direction(u1, u2, exact_book_cosine: bool = True):
    """Reference: vec3.RandomCosineDirection (vec3.go:119-128).

    z = sqrt(1-r2); x = cos(2π r1)·2·sqrt(r2); y = sin(2π r1)·2·sqrt(r2).
    With exact_book_cosine=False the mathematically-correct sqrt(r2) factor is
    used instead (a true cosine-weighted hemisphere after normalization).
    """
    scale = 2.0 if exact_book_cosine else 1.0
    z = jnp.sqrt(1.0 - u2)
    phi = TWO_PI * u1
    r = scale * jnp.sqrt(u2)
    return jnp.stack([jnp.cos(phi) * r, jnp.sin(phi) * r, z], axis=-1)


def random_to_sphere(radius, distance_squared, u1, u2):
    """Cone sampling toward a sphere. Reference: vec3.RandomToSphere
    (vec3.go:130-139)."""
    z = 1.0 + u2 * (jnp.sqrt(1.0 - radius * radius / distance_squared) - 1.0)
    phi = TWO_PI * u1
    s = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return jnp.stack([jnp.cos(phi) * s, jnp.sin(phi) * s, z], axis=-1)


def random_in_unit_disc(u1, u2):
    """Uniform in the unit disc.

    The reference rejection-samples (camera/camera.go:90-97); we use the exact
    polar transform (same distribution, no data-dependent loop).
    """
    r = jnp.sqrt(u1)
    phi = TWO_PI * u2
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)


def random_in_unit_sphere(u1, u2, u3):
    """Uniform in the unit ball (metal fuzz / isotropic phase).

    Reference rejection-samples (material/material.go:10-18); exact transform
    here: direction uniform on sphere, radius ∝ cbrt(u)."""
    z = 1.0 - 2.0 * u1
    phi = TWO_PI * u2
    s = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    d = jnp.stack([s * jnp.cos(phi), s * jnp.sin(phi), z], axis=-1)
    # cbrt spelled exp(log/3): the Pallas megakernel uses the same formula
    # so that both consume the same values for stream parity (the clamp
    # moves exact 0 to 1e-10, far below the fuzz scale).
    r = jnp.exp(jnp.log(jnp.maximum(u3, 1e-30)) * jnp.float32(1.0 / 3.0))
    return d * r[..., None]


def cosine_pdf_value(normal, direction):
    """Cosine-lobe PDF value: max(cos,0)/π of the normalized direction against
    the (already unit) lobe axis. Reference: pdf.Cosine.Value (pdf/cosine.go:28)."""
    from izpi_tpu.core import vecmath as vm

    cosine = vm.dot(vm.normalize(direction), vm.normalize(normal))
    return jnp.where(cosine > 0, cosine / jnp.pi, 0.0)


def cosine_pdf_generate(normal, u1, u2, exact_book_cosine: bool = True):
    """Sample the cosine lobe around `normal` via ONB.
    Reference: pdf.Cosine.Generate (pdf/cosine.go:37)."""
    u, v, w = onb_mod.build_from_w(normal)
    return onb_mod.local(u, v, w, random_cosine_direction(u1, u2, exact_book_cosine))
