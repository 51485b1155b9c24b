"""CIE 1931 colorimetry core, batched for device use.

Data: the standard CIE 1931 2° color-matching functions sampled at 5 nm over
380–750 nm (public data, en.wikipedia.org/wiki/CIE_1931_color_space), the same
table the reference uses (internal/spectral/spectral.go:16-76), so spectral
parity holds exactly. `CIE_Y_INTEGRAL` is kept at the reference's constant
21.3768 (spectral.go:64) rather than the re-summed value.

All evaluation functions are jnp and batched over arbitrary leading dims.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

WAVELENGTH_MIN = 380.0
WAVELENGTH_MAX = 750.0
N_CIE = 75
CIE_STEP = 5.0

CIE_WAVELENGTHS = np.arange(380.0, 751.0, 5.0)  # (75,)

CIE_X = np.array([
    0.0014, 0.0022, 0.0042, 0.0076, 0.0143, 0.0232, 0.0435, 0.0776, 0.1344, 0.2148,
    0.2839, 0.3285, 0.3483, 0.3481, 0.3362, 0.3187, 0.2908, 0.2511, 0.1954, 0.1421,
    0.0956, 0.0580, 0.0320, 0.0147, 0.0049, 0.0024, 0.0093, 0.0291, 0.0633, 0.1096,
    0.1655, 0.2257, 0.2904, 0.3597, 0.4334, 0.5121, 0.5945, 0.6784, 0.7621, 0.8425,
    0.9163, 0.9786, 1.0263, 1.0567, 1.0622, 1.0456, 1.0026, 0.9384, 0.8544, 0.7514,
    0.6424, 0.5419, 0.4479, 0.3608, 0.2835, 0.2187, 0.1649, 0.1212, 0.0874, 0.0636,
    0.0468, 0.0329, 0.0227, 0.0158, 0.0114, 0.0081, 0.0058, 0.0041, 0.0029, 0.0021,
    0.0015, 0.0011, 0.0008, 0.0006, 0.0004,
])

CIE_Y = np.array([
    0.0000, 0.0001, 0.0001, 0.0002, 0.0004, 0.0006, 0.0012, 0.0022, 0.0040, 0.0073,
    0.0116, 0.0168, 0.0230, 0.0298, 0.0380, 0.0480, 0.0600, 0.0739, 0.0910, 0.1126,
    0.1390, 0.1693, 0.2080, 0.2586, 0.3230, 0.4073, 0.5030, 0.6082, 0.7100, 0.7932,
    0.8620, 0.9149, 0.9540, 0.9803, 0.9950, 1.0000, 0.9950, 0.9786, 0.9520, 0.9154,
    0.8700, 0.8163, 0.7570, 0.6949, 0.6310, 0.5668, 0.5030, 0.4412, 0.3810, 0.3210,
    0.2650, 0.2170, 0.1750, 0.1382, 0.1070, 0.0816, 0.0610, 0.0446, 0.0320, 0.0232,
    0.0170, 0.0119, 0.0082, 0.0057, 0.0041, 0.0029, 0.0021, 0.0015, 0.0010, 0.0007,
    0.0005, 0.0004, 0.0003, 0.0002, 0.0001,
])

CIE_Z = np.array([
    0.0065, 0.0105, 0.0201, 0.0362, 0.0679, 0.1102, 0.2074, 0.3713, 0.6456, 1.0391,
    1.3856, 1.6230, 1.7471, 1.7826, 1.7721, 1.7441, 1.6692, 1.5281, 1.2876, 1.0419,
    0.8130, 0.6162, 0.4652, 0.3533, 0.2720, 0.2123, 0.1582, 0.1117, 0.0782, 0.0573,
    0.0422, 0.0298, 0.0203, 0.0134, 0.0087, 0.0057, 0.0039, 0.0027, 0.0021, 0.0018,
    0.0017, 0.0014, 0.0011, 0.0010, 0.0009, 0.0008, 0.0006, 0.0003, 0.0002, 0.0000,
    0.0000, 0.0000, 0.0000, 0.0000, 0.0000, 0.0000, 0.0000, 0.0000, 0.0000, 0.0000,
    0.0000, 0.0000, 0.0000, 0.0000, 0.0000, 0.0000, 0.0000, 0.0000, 0.0000, 0.0000,
    0.0000, 0.0000, 0.0000, 0.0000, 0.0000,
])

# Reference keeps this literal (spectral.go:64); it is *close to* sum(CIE_Y)
# but the literal is what normalizes every estimator, so we match it.
CIE_Y_INTEGRAL = 21.3768

# Precomputed inclusive prefix sum of CIE_Y for wavelength CDF inversion.
_CIE_Y_CUMSUM = np.cumsum(CIE_Y)

# XYZ -> linear sRGB (debug view). Reference: spectral.WavelengthToRGB
# (spectral.go:256-273).
XYZ_TO_SRGB = np.array([
    [3.2404542, -1.5371385, -0.4985314],
    [-0.9692660, 1.8760108, 0.0415560],
    [0.0556434, -0.2040259, 1.0572252],
])


def _interp_fixed_grid(table, lam):
    """Linear interpolation of a 75-entry 5nm table, clamped at the ends.

    Matches the reference's endpoint clamping (spectral.go:227-254).
    """
    table = jnp.asarray(table, dtype=jnp.float32)
    x = (jnp.asarray(lam, dtype=jnp.float32) - WAVELENGTH_MIN) / CIE_STEP
    x = jnp.clip(x, 0.0, N_CIE - 1.0)
    i0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, N_CIE - 2)
    t = x - i0.astype(jnp.float32)
    return table[i0] * (1.0 - t) + table[i0 + 1] * t


def get_cie_values(lam):
    """x̄(λ), ȳ(λ), z̄(λ) by linear interpolation. Reference: GetCIEValues
    (spectral.go:227). Batched: lam (...,) -> three (...,) arrays."""
    return (
        _interp_fixed_grid(CIE_X, lam),
        _interp_fixed_grid(CIE_Y, lam),
        _interp_fixed_grid(CIE_Z, lam),
    )


def sample_wavelength(u):
    """CIE-Y importance sampling of λ by CDF inversion.

    Reference: spectral.SampleWavelength (spectral.go:184-224). Returns
    (lambda, pdf). pdf is ȳ(λ)/CIE_Y_INTEGRAL with the reference's
    linear-in-mass interpolation inside the winning bin; the i==0 and
    target-beyond-end edge cases follow the reference exactly.
    """
    u = jnp.asarray(u, dtype=jnp.float32)
    cum = jnp.asarray(_CIE_Y_CUMSUM, dtype=jnp.float32)
    y = jnp.asarray(CIE_Y, dtype=jnp.float32)
    w = jnp.asarray(CIE_WAVELENGTHS, dtype=jnp.float32)

    target = u * CIE_Y_INTEGRAL
    # First i such that cumsum[i] >= target  (cumsum is inclusive).
    i = jnp.searchsorted(cum, target, side="left").astype(jnp.int32)

    in_range = i < N_CIE
    i_safe = jnp.clip(i, 0, N_CIE - 1)
    prev = jnp.where(i_safe > 0, cum[jnp.maximum(i_safe - 1, 0)], 0.0)
    t = (target - prev) / jnp.maximum(y[i_safe], 1e-20)

    i_gt0 = i_safe > 0
    im1 = jnp.maximum(i_safe - 1, 0)
    lam_interp = w[im1] + t * (w[i_safe] - w[im1])
    y_interp = y[im1] + t * (y[i_safe] - y[im1])

    lam = jnp.where(i_gt0, lam_interp, w[i_safe])
    pdf = jnp.where(i_gt0, y_interp, y[i_safe]) / CIE_Y_INTEGRAL

    lam = jnp.where(in_range, lam, WAVELENGTH_MAX)
    pdf = jnp.where(in_range, pdf, y[N_CIE - 1] / CIE_Y_INTEGRAL)
    return lam, pdf


def wavelength_to_rgb(lam):
    """Debug tint of a wavelength, clamped linear sRGB. Reference:
    spectral.WavelengthToRGB (spectral.go:256)."""
    x, y, z = get_cie_values(lam)
    xyz = jnp.stack([x, y, z], axis=-1)
    rgb = jnp.matmul(xyz, jnp.asarray(XYZ_TO_SRGB, dtype=jnp.float32).T,
                     precision=jax.lax.Precision.HIGHEST)
    return jnp.clip(rgb, 0.0, 1.0)
