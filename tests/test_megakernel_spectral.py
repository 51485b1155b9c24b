"""Spectral Pallas megakernel vs the XLA spectral pool — the same
stream-parity strategy as test_megakernel.py, on the reference default
workload class (spectral Cornell, internal/sampler/spectral.go)."""

import numpy as np
import jax

from izpi_tpu.core import rng
from izpi_tpu.integrator import path as path_mod
from izpi_tpu.ops import megakernel_spectral
from izpi_tpu.render import renderer
from izpi_tpu.scene.library.cornell_spectral import cornell_box_spectral


def _compare(with_prism: bool, nx=12, ny=12, spp=4, max_depth=6):
    scene = cornell_box_spectral(aspect=nx / ny, with_prism=with_prism)
    ctx = renderer.RenderContext(scene, use_bvh=False)
    assert megakernel_spectral.eligible(ctx.cs, ctx.meta)
    settings = path_mod.RenderSettings(max_depth=max_depth)
    key = rng.render_key(5)

    mega = jax.jit(megakernel_spectral.build_renderer(
        ctx.cs, ctx.meta, settings, nx, ny, spp, interpret=True))
    acc_m, rays_m = mega(key, 0)

    pool = ctx.pool_runner(nx, ny, True, ctx.meta.spectral_background_spd or 0,
                           settings)
    acc_p, rays_p = pool(key, spp, nx * ny * spp, 0)

    acc_m, acc_p = np.asarray(acc_m), np.asarray(acc_p)
    assert int(rays_m) == int(rays_p), (int(rays_m), int(rays_p))
    # Same Threefry streams; only the SPD piecewise-vs-grid lerp and fp
    # accumulation order differ.
    np.testing.assert_allclose(acc_m, acc_p, rtol=2e-4, atol=2e-4)


def test_spectral_mega_matches_pool_simple():
    _compare(with_prism=False)


def test_spectral_mega_matches_pool_prism_dispersion():
    # with_prism adds the dielectric pyramid with η(λ) → dispersion.
    _compare(with_prism=True, max_depth=8)


def test_spectral_mega_refill_matches_pool(monkeypatch):
    """Without replica slots each slot walks all 4 samples of its pixel,
    refilling λ and the path constants in the kernel."""
    monkeypatch.setattr(megakernel_spectral, "MIN_SLOTS", 1)
    _compare(with_prism=True, nx=6, ny=6, max_depth=8)


def test_piecewise_knots_reproduce_grid():
    from izpi_tpu.scene.compiler import compile_scene
    import jax.numpy as jnp
    from izpi_tpu.spectral import spd as spd_mod

    scene = cornell_box_spectral(with_prism=True)
    cs, meta = compile_scene(scene)
    table = np.asarray(cs.spd_table)
    lam = jnp.asarray(np.linspace(380.0, 750.0, 777), jnp.float32)
    for sid in megakernel_spectral._used_spd_ids(cs, meta):
        xs, vs = megakernel_spectral._extract_knots(table[sid])
        got = np.asarray(megakernel_spectral._piecewise_eval(xs, vs, lam))
        want = np.asarray(spd_mod.device_spd_value(
            cs.spd_table, jnp.full(lam.shape, sid, jnp.int32), lam))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_sample_wavelength_matches_oracle():
    from izpi_tpu.spectral import cie
    import jax.numpy as jnp

    u = jnp.asarray(np.linspace(0.0, 0.999999, 4096), jnp.float32)
    lam_k, pdf_k = megakernel_spectral._sample_wavelength(u)
    lam_o, pdf_o = cie.sample_wavelength(u)
    np.testing.assert_allclose(np.asarray(lam_k), np.asarray(lam_o),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(np.asarray(pdf_k), np.asarray(pdf_o),
                               rtol=1e-5, atol=1e-7)
