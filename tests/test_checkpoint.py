"""Checkpoint/resume tests (capability beyond the reference)."""

import numpy as np

from izpi_tpu.integrator import path as path_mod
from izpi_tpu.render import renderer
from izpi_tpu.scene.library.cornell import cornell_box


def test_checkpoint_resume_matches_uninterrupted(tmp_path):
    s = path_mod.RenderSettings(max_depth=4)
    ckpt = str(tmp_path / "r.ckpt")
    full = renderer.render(cornell_box(), 12, 12, 8, settings=s, seed=7)
    # Chunked with checkpointing...
    a = renderer.render(cornell_box(), 12, 12, 8, settings=s, seed=7,
                        checkpoint_path=ckpt, checkpoint_interval=3)
    np.testing.assert_allclose(full.image, a.image, atol=2e-5)
    assert full.rays_traced == a.rays_traced
    # ...and resume from a partial checkpoint: rewrite one with fewer samples
    from izpi_tpu.render import checkpoint as ck
    from izpi_tpu.scene.compiler import compile_scene

    cs, meta = compile_scene(cornell_box())
    fp = ck.config_fingerprint(12, 12, 8, 7, meta, s)
    partial = ck.load(ckpt, fp)
    assert partial is not None
    acc, done, rays = partial
    assert done == 8
    # Corrupt fingerprint → treated as absent.
    assert ck.load(ckpt, "deadbeef") is None


def test_resume_continues_from_partial(tmp_path):
    s = path_mod.RenderSettings(max_depth=4)
    ckpt = str(tmp_path / "p.ckpt")
    # Render only the first 4 samples by "interrupting": run spp=4 with
    # interval 2 writing into the checkpoint, then rerun at spp=8 with the
    # matching fingerprint... fingerprints include spp, so emulate a crash
    # by rendering spp=8 / interval 2 and truncating the checkpoint to the
    # 4-sample state.
    from izpi_tpu.render import checkpoint as ck
    from izpi_tpu.scene.compiler import compile_scene

    full = renderer.render(cornell_box(), 12, 12, 8, settings=s, seed=9,
                           checkpoint_path=ckpt, checkpoint_interval=2)
    cs, meta = compile_scene(cornell_box())
    fp = ck.config_fingerprint(12, 12, 8, 9, meta, s)

    # Simulate crash at sample 4: halve the state (requires replay) — here
    # simply re-render with interval 4 and capture the midpoint checkpoint.
    ckpt2 = str(tmp_path / "q.ckpt")
    import izpi_tpu.render.checkpoint as ckpt_mod
    orig_save = ckpt_mod.save
    states = {}

    def spy_save(path, acc, done, rays, f):
        states[done] = (acc.copy(), done, rays)
        orig_save(path, acc, done, rays, f)

    ckpt_mod.save = spy_save
    try:
        renderer.render(cornell_box(), 12, 12, 8, settings=s, seed=9,
                        checkpoint_path=ckpt2, checkpoint_interval=4)
    finally:
        ckpt_mod.save = orig_save
    acc4, done4, rays4 = states[4]
    ck.save(ckpt2, acc4, 4, rays4, fp)

    resumed = renderer.render(cornell_box(), 12, 12, 8, settings=s, seed=9,
                              checkpoint_path=ckpt2, checkpoint_interval=4)
    np.testing.assert_allclose(resumed.image, full.image, atol=2e-5)


def test_spectral_checkpoint_resume_matches_uninterrupted(tmp_path):
    """Spectral resume end-to-end: the checkpointed canvas is pre-firefly
    XYZ, so a resumed render must reproduce the uninterrupted ACEScg image
    bit-for-bit."""
    from izpi_tpu.scene.library.cornell_spectral import cornell_box_spectral

    s = path_mod.RenderSettings(max_depth=4)
    ckpt = str(tmp_path / "spec.ckpt")
    scene = cornell_box_spectral()
    full = renderer.render(scene, 12, 12, 8, settings=s, seed=3,
                           sampler_type="spectral")
    chunked = renderer.render(scene, 12, 12, 8, settings=s, seed=3,
                              sampler_type="spectral",
                              checkpoint_path=ckpt, checkpoint_interval=4)
    np.testing.assert_allclose(full.image, chunked.image, atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(full.xyz, chunked.xyz, atol=2e-5, rtol=2e-5)

    # Emulate a crash after 4 samples: capture the intermediate
    # checkpoint state written at off=4, restore it, then resume to 8.
    from izpi_tpu.render import checkpoint as ck
    from izpi_tpu.scene.compiler import compile_scene

    cs, meta = compile_scene(scene)
    fp = ck.config_fingerprint(12, 12, 8, 3, meta, s)
    acc, done, rays = ck.load(ckpt, fp)
    assert done == 8

    states = []
    real_save = ck.save

    def capture(path, acc, done, rays, fingerprint):
        states.append((np.array(acc), done, rays, fingerprint))
        real_save(path, acc, done, rays, fingerprint)

    ckpt2 = str(tmp_path / "spec2.ckpt")  # fresh path: no resume skip
    ck.save = capture
    try:
        renderer.render(scene, 12, 12, 8, settings=s, seed=3,
                        sampler_type="spectral",
                        checkpoint_path=ckpt2, checkpoint_interval=4)
    finally:
        ck.save = real_save
    acc4 = next(st for st in states if st[1] == 4)
    real_save(ckpt2, acc4[0], acc4[1], acc4[2], acc4[3])
    resumed = renderer.render(scene, 12, 12, 8, settings=s, seed=3,
                              sampler_type="spectral", checkpoint_path=ckpt2)
    np.testing.assert_allclose(full.xyz, resumed.xyz, atol=2e-5, rtol=2e-5)
