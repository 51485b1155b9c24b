"""Executed multi-host distribution: a REAL 2-process cluster over
localhost, the proof for SURVEY §2.6 row 41.

Two subprocesses each bring 2 virtual CPU devices, form a jax.distributed
cluster through dist.initialize_multihost (the reference ships a working
gRPC cluster — internal/leader/leader.go:37, worker/worker.go:89 — so
written-but-never-run wiring does not count), render the production
sample-sharded pool over the global 4-device mesh, and the result must
match the same render executed single-process on a 4-device mesh."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_cluster_renders(tmp_path):
    coordinator = f"127.0.0.1:{_free_port()}"
    out = str(tmp_path / "rank0")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coordinator, str(rank), out],
            cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in (0, 1)
    ]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost worker timed out")
        logs.append(stdout)
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-3000:]}"

    got = np.load(out + ".npz")

    # Single-process reference on a 4-device mesh: identical sample split
    # (spp_local=1, offsets 0..3), so images agree to psum accumulation
    # order.
    from izpi_tpu.integrator import path as path_mod
    from izpi_tpu.parallel import dist
    from izpi_tpu.scene.library.cornell import cornell_box

    settings = path_mod.RenderSettings(max_depth=3)
    ref = dist.render_distributed(cornell_box(aspect=1.0), 16, 16, 4,
                                  mesh=dist.make_mesh(4), settings=settings,
                                  seed=0)
    assert int(got["rays"]) == ref.rays_traced
    np.testing.assert_allclose(got["image"], ref.image, atol=1e-5)
