"""Where the program keeps its compile cache, and how chip_smoke.py behaves
on a host without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, env_update, cwd=ROOT):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_update)
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, timeout=300, cwd=cwd, env=env)


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_compile_cache_placement(tmp_path, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set the program sets no cache
    directory (JAX uses the variable); without it the cache lives at one
    fixed path inside the checkout."""
    env = {}
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    r = _run(["-c", "import json, jax, izpi_tpu; print(json.dumps(["
              "jax.config.jax_compilation_cache_dir, izpi_tpu.CACHE_DIR]))"],
             env)
    assert r.returncode == 0, r.stderr[-2000:]
    got, fixed = json.loads(r.stdout.strip().splitlines()[-1])
    assert fixed == os.path.join(ROOT, ".jax_cache")
    assert got == (str(tmp_path / env_dir) if env_dir else fixed)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """On a CPU-only host chip_smoke.py exits non-zero and prints no result
    line, both in the checkout and copied alone into an empty directory."""
    cwd = ROOT
    if alone:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    r = _run(["chip_smoke.py"], {}, cwd=cwd)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs a GPU" in r.stderr
