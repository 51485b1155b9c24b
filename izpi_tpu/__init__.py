"""izpi_tpu — a differentiable spectral path tracer for JAX accelerators.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of flynn-nrg/izpi
(a Go CPU path tracer; see SURVEY.md). Instead of izpi's
pointer-chasing object graph with per-ray recursion (reference:
internal/sampler/colour.go), everything here is a wavefront computation over
struct-of-array (SoA) buffers:

- a ray batch is a pytree of (N,)/(N,3) float32 arrays,
- the scene is compiled to flat primitive/material/texture tables
  (izpi_tpu.scene.compiler, the analog of internal/transport/transport.go),
- the bounce recursion becomes a `lax.while_loop` over depth with masked
  lockstep rays (izpi_tpu.integrator),
- acceleration is a SoA BVH built on host and traversed on device
  (izpi_tpu.accel), with a brute-force all-primitives intersector as the
  correctness oracle and the fast path for small scenes,
- scale-out is `shard_map` over a `jax.sharding.Mesh` (izpi_tpu.parallel)
  instead of izpi's gRPC leader/worker tile streaming.

Default dtype is float32 (the reference uses float64 on CPU; tolerance for the
difference is budgeted in the parity tests).
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Persistent compilation cache. JAX reads JAX_COMPILATION_CACHE_DIR itself
# when it is set; otherwise the cache lives at one fixed path inside the
# checkout (listed in .gitignore), shared by every process run from it.
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _os.makedirs(CACHE_DIR, exist_ok=True)
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)

from izpi_tpu.scene import types as scene_types  # noqa: F401
