"""Pallas kernels and kernel-side primitives (the hot ops).

The reference's single "native" component is the 4-wide SIMD AABB kernel
(internal/hitable/bvh4_simd_amd64.go); here the analog is larger: the entire
wavefront bounce loop runs as one Pallas kernel through Triton with each
path's state in registers (ops.megakernel, ops.megakernel_spectral), with a
counter-based Threefry implemented in-kernel (ops.threefry) so results stay
bit-identical to the jax.random streams used by the XLA oracle integrator.
"""
