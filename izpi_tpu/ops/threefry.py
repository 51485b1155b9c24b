"""Threefry-2x32 as plain jnp uint32 ops — usable inside Pallas kernels.

jax.random implements Threefry through a dedicated XLA primitive
(threefry2x32_p) that is not available inside a Pallas kernel body, so the
wavefront megakernel (ops.megakernel) needs its own copy of the block cipher
built from adds/xors/rotates. This module provides that copy plus the exact
`fold_in` / `uniform` derivations used by izpi_tpu.core.rng, and tests assert
bit-identical output against jax.random — which is what makes the megakernel
reproduce the oracle integrator's sample streams exactly.

Reference rationale: the Go tracer threads a per-goroutine LCG through the
whole call graph (internal/fastrandom/fastrandom.go:13-47); this design
keys every (pixel, sample, depth, use) tuple instead (core/rng.py), and this
module is that keying in plain uint32 arithmetic.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = np.uint32(0x1BD11BDA)  # numpy scalar: safe to close over in Pallas


def _rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The 20-round Threefry-2x32 block cipher on uint32 arrays.

    All four arguments broadcast together; returns (y0, y1). Bit-identical
    to jax._src.prng.threefry_2x32 (validated in tests/test_ops_threefry.py).
    """
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for r in range(20):
        x0 = x0 + x1
        x1 = _rotl(x1, _ROT[r % 8])
        x1 = x1 ^ x0
        if r % 4 == 3:
            j = r // 4 + 1  # key-schedule injection 1..5
            x0 = x0 + ks[j % 3]
            x1 = x1 + ks[(j + 1) % 3] + np.uint32(j)
    return x0, x1


def fold_in(k0, k1, data):
    """jax.random.fold_in on raw (k0, k1) uint32 words.

    fold_in(key, d) = threefry2x32(key, seed_pair(d)) with
    seed_pair(d) = (0, d) for a 32-bit nonnegative d (threefry_seed).
    """
    zero = jnp.zeros_like(data)
    return threefry2x32(k0, k1, zero, data.astype(jnp.uint32))


def bits_to_uniform(bits):
    """uint32 → float32 in [0, 1), exactly like jax.random.uniform:
    keep 23 mantissa bits, OR in the exponent of 1.0, subtract 1.
    (lax.bitcast_convert_type rather than .view so it works inside Pallas.)"""
    import jax

    f = jax.lax.bitcast_convert_type(
        (bits >> np.uint32(9)) | np.uint32(0x3F800000), jnp.float32)
    return f - jnp.float32(1.0)


def uniforms_2(k0, k1, c0, c1):
    """Two U[0,1) streams for counters (c0, c1) under key (k0, k1) —
    one cipher call, matching jax.random.uniform(key, (n,)) where the
    counter array [0..n-1] is split in half (threefry_2x32's layout:
    word i pairs with word i + n//2)."""
    y0, y1 = threefry2x32(k0, k1, c0.astype(jnp.uint32),
                          c1.astype(jnp.uint32))
    return bits_to_uniform(y0), bits_to_uniform(y1)


def uniforms_n(k0, k1, n: int):
    """n U[0,1) variates per key lane.

    Counter layout = the classic (non-partitionable) jax.random one:
    the counter vector [0..n-1] (zero-padded to even length) is split in
    half and the halves run through the cipher pairwise, so n words cost
    ceil(n/2) cipher calls — half of what the partitionable scheme's
    one-cipher-per-word XOR construction pays.

    k0, k1: uint32 arrays of any shape S. Returns a list of n arrays of
    shape S: entry i is uniform word i of the (n,) draw.
    """
    half = (n + 1) // 2
    out = [None] * (2 * half)
    for i in range(half):
        c0 = jnp.full_like(k0, i)
        c1 = jnp.full_like(k0, i + half)  # for odd n the last word (the
        u0, u1 = uniforms_2(k0, k1, c0, c1)  # zero pad's slot) is dropped
        out[i] = u0
        out[i + half] = u1
    return out[:n]
