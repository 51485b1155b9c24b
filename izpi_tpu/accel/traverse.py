"""Device-side BVH4 traversal — pure-jnp gather form, compiled by XLA on
every backend.

The reference traverses with a per-goroutine stack and a 4-wide SIMD slab
test (bvh4.go:49-163, RayAABB4_SIMD). Here the whole ray batch traverses in
lockstep: each iteration every active ray pops one node, slab-tests its 4
children in one vectorized pass (the RayAABB4 analog, batched over N rays),
accumulates leaf primitive hits, and pushes internal children. Rays that
exhaust their stacks idle until the batch finishes — the usual cost of
divergence on a lockstep machine, bounded by compaction upstream.

Everything is gathers + elementwise math; node data is packed into single
arrays so each pop is a few wide gathers rather than many small ones.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from izpi_tpu.accel import bvh_build
from izpi_tpu.geometry import primitives as prim

STACK_DEPTH = 64  # bvh4.go:58
# Traversal steps between checks of the all-stacks-empty predicate
# (core.loops.chunked_while); 1 is a plain lax.while_loop.
LOOP_CHUNK = 16


class BVH4Device(NamedTuple):
    bounds: jax.Array  # (Nn, 24) f32
    child: jax.Array   # (Nn, 4) i32
    count: jax.Array   # (Nn, 4) i32


def upload(bvh: bvh_build.BVH4Arrays) -> BVH4Device:
    return BVH4Device(
        bounds=jnp.asarray(bvh.bounds),
        child=jnp.asarray(bvh.child),
        count=jnp.asarray(bvh.count),
    )


def reorder_prims(prims: prim.Prims, order) -> prim.Prims:
    """Apply the BVH's primitive reordering so leaves are contiguous runs
    (bvh4.go:586-590)."""
    import numpy as np

    idx = jnp.asarray(np.asarray(order), jnp.int32)
    return prim.Prims(*[jnp.asarray(f)[idx] for f in prims])


def slab_test_4(bounds_row, o, inv_d, t_min, t_max):
    """1 ray × 4 child AABBs → 4-bit mask. The RayAABB4 kernel
    (bvh4_simd_*.go) batched over rays.

    bounds_row: (N, 24); o, inv_d: (N, 3); t_min: scalar; t_max: (N,).
    Returns (N, 4) bool. Matches aabb.go:67-92: swap by direction sign,
    tMax <= tMin → miss.
    """
    lo = bounds_row[:, 0:12].reshape(-1, 3, 4)   # (N, axis, slot) mins
    hi = bounds_row[:, 12:24].reshape(-1, 3, 4)  # maxs
    t0 = (lo - o[:, :, None]) * inv_d[:, :, None]
    t1 = (hi - o[:, :, None]) * inv_d[:, :, None]
    neg = (inv_d < 0.0)[:, :, None]
    near = jnp.where(neg, t1, t0)
    far = jnp.where(neg, t0, t1)
    tn = jnp.maximum(jnp.max(near, axis=1), t_min)          # (N, 4)
    tf = jnp.minimum(jnp.min(far, axis=1), t_max[:, None])  # (N, 4)
    return tf > tn


def intersect_bvh(prims: prim.Prims, bvh: BVH4Device, o, d, time,
                  t_min, t_max) -> prim.Hit:
    """Closest-hit via batched stack traversal. o, d: (N,3)."""
    n = o.shape[0]
    rows = jnp.arange(n)
    inv_d = 1.0 / d

    zero1 = time * 0.0
    stack0 = jnp.zeros((n, STACK_DEPTH), jnp.int32) + zero1.astype(
        jnp.int32)[:, None]
    sp0 = zero1.astype(jnp.int32) + 1  # root pushed at slot 0
    t_best0 = zero1 + jnp.minimum(jnp.asarray(t_max, jnp.float32), prim.T_MAX)
    idx_best0 = zero1.astype(jnp.int32) - 1

    def cond(state):
        _stack, sp, _t, _i = state
        return jnp.any(sp > 0)

    def body(state):
        stack, sp, t_best, idx_best = state
        active = sp > 0
        top = jnp.maximum(sp - 1, 0)
        node = jnp.where(active, stack[rows, top], 0)
        sp = sp - active.astype(jnp.int32)

        brow = bvh.bounds[node]
        child = bvh.child[node]
        count = bvh.count[node]
        hitmask = slab_test_4(brow, o, inv_d, t_min, t_best)
        hitmask = hitmask & (count != -1) & active[:, None]

        # Leaf slots: test up to 4 contiguous primitives each
        # (bvh4.go:123-134), shrinking t_best.
        for s in range(4):
            leaf = hitmask[:, s] & (count[:, s] > 0)
            start = child[:, s]
            cnt = count[:, s]
            for k in range(bvh_build.LEAF_SIZE):
                valid = leaf & (k < cnt)
                pidx = jnp.where(valid, start + k, 0)
                t, ok = prim.prim_t(
                    prims.kind[pidx], prims.g0[pidx], prims.g1[pidx],
                    prims.g2[pidx], prims.g3[pidx], o, d, time,
                    t_min, t_best,
                )
                better = valid & ok & (t < t_best)
                t_best = jnp.where(better, t, t_best)
                idx_best = jnp.where(better, pidx, idx_best)

        # Internal slots: push. Overflow cannot occur: bvh_build.validate()
        # asserts the tree's worst-case stack occupancy fits STACK_DEPTH
        # (checked at attach()), so the clamp below is never taken.
        for s in range(4):
            push = hitmask[:, s] & (count[:, s] == 0)
            slot = jnp.minimum(sp, STACK_DEPTH - 1)
            cur = stack[rows, slot]
            stack = stack.at[rows, slot].set(
                jnp.where(push, child[:, s], cur)
            )
            sp = sp + push.astype(jnp.int32)

        return stack, sp, t_best, idx_best

    # The body is a fixpoint once all stacks are empty, so checking the
    # predicate only every LOOP_CHUNK steps is exact.
    from izpi_tpu.core.loops import chunked_while

    _stack, _sp, t_best, idx_best = chunked_while(
        cond, body, (stack0, sp0, t_best0, idx_best0), chunk=LOOP_CHUNK
    )
    hit = idx_best >= 0
    return prim.finalize_hit(prims, o, d, time, t_best, idx_best, hit)


def make_bvh_intersector(cs, bvh: BVH4Device):
    """Intersector closure over an already-reordered CompiledScene."""

    def intersect(o, d, time, t_min, t_max):
        return intersect_bvh(cs.prims, bvh, o, d, time, t_min, t_max)

    return intersect


def attach(cs, seed: int = 1):
    """Build a BVH4 over a compiled scene, reorder its primitives, and
    return (cs_reordered, intersect_fn). The build-time validation mirrors
    the reference's construction-time self-check (bvh4.go:535-545)."""
    arrays = bvh_build.build_bvh4(cs.prims, seed)
    errors = bvh_build.validate(arrays, cs.prims.count,
                                stack_depth=STACK_DEPTH)
    if errors:
        raise AssertionError(f"BVH4 validation failed: {errors[:5]}")
    cs2 = cs._replace(prims=reorder_prims(cs.prims, arrays.prim_order))
    return cs2, make_bvh_intersector(cs2, upload(arrays))
