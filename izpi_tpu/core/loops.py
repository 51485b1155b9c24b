"""Loop helpers for bodies that are a fixpoint once their condition fails.

- `guarded_fori`: when a STATIC upper bound on the trip count exists, run a
  fori_loop over ceil(bound/chunk) `lax.cond`-guarded CHUNKS of `chunk`
  unguarded iterations — no data-dependent loop predicate at all.
  Overrun inside the last live chunk is masked-fixpoint work.
- `chunked_while`: an outer while checks the predicate only once every
  `chunk` inner iterations; with `guard=True` the inner span is itself a
  guarded_fori, so over-running most of a large chunk costs
  chunk/guard_chunk state copies instead of full bodies.

Either way the body MUST be a fixpoint once the condition is false (every
update masked by its own active-lanes logic); the guards only make the
no-op iterations cheap, correctness never depends on them.
"""

from __future__ import annotations

import jax


def _guarded(cond, body):
    return lambda s: jax.lax.cond(cond(s), body, lambda x: x, s)


def guarded_fori(n_iters: int, cond, body, state, chunk: int = 8):
    """Run `body` while `cond` holds, as a static fori_loop over
    cond-guarded chunks. The total trip count NEVER exceeds `n_iters`:
    floor(n/chunk) full chunks plus one exact remainder chunk, so callers
    whose body is not a fixpoint past iteration `n_iters` (e.g. a bounce
    loop with a depth cap, reference colour.go:34-36) stay exact even when
    chunk does not divide n_iters."""
    chunk = max(1, min(chunk, n_iters))
    n_full, rem = divmod(n_iters, chunk)

    def make_chunk_body(span):
        def chunk_body(st):
            return jax.lax.fori_loop(0, span, lambda _i, s: body(s), st)
        return chunk_body

    g = _guarded(cond, make_chunk_body(chunk))
    state = jax.lax.fori_loop(0, n_full, lambda _i, s: g(s), state)
    if rem:
        state = _guarded(cond, make_chunk_body(rem))(state)
    return state


def chunked_while(cond, body, state, chunk: int, guard: bool = False,
                  guard_chunk: int = 8):
    """while(cond): run `body` — but testing `cond` only every `chunk` steps.
    guard=True makes chunk overrun cost state copies instead of full bodies
    (see module docstring), so `chunk` can be large."""
    if chunk <= 1:
        return jax.lax.while_loop(cond, body, state)

    if guard:
        def outer_body(st):
            return guarded_fori(chunk, cond, body, st, chunk=guard_chunk)
    else:
        def outer_body(st):
            return jax.lax.fori_loop(0, chunk, lambda _i, s: body(s), st)

    return jax.lax.while_loop(cond, outer_body, state)
