"""The stochastic-process protocol.

A *process* is an immutable pytree (NamedTuple of jnp leaves) with pure
methods, so it can be closed over or passed through `jit` / `shard_map` /
`vmap` freely:

- ``n_draws``            — (static) innovations consumed per path per step
- ``init_state(path_ids, dtype)``   — state pytree for a block of paths
- ``draws(seed, stream, path_ids, t, dtype)`` — the innovations for step
  ``t`` (standard normals by default; the GARCH bootstrap overrides this
  with resampled historical shocks)
- ``step(state, eps, t)`` — one time-step of the SDE / recurrence
- ``prices(state)``       — current prices for observation
- ``antithetic(eps)``     — mirror an innovation block (for the antithetic
  sampler); default is negation, correct for symmetric innovations

Time stays *sequential* — a `lax.scan` (or an on-chip loop in the Pallas
fast path); parallelism comes from the path (and asset) axes, mirroring the
reference's NumPy vectorization over `n_sims` (reference app.py:612-633).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from montecarlo.rng.normal import normal_draw, normal_pair


def grad_safe_sqrt(q):
    """``sqrt(max(q, 0))`` with a FINITE gradient at ``q == 0``.

    The multi-state ``im_norm`` quadratic forms hit exactly zero at dates
    with no live risk (all LMM forwards fixed, a matured book's dv rows) —
    ``sqrt``'s infinite derivative there turns every xVA-greek jvp into
    ``0 * inf = NaN`` (caught driving `xva --underlying lmm --greeks`).
    Double-where: the primal is bitwise ``sqrt(max(q, 0))`` (for q > 0 the
    argument is untouched; for q <= 0 both forms return exactly 0.0), and
    the tangent at q <= 0 is 0 — the correct derivative of the clamped
    branch.
    """
    pos = q > 0.0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, q, 1.0)),
                     jnp.zeros_like(q))


class NormalDrawsMixin:
    """Default innovation source: i.i.d. standard normals, counter-keyed by
    (global path id, t * n_draws + d) so streams are shard-invariant.

    Innovations are a *tuple of per-dimension arrays* (each shaped like
    ``path_ids``) rather than one trailing-axis array: inside the fused
    kernel a block of paths is a 1-D register array, and every draw keeps
    that shape.  Consecutive dimensions of one step share a
    Threefry call (draw index ``m = t*D + d``, counter ``m >> 1``), so the
    cipher work is CSE'd."""

    @property
    def draw_kinds(self):
        """Per-slot innovation kinds ("normal"/"uniform") — what a
        distribution-substituting sampler (QMC) must provide per draw.
        Mixed-draw processes override this as a class attribute."""
        return ("normal",) * self.n_draws

    def draws(self, seed, stream, path_ids, t, dtype=jnp.float32):
        d0 = jnp.asarray(t).astype(jnp.uint32) * jnp.uint32(self.n_draws)
        return tuple(
            normal_draw(seed, stream, path_ids, d0 + jnp.uint32(d), dtype)
            for d in range(self.n_draws))

    def draws_pair(self, seed, stream, path_ids, j, dtype=jnp.float32):
        """Innovations for the two consecutive steps (2j, 2j+1) with the
        cipher sharing made *explicit*: the 2D draws of a step pair span
        exactly D Threefry calls (draw m lives in call m >> 1), and both
        Box-Muller halves of every call are consumed.  Bitwise identical to
        calling :meth:`draws` at t=2j and t=2j+1 — used by the fused Pallas
        engine, where relying on compiler CSE across the two calls proved
        unreliable."""
        D = self.n_draws
        j = jnp.asarray(j).astype(jnp.uint32)
        flat = []
        for c in range(D):
            z0, z1 = normal_pair(seed, stream, path_ids,
                                 j * jnp.uint32(D) + jnp.uint32(c), dtype)
            flat += [z0, z1]
        return tuple(flat[:D]), tuple(flat[D:])

    def antithetic(self, eps):
        return tuple(-e for e in eps)
