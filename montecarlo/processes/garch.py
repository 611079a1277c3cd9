"""GARCH(1,1) bootstrap process — exact reference-recurrence parity.

Reproduces the reference app's Monte Carlo dynamics (reference
app.py:586-633):

    shock_t ~ resample(standardized historical returns)     (app.py:609, 620)
    r_t      = shock_t * sqrt(var_t)                        (app.py:623-626)
    S_{t+1}  = S_t * exp(r_t)                               (app.py:629)
    var_{t+1}= omega + alpha * r_t^2 + beta * var_t         (app.py:633)

with omega=1e-5, alpha=0.10, beta=0.85 (app.py:601-603) and initial daily
variance rvol_20[-1]^2 / 252 (app.py:606).

Differences from the reference:
- the resampling uses counter-based uniform index draws into a *padded,
  static-shape* device-resident table instead of `np.random.choice` on the
  unseeded global NumPy RNG — so it is reproducible and shard-invariant;
- prices evolve in log space (mathematically identical, numerically kinder).

Statistical distribution of the paths is identical; per-draw equality with
NumPy is impossible by design (the reference is unseeded).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from montecarlo.rng.normal import (exp32, index_from_uniform,
                                        log32, uniform_draw,
                                        uniform_from_bits)
from montecarlo.rng.threefry import random_bits

#: Reference GARCH parameters (app.py:601-603).
DEFAULT_OMEGA = 1e-5
DEFAULT_ALPHA = 0.10
DEFAULT_BETA = 0.85

#: Minimum history the reference requires before simulating (app.py:594).
MIN_HISTORY = 100


class GARCHState(NamedTuple):
    log_s: jnp.ndarray  # (n_paths,)
    var: jnp.ndarray    # (n_paths,) current daily variance


class GARCHBootstrap(NamedTuple("GARCHFields", [
        ("s0", jnp.ndarray),
        ("var0", jnp.ndarray),
        ("omega", jnp.ndarray),
        ("alpha", jnp.ndarray),
        ("beta", jnp.ndarray),
        ("table", jnp.ndarray),     # (table_size,) standardized returns, padded
        ("n_table", jnp.ndarray),   # int32 — number of valid entries
])):
    """Bootstrap-GARCH(1,1) with a device-resident shock table."""

    n_draws = 1
    draw_kinds = ("uniform",)  # bootstrap resampling index

    @classmethod
    def create(cls, returns, s0, var0, omega=DEFAULT_OMEGA,
               alpha=DEFAULT_ALPHA, beta=DEFAULT_BETA,
               dtype=jnp.float32, pad_to: int | None = None):
        """Build from a history of log returns.

        Standardizes the history exactly as the reference does
        (``returns / (std(returns) + 1e-10)``, app.py:609) and pads the table
        to a static power-of-two size so the compiled gather shape never
        depends on the data length.
        """
        returns = np.asarray(returns, np.float64)
        n = int(returns.size)
        if n < MIN_HISTORY:
            raise ValueError(
                f"need >= {MIN_HISTORY} return observations, got {n}"
            )
        std_returns = np.sort(returns / (returns.std() + 1e-10))
        # Sorted ascending: the uniform -> shock map is then monotone, so
        # the antithetic mirror u -> 1-u is negatively correlated in VALUE
        # (variance-reducing), not just in rank.  Sorting does not change
        # the bootstrap distribution (indices are uniform either way).
        if pad_to is None:
            # Smallest multiple of 128: a few static table sizes cover
            # every history length, so compiled shapes rarely change.
            pad_to = ((n + 127) // 128) * 128
        if pad_to % 128 != 0:
            raise ValueError(f"pad_to={pad_to} must be a multiple of 128")
        table = np.zeros(pad_to, np.float64)
        table[:n] = std_returns
        as_ = lambda v: jnp.asarray(v, dtype)
        return cls(
            s0=as_(s0), var0=as_(var0), omega=as_(omega), alpha=as_(alpha),
            beta=as_(beta), table=as_(table),
            n_table=jnp.asarray(n, jnp.int32),
        )

    def init_state(self, path_ids, dtype=jnp.float32) -> GARCHState:
        shape = path_ids.shape
        return GARCHState(
            log_s=jnp.full(shape, log32(self.s0).astype(dtype), dtype),
            var=jnp.full(shape, self.var0.astype(dtype), dtype),
        )

    def _index_of(self, u):
        """Uniform over exactly the n_table valid entries; the padding is
        unreachable, so the static table size never affects the draw."""
        return index_from_uniform(u, self.n_table)

    def _gather(self, idx, dtype):
        """Shock-table read: a gather in the scan engine, an indexed load
        from the table ref inside the fused kernel."""
        return self.table.astype(dtype)[idx]

    def draws(self, seed, stream, path_ids, t, dtype=jnp.float32):
        """Bootstrap innovation: the raw UNIFORM per (path, t).  The table
        gather happens inside :meth:`step` — drawing the uniform (not the
        gathered shock) is what makes :meth:`antithetic` sound: the mirror
        acts on ``u`` *before* the resampling, so both halves of a pair are
        valid bootstrap draws.  (Negating a gathered shock from a skewed,
        non-zero-mean empirical table would bias the estimator — the
        reference's table, returns/(std+1e-10) at app.py:609, is not
        demeaned.)"""
        m = jnp.asarray(t).astype(jnp.uint32) * jnp.uint32(self.n_draws)
        return (uniform_draw(seed, stream, path_ids, m, jnp.float32)
                .astype(dtype),)

    def draws_pair(self, seed, stream, path_ids, j, dtype=jnp.float32):
        """Uniforms for steps (2j, 2j+1): both halves of one Threefry call
        (draw m uses component m & 1 of call m >> 1, and here m = t) —
        bitwise identical to two draws() calls."""
        j = jnp.asarray(j).astype(jnp.uint32)
        b0, b1 = random_bits(seed, stream, path_ids, j)
        u0 = uniform_from_bits(b0, jnp.float32).astype(dtype)
        u1 = uniform_from_bits(b1, jnp.float32).astype(dtype)
        return ((u0,), (u1,))

    def antithetic(self, eps):
        """Mirror the uniform: u -> 1-u.  With the sorted table this pairs
        low shocks with high shocks (negatively correlated values) while
        every half remains an exact bootstrap draw — unbiased, unlike
        negating the drawn shock."""
        return tuple(1.0 - e for e in eps)

    def _recur(self, state: GARCHState, shock) -> GARCHState:
        vol = jnp.sqrt(state.var)
        r = shock * vol
        new_var = (self.omega.astype(r.dtype)
                   + self.alpha.astype(r.dtype) * jnp.square(r)
                   + self.beta.astype(r.dtype) * state.var)
        return GARCHState(log_s=state.log_s + r, var=new_var)

    def step(self, state: GARCHState, eps, t) -> GARCHState:
        shock = self._gather(self._index_of(eps[0]), state.var.dtype)
        return self._recur(state, shock)

    def prices(self, state: GARCHState):
        return exp32(state.log_s)

    def log_prices(self, state):
        """Native log prices — the functional engines fold log-space
        functionals on these directly (no per-step exp/log)."""
        return state.log_s
