"""Bates (1996): Heston stochastic volatility + Merton lognormal jumps.

    d log S = (mu - lam*mbar - v+/2) dt + sqrt(v+ dt) z_s + sum_j J_j,
    dv      = kappa (theta - v+) dt + xi sqrt(v+ dt) z_v,
    N ~ Poisson(lam dt),  J ~ N(jump_mean, jump_std^2),
    mbar = E[e^J] - 1  (risk-drift compensation),

full-truncation Euler on the variance (exactly the Heston scheme,
processes/heston.py) with Merton's aggregated-jump leg: given the count N,
the jump sum is N*jump_mean + sqrt(N)*jump_std * z_j.  Counts come from a
truncated inverse-CDF Poisson on a SEPARATE key stream (a raw-bits uniform
must never share a cipher call with a Box-Muller normal — DEVNOTES RNG
trap), so draws stay counter-based and shard-invariant.

Scalar state pytree -> fused-kernel eligible.  Validation oracle: the Bates
characteristic function is the *product* of the Heston CF and the Merton
jump CF, priced through the generic Gil-Pelaez machinery
(`engine.cf_pricing.cf_call_price`); `bates_log_cf` lives here.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from montecarlo.processes.merton import (K_MAX, _JUMP_STREAM,
                                             check_jump_grid, poisson_count)
from montecarlo.rng.normal import (exp32, log32, normal_draw,
                                        uniform_draw)


class BatesState(NamedTuple):
    log_s: jnp.ndarray
    v: jnp.ndarray


class Bates(NamedTuple("BatesFields", [
        ("s0", jnp.ndarray),
        ("v0", jnp.ndarray),
        ("mu", jnp.ndarray),
        ("kappa", jnp.ndarray),
        ("theta", jnp.ndarray),
        ("xi", jnp.ndarray),
        ("rho", jnp.ndarray),
        ("lam", jnp.ndarray),
        ("jump_mean", jnp.ndarray),
        ("jump_std", jnp.ndarray),
        ("dt", jnp.ndarray),
])):
    """Bates stochastic-volatility jump-diffusion."""

    n_draws = 4  # z_s, z_perp, u_count, z_jump
    draw_kinds = ("normal", "normal", "uniform", "normal")

    @classmethod
    def create(cls, s0, v0, mu, kappa, theta, xi, rho, lam, jump_mean,
               jump_std, dt, dtype=jnp.float32):
        check_jump_grid(lam, dt)
        as_ = lambda v: jnp.asarray(v, dtype)
        return cls(s0=as_(s0), v0=as_(v0), mu=as_(mu), kappa=as_(kappa),
                   theta=as_(theta), xi=as_(xi), rho=as_(rho),
                   lam=as_(lam), jump_mean=as_(jump_mean),
                   jump_std=as_(jump_std), dt=as_(dt))

    def init_state(self, path_ids, dtype=jnp.float32) -> BatesState:
        shape = path_ids.shape
        return BatesState(
            log_s=jnp.full(shape, log32(self.s0).astype(dtype), dtype),
            v=jnp.full(shape, self.v0.astype(dtype), dtype),
        )

    def draws(self, seed, stream, path_ids, t, dtype=jnp.float32):
        # Three normals on the main stream (indices 3t..3t+2: Box-Muller
        # halves pair up across consecutive indices, nothing wasted); the
        # count uniform on the separate jump stream (cipher independence).
        m0 = jnp.asarray(t).astype(jnp.uint32) * jnp.uint32(3)
        z_s = normal_draw(seed, stream, path_ids, m0, dtype)
        z_p = normal_draw(seed, stream, path_ids, m0 + jnp.uint32(1), dtype)
        z_j = normal_draw(seed, stream, path_ids, m0 + jnp.uint32(2), dtype)
        u = uniform_draw(seed, stream ^ _JUMP_STREAM, path_ids,
                         jnp.asarray(t).astype(jnp.uint32), dtype)
        return (z_s, z_p, u, z_j)

    def draws_pair(self, seed, stream, path_ids, j, dtype=jnp.float32):
        """Two-step draws with EXPLICIT cipher sharing (fused kernel): the
        six normals of a step pair are exactly the six Box-Muller halves
        of counters 3j..3j+2, and the two count uniforms are the halves of
        counter j — 3 Box-Muller pairs + 1 uniform cipher instead of the
        6 + 2 the per-step delegation paid.  Bitwise identical to two
        :meth:`draws` calls by construction."""
        from montecarlo.rng.normal import normal_pair, uniform_pair

        jj = jnp.asarray(j).astype(jnp.uint32)
        c = jj * jnp.uint32(3)
        z_s0, z_p0 = normal_pair(seed, stream, path_ids, c, dtype)
        z_j0, z_s1 = normal_pair(seed, stream, path_ids,
                                 c + jnp.uint32(1), dtype)
        z_p1, z_j1 = normal_pair(seed, stream, path_ids,
                                 c + jnp.uint32(2), dtype)
        u0, u1 = uniform_pair(seed, stream ^ _JUMP_STREAM, path_ids, jj,
                              dtype)
        return (z_s0, z_p0, u0, z_j0), (z_s1, z_p1, u1, z_j1)

    def antithetic(self, eps):
        z_s, z_p, u, z_j = eps
        return (-z_s, -z_p, 1.0 - u, -z_j)

    def _poisson_count(self, u, dtype):
        return poisson_count(u, (self.lam * self.dt).astype(dtype), dtype)

    def step(self, state: BatesState, eps, t) -> BatesState:
        dtype = state.log_s.dtype
        z_s, z_p, u, z_j = eps
        rho = self.rho.astype(dtype)
        z_v = rho * z_s + jnp.sqrt(1.0 - jnp.square(rho)) * z_p
        dt = self.dt.astype(dtype)
        v_plus = jnp.maximum(state.v, 0.0)
        positive = v_plus > 0
        v_safe = jnp.where(positive, v_plus, 1.0)
        sq_vdt = jnp.where(positive, jnp.sqrt(v_safe * dt), 0.0)

        n = self._poisson_count(u, dtype)
        jm = self.jump_mean.astype(dtype)
        js = self.jump_std.astype(dtype)
        jumps = n * jm + jnp.sqrt(n) * js * z_j
        mbar = exp32(jm + 0.5 * jnp.square(js)) - 1.0

        # Increment grouped before the accumulator add (see GBM.step).
        log_s = (state.log_s
                 + ((self.mu.astype(dtype) - self.lam.astype(dtype) * mbar
                     - 0.5 * v_plus) * dt
                    + sq_vdt * z_s + jumps))
        v = (state.v
             + self.kappa.astype(dtype)
             * (self.theta.astype(dtype) - v_plus) * dt
             + self.xi.astype(dtype) * sq_vdt * z_v)
        return BatesState(log_s=log_s, v=v)

    def prices(self, state: BatesState):
        return exp32(state.log_s)

    def log_prices(self, state):
        """Native log prices — the functional engines fold log-space
        functionals on these directly (no per-step exp/log)."""
        return state.log_s


def bates_log_cf(s0, r, v0, kappa, theta, xi, rho, lam, jump_mean,
                 jump_std, T):
    """Risk-neutral CF of ln S_T under Bates: Heston CF x Merton jump CF.

    Continuous-limit oracle for the Euler MC (use with
    `engine.cf_pricing.cf_call_price`).  The Heston factor reuses the
    trap-form CF (`engine.heston_analytic`); the jump factor multiplies
    exp(lam T (e^{iu jm - u^2 js^2/2} - 1) - iu lam mbar T).
    """
    import numpy as np

    from montecarlo.engine.heston_analytic import HestonParams, _phi

    params = HestonParams(v0=jnp.asarray(v0), kappa=jnp.asarray(kappa),
                          theta=jnp.asarray(theta), xi=jnp.asarray(xi),
                          rho=jnp.asarray(rho))
    mbar = float(np.exp(jump_mean + 0.5 * jump_std**2) - 1.0)

    def phi(us):
        iu = 1j * us
        # j=2 is the plain risk-neutral CF of ln S_T in the trap form.
        heston = _phi(us, 2, T, r, s0, params)
        jump = jnp.exp(lam * T * (jnp.exp(iu * jump_mean
                                          - 0.5 * jump_std**2 * us * us)
                                  - 1.0)
                       - iu * lam * mbar * T)
        return heston * jump

    return phi
