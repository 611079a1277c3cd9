"""Bates under the Andersen QE-M variance scheme + exact jump leg.

The Euler Bates (`processes/bates.py`) pays the same O(dt) variance-
discretization bias as Euler Heston — worst on Feller-violating
calibrations.  This process composes the two EXACT legs:

- variance + continuous log-spot: the QE-M scheme (one copy —
  `heston_qe.QEVarianceMixin` / `qe_constants`), whose martingale
  correction makes ``E[e^{dX_cont} | v] = e^{mu dt}`` hold exactly;
- jumps: Merton's aggregated-jump leg (count from a truncated
  inverse-CDF Poisson on its own key stream, sum = N jm + sqrt(N) js z),
  compensated by ``-lam mbar dt`` with ``mbar = E[e^J] - 1`` — exact by
  construction (the compensator is the jump MGF itself).

So the discounted spot is a martingale at EVERY step to float precision,
and the only discretization effect left is the step-frequency of jump
arrivals (a grid-resolution question, not a scheme bias).  Draw budget:
2 normals (asset, jump size) + 1 variance uniform + 1 count uniform per
step, each family on its own cipher stream.

Oracle: the exact Bates CF (`bates.bates_log_cf` through
`engine.cf_pricing.cf_call_price`) — the QE-Bates price at 8 steps/year
matches it at MC resolution where Euler Bates is biased
(tests/test_bates_qe.py).  Same result contract as `Bates`; the
cross-engine ULP (not bitwise) parity note in `heston_qe` applies.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from montecarlo.processes.heston_qe import (_V_STREAM, QEVarianceMixin,
                                                qe_constants)
from montecarlo.processes.merton import (_JUMP_STREAM, check_jump_grid,
                                             poisson_count)
from montecarlo.rng.normal import (exp32, log32, normal_draw,
                                       normal_pair, uniform_draw,
                                       uniform_pair)


class BatesQEState(NamedTuple):
    log_s: jnp.ndarray
    v: jnp.ndarray      # >= 0 by construction (QE)


class BatesQE(QEVarianceMixin, NamedTuple("BatesQEFields", [
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
        ("e_kdt", jnp.ndarray),
        ("c1", jnp.ndarray),
        ("c2", jnp.ndarray),
        ("k0", jnp.ndarray),
        ("k1", jnp.ndarray),
        ("k2", jnp.ndarray),
        ("k3", jnp.ndarray),
        ("k4", jnp.ndarray),
        ("mgf_a", jnp.ndarray),
])):
    """Bates stochastic-volatility jump-diffusion under QE-M."""

    n_draws = 4  # z_s, u_variance, u_count, z_jump
    draw_kinds = ("normal", "uniform", "uniform", "normal")

    @classmethod
    def create(cls, s0, v0, mu, kappa, theta, xi, rho, lam, jump_mean,
               jump_std, dt, dtype=jnp.float32):
        if float(xi) <= 0.0:
            raise ValueError("xi must be positive (xi=0 is Merton)")
        if float(kappa) <= 0.0:
            raise ValueError("kappa must be positive (QE's conditional "
                             "moments use the mean-reverting transition)")
        check_jump_grid(lam, dt)
        as_ = lambda v: jnp.asarray(v, dtype)
        kappa_, theta_, xi_, rho_, dt_ = (as_(kappa), as_(theta), as_(xi),
                                          as_(rho), as_(dt))
        e, c1, c2, k0, k1, k2, k34, mgf_a = qe_constants(
            kappa_, theta_, xi_, rho_, dt_, dtype)
        return cls(s0=as_(s0), v0=as_(v0), mu=as_(mu), kappa=kappa_,
                   theta=theta_, xi=xi_, rho=rho_, lam=as_(lam),
                   jump_mean=as_(jump_mean), jump_std=as_(jump_std),
                   dt=dt_, e_kdt=e, c1=c1, c2=c2, k0=k0, k1=k1, k2=k2,
                   k3=k34, k4=k34, mgf_a=mgf_a)

    def init_state(self, path_ids, dtype=jnp.float32) -> BatesQEState:
        shape = path_ids.shape
        return BatesQEState(
            log_s=jnp.full(shape, log32(self.s0).astype(dtype), dtype),
            v=jnp.full(shape, self.v0.astype(dtype), dtype),
        )

    def draws(self, seed, stream, path_ids, t, dtype=jnp.float32):
        tt = jnp.asarray(t).astype(jnp.uint32)
        m0 = tt * jnp.uint32(2)
        return (normal_draw(seed, stream, path_ids, m0, dtype),
                uniform_draw(seed, stream ^ _V_STREAM, path_ids, tt,
                             dtype),
                uniform_draw(seed, stream ^ _JUMP_STREAM, path_ids, tt,
                             dtype),
                normal_draw(seed, stream, path_ids, m0 + jnp.uint32(1),
                            dtype))

    def draws_pair(self, seed, stream, path_ids, j, dtype=jnp.float32):
        """Steps (2j, 2j+1) with explicit cipher sharing: the pair's four
        normals are the Box-Muller halves of counters 2j and 2j+1, its
        variance/count uniforms the halves of counter j on their streams
        — bitwise identical to two :meth:`draws` calls."""
        jj = jnp.asarray(j).astype(jnp.uint32)
        c = jj * jnp.uint32(2)
        z_s0, z_j0 = normal_pair(seed, stream, path_ids, c, dtype)
        z_s1, z_j1 = normal_pair(seed, stream, path_ids,
                                 c + jnp.uint32(1), dtype)
        uv0, uv1 = uniform_pair(seed, stream ^ _V_STREAM, path_ids, jj,
                                dtype)
        uc0, uc1 = uniform_pair(seed, stream ^ _JUMP_STREAM, path_ids, jj,
                                dtype)
        return (z_s0, uv0, uc0, z_j0), (z_s1, uv1, uc1, z_j1)

    def antithetic(self, eps):
        z_s, u_v, u_c, z_j = eps
        return (-z_s, 1.0 - u_v, 1.0 - u_c, -z_j)

    def step(self, state: BatesQEState, eps, t) -> BatesQEState:
        dtype = state.log_s.dtype
        z_s, u_v, u_c, z_j = eps
        v = state.v
        v_new, quad, a, b2, p, beta = self._next_v(v, u_v, dtype)
        k0s = self._k0_star(v, quad, a, b2, p, beta, dtype)
        var_s = self.k3.astype(dtype) * v + self.k4.astype(dtype) * v_new
        positive = var_s > 0
        sq = jnp.where(positive,
                       jnp.sqrt(jnp.where(positive, var_s, 1.0)), 0.0)
        # Aggregated jumps (Merton): given the count N, the lognormal
        # jump sum is N jm + sqrt(N) js z; the -lam mbar dt compensator
        # makes the jump leg an exact martingale factor.
        n = poisson_count(u_c, (self.lam * self.dt).astype(dtype), dtype)
        jm = self.jump_mean.astype(dtype)
        js = self.jump_std.astype(dtype)
        jumps = n * jm + jnp.sqrt(n) * js * z_j
        mbar = exp32(jm + 0.5 * jnp.square(js)) - 1.0
        log_s = (state.log_s
                 + ((self.mu.astype(dtype)
                     - self.lam.astype(dtype) * mbar)
                    * self.dt.astype(dtype) + k0s
                    + self.k1.astype(dtype) * v
                    + self.k2.astype(dtype) * v_new
                    + sq * z_s + jumps))
        return BatesQEState(log_s=log_s, v=v_new)

    def prices(self, state: BatesQEState):
        return exp32(state.log_s)

    def log_prices(self, state):
        """Native log prices for the functional engines."""
        return state.log_s
