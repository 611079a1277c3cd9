"""Heston stochastic-volatility model, full-truncation Euler scheme
(BASELINE.json config 4).

    dS_t = mu S_t dt + sqrt(v_t) S_t dW^S
    dv_t = kappa (theta - v_t) dt + xi sqrt(v_t) dW^v,   corr(dW^S, dW^v) = rho

Full truncation (Lord, Koekkoek & van Dijk 2010): the variance used in both
the drift and diffusion of the discretized equations is v^+ = max(v, 0), and
the stored v may go negative (it mean-reverts back) — the scheme with the
smallest bias among Euler variants:

    log S_{t+1} = log S_t + (mu - v^+/2) dt + sqrt(v^+ dt) z_s
    v_{t+1}     = v_t + kappa (theta - v^+) dt + xi sqrt(v^+ dt) z_v
    z_s = z_1,  z_v = rho z_1 + sqrt(1 - rho^2) z_2
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from montecarlo.rng.normal import exp32, log32

from montecarlo.processes.base import NormalDrawsMixin


class HestonState(NamedTuple):
    log_s: jnp.ndarray  # (n_paths,)
    v: jnp.ndarray      # (n_paths,) — may be negative; truncated at use


class Heston(NormalDrawsMixin, NamedTuple("HestonFields", [
        ("s0", jnp.ndarray),
        ("v0", jnp.ndarray),
        ("mu", jnp.ndarray),
        ("kappa", jnp.ndarray),
        ("theta", jnp.ndarray),
        ("xi", jnp.ndarray),
        ("rho", jnp.ndarray),
        ("dt", jnp.ndarray),
])):
    """Heston model under full-truncation Euler."""

    n_draws = 2

    @classmethod
    def create(cls, s0, v0, mu, kappa, theta, xi, rho, dt, dtype=jnp.float32):
        as_ = lambda v: jnp.asarray(v, dtype)
        return cls(s0=as_(s0), v0=as_(v0), mu=as_(mu), kappa=as_(kappa),
                   theta=as_(theta), xi=as_(xi), rho=as_(rho), dt=as_(dt))

    def init_state(self, path_ids, dtype=jnp.float32) -> HestonState:
        shape = path_ids.shape
        return HestonState(
            log_s=jnp.full(shape, log32(self.s0).astype(dtype), dtype),
            v=jnp.full(shape, self.v0.astype(dtype), dtype),
        )

    def step(self, state: HestonState, eps, t) -> HestonState:
        dtype = state.log_s.dtype
        z1, z2 = eps[0], eps[1]
        rho = self.rho.astype(dtype)
        z_v = rho * z1 + jnp.sqrt(1.0 - jnp.square(rho)) * z2
        dt = self.dt.astype(dtype)
        v_plus = jnp.maximum(state.v, 0.0)
        # Double-where guards the sqrt's gradient singularity at v == 0
        # (pathwise Greeks differentiate through this step; sqrt'(0) = inf
        # would poison the whole reverse pass with NaNs).
        positive = v_plus > 0
        v_safe = jnp.where(positive, v_plus, 1.0)
        sq_vdt = jnp.where(positive, jnp.sqrt(v_safe * dt), 0.0)
        # Increment grouped before the accumulator add (see GBM.step).
        log_s = (state.log_s
                 + ((self.mu.astype(dtype) - 0.5 * v_plus) * dt
                    + sq_vdt * z1))
        v = (state.v
             + self.kappa.astype(dtype) * (self.theta.astype(dtype) - v_plus) * dt
             + self.xi.astype(dtype) * sq_vdt * z_v)
        return HestonState(log_s=log_s, v=v)

    def prices(self, state: HestonState):
        return exp32(state.log_s)

    def log_prices(self, state):
        """Native log prices — the functional engines fold log-space
        functionals on these directly (no per-step exp/log)."""
        return state.log_s
