"""Geometric Brownian motion — the benchmark workload (BASELINE.json config 1).

Log-Euler scheme, which is *exact* for GBM:

    log S_{t+1} = log S_t + (mu - sigma^2/2) dt + sigma sqrt(dt) z_t

The reference app's Monte Carlo is a bootstrap-GARCH generalization of this
(reference app.py:618-633); plain GBM is the constant-variance, Gaussian-shock
special case and is the process the driver's north-star metric
(GBM path-steps/sec/chip) is measured on.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from montecarlo.rng.normal import exp32, log32

from montecarlo.processes.base import NormalDrawsMixin


class GBMState(NamedTuple):
    log_s: jnp.ndarray  # (n_paths,)


class GBM(NormalDrawsMixin, NamedTuple("GBMFields", [
        ("s0", jnp.ndarray),
        ("mu", jnp.ndarray),
        ("sigma", jnp.ndarray),
        ("dt", jnp.ndarray),
])):
    """Single-asset GBM. ``mu``/``sigma`` are per-unit-time (e.g. annualized
    with ``dt = 1/252``)."""

    n_draws = 1

    @classmethod
    def create(cls, s0, mu, sigma, dt, dtype=jnp.float32):
        as_ = lambda v: jnp.asarray(v, dtype)
        return cls(s0=as_(s0), mu=as_(mu), sigma=as_(sigma), dt=as_(dt))

    def init_state(self, path_ids, dtype=jnp.float32) -> GBMState:
        log_s0 = log32(self.s0).astype(dtype)
        return GBMState(log_s=jnp.full(path_ids.shape, log_s0, dtype))

    def step(self, state: GBMState, eps, t) -> GBMState:
        z = eps[0]
        dtype = state.log_s.dtype
        drift = ((self.mu - 0.5 * jnp.square(self.sigma)) * self.dt).astype(dtype)
        scale = (self.sigma * jnp.sqrt(self.dt)).astype(dtype)
        # The step increment is grouped BEFORE the accumulator add:
        # repeatedly adding the small constant drift to the large log-price
        # in f32 has a systematic round-to-nearest bias (~1e-7/step,
        # -2.6e-5 over 252 steps — a real -1.4e-3 on the 1y call that only
        # QMC error bars could see); one add of the grouped random
        # increment is unbiased. Applies to every log-accumulating process.
        return GBMState(log_s=state.log_s + (drift + scale * z))

    def prices(self, state: GBMState):
        return exp32(state.log_s)

    def log_prices(self, state):
        """Native log prices — the functional engines fold log-space
        functionals on these directly (no per-step exp/log)."""
        return state.log_s
