"""Euler–Maruyama GBM — the canonical *biased* discretization.

    S_{t+1} = S_t * (1 + mu dt + sigma sqrt(dt) z_t)

Unlike :class:`montecarlo.processes.gbm.GBM` (log-Euler, exact for GBM),
the arithmetic Euler scheme has O(dt) weak error and O(sqrt(dt)) strong
error — which makes it the standard test workload for multilevel Monte
Carlo (Giles 2008): the level-coupling variance decays like O(dt) and MLMC
beats single-level MC by orders of magnitude at tight tolerances.  See
:mod:`montecarlo.engine.mlmc`.

(The reference app has no discretized-SDE machinery at all — its loop at
reference app.py:618-633 is an exact-in-distribution bootstrap recurrence —
so this process exists purely for the rebuild's MLMC capability.)
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from montecarlo.processes.base import NormalDrawsMixin


class EulerGBMState(NamedTuple):
    s: jnp.ndarray  # (n_paths,)


class EulerGBM(NormalDrawsMixin, NamedTuple("EulerGBMFields", [
        ("s0", jnp.ndarray),
        ("mu", jnp.ndarray),
        ("sigma", jnp.ndarray),
        ("dt", jnp.ndarray),
])):
    """Single-asset GBM under the arithmetic Euler–Maruyama scheme."""

    n_draws = 1

    @classmethod
    def create(cls, s0, mu, sigma, dt, dtype=jnp.float32):
        as_ = lambda v: jnp.asarray(v, dtype)
        return cls(s0=as_(s0), mu=as_(mu), sigma=as_(sigma), dt=as_(dt))

    def init_state(self, path_ids, dtype=jnp.float32) -> EulerGBMState:
        s0 = jnp.asarray(self.s0, dtype)
        return EulerGBMState(s=jnp.full(path_ids.shape, s0, dtype))

    def step(self, state: EulerGBMState, eps, t) -> EulerGBMState:
        z = eps[0]
        dtype = state.s.dtype
        drift = (self.mu * self.dt).astype(dtype)
        scale = (self.sigma * jnp.sqrt(self.dt)).astype(dtype)
        return EulerGBMState(s=state.s * (1.0 + drift + scale * z))

    def prices(self, state: EulerGBMState):
        return state.s
