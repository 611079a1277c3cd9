"""Correlated multi-asset GBM (BASELINE.json config 3).

Per step, each path draws ``n_assets`` i.i.d. standard normals which are
correlated through a Cholesky factor — the correlation is a single
(n_paths, n_assets) x (n_assets, n_assets) matmul at full f32 precision:

    log S_{t+1,a} = log S_{t,a} + (mu_a - sigma_a^2/2) dt
                    + sigma_a sqrt(dt) * (L z_t)_a
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from montecarlo.rng.normal import exp32, log32
import numpy as np

from montecarlo.processes.base import NormalDrawsMixin


class MultiGBMState(NamedTuple):
    log_s: jnp.ndarray  # (n_paths, n_assets)


class MultiGBM(NormalDrawsMixin, NamedTuple("MultiGBMFields", [
        ("s0", jnp.ndarray),     # (n_assets,)
        ("mu", jnp.ndarray),     # (n_assets,)
        ("sigma", jnp.ndarray),  # (n_assets,)
        ("chol", jnp.ndarray),   # (n_assets, n_assets) lower-triangular
        ("dt", jnp.ndarray),
])):
    """Basket of correlated GBM assets."""

    @classmethod
    def create(cls, s0, mu, sigma, corr, dt, dtype=jnp.float32):
        corr = np.asarray(corr, np.float64)
        chol = np.linalg.cholesky(corr)
        as_ = lambda v: jnp.asarray(v, dtype)
        return cls(s0=as_(s0), mu=as_(mu), sigma=as_(sigma),
                   chol=as_(chol), dt=as_(dt))

    @property
    def n_draws(self) -> int:
        return self.s0.shape[0]

    def init_state(self, path_ids, dtype=jnp.float32) -> MultiGBMState:
        n = path_ids.shape[0]
        log_s0 = log32(self.s0).astype(dtype)
        return MultiGBMState(log_s=jnp.broadcast_to(
            log_s0[None, :], (n, self.n_draws)).astype(dtype))

    def step(self, state: MultiGBMState, eps, t) -> MultiGBMState:
        dtype = state.log_s.dtype
        # Correlate: (n_paths, A) @ L^T — one matmul at full f32
        # precision (TF32 would distort the correlation).
        zmat = jnp.stack(eps, axis=-1)
        zc = jnp.dot(zmat, self.chol.astype(dtype).T,
                     precision=jax.lax.Precision.HIGHEST,
                     preferred_element_type=jnp.float32).astype(dtype)
        drift = ((self.mu - 0.5 * jnp.square(self.sigma)) * self.dt).astype(dtype)
        scale = (self.sigma * jnp.sqrt(self.dt)).astype(dtype)
        # Increment grouped before the accumulator add (see GBM.step).
        return MultiGBMState(log_s=state.log_s
                             + (drift[None, :] + scale[None, :] * zc))

    def prices(self, state: MultiGBMState):
        return exp32(state.log_s)

    def log_prices(self, state):
        """Native log prices — the functional engines fold log-space
        functionals on these directly (no per-step exp/log)."""
        return state.log_s
