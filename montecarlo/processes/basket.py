"""Kernel-fuseable correlated multi-asset GBM (basket form).

`MultiGBM` keeps its state as an (n_paths, n_assets) matrix and correlates
draws with one matmul — ideal for the XLA scan engine.  Inside the fused
kernel every array is one value per path, so this sibling process keeps
**one array per asset** (a tuple state) and unrolls the Cholesky
correlation over the (small, static) asset count:

    zc_a = sum_{b<=a} L[a,b] * z_b            (A(A+1)/2 fused mul-adds)
    log S_a += (mu_a - sigma_a^2/2) dt + sigma_a sqrt(dt) zc_a

``prices`` returns the *basket value* (weights . S), which is exactly what
basket-option payoffs and portfolio VaR consume — so the entire config-3
workload (BASELINE.json) runs as one fused kernel.  Draw streams use the
same (t*A + b) convention as MultiGBM, so the two agree statistically and
per-draw.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from montecarlo.rng.normal import exp32, log32
import numpy as np

from montecarlo.processes.base import NormalDrawsMixin


class BasketGBM(NormalDrawsMixin, NamedTuple("BasketGBMFields", [
        ("s0", jnp.ndarray),         # (A,)
        ("mu", jnp.ndarray),         # (A,)
        ("sigma", jnp.ndarray),      # (A,)
        ("chol_flat", jnp.ndarray),  # (A*A,) row-major lower-triangular
        ("weights", jnp.ndarray),    # (A,)
        ("dt", jnp.ndarray),
])):
    """Correlated GBM basket with per-asset tuple state."""

    @classmethod
    def create(cls, s0, mu, sigma, corr, weights, dt, dtype=jnp.float32):
        corr = np.asarray(corr, np.float64)
        chol = np.linalg.cholesky(corr)
        as_ = lambda v: jnp.asarray(v, dtype)
        return cls(s0=as_(s0), mu=as_(mu), sigma=as_(sigma),
                   chol_flat=as_(chol.reshape(-1)), weights=as_(weights),
                   dt=as_(dt))

    @property
    def n_assets(self) -> int:
        return self.s0.shape[0]

    @property
    def n_draws(self) -> int:
        return self.n_assets

    def init_state(self, path_ids, dtype=jnp.float32):
        return tuple(
            jnp.full(path_ids.shape, log32(self.s0[a]).astype(dtype),
                     dtype)
            for a in range(self.n_assets))

    def step(self, state, eps, t):
        a_n = self.n_assets
        dtype = state[0].dtype
        chol = self.chol_flat.astype(dtype)
        new = []
        for a in range(a_n):
            zc = chol[a * a_n] * eps[0]
            for b in range(1, a + 1):
                zc = zc + chol[a * a_n + b] * eps[b]
            drift = ((self.mu[a] - 0.5 * jnp.square(self.sigma[a]))
                     * self.dt).astype(dtype)
            scale = (self.sigma[a] * jnp.sqrt(self.dt)).astype(dtype)
            # Increment grouped before the add (see GBM.step).
            new.append(state[a] + (drift + scale * zc))
        return tuple(new)

    def prices(self, state):
        """Basket value: weights . exp(log S). (Per-asset prices are
        available from the scan engine via MultiGBM when needed.)"""
        dtype = state[0].dtype
        w = self.weights.astype(dtype)
        out = w[0] * exp32(state[0])
        for a in range(1, self.n_assets):
            out = out + w[a] * exp32(state[a])
        return out
