"""CCC-GARCH portfolio process: per-asset GARCH(1,1) volatilities with
constant conditional correlation (Bollerslev 1990).

The reference's namesake model, extended to portfolios: every asset carries
its own GARCH(1,1) variance recurrence

    var_{a,t+1} = omega_a + alpha_a r_{a,t}^2 + beta_a var_{a,t}

while the shock vector is jointly normal with a constant correlation matrix
(applied as an unrolled Cholesky, like `BasketGBM`).  Returns are

    r_{a,t} = sqrt(var_{a,t}) * zc_{a,t},   log S_a += r_{a,t}

``prices`` yields the weighted portfolio value, so billion-path portfolio
VaR for a GARCH book runs through the same fused kernel / on-device VaR
machinery as everything else (tuple state, 2-D arrays only).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from montecarlo.rng.normal import exp32, log32
import numpy as np

from montecarlo.processes.base import NormalDrawsMixin


class CCCGarch(NormalDrawsMixin, NamedTuple("CCCGarchFields", [
        ("s0", jnp.ndarray),         # (A,)
        ("var0", jnp.ndarray),       # (A,) initial daily variances
        ("omega", jnp.ndarray),      # (A,)
        ("alpha", jnp.ndarray),      # (A,)
        ("beta", jnp.ndarray),       # (A,)
        ("chol_flat", jnp.ndarray),  # (A*A,) lower-triangular correlation
        ("weights", jnp.ndarray),    # (A,) portfolio weights
])):
    """Constant-conditional-correlation multivariate GARCH(1,1)."""

    @classmethod
    def create(cls, s0, var0, omega, alpha, beta, corr, weights,
               dtype=jnp.float32):
        corr = np.asarray(corr, np.float64)
        chol = np.linalg.cholesky(corr)
        as_ = lambda v: jnp.asarray(v, dtype)
        return cls(s0=as_(s0), var0=as_(var0), omega=as_(omega),
                   alpha=as_(alpha), beta=as_(beta),
                   chol_flat=as_(chol.reshape(-1)), weights=as_(weights))

    @property
    def n_assets(self) -> int:
        return self.s0.shape[0]

    @property
    def n_draws(self) -> int:
        return self.n_assets

    def init_state(self, path_ids, dtype=jnp.float32):
        log_s = tuple(jnp.full(path_ids.shape,
                               log32(self.s0[a]).astype(dtype), dtype)
                      for a in range(self.n_assets))
        var = tuple(jnp.full(path_ids.shape, self.var0[a].astype(dtype),
                             dtype)
                    for a in range(self.n_assets))
        return (log_s, var)

    def step(self, state, eps, t):
        log_s, var = state
        a_n = self.n_assets
        dtype = log_s[0].dtype
        chol = self.chol_flat.astype(dtype)
        new_log_s, new_var = [], []
        for a in range(a_n):
            zc = chol[a * a_n] * eps[0]
            for b in range(1, a + 1):
                zc = zc + chol[a * a_n + b] * eps[b]
            r = jnp.sqrt(var[a]) * zc
            new_log_s.append(log_s[a] + r)
            new_var.append(self.omega[a].astype(dtype)
                           + self.alpha[a].astype(dtype) * jnp.square(r)
                           + self.beta[a].astype(dtype) * var[a])
        return (tuple(new_log_s), tuple(new_var))

    def prices(self, state):
        log_s, _ = state
        dtype = log_s[0].dtype
        w = self.weights.astype(dtype)
        out = w[0] * exp32(log_s[0])
        for a in range(1, self.n_assets):
            out = out + w[a] * exp32(log_s[a])
        return out
