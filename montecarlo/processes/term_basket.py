"""Correlated GBM basket with per-asset term structures.

Closes the gap left by :class:`montecarlo.processes.term_gbm.
TermStructureGBM` (single asset) and :class:`montecarlo.processes.
basket.BasketGBM` (flat parameters): each asset carries its own per-step
drift and vol curve (dividend/repo-adjusted forwards, forward-vol strips),
while draws stay correlated through the unrolled Cholesky.

    log S_a += (mu_a(t) - sigma_a(t)^2/2) dt + sigma_a(t) sqrt(dt) zc_a

Curves live as (A, pad) leaves; inside Pallas kernels the per-step entry is
selected by the same one-hot masked reduction TermStructureGBM uses (static
asset index, dynamic time index).  Tuple state of 2-D arrays — fused-kernel
eligible.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from montecarlo.rng.normal import exp32, log32
import numpy as np

from montecarlo.processes.base import NormalDrawsMixin


class TermBasketGBM(NormalDrawsMixin, NamedTuple("TermBasketFields", [
        ("s0", jnp.ndarray),         # (A,)
        ("mu_t", jnp.ndarray),       # (A, pad) per-step drift curves
        ("sigma_t", jnp.ndarray),    # (A, pad) per-step vol curves
        ("chol_flat", jnp.ndarray),  # (A*A,) row-major lower-triangular
        ("weights", jnp.ndarray),    # (A,)
        ("dt", jnp.ndarray),
])):
    """Correlated basket under deterministic per-asset term structures."""

    @classmethod
    def create(cls, s0, mu_curves, sigma_curves, corr, weights, dt,
               dtype=jnp.float32, pad_to: int | None = None):
        mu_curves = np.atleast_2d(np.asarray(mu_curves, np.float64))
        sigma_curves = np.atleast_2d(np.asarray(sigma_curves, np.float64))
        if mu_curves.shape != sigma_curves.shape:
            raise ValueError("mu and sigma curves must share a shape")
        a_n, n = mu_curves.shape
        if len(np.asarray(s0).shape) != 1 or np.asarray(s0).size != a_n:
            raise ValueError("s0 must be (A,) matching the curve rows")
        if pad_to is None:
            pad_to = max(128, int(np.ceil(n / 128.0)) * 128)
        mu_p = np.zeros((a_n, pad_to))
        sig_p = np.zeros((a_n, pad_to))
        mu_p[:, :n], sig_p[:, :n] = mu_curves, sigma_curves
        corr = np.asarray(corr, np.float64)
        chol = np.linalg.cholesky(corr)
        as_ = lambda v: jnp.asarray(v, dtype)
        return cls(s0=as_(s0), mu_t=as_(mu_p), sigma_t=as_(sig_p),
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
        ti = jnp.asarray(t, jnp.int32)
        chol = self.chol_flat.astype(dtype)
        new = []
        for a in range(a_n):
            zc = chol[a * a_n] * eps[0]
            for b in range(1, a + 1):
                zc = zc + chol[a * a_n + b] * eps[b]
            mu = self.mu_t[a][ti]
            sigma = self.sigma_t[a][ti]
            drift = ((mu - 0.5 * jnp.square(sigma)) * self.dt).astype(dtype)
            scale = (sigma * jnp.sqrt(self.dt)).astype(dtype)
            # Increment grouped before the add (see GBM.step).
            new.append(state[a] + (drift + scale * zc))
        return tuple(new)

    def prices(self, state):
        """Basket value: weights . exp(log S)."""
        dtype = state[0].dtype
        w = self.weights.astype(dtype)
        out = w[0] * exp32(state[0])
        for a in range(1, self.n_assets):
            out = out + w[a] * exp32(state[a])
        return out
