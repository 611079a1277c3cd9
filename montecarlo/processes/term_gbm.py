"""GBM with term structure: time-varying drift and volatility.

Real desks discount with a rate curve and diffuse with a (deterministic)
forward-vol curve; dividends enter as a drift adjustment.  This process
takes per-step arrays

    log S_{t+1} = log S_t + (mu_t - sigma_t^2/2) dt + sigma_t sqrt(dt) z_t

(padded to a static length so the compiled shapes never depend on the
horizon).  Scalar state + 1-D leaves keep it fused-kernel eligible; the
per-step parameter reads are scalar indexed loads inside the kernel.

Convenience constructors: ``from_curves(rates, vols, dt)`` and
``with_dividend(r, q, sigma)`` (continuous yield: mu = r - q).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from montecarlo.rng.normal import exp32, log32
import numpy as np

from montecarlo.processes.base import NormalDrawsMixin


class TermGBMState(NamedTuple):
    log_s: jnp.ndarray


class TermStructureGBM(NormalDrawsMixin, NamedTuple("TermGBMFields", [
        ("s0", jnp.ndarray),
        ("mu_t", jnp.ndarray),     # (pad,) per-step drift (per unit time)
        ("sigma_t", jnp.ndarray),  # (pad,) per-step vol (per unit time)
        ("dt", jnp.ndarray),
])):
    """GBM under deterministic rate/vol term structures."""

    n_draws = 1

    @classmethod
    def from_curves(cls, s0, mu_curve, sigma_curve, dt, dtype=jnp.float32,
                    pad_to: int | None = None):
        mu_curve = np.asarray(mu_curve, np.float64)
        sigma_curve = np.asarray(sigma_curve, np.float64)
        if mu_curve.shape != sigma_curve.shape:
            raise ValueError("mu and sigma curves must share a length")
        n = mu_curve.size
        if pad_to is None:
            pad_to = max(1, 1 << int(np.ceil(np.log2(max(n, 1)))))
        mu_p = np.zeros(pad_to)
        sig_p = np.zeros(pad_to)
        mu_p[:n], sig_p[:n] = mu_curve, sigma_curve
        as_ = lambda v: jnp.asarray(v, dtype)
        return cls(s0=as_(s0), mu_t=as_(mu_p), sigma_t=as_(sig_p),
                   dt=as_(dt))

    @classmethod
    def with_dividend(cls, s0, r, q, sigma, dt, n_steps: int,
                      dtype=jnp.float32):
        """Constant rate r, continuous dividend yield q: mu = r - q."""
        return cls.from_curves(s0, np.full(n_steps, r - q),
                               np.full(n_steps, sigma), dt, dtype)

    def init_state(self, path_ids, dtype=jnp.float32) -> TermGBMState:
        return TermGBMState(log_s=jnp.full(path_ids.shape,
                                           log32(self.s0).astype(dtype),
                                           dtype))

    def step(self, state: TermGBMState, eps, t) -> TermGBMState:
        dtype = state.log_s.dtype
        ti = jnp.asarray(t, jnp.int32)
        mu = self.mu_t[ti]
        sigma = self.sigma_t[ti]
        drift = ((mu - 0.5 * jnp.square(sigma)) * self.dt).astype(dtype)
        scale = (sigma * jnp.sqrt(self.dt)).astype(dtype)
        # Increment grouped before the accumulator add (see GBM.step).
        return TermGBMState(log_s=state.log_s + (drift + scale * eps[0]))

    def prices(self, state: TermGBMState):
        return exp32(state.log_s)

    def log_prices(self, state):
        """Native log prices — the functional engines fold log-space
        functionals on these directly (no per-step exp/log)."""
        return state.log_s

