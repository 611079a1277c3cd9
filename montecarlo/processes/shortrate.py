"""Short-rate models: Vasicek, CIR, and Hull–White (extended Vasicek).

A new asset class for the framework (the reference app is equities-only —
its MC is the bootstrap recurrence at reference app.py:618-633): stochastic
interest rates with Monte Carlo bond/option pricing validated against the
affine closed forms (see :mod:`montecarlo.engine.rates`).

All three are scalar-state processes under the standard protocol
(:mod:`montecarlo.processes.base`), so they ride the same scan engine,
samplers, sharding, and the fused path kernel:

- **Vasicek** ``dr = kappa (theta - r) dt + sigma dW`` — stepped with the
  *exact* Ornstein–Uhlenbeck transition (no discretization bias in the rate
  path itself; only the discount integral is discretized).
- **CIR** ``dr = kappa (theta - r) dt + sigma sqrt(r) dW`` — full-truncation
  Euler (Lord–Koekkoek–van Dijk), the same scheme family as the Heston
  variance leg.
- **Hull–White** ``dr = (theta(t) - a r) dt + sigma dW`` — per-step theta
  curve (exact OU transition with theta frozen within each step), with a
  constructor that fits theta(t) to a market instantaneous-forward curve so
  the model reprices the input discount curve by construction.

The observable (``prices``) is the short rate r_t; discounting uses the
trapezoid pathwise integral functional
(:func:`montecarlo.engine.functionals.trapezoid_integral`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from montecarlo.rng.normal import exp32, log32
import numpy as np

from montecarlo.processes.base import NormalDrawsMixin


class RateState(NamedTuple):
    r: jnp.ndarray  # (n_paths,)


class Vasicek(NormalDrawsMixin, NamedTuple("VasicekFields", [
        ("r0", jnp.ndarray),
        ("kappa", jnp.ndarray),
        ("theta", jnp.ndarray),
        ("sigma", jnp.ndarray),
        ("dt", jnp.ndarray),
])):
    """Ornstein–Uhlenbeck short rate, exact per-step transition:

    r' = theta + (r - theta) e^{-kappa dt}
         + sigma sqrt((1 - e^{-2 kappa dt}) / (2 kappa)) z
    """

    n_draws = 1

    @classmethod
    def create(cls, r0, kappa, theta, sigma, dt, dtype=jnp.float32):
        as_ = lambda v: jnp.asarray(v, dtype)
        return cls(r0=as_(r0), kappa=as_(kappa), theta=as_(theta),
                   sigma=as_(sigma), dt=as_(dt))

    def init_state(self, path_ids, dtype=jnp.float32) -> RateState:
        return RateState(r=jnp.full(path_ids.shape,
                                    jnp.asarray(self.r0, dtype), dtype))

    def step(self, state: RateState, eps, t) -> RateState:
        dtype = state.r.dtype
        decay = exp32(-self.kappa * self.dt).astype(dtype)
        scale = (self.sigma * jnp.sqrt(
            (1.0 - exp32(-2.0 * self.kappa * self.dt))
            / (2.0 * self.kappa))).astype(dtype)
        theta = jnp.asarray(self.theta, dtype)
        return RateState(r=theta + (state.r - theta) * decay
                         + scale * eps[0])

    def prices(self, state: RateState):
        return state.r


class CIR(NormalDrawsMixin, NamedTuple("CIRFields", [
        ("r0", jnp.ndarray),
        ("kappa", jnp.ndarray),
        ("theta", jnp.ndarray),
        ("sigma", jnp.ndarray),
        ("dt", jnp.ndarray),
])):
    """Cox–Ingersoll–Ross square-root rate, full-truncation Euler:

    r' = r + kappa (theta - r+) dt + sigma sqrt(r+ dt) z,   r+ = max(r, 0)
    """

    n_draws = 1

    @classmethod
    def create(cls, r0, kappa, theta, sigma, dt, dtype=jnp.float32):
        as_ = lambda v: jnp.asarray(v, dtype)
        return cls(r0=as_(r0), kappa=as_(kappa), theta=as_(theta),
                   sigma=as_(sigma), dt=as_(dt))

    def init_state(self, path_ids, dtype=jnp.float32) -> RateState:
        return RateState(r=jnp.full(path_ids.shape,
                                    jnp.asarray(self.r0, dtype), dtype))

    def step(self, state: RateState, eps, t) -> RateState:
        dtype = state.r.dtype
        r_plus = jnp.maximum(state.r, 0.0)
        kdt = (self.kappa * self.dt).astype(dtype)
        theta = jnp.asarray(self.theta, dtype)
        vol = (self.sigma * jnp.sqrt(self.dt)).astype(dtype)
        return RateState(r=state.r + kdt * (theta - r_plus)
                         + vol * jnp.sqrt(r_plus) * eps[0])

    def prices(self, state: RateState):
        return state.r


class HullWhite(NormalDrawsMixin, NamedTuple("HullWhiteFields", [
        ("r0", jnp.ndarray),
        ("a", jnp.ndarray),
        ("sigma", jnp.ndarray),
        ("theta_t", jnp.ndarray),  # (pad,) per-step theta (per unit time)
        ("dt", jnp.ndarray),
])):
    """Hull–White one-factor: ``dr = (theta(t) - a r) dt + sigma dW``.

    theta is a per-step curve (padded to a static length, one-hot selected
    inside Pallas kernels exactly like
    :class:`montecarlo.processes.term_gbm.TermStructureGBM`); the step
    is the exact OU transition with theta frozen within the step:

    r' = r e^{-a dt} + (theta_k / a)(1 - e^{-a dt})
         + sigma sqrt((1 - e^{-2 a dt}) / (2 a)) z
    """

    n_draws = 1

    @classmethod
    def create(cls, r0, a, sigma, theta_curve, dt, dtype=jnp.float32,
               pad_to: int | None = None):
        theta_curve = np.asarray(theta_curve, np.float64)
        n = theta_curve.size
        if pad_to is None:
            pad_to = max(1, int(np.ceil(n / 128.0)) * 128)
        pad = np.zeros(pad_to)
        pad[:n] = theta_curve
        as_ = lambda v: jnp.asarray(v, dtype)
        return cls(r0=as_(r0), a=as_(a), sigma=as_(sigma),
                   theta_t=as_(pad), dt=as_(dt))

    @classmethod
    def from_forward_curve(cls, forwards, a, sigma, dt, dtype=jnp.float32,
                           pad_to: int | None = None):
        """Fit theta(t) to market instantaneous forwards f(0, t).

        ``forwards[k] = f(0, k dt)`` for k = 0..n_steps (one more entry than
        steps).  The no-arbitrage drift (Hull–White 1990):

            theta(t) = df/dt + a f(t) + sigma^2 / (2a) (1 - e^{-2at})

        evaluated at step midpoints (centered difference for df/dt), which
        makes the model reprice P(0,T) = exp(-int f) up to O(dt^2).
        """
        f = np.asarray(forwards, np.float64)
        if f.size < 2:
            raise ValueError("need forwards on the step grid (>= 2 points)")
        dt_f = float(dt)
        n_steps = f.size - 1
        t_mid = (np.arange(n_steps) + 0.5) * dt_f
        dfdt = np.diff(f) / dt_f                    # centered at midpoints
        f_mid = 0.5 * (f[:-1] + f[1:])
        a_f, s_f = float(a), float(sigma)
        theta = dfdt + a_f * f_mid + (s_f**2 / (2.0 * a_f)
                                      * (1.0 - np.exp(-2.0 * a_f * t_mid)))
        return cls.create(f[0], a, sigma, theta, dt, dtype, pad_to)

    def init_state(self, path_ids, dtype=jnp.float32) -> RateState:
        return RateState(r=jnp.full(path_ids.shape,
                                    jnp.asarray(self.r0, dtype), dtype))

    def step(self, state: RateState, eps, t) -> RateState:
        dtype = state.r.dtype
        ti = jnp.asarray(t, jnp.int32)
        theta = self.theta_t[ti].astype(dtype)
        decay = exp32(-self.a * self.dt).astype(dtype)
        scale = (self.sigma * jnp.sqrt(
            (1.0 - exp32(-2.0 * self.a * self.dt))
            / (2.0 * self.a))).astype(dtype)
        mean_term = (theta / self.a.astype(dtype)) * (1.0 - decay)
        return RateState(r=state.r * decay + mean_term + scale * eps[0])

    def prices(self, state: RateState):
        return state.r
