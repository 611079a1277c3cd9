"""Equity x stochastic-rates hybrid (GBM under Vasicek), EXACT transition.

    dS/S = r_t dt + sigma_s dW_s
    dr   = kappa (theta - r) dt + sigma_r dW_r,   corr(dW_s, dW_r) = rho

The long-dated equity / hybrid-desk model: equity options, GMxB-style
guarantees, and equity xVA all need the equity leg to feel the rate moves
(a flat-rate GBM misprices a 10y call materially when rates are volatile).

Design — ZERO time-discretization error: over one step the
triple

    X1 = r_{t+dt},   X2 = integral_t^{t+dt} r_u du,   X3 = sigma_s W_s(dt)

is jointly GAUSSIAN conditional on r_t, with closed-form mean/covariance
(Ornstein-Uhlenbeck algebra); the state-independent 3x3 covariance is
Cholesky-factorized ONCE at create time (host, f64) and each step maps 3
unit normals through it:

    log S += X2 - sigma_s^2 dt / 2 + X3        (risk-neutral equity leg)
    integ += X2                                 (exact pathwise discounting)
    r      = X1

so a 1-step simulation to maturity is as unbiased as a 1000-step one —
the European-call test pins the closed form at n_steps = 4, and the
bank-account test recovers the Vasicek ZCB exactly.  All-normal draws
(NormalDrawsMixin): Sobol-eligible and fused-Pallas-capable (3 scalar
state leaves).

Closed-form oracle (Merton 1973 / Geman-El Karoui-Rochet): under the
T-forward measure the call is Black with total variance

    V(T) = sigma_s^2 T + 2 rho sigma_s sigma_r (T - B)/kappa
           + sigma_r^2 (T - 2B + C2) / kappa^2,
    B = (1 - e^{-kappa T})/kappa,  C2 = (1 - e^{-2 kappa T})/(2 kappa),

i.e. ``price = S0 N(d1) - K P(0,T) N(d2)`` with
``d1 = [ln(S0/(K P)) + V/2]/sqrt(V)`` (`hybrid_call_closed_form`).

Beyond-reference capability (the reference has neither stochastic rates
nor hybrids); same process protocol as every model here.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from montecarlo.processes.base import (NormalDrawsMixin,
                                            grad_safe_sqrt)
from montecarlo.rng.normal import exp32, log32


class HybridState(NamedTuple):
    log_s: jnp.ndarray  # (n_paths,)
    r: jnp.ndarray      # (n_paths,) short rate
    integ: jnp.ndarray  # (n_paths,) exact running integral of r du


def _transition_constants(kappa: float, sigma_r: float, sigma_s: float,
                          rho: float, dt: float):
    """Per-step conditional means/Cholesky of (r', int r, sigma_s W_s)."""
    k = float(kappa)
    e1 = math.exp(-k * dt)
    b1 = (1.0 - e1) / k
    c2 = (1.0 - math.exp(-2.0 * k * dt)) / (2.0 * k)
    cov = np.array([
        [sigma_r**2 * c2,
         sigma_r**2 * (b1 - c2) / k,
         rho * sigma_s * sigma_r * b1],
        [sigma_r**2 * (b1 - c2) / k,
         sigma_r**2 * (dt - 2.0 * b1 + c2) / k**2,
         rho * sigma_s * sigma_r * (dt - b1) / k],
        [rho * sigma_s * sigma_r * b1,
         rho * sigma_s * sigma_r * (dt - b1) / k,
         sigma_s**2 * dt],
    ], np.float64)
    # Tiny jitter for the rho = +-1 degenerate boundary.
    chol = np.linalg.cholesky(cov + 1e-18 * np.eye(3))
    return e1, b1, chol


class EquityVasicekHybrid(NormalDrawsMixin, NamedTuple("HybridFields", [
        ("s0", jnp.ndarray),
        ("r0", jnp.ndarray),
        ("kappa", jnp.ndarray),
        ("theta", jnp.ndarray),
        ("sigma_r", jnp.ndarray),
        ("sigma_s", jnp.ndarray),
        ("rho", jnp.ndarray),
        ("dt", jnp.ndarray),
        ("decay", jnp.ndarray),     # e^{-kappa dt}
        ("b1", jnp.ndarray),        # B(dt)
        ("chol", jnp.ndarray),      # (3, 3) transition Cholesky
])):
    """GBM equity under Vasicek short rates, exact joint transition."""

    n_draws = 3

    #: Multi-component exposure protocol (engine.exposure): cross-asset
    #: netting sets mark rate trades off component 1 (the Vasicek short
    #: rate) and equity trades off component 0, all on ONE simulation;
    #: discounting is EXACT through component 2 (the running integral —
    #: no trapezoid error), and the multivariate delta-normal IM folds
    #: equity and rate deltas with their instantaneous correlation.
    exposure_components = ("s", "r", "integ")
    exposure_discount_kind = "exact"

    @classmethod
    def create(cls, s0, r0, kappa, theta, sigma_r, sigma_s, rho, dt,
               dtype=jnp.float32):
        if float(kappa) <= 0.0:
            raise ValueError("kappa must be positive")
        if not -1.0 <= float(rho) <= 1.0:
            raise ValueError("need -1 <= rho <= 1")
        e1, b1, chol = _transition_constants(float(kappa), float(sigma_r),
                                             float(sigma_s), float(rho),
                                             float(dt))
        as_ = lambda v: jnp.asarray(v, dtype)
        return cls(s0=as_(s0), r0=as_(r0), kappa=as_(kappa),
                   theta=as_(theta), sigma_r=as_(sigma_r),
                   sigma_s=as_(sigma_s), rho=as_(rho), dt=as_(dt),
                   decay=as_(e1), b1=as_(b1), chol=as_(chol))

    def init_state(self, path_ids, dtype=jnp.float32) -> HybridState:
        shape = path_ids.shape
        return HybridState(
            log_s=jnp.full(shape, log32(self.s0).astype(dtype), dtype),
            r=jnp.full(shape, self.r0.astype(dtype), dtype),
            integ=jnp.zeros(shape, dtype),
        )

    def step(self, state: HybridState, eps, t) -> HybridState:
        dtype = state.log_s.dtype
        z1, z2, z3 = eps
        ch = self.chol.astype(dtype)
        # Stochastic parts of (r', int r, sigma_s W_s): constant Cholesky.
        x1 = ch[0, 0] * z1
        x2 = ch[1, 0] * z1 + ch[1, 1] * z2
        x3 = ch[2, 0] * z1 + ch[2, 1] * z2 + ch[2, 2] * z3
        theta = self.theta.astype(dtype)
        dev = state.r - theta
        r_new = theta + dev * self.decay.astype(dtype) + x1
        i_mean = theta * self.dt.astype(dtype) + dev * self.b1.astype(dtype)
        inc_i = i_mean + x2
        half_var = (0.5 * jnp.square(self.sigma_s)
                    * self.dt).astype(dtype)
        return HybridState(
            log_s=state.log_s + (inc_i - half_var + x3),
            r=r_new,
            integ=state.integ + inc_i,
        )

    def prices(self, state: HybridState):
        return exp32(state.log_s)

    def log_prices(self, state):
        """Native log prices for log-space functionals."""
        return state.log_s

    def discount(self, state: HybridState):
        """Exact pathwise discount factor e^{-int_0^t r du}."""
        return exp32(-state.integ)

    # --- exposure protocol -------------------------------------------
    def exposure_obs(self, state: HybridState):
        """(n_paths, 3) observation: (S, r, int r du)."""
        return jnp.stack([exp32(state.log_s), state.r, state.integ],
                         axis=-1)

    def pathwise_discount(self, obs):
        """Exact D(0, t_k) rows from the (..., C, N) observation."""
        return exp32(-obs[..., 2, :])

    def wwr_state(self, obs):
        """The state the wrong-way intensity loads on: the equity spot
        (credit-equity WWR — the classic Merton-style linkage)."""
        return obs[..., 0, :]

    def im_norm(self, dvs, obs, mpor):
        """Multivariate delta-normal IM std over the margin period:
        equity shock std ``S sigma_s sqrt(mpor)`` (lognormal convention),
        rate shock the exact OU conditional std, folded with the
        INSTANTANEOUS equity-rate correlation rho (the standard
        delta-normal approximation for the cross term).  The integral
        component carries no shock (trades mark off (S, r) only; its
        sensitivity row is identically zero for any book built from the
        documented closures)."""
        dtype = dvs.dtype
        kap = jnp.asarray(self.kappa, dtype)
        m = jnp.asarray(mpor, dtype)
        s_spot = obs[..., 0, :]
        sd_s = (jnp.asarray(self.sigma_s, dtype)
                * jnp.sqrt(m)) * s_spot
        sd_r = jnp.asarray(self.sigma_r, dtype) * jnp.sqrt(
            (1.0 - jnp.exp(-2.0 * kap * m))
            / jnp.maximum(2.0 * kap, 1e-12))
        rho = jnp.asarray(self.rho, dtype)
        a = dvs[..., 0, :] * sd_s
        b = dvs[..., 1, :] * sd_r
        # grad_safe: a matured book's dv rows are exactly zero — plain
        # sqrt's infinite slope at 0 NaNs the xVA-greek tangents.
        return grad_safe_sqrt(a * a + b * b + 2.0 * rho * a * b)


def hybrid_price_mc(process: EquityVasicekHybrid, payoff_fn, n_paths: int,
                    n_steps: int, *, seed: int, dtype=jnp.float32):
    """Price E[e^{-int r} payoff(S_T)] under the hybrid — the pathwise
    discount lives in the state, so pricing walks the state directly
    (scan engine; the terminal-price fast paths drop the integral).

    Returns ``{"price", "std_err", "n_paths"}``.
    """
    from functools import partial

    import jax

    from montecarlo.engine.simulate import path_ids_for
    from montecarlo.rng.threefry import key_from_seed_dynamic
    from montecarlo.samplers import PlainSampler

    k0, k1 = key_from_seed_dynamic(seed, 0)

    @partial(jax.jit, static_argnames=("payoff_fn", "n_paths", "n_steps",
                                       "dtype"))
    def run(proc, k0, k1, payoff_fn, n_paths, n_steps, dtype):
        sampler = PlainSampler()
        ids = path_ids_for(n_paths, 0)
        state0 = proc.init_state(ids, dtype)

        def body(state, t):
            eps = sampler.draws(proc, k0, k1, ids, t, dtype)
            return proc.step(state, eps, t), None

        final, _ = jax.lax.scan(body, state0,
                                jnp.arange(n_steps, dtype=jnp.int32))
        vals = proc.discount(final) * payoff_fn(proc.prices(final))
        n = jnp.asarray(n_paths, dtype)
        return {"price": jnp.mean(vals),
                "std_err": jnp.std(vals, ddof=1) / jnp.sqrt(n)}

    out = run(process, k0, k1, payoff_fn, n_paths, n_steps, dtype)
    out["n_paths"] = n_paths
    return out


def hybrid_call_closed_form(s0, strike, T, r0, kappa, theta, sigma_r,
                            sigma_s, rho):
    """European call under the hybrid, exact (T-forward-measure Black
    with the integrated equity+bond variance; see module docstring)."""
    from scipy.stats import norm

    from montecarlo.engine.rates import vasicek_zcb

    k = float(kappa)
    b = (1.0 - math.exp(-k * T)) / k
    c2 = (1.0 - math.exp(-2.0 * k * T)) / (2.0 * k)
    v = (sigma_s**2 * T
         + 2.0 * rho * sigma_s * sigma_r * (T - b) / k
         + sigma_r**2 * (T - 2.0 * b + c2) / k**2)
    p0t = float(vasicek_zcb(r0, kappa, theta, sigma_r, T))
    d1 = (math.log(s0 / (strike * p0t)) + 0.5 * v) / math.sqrt(v)
    d2 = d1 - math.sqrt(v)
    return s0 * norm.cdf(d1) - strike * p0t * norm.cdf(d2)


__all__ = ["EquityVasicekHybrid", "HybridState",
           "hybrid_call_closed_form", "hybrid_price_mc"]
