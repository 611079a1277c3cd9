"""Equity + volatility netting sets on Heston: the multi-state exposure
protocol (`engine.exposure.is_multistate`) carried by a STOCHASTIC-VOL
equity underlying — so one netting set can hold equity forwards AND
variance swaps marked off the SAME simulation, with the vol-equity
correlation driving real netting (a long-equity book hedged with a long
variance swap nets exactly when rho < 0 moves them oppositely).

The reference app has no derivatives risk surface at all (reference
app.py stops at VaR/CVaR on GBM paths, app.py:639-656); this extends
the framework's own xVA bar — rates (Vasicek/G2++/LMM), cross-asset
hybrid, equity GBM — with the equity-VOLATILITY asset class.

`HestonExposure` is the pricing `processes.heston.Heston` (identical
full-truncation Euler algebra — same drift grouping, same double-where
sqrt guard) plus one state component: the ACCRUED VARIANCE
``ivar_t = sum v^+ dt`` over the grid, which is exactly the realized
leg a variance-swap mark needs.  Risk-neutral drift ``mu = r`` with
flat-rate discounting (the engine's "flat" kind — Heston desks discount
off a deterministic curve).

Variance-swap marks are AFFINE closed forms in (v, ivar):

    V_t = e^{-r (T - t)} ( [ ivar_t + E(int_t^T v du | v_t) ] / T - K ),
    E(int_t^T v du | v_t) = (v - theta)(1 - e^{-kappa tau})/kappa
                            + theta tau,

the continuous-limit CIR expectation (market practice marks by the
closed form; the scheme's O(dt) accrual discretization is the same one
the contract's realized leg uses, so the par identity at t=0 is exact
by construction — tested, plus a discounted-mark martingale test within
scheme bias).

Wrong-way state: the VARIANCE (not the spot) — a volatility book's
classic wrong-way linkage is "counterparties default when vol spikes";
`wwr_beta > 0` on a long-variance-swap book must RAISE CVA (tested).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from montecarlo.processes.base import (NormalDrawsMixin,
                                            grad_safe_sqrt)
from montecarlo.rng.normal import exp32, log32


class HestonExposureState(NamedTuple):
    log_s: jnp.ndarray  # (n_paths,)
    v: jnp.ndarray      # (n_paths,) — may be negative; truncated at use
    ivar: jnp.ndarray   # (n_paths,) accrued sum v^+ dt (realized leg)


class HestonExposure(NormalDrawsMixin, NamedTuple("HestonExposureFields", [
        ("s0", jnp.ndarray),
        ("v0", jnp.ndarray),
        ("mu", jnp.ndarray),      # risk-neutral: the flat rate r
        ("kappa", jnp.ndarray),
        ("theta", jnp.ndarray),
        ("xi", jnp.ndarray),
        ("rho", jnp.ndarray),
        ("dt", jnp.ndarray),
])):
    """Heston full-truncation Euler + accrued variance, exposing the
    multi-state netting protocol (components ``(s, v, ivar)``)."""

    n_draws = 2

    #: Multi-component exposure protocol (engine.exposure): equity
    #: trades mark off component 0, variance swaps off (1, 2);
    #: discounting is the engine's flat rate (deterministic curve).
    exposure_components = ("s", "v", "ivar")
    exposure_discount_kind = "flat"

    @classmethod
    def create(cls, s0, v0, r, kappa, theta, xi, rho, dt,
               dtype=jnp.float32):
        if float(kappa) <= 0.0:
            raise ValueError("kappa must be positive")
        if not -1.0 <= float(rho) <= 1.0:
            raise ValueError("need -1 <= rho <= 1")
        as_ = lambda v: jnp.asarray(v, dtype)
        return cls(s0=as_(s0), v0=as_(v0), mu=as_(r), kappa=as_(kappa),
                   theta=as_(theta), xi=as_(xi), rho=as_(rho), dt=as_(dt))

    def init_state(self, path_ids, dtype=jnp.float32) -> HestonExposureState:
        shape = path_ids.shape
        return HestonExposureState(
            log_s=jnp.full(shape, log32(self.s0).astype(dtype), dtype),
            v=jnp.full(shape, self.v0.astype(dtype), dtype),
            ivar=jnp.zeros(shape, dtype),
        )

    def step(self, state: HestonExposureState, eps, t) -> HestonExposureState:
        # Identical algebra to processes.heston.Heston.step (increment
        # grouping, double-where sqrt guard) + the left-point variance
        # accrual — the SAME v^+ dt the log-S drift consumes, so the
        # accrued leg is the scheme's own variance budget.
        dtype = state.log_s.dtype
        z1, z2 = eps[0], eps[1]
        rho = self.rho.astype(dtype)
        z_v = rho * z1 + jnp.sqrt(1.0 - jnp.square(rho)) * z2
        dt = self.dt.astype(dtype)
        v_plus = jnp.maximum(state.v, 0.0)
        positive = v_plus > 0
        v_safe = jnp.where(positive, v_plus, 1.0)
        sq_vdt = jnp.where(positive, jnp.sqrt(v_safe * dt), 0.0)
        log_s = (state.log_s
                 + ((self.mu.astype(dtype) - 0.5 * v_plus) * dt
                    + sq_vdt * z1))
        v = (state.v
             + self.kappa.astype(dtype)
             * (self.theta.astype(dtype) - v_plus) * dt
             + self.xi.astype(dtype) * sq_vdt * z_v)
        return HestonExposureState(log_s=log_s, v=v,
                                   ivar=state.ivar + v_plus * dt)

    def prices(self, state: HestonExposureState):
        return exp32(state.log_s)

    def log_prices(self, state):
        return state.log_s

    # --- exposure protocol -------------------------------------------
    def exposure_obs(self, state: HestonExposureState):
        """(n_paths, 3) observation: (S, v, accrued variance)."""
        return jnp.stack([exp32(state.log_s), state.v, state.ivar],
                         axis=-1)

    def wwr_state(self, obs):
        """The state the wrong-way intensity loads on: the VARIANCE —
        a vol desk's classic linkage (defaults cluster when vol spikes);
        `wwr_beta > 0` tilts default mass onto high-variance paths."""
        return obs[..., 1, :]

    def im_norm(self, dvs, obs, mpor):
        """Multivariate delta-normal IM std over the margin period:
        equity shock ``S sqrt(v^+) sqrt(mpor)`` (the LOCAL vol, not a
        constant — high-vol states post more margin), variance shock
        ``xi sqrt(v^+) sqrt(mpor)`` (CIR diffusion), folded with the
        instantaneous correlation rho.  The accrued-variance component
        carries no shock over the margin period (its increment is
        O(mpor) deterministic to leading order, like the hybrid's
        integral row)."""
        dtype = dvs.dtype
        m = jnp.asarray(mpor, dtype)
        v_plus = jnp.maximum(obs[..., 1, :], 0.0)
        sq_vm = jnp.sqrt(v_plus * m)
        a = dvs[..., 0, :] * obs[..., 0, :] * sq_vm
        b = dvs[..., 1, :] * jnp.asarray(self.xi, dtype) * sq_vm
        rho = jnp.asarray(self.rho, dtype)
        # grad_safe: v^+ == 0 states (and matured books' dv rows) zero
        # the quadratic form exactly — plain sqrt NaNs the greek jvp.
        return grad_safe_sqrt(a * a + b * b + 2.0 * rho * a * b)


def heston_forward_value_fn(model: HestonExposure, strike: float,
                            maturity: float, dtype=None):
    """Equity forward as a netting trade on the (3, N) state columns:
    ``S - K e^{-r (T - t)}`` with the model's flat rate (cite
    engine/exposure.py:43-95 for the closure contract)."""
    if dtype is None:
        dtype = jnp.result_type(model.xi)
    r = jnp.asarray(model.mu, dtype)
    k = jnp.asarray(strike, dtype)
    t_mat = jnp.asarray(maturity, dtype)

    def value(cols, t):
        tau = jnp.maximum(t_mat - jnp.asarray(t, dtype), 0.0)
        return cols[0] - k * jnp.exp(-r * tau)

    return value


def heston_varswap_expected_total(model: HestonExposure,
                                  maturity: float) -> float:
    """E[int_0^T v du] off the initial state — the par VARIANCE strike
    times T (host float, exact CIR expectation)."""
    import numpy as np

    v0 = float(model.v0)
    th = float(model.theta)
    kap = float(model.kappa)
    t = float(maturity)
    return (v0 - th) * (1.0 - np.exp(-kap * t)) / kap + th * t


def heston_varswap_value_fn(model: HestonExposure, strike_var: float,
                            maturity: float, *, notional: float = 1.0,
                            dtype=None):
    """Variance swap as a netting trade: pays ``N (RV_{0,T} - K)`` at T
    with ``RV`` the model's accrued variance over [0, T] divided by T.
    The mark at t is the affine closed form on (v, ivar) (module
    docstring); after T the exposure is zero (the payment settles).

    ``strike_var`` in VARIANCE units (e.g. 0.04 = 20% vol); the t=0 mark
    of the par strike (`heston_varswap_expected_total(model, T)/T`) is
    exactly zero — tested."""
    if dtype is None:
        dtype = jnp.result_type(model.xi)
    r = jnp.asarray(model.mu, dtype)
    kap = jnp.asarray(model.kappa, dtype)
    th = jnp.asarray(model.theta, dtype)
    k = jnp.asarray(strike_var, dtype)
    n = jnp.asarray(notional, dtype)
    t_mat = jnp.asarray(maturity, dtype)

    def value(cols, t):
        tau = jnp.maximum(t_mat - jnp.asarray(t, dtype), 0.0)
        alive = tau > 1e-9
        # E[int_t^T v du | v_t] — affine CIR conditional expectation.
        rem = (cols[1] - th) * (1.0 - jnp.exp(-kap * tau)) / kap \
            + th * tau
        total = (cols[2] + rem) / t_mat
        return jnp.where(alive,
                         n * jnp.exp(-r * tau) * (total - k),
                         jnp.zeros_like(cols[2]))

    return value


__all__ = ["HestonExposure", "HestonExposureState",
           "heston_forward_value_fn", "heston_varswap_expected_total",
           "heston_varswap_value_fn"]
