"""Jittable semi-analytic Heston pricing and vol-surface calibration.

The characteristic-function (semi-analytic) Heston call price, evaluated
with fixed Gauss-Legendre quadrature so it jits, vmaps over whole
strike/maturity surfaces, and differentiates — which turns calibration into
plain gradient descent on device:

    params* = argmin sum_i (C_heston(K_i, T_i; params) - C_market_i)^2

('Little Heston trap' formulation, Albrecher et al. 2007 — matches the
adaptive-quadrature oracle in tests/oracles.py to ~1e-4.)
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class HestonParams(NamedTuple):
    v0: jnp.ndarray
    kappa: jnp.ndarray
    theta: jnp.ndarray
    xi: jnp.ndarray
    rho: jnp.ndarray


def _quad_nodes(n_quad: int, u_max: float):
    x, w = np.polynomial.legendre.leggauss(n_quad)
    u = 0.5 * u_max * (x + 1.0)
    w = 0.5 * u_max * w
    return jnp.asarray(u), jnp.asarray(w)


def _phi(u, j, T, r, s0, p: HestonParams):
    """Characteristic function of ln S_T (trap form); u is real."""
    iu = 1j * u
    a = p.kappa * p.theta
    b = jnp.where(j == 1, p.kappa - p.rho * p.xi, p.kappa)
    uu = jnp.where(j == 1, 0.5, -0.5)
    d = jnp.sqrt((p.rho * p.xi * iu - b) ** 2
                 - p.xi**2 * (2 * uu * iu - u**2))
    g = (b - p.rho * p.xi * iu + d) / (b - p.rho * p.xi * iu - d)
    big_g = 1.0 / g
    c = (r * iu * T + a / p.xi**2 * (
        (b - p.rho * p.xi * iu - d) * T
        - 2.0 * jnp.log((1 - big_g * jnp.exp(-d * T)) / (1 - big_g))))
    dd = ((b - p.rho * p.xi * iu - d) / p.xi**2
          * ((1 - jnp.exp(-d * T)) / (1 - big_g * jnp.exp(-d * T))))
    return jnp.exp(c + dd * p.v0 + iu * jnp.log(s0))


@partial(jax.jit, static_argnames=("n_quad",))
def heston_call_cf(s0, strike, T, r, params: HestonParams, *,
                   n_quad: int = 128, u_max: float = 200.0):
    """Semi-analytic Heston call price (scalar or broadcast batch of
    strike/T).  Gauss-Legendre on [0, u_max]."""
    u, w = _quad_nodes(n_quad, u_max)
    s0 = jnp.asarray(s0, jnp.float64 if jax.config.jax_enable_x64
                     else jnp.float32)
    strike, T = jnp.asarray(strike), jnp.asarray(T)
    lnk = jnp.log(strike)

    def p_j(j):
        def integrand(ui):
            val = (jnp.exp(-1j * ui * lnk)
                   * _phi(ui, j, T, r, s0, params) / (1j * ui))
            return jnp.real(val)
        vals = jax.vmap(integrand)(u)  # (n_quad, *batch)
        return 0.5 + jnp.tensordot(w, vals, axes=1) / jnp.pi

    return s0 * p_j(1) - strike * jnp.exp(-r * T) * p_j(2)


def _constrain(raw):
    return HestonParams(
        v0=jax.nn.softplus(raw[0]) * 0.04,
        kappa=jax.nn.softplus(raw[1]),
        theta=jax.nn.softplus(raw[2]) * 0.04,
        xi=jax.nn.softplus(raw[3]) * 0.5,
        rho=jnp.tanh(raw[4]),
    )


@partial(jax.jit, static_argnames=("n_iters", "n_quad"))
def _calibrate(strikes, maturities, prices, s0, r, raw0, n_iters: int,
               n_quad: int, lr: float):
    import optax

    def loss_fn(raw):
        p = _constrain(raw)
        model = heston_call_cf(s0, strikes, maturities, r, p, n_quad=n_quad)
        return jnp.mean(jnp.square(model - prices))

    opt = optax.adam(lr)
    grad_fn = jax.value_and_grad(loss_fn)

    def step(carry, _):
        raw, opt_state = carry
        loss, g = grad_fn(raw)
        updates, opt_state = opt.update(g, opt_state)
        return (optax.apply_updates(raw, updates), opt_state), loss

    (raw, _), losses = jax.lax.scan(step, (raw0, opt.init(raw0)), None,
                                    length=n_iters)
    return raw, losses


def calibrate_heston(strikes, maturities, prices, *, s0, r,
                     n_iters: int = 800, n_quad: int = 96,
                     lr: float = 0.05) -> HestonParams:
    """Fit Heston parameters to market call prices by Adam on the exact
    gradient of the semi-analytic pricer.  Returns constrained params."""
    raw0 = jnp.asarray([1.0, 0.5, 1.0, 1.0, 0.0], jnp.float32)
    raw, losses = _calibrate(jnp.asarray(strikes), jnp.asarray(maturities),
                             jnp.asarray(prices), s0, r, raw0, n_iters,
                             n_quad, lr)
    return jax.tree.map(float, _constrain(raw))


@partial(jax.jit, static_argnames=("n_iters", "n_quad"))
def _calibrate_iv(strikes, maturities, ivs, s0, r, raw0, n_iters: int,
                  n_quad: int, lr: float):
    import optax

    from montecarlo.engine.implied_vol import implied_vol_call

    lower = jnp.maximum(s0 - strikes * jnp.exp(-r * maturities), 0.0)

    def loss_fn(raw):
        p = _constrain(raw)
        model = heston_call_cf(s0, strikes, maturities, r, p, n_quad=n_quad)
        # Clamp into the no-arbitrage band so the inversion never NaNs
        # while the optimizer is far from the data.
        model = jnp.clip(model, lower + 1e-6, s0 * (1.0 - 1e-6))
        model_iv = implied_vol_call(model, s0, strikes, r, maturities)
        return jnp.mean(jnp.square(model_iv - ivs))

    opt = optax.adam(lr)
    grad_fn = jax.value_and_grad(loss_fn)

    def step(carry, _):
        raw, opt_state = carry
        loss, g = grad_fn(raw)
        updates, opt_state = opt.update(g, opt_state)
        return (optax.apply_updates(raw, updates), opt_state), loss

    (raw, _), losses = jax.lax.scan(step, (raw0, opt.init(raw0)), None,
                                    length=n_iters)
    return raw, losses


def calibrate_heston_to_ivs(strikes, maturities, ivs, *, s0, r,
                            n_iters: int = 800, n_quad: int = 96,
                            lr: float = 0.05) -> HestonParams:
    """Fit Heston parameters to a market **implied-vol** surface.

    The loss lives in IV space (differentiating through the vectorized
    Newton BS inversion of the model prices), which is how desks quote
    calibration quality: wings and short maturities get their natural
    weight instead of being drowned by deep-ITM dollar prices.
    """
    raw0 = jnp.asarray([1.0, 0.5, 1.0, 1.0, 0.0], jnp.float32)
    raw, losses = _calibrate_iv(jnp.asarray(strikes),
                                jnp.asarray(maturities), jnp.asarray(ivs),
                                s0, r, raw0, n_iters, n_quad, lr)
    return jax.tree.map(float, _constrain(raw))
