"""Fixed-income pricing over the short-rate processes.

Monte Carlo bond / bond-option pricing under the bank-account numeraire,

    P(0, T)   = E[ exp(-int_0^T r_t dt) ]
    ZBC(T1,T2) = E[ exp(-int_0^T1 r_t dt) * max(P(T1, T2) - K, 0) ]

with the discount integral folded into the simulation scan (trapezoid
functional — O(paths) memory, no path materialization), validated against
the affine closed forms shipped here (Vasicek / CIR zero-coupon bonds,
Jamshidian's Vasicek bond-option formula).

The reference app has no fixed-income surface at all; this module extends
the rebuild's derivatives coverage to the rates asset class on the same
engine/sharding machinery.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from montecarlo.engine.functionals import (
    simulate_functionals,
    trapezoid_integral,
)
from montecarlo.engine.pricing import mc_estimate
from montecarlo.processes.shortrate import Vasicek


# --- affine closed forms (oracles and quoting) -------------------------------

def vasicek_zcb(r0, kappa, theta, sigma, T):
    """Vasicek zero-coupon bond price P(0, T) = A e^{-B r0}."""
    k, th, s = float(kappa), float(theta), float(sigma)
    B = (1.0 - math.exp(-k * T)) / k
    A = math.exp((th - s * s / (2.0 * k * k)) * (B - T)
                 - s * s * B * B / (4.0 * k))
    return A * math.exp(-B * float(r0))


def cir_zcb(r0, kappa, theta, sigma, T):
    """CIR zero-coupon bond price (Cox–Ingersoll–Ross 1985)."""
    k, th, s = float(kappa), float(theta), float(sigma)
    h = math.sqrt(k * k + 2.0 * s * s)
    ehT = math.exp(h * T)
    denom = 2.0 * h + (k + h) * (ehT - 1.0)
    A = (2.0 * h * math.exp((k + h) * T / 2.0) / denom) ** (
        2.0 * k * th / (s * s))
    B = 2.0 * (ehT - 1.0) / denom
    return A * math.exp(-B * float(r0))


def vasicek_bond_option(r0, kappa, theta, sigma, T1, T2, strike,
                        call: bool = True):
    """European option maturing T1 on a T2-bond — Jamshidian (1989)."""
    from math import erf, log, sqrt

    def ncdf(x):
        return 0.5 * (1.0 + erf(x / sqrt(2.0)))

    p1 = vasicek_zcb(r0, kappa, theta, sigma, T1)
    p2 = vasicek_zcb(r0, kappa, theta, sigma, T2)
    k = float(kappa)
    s = float(sigma)
    b = (1.0 - math.exp(-k * (T2 - T1))) / k
    sig_p = b * s * math.sqrt((1.0 - math.exp(-2.0 * k * T1)) / (2.0 * k))
    h = log(p2 / (float(strike) * p1)) / sig_p + 0.5 * sig_p
    if call:
        return p2 * ncdf(h) - float(strike) * p1 * ncdf(h - sig_p)
    return float(strike) * p1 * ncdf(sig_p - h) - p2 * ncdf(-h)


def vasicek_bond_from_rate(r, kappa, theta, sigma, tau):
    """P(t, t+tau) as an (affine, jnp-broadcasting) function of r_t."""
    k = jnp.asarray(kappa)
    th, s = jnp.asarray(theta), jnp.asarray(sigma)
    B = (1.0 - jnp.exp(-k * tau)) / k
    A = jnp.exp((th - s * s / (2.0 * k * k)) * (B - tau)
                - s * s * B * B / (4.0 * k))
    return A * jnp.exp(-B * r)


def vasicek_bond_option_from_rate(r, kappa, theta, sigma, tau1, tau2,
                                  strike, call: bool = True):
    """Jamshidian bond option valued AT time t from the short rate r_t —
    the jnp-broadcasting (and differentiable) twin of
    :func:`vasicek_bond_option`: ``tau1``/``tau2`` are the year fractions
    from the valuation date to the option expiry and the bond maturity.
    Time-homogeneity of Vasicek makes the t=0 formula reusable at any t.

    ``tau1 -> 0`` degenerates smoothly to the intrinsic value (sig_p is
    floored, h saturates the normal CDF), so exposure grids that include
    the expiry date itself need no special-casing.
    """
    import jax

    ncdf = jax.scipy.stats.norm.cdf
    p1 = vasicek_bond_from_rate(r, kappa, theta, sigma, tau1)
    p2 = vasicek_bond_from_rate(r, kappa, theta, sigma, tau2)
    k = jnp.asarray(kappa)
    s = jnp.asarray(sigma)
    b = (1.0 - jnp.exp(-k * (tau2 - tau1))) / k
    var = (1.0 - jnp.exp(-2.0 * k * jnp.maximum(tau1, 0.0))) / (2.0 * k)
    sig_p = jnp.maximum(b * s * jnp.sqrt(var), 1e-12)
    strike = jnp.asarray(strike)
    h = jnp.log(p2 / (strike * p1)) / sig_p + 0.5 * sig_p
    if call:
        return p2 * ncdf(h) - strike * p1 * ncdf(h - sig_p)
    return strike * p1 * ncdf(sig_p - h) - p2 * ncdf(-h)


def vasicek_cap_price(r0, kappa, theta, sigma, strike, reset_times,
                      pay_dt, *, floor: bool = False):
    """Cap (or floor) on the simple rate, closed form under Vasicek.

    Caplet i pays ``delta * (L(T_i, T_i + delta) - K)^+`` at
    ``T_i + delta``; the standard identity rewrites it as ``(1 + K delta)``
    zero-coupon-bond PUTS expiring at the reset, struck at
    ``1 / (1 + K delta)`` (floorlets are the CALLS).  ``reset_times`` is
    the (R,) array of caplet fixing dates; jnp-broadcasting and
    differentiable like the swaption pricer.  MC cross-checked
    (tests/test_rates.py style: pathwise-discounted caplet payoffs).
    """
    resets = jnp.asarray(reset_times)
    delta = jnp.asarray(pay_dt)
    kd = 1.0 + jnp.asarray(strike) * delta
    per = vasicek_bond_option_from_rate(
        jnp.asarray(r0), kappa, theta, sigma, resets, resets + delta,
        1.0 / kd, call=bool(floor))
    return jnp.sum(kd * per)


# --- Monte Carlo pricers ------------------------------------------------------

def zcb_price_mc(model, T: float, n_steps: int, n_paths: int, *, seed: int,
                 stream: int = 0, dtype=jnp.float32, path_offset=0) -> dict:
    """P(0, T) by simulation: mean of exp(-trapezoid int r dt).

    Works for any short-rate process under the standard protocol; the
    integral folds into the scan (O(paths) memory).
    """
    dt = T / n_steps
    out = simulate_functionals(
        model, n_paths, n_steps, seed=seed, stream=stream, dtype=dtype,
        path_offset=path_offset,
        functionals={"discount_integral": trapezoid_integral(dt)})
    return mc_estimate(jnp.exp(-out["discount_integral"]))


def bond_option_mc(model: Vasicek, T1: float, T2: float, strike: float,
                   n_steps: int, n_paths: int, *, seed: int,
                   call: bool = True, dtype=jnp.float32) -> dict:
    """Vasicek bond option by simulation to T1: the T2-bond at expiry is the
    affine function of r_{T1}, discounting is pathwise."""
    if not isinstance(model, Vasicek):
        raise TypeError("bond_option_mc prices under Vasicek (affine "
                        "P(T1,T2) as a function of r); got "
                        f"{type(model).__name__}")
    dt = T1 / n_steps
    out = simulate_functionals(
        model, n_paths, n_steps, seed=seed, dtype=dtype,
        functionals={"discount_integral": trapezoid_integral(dt)})
    p_t1_t2 = vasicek_bond_from_rate(out["terminal"], model.kappa,
                                     model.theta, model.sigma, T2 - T1)
    intrinsic = (jnp.maximum(p_t1_t2 - strike, 0.0) if call
                 else jnp.maximum(strike - p_t1_t2, 0.0))
    return mc_estimate(jnp.exp(-out["discount_integral"]) * intrinsic)


__all__ = [
    "vasicek_zcb", "cir_zcb", "vasicek_bond_option",
    "vasicek_bond_from_rate", "vasicek_bond_option_from_rate",
    "vasicek_cap_price", "zcb_price_mc", "bond_option_mc",
]
