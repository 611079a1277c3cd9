"""Bermudan swaptions under Vasicek: pathwise-discounted LSM.

Extends the equity LSM (:mod:`montecarlo.engine.american` — constant
discount rate, time-independent payoff) to the rates asset class, where
both are stochastic: the numeraire is the bank account (per-step discount
``exp(-(r_t + r_{t+1})/2 dt)`` along each path) and the exercise value at a
reset date is the remaining swap's value, affine in the short rate through
the Vasicek zero-coupon closed form.

    payer swap value at t_j = 1 - P(t_j, T_N) - K Delta sum_{i>j} P(t_j, T_i)

Backward induction regresses the (pathwise-discounted) continuation value
on a polynomial basis of r_t over ITM paths, exactly the Longstaff-Schwartz
recipe; everything is one jitted program with static shapes.

Validation: with a single exercise date the Bermudan *is* the European
payer swaption, priced in closed form by Jamshidian's (1989) decomposition
(:func:`vasicek_swaption_jamshidian`); more dates can only add value.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from montecarlo.engine.rates import vasicek_bond_from_rate, vasicek_zcb
from montecarlo.engine.precision import mm as _mm
from montecarlo.engine.simulate import simulate
from montecarlo.processes.shortrate import Vasicek


def _swap_value(r, model: Vasicek, taus, strike, delta):
    """Payer swap value at a reset date, remaining payments at ``taus``.

    ``taus``: (n_pay,) year fractions from the valuation date to each
    remaining payment; broadcasts over the path array ``r``.
    """
    p = vasicek_bond_from_rate(r[..., None], model.kappa, model.theta,
                               model.sigma, jnp.asarray(taus))
    float_leg = 1.0 - p[..., -1]
    fixed_leg = strike * delta * jnp.sum(p, axis=-1)
    return float_leg - fixed_leg


def _basis(x, degree: int):
    cols = [jnp.ones_like(x)]
    for _ in range(degree):
        cols.append(cols[-1] * x)
    return jnp.stack(cols, axis=-1)


@partial(jax.jit, static_argnames=("n_paths", "steps_per_period",
                                   "n_periods", "n_exercise", "seed",
                                   "degree", "dtype"))
def bermudan_swaption_lsm(model: Vasicek, strike: float, *, n_paths: int,
                          steps_per_period: int, n_periods: int,
                          n_exercise: int, seed: int, degree: int = 3,
                          dtype=jnp.float64) -> dict:
    """Bermudan payer swaption by LSM with pathwise discounting.

    The underlying swap pays at the ``n_periods`` period ends (period
    length ``delta = steps_per_period * model.dt``); exercise is allowed at
    the first ``n_exercise`` reset dates (period starts, the first at one
    period from today).  ``n_exercise=1`` is the European case.

    Returns ``{"price", "std_err", "n_paths"}``.
    """
    if not 1 <= n_exercise < n_periods:
        # Exercise at reset n_periods would enter a swap with no remaining
        # payments; past it the indices are nonsense (empty taus -> an
        # obscure IndexError deep inside jit).
        raise ValueError(
            f"n_exercise={n_exercise} must be in [1, n_periods-1]="
            f"[1, {n_periods - 1}]")
    dt = jnp.asarray(model.dt, dtype)
    delta = steps_per_period * dt
    n_steps = steps_per_period * (n_exercise)  # simulate to the last reset
    paths = simulate(model, n_paths, n_steps, seed=seed, mode="paths",
                     dtype=dtype)  # (n_steps+1, n_paths) short-rate paths

    # Pathwise discount factors to each reset date (trapezoid integral).
    mid = 0.5 * (paths[:-1] + paths[1:]) * dt
    cum = jnp.concatenate([jnp.zeros((1, n_paths), dtype),
                           jnp.cumsum(mid, axis=0)], axis=0)
    disc_to = jnp.exp(-cum)  # (n_steps+1, n_paths), row k = D(0, t_k)

    def exercise_value(j):
        """Swap value at reset j (1-based period index) on all paths."""
        step = j * steps_per_period
        r = paths[step]
        taus = (jnp.arange(1, n_periods - (j - 1) + 0, dtype=dtype)) * delta
        return r, _swap_value(r, model, taus, strike, delta), disc_to[step]

    # Backward induction over the exercise dates (a static python loop —
    # n_exercise is small; each iteration is fully vectorized over paths).
    r, ex, d = exercise_value(n_exercise)
    cash = jnp.maximum(ex, 0.0) * d  # discounted-to-0 cashflow
    for j in range(n_exercise - 1, 0, -1):
        r, ex, d = exercise_value(j)
        itm = ex > 0
        w = itm.astype(dtype)
        wsum = jnp.maximum(jnp.sum(w), 1.0)
        m = jnp.sum(w * r) / wsum
        sd = jnp.sqrt(jnp.sum(w * jnp.square(r - m)) / wsum + 1e-12)
        x = _basis((r - m) / sd, degree)
        xw = x * w[:, None]
        a = _mm(xw.T, x) / wsum + 1e-8 * jnp.eye(degree + 1, dtype=dtype)
        b = _mm(xw.T, cash / jnp.maximum(d, 1e-30)) / wsum
        beta = jnp.linalg.solve(a, b)
        continuation = _mm(x, beta)  # in t_j dollars
        take = itm & (ex >= continuation)
        cash = jnp.where(take, ex * d, cash)
    n = jnp.asarray(n_paths, dtype)
    return {
        "price": jnp.mean(cash),
        "std_err": jnp.std(cash, ddof=1) / jnp.sqrt(n),
        "n_paths": n_paths,
    }


def vasicek_swaption_jamshidian(model_params, strike: float, t0: float,
                                delta: float, n_periods: int,
                                r0: float) -> float:
    """European payer swaption in closed form (Jamshidian 1989).

    Exercise at ``t0`` into a payer swap with payments at
    ``t0 + delta, ..., t0 + n_periods*delta``.  Decomposition: find r* at
    which the coupon bond (fixed leg + final notional) is at par, then the
    swaption is a portfolio of zero-coupon bond *puts* struck at each
    bond's value under r*.
    """
    from scipy.optimize import brentq

    from montecarlo.engine.rates import vasicek_bond_option, vasicek_zcb

    kappa, theta, sigma = model_params
    times = t0 + delta * np.arange(1, n_periods + 1)
    coupons = np.full(n_periods, strike * delta)
    coupons[-1] += 1.0

    def p_t0(tau, r):
        # P(t0, t0+tau) seen from rate r — the affine closed form shared
        # with the bond pricer (one implementation, one oracle).
        return vasicek_zcb(r, kappa, theta, sigma, tau)

    def par_gap(r):
        return sum(c * p_t0(t - t0, r) for c, t in zip(coupons, times)) - 1.0

    r_star = brentq(par_gap, -2.0, 3.0, xtol=1e-14)
    total = 0.0
    for c, t in zip(coupons, times):
        k_i = p_t0(t - t0, r_star)
        total += c * vasicek_bond_option(r0, kappa, theta, sigma, t0, t,
                                         k_i, call=False)
    return total


@partial(jax.jit, static_argnames=("start_idx", "end_idx", "n_exercise",
                                   "n_paths", "seed", "degree", "dtype"))
def lmm_bermudan_swaption_lsm(model, strike: float, start_idx: int,
                              end_idx: int, *, n_exercise: int,
                              n_paths: int, seed: int, degree: int = 3,
                              dtype=jnp.float64) -> dict:
    """Bermudan payer swaption under the Libor Market Model by LSM.

    Exercise is allowed at resets ``start_idx .. start_idx+n_exercise-1``
    (each entering the REMAINING swap out to ``end_idx`` — the standard
    co-terminal Bermudan); the exercise value is the exact forward-curve
    closed form (`processes.lmm.lmm_swap_value_fn`, which masks to the
    live payments by itself), discounting is the EXACT discrete bank
    account, and the regression state is the remaining swap's par rate.

    ``n_exercise=1`` is the European case and reproduces
    `lmm_swaption_mc` at the same seed to reduction roundoff (same scan,
    same draws, bitwise-identical pathwise cashflows; only the closing
    mean compiles in a different program — tested at rtol 1e-12); more
    dates can only add value.
    """
    from montecarlo.processes.lmm import lmm_swap_value_fn

    k_fwd = int(model.sigma.shape[0])
    if not 1 <= start_idx < end_idx <= k_fwd:
        raise ValueError(f"need 1 <= start ({start_idx}) < end "
                         f"({end_idx}) <= K ({k_fwd})")
    if not 1 <= n_exercise <= end_idx - start_idx:
        raise ValueError(f"n_exercise={n_exercise} must be in "
                         f"[1, {end_idx - start_idx}]")
    dlt = jnp.asarray(model.delta, dtype)
    last_ex = start_idx + n_exercise - 1
    obs = simulate(model, n_paths, last_ex, seed=seed, mode="paths",
                   dtype=dtype,
                   observe=lambda p, s: p.exposure_obs(s))
    # (T+1, N, C) -> (T+1, C, N): the trade-closure layout.
    obs = jnp.moveaxis(obs, -1, 1)
    v_fn = lmm_swap_value_fn(model, strike, start_idx, end_idx,
                             dtype=dtype)

    def at(j):
        cols = obs[j]                                   # (C, N)
        ex = v_fn(cols, jnp.asarray(j, dtype) * dlt)
        d = jnp.exp(-cols[-1])                          # 1/B(T_j), exact
        # Remaining-swap par rate — the regression state.
        f = cols[:k_fwd]
        jj = jnp.arange(k_fwd)[:, None]
        dfac = jnp.where(jj >= j, 1.0 / (1.0 + dlt * f), 1.0)
        p = jnp.cumprod(dfac, axis=0)
        pay = (jj >= j) & (jj < end_idx)
        annuity = dlt * jnp.sum(jnp.where(pay, p, 0.0), axis=0)
        p_last = p[end_idx - 1]
        rate = (1.0 - p_last) / jnp.maximum(annuity, 1e-30)
        return rate, ex, d

    r, ex, d = at(last_ex)
    cash = jnp.maximum(ex, 0.0) * d
    for j in range(last_ex - 1, start_idx - 1, -1):
        r, ex, d = at(j)
        itm = ex > 0
        w = itm.astype(dtype)
        wsum = jnp.maximum(jnp.sum(w), 1.0)
        m = jnp.sum(w * r) / wsum
        sd = jnp.sqrt(jnp.sum(w * jnp.square(r - m)) / wsum + 1e-12)
        x = _basis((r - m) / sd, degree)
        xw = x * w[:, None]
        a = _mm(xw.T, x) / wsum + 1e-8 * jnp.eye(degree + 1, dtype=dtype)
        b = _mm(xw.T, cash / jnp.maximum(d, 1e-30)) / wsum
        beta = jnp.linalg.solve(a, b)
        continuation = _mm(x, beta)
        take = itm & (ex >= continuation)
        cash = jnp.where(take, ex * d, cash)
    n = jnp.asarray(n_paths, dtype)
    return {"price": jnp.mean(cash),
            "std_err": jnp.std(cash, ddof=1) / jnp.sqrt(n),
            "n_paths": n_paths}


__all__ = ["bermudan_swaption_lsm", "lmm_bermudan_swaption_lsm",
           "vasicek_swaption_jamshidian"]
