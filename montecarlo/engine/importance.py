"""Importance sampling for GBM — drift shift with exact likelihood weights.

Deep out-of-the-money payoffs starve plain MC (almost every path pays zero).
Sampling under a drift-shifted measure pushes paths into the payoff region;
the estimator reweights each path by the Radon-Nikodym derivative.  For GBM
the per-path weight is an exact function of the terminal price alone:

    sample under  mu' = mu + c * sigma / sqrt(dt)   (z -> z + c per step)
    weight(S_T) = exp(-c * Z + T_steps * c^2 / 2),
    Z = (ln(S_T/S0) - T_steps*(mu' - sigma^2/2)*dt) / (sigma*sqrt(dt))

so the fused Pallas kernel runs unmodified under the shifted process and the
weighting happens on the terminal array.  `optimal-ish` shift: aim the
terminal median at the strike (``shift_to_strike``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from montecarlo.engine.dispatch import terminal_prices
from montecarlo.processes.gbm import GBM
from montecarlo.stats.welford import moments_from_array, std_error


def shift_to_strike(process: GBM, strike, n_steps: int):
    """Per-step shift c that moves the terminal *median* onto the strike."""
    t_total = process.dt * n_steps
    drift_med = (process.mu - 0.5 * jnp.square(process.sigma)) * t_total
    gap = jnp.log(jnp.asarray(strike, jnp.float32) / process.s0) - drift_med
    # gap = c * sigma * sqrt(dt) * n_steps
    return gap / (process.sigma * jnp.sqrt(process.dt) * n_steps)


@partial(jax.jit, static_argnames=("payoff_fn", "n_paths", "seed",
                                   "n_replicates", "dtype"))
def stratified_terminal_estimate(process: GBM, payoff_fn, n_paths: int, *,
                                 seed: int, t_years, discount=1.0,
                                 n_replicates: int = 16,
                                 dtype=jnp.float32):
    """Stratified sampling of the terminal GBM distribution.

    For European payoffs GBM's terminal law is known in closed form, so the
    single stratification variable is the terminal normal: stratum i draws
    u_i = (i + v_i)/N (v_i a counter-based uniform), z = ndtri(u),
    S_T = S0 exp((mu - sigma^2/2) T + sigma sqrt(T) z).  Every stratum is
    hit exactly once — the N^(-1) 'jittered grid' that dominates plain MC
    for any monotone-ish payoff.

    The standard error comes from ``n_replicates`` interleaved replications
    (per-stratum variance is not estimable with one draw per stratum).
    Returns {"price", "std_err", "n_paths"}.
    """
    from jax.scipy.special import ndtri

    from montecarlo.rng.normal import uniform_draw

    if n_paths % n_replicates:
        raise ValueError(
            f"n_paths={n_paths} must be divisible by "
            f"n_replicates={n_replicates} (interleaved replication)")
    if n_paths > 1 << 24 and dtype == jnp.float32:
        # ids.astype(f32) rounds odd ids past 2^24 — strata would be
        # double-covered/skipped and the estimator silently biased.
        raise ValueError(
            "stratification beyond 2^24 paths needs dtype=float64 "
            "(float32 cannot index the strata exactly)")
    ids = jnp.arange(n_paths, dtype=jnp.uint32)
    v = uniform_draw(seed, 0x5742, ids, jnp.uint32(0), dtype)
    u = (ids.astype(dtype) + v) / n_paths
    z = ndtri(jnp.clip(u, 1e-7, 1.0 - 1e-7)).astype(dtype)
    t = jnp.asarray(t_years, dtype)
    s_t = process.s0.astype(dtype) * jnp.exp(
        (process.mu - 0.5 * jnp.square(process.sigma)).astype(dtype) * t
        + process.sigma.astype(dtype) * jnp.sqrt(t) * z)
    vals = payoff_fn(s_t) * jnp.asarray(discount, dtype)
    price = jnp.mean(vals)
    # Interleaved replications: strata i mod K form replicate k.
    reps = vals.reshape(n_paths // n_replicates, n_replicates)
    rep_means = jnp.mean(reps, axis=0)
    se = jnp.std(rep_means, ddof=1) / jnp.sqrt(jnp.asarray(n_replicates,
                                                           dtype))
    return {"price": price, "std_err": se, "n_paths": n_paths}


@partial(jax.jit, static_argnames=("payoff_fn", "n_paths", "n_steps",
                                   "seed", "stream", "dtype"))
def importance_sampled_estimate(process: GBM, payoff_fn, n_paths: int,
                                n_steps: int, *, seed: int, shift,
                                discount=1.0, stream: int = 0,
                                dtype=jnp.float32):
    """IS estimator: simulate the drift-shifted GBM (fused kernel eligible),
    reweight, return {"price", "std_err", "n_paths", "ess"}.

    ``ess`` is the effective sample size (sum w)^2 / sum w^2 — a health
    check for the chosen shift.
    """
    c = jnp.asarray(shift, dtype)
    sigma = process.sigma.astype(dtype)
    sq_dt = jnp.sqrt(process.dt).astype(dtype)
    # Shifting every z by c adds c*sigma*sqrt(dt) per log-step: mu' = mu + c*sigma/sqrt(dt).
    shifted = GBM(s0=process.s0, mu=process.mu + c * sigma / sq_dt,
                  sigma=process.sigma, dt=process.dt)
    terminal = terminal_prices(shifted, n_paths, n_steps, seed=seed,
                               stream=stream, dtype=dtype)
    t_steps = jnp.asarray(n_steps, dtype)
    drift_s = (shifted.mu - 0.5 * jnp.square(shifted.sigma)) * shifted.dt
    z_total = ((jnp.log(terminal / process.s0) - t_steps * drift_s)
               / (sigma * sq_dt))
    # Per-step RN derivative exp(-c z' + c^2/2) with z' the raw shifted
    # draw; z_total above is centered under the *shifted* drift
    # (z_total = sum z' - T c), so the product over steps is
    # exp(-c (z_total + T c) + T c^2/2) = exp(-c z_total - T c^2/2):
    log_w = -c * z_total - 0.5 * t_steps * jnp.square(c)
    w = jnp.exp(log_w)
    vals = payoff_fn(terminal) * w
    st = moments_from_array(vals, axis=0)
    d = jnp.asarray(discount, dtype)
    ess = jnp.square(jnp.sum(w)) / jnp.maximum(jnp.sum(jnp.square(w)), 1e-30)
    return {
        "price": d * st.mean,
        "std_err": d * std_error(st),
        "n_paths": n_paths,
        "ess": ess,
    }
