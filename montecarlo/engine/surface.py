"""Model-implied volatility surfaces from one Monte Carlo run.

``price_snapshot`` latches the price at a fixed step inside the simulation
fold, so a SINGLE run (one fused kernel on the GPU) yields the terminal prices
of *every* maturity on the grid — no per-maturity re-simulation, paths
never materialize.  European calls across the (strike, maturity) grid then
invert through the vectorized BS Newton solver:

    surface = mc_implied_vol_surface(proc, strikes, step_grid, dt, rate=...)

The reference has nothing like this; it is the standard desk artifact for
eyeballing a model's smile/term structure against the market (and the
generic counterpart of the Heston/SABR calibration oracles).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from montecarlo.engine.functionals import (PathFunctional,
                                               simulate_functionals)
from montecarlo.engine.implied_vol import implied_vol_call


def price_snapshot(step: int) -> PathFunctional:
    """Latch the price observed at step ``step`` (1-based; spot = 0 is the
    init value).  Composes with the fused functional kernel like any other
    PathFunctional, so K maturities ride one time loop."""
    if step == 0:
        return PathFunctional(init=lambda s: s,
                              update=lambda acc, s, t: acc,
                              finalize=lambda acc, n_steps: acc)
    return PathFunctional(
        init=lambda s: jnp.zeros_like(s),
        update=lambda acc, s, t: jnp.where(t == step, s, acc),
        finalize=lambda acc, n_steps: acc,
    )


@jax.jit
def _grid_prices(terms, discs, ks):
    """Discounted call prices for every (maturity, strike) cell — module-
    level jit so repeated surfaces reuse the compiled program."""
    pay = jnp.maximum(terms[:, :, None] - ks[None, None, :], 0.0)
    return discs[:, None] * jnp.mean(pay, axis=1)  # (T, K)


def mc_implied_vol_surface(process, strikes, step_grid, dt: float, *,
                           rate: float, n_paths: int = 1 << 17,
                           seed: int = 0, s0=None, **sim_kw) -> dict:
    """Black-Scholes implied-vol surface of a process's European calls.

    Args:
      strikes: (K,) strike grid.
      step_grid: increasing step indices (each <= n_steps); maturity of
        entry j is ``step_grid[j] * dt`` years.
      rate: continuous discount rate (also the BS inversion's carry).
      s0: spot for the BS inversion (default ``float(process.s0)``).

    Returns ``{"ivs" (T, K), "prices" (T, K), "maturities" (T,),
    "strikes" (K,)}`` — NaN where a price falls outside the no-arbitrage
    band (e.g. MC noise on far wings).
    """
    steps = [int(s) for s in step_grid]
    if any(b <= a for a, b in zip(steps, steps[1:])) or steps[0] < 1:
        raise ValueError("step_grid must be strictly increasing and >= 1")
    n_steps = steps[-1]
    funcs = {f"m{j}": price_snapshot(s) for j, s in enumerate(steps)}
    out = simulate_functionals(process, n_paths, n_steps, seed=seed,
                               functionals=funcs, **sim_kw)

    spot = float(process.s0) if s0 is None else float(s0)
    strikes = np.asarray(strikes, np.float64)
    mats = np.asarray(steps, np.float64) * float(dt)
    # One device program for the whole grid (no per-maturity host
    # dispatch): stack the
    # snapshots, price every (T, K) cell, and invert in the same call.
    terms = jnp.stack([out[f"m{j}"] if s != n_steps else out["terminal"]
                       for j, s in enumerate(steps)])        # (T, N)
    discs = jnp.exp(-rate * jnp.asarray(mats, terms.dtype))  # (T,)
    ks = jnp.asarray(strikes, terms.dtype)
    prices = np.asarray(_grid_prices(terms, discs, ks), np.float64)
    ivs = np.asarray(implied_vol_call(
        jnp.asarray(prices), spot, jnp.asarray(strikes)[None, :],
        rate, jnp.asarray(mats)[:, None]))
    return {"ivs": ivs, "prices": prices, "maturities": mats,
            "strikes": strikes}
