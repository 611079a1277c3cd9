"""Risk metrics over terminal Monte Carlo prices — reference formula parity.

Implements exactly the statistics the reference's Monte Carlo returns
(reference app.py:636-657): terminal percentiles p1..p99, expected
return/vol, probability of profit, VaR95 and CVaR95 — same definitions,
same percentile interpolation, same units (percent).
"""

from __future__ import annotations

import jax.numpy as jnp

from montecarlo.stats.quantiles import percentile_linear

#: Terminal-price percentile levels the reference reports (app.py:639).
TERMINAL_PERCENTILES = (1, 5, 10, 25, 50, 75, 90, 95, 99)
#: Per-time-step path percentile levels (app.py:644).
PATH_PERCENTILES = (5, 25, 50, 75, 95)


def terminal_statistics(final_prices, current_price):
    """The reference's MC result statistics (app.py:647-657).

    Args:
      final_prices: (n_paths,) terminal prices.
      current_price: spot.

    Returns a dict with the reference's keys: ``percentiles`` (p1..p99),
    ``expected_return``, ``expected_vol``, ``prob_profit``, ``var_95``,
    ``cvar_95`` — all in percent, as the reference reports them.
    """
    final_prices = jnp.asarray(final_prices)
    s0 = jnp.asarray(current_price, final_prices.dtype)

    qs = percentile_linear(final_prices, jnp.asarray(TERMINAL_PERCENTILES,
                                                     final_prices.dtype))
    percentiles = {f"p{p}": qs[i] for i, p in enumerate(TERMINAL_PERCENTILES)}

    p5 = percentiles["p5"]
    tail_mask = final_prices <= p5
    tail_count = jnp.maximum(jnp.sum(tail_mask), 1)
    tail_mean = jnp.sum(jnp.where(tail_mask, final_prices, 0.0)) / tail_count

    return {
        "percentiles": percentiles,
        "expected_return": (jnp.mean(final_prices) / s0 - 1.0) * 100.0,
        "expected_vol": jnp.std(final_prices) / s0 * 100.0,
        "prob_profit": jnp.mean((final_prices > s0).astype(final_prices.dtype))
        * 100.0,
        "var_95": (s0 - p5) / s0 * 100.0,
        "cvar_95": (s0 - tail_mean) / s0 * 100.0,
    }


def path_percentiles(paths):
    """Per-time-step percentile curves p5/25/50/75/95 (app.py:643-645).

    Args:
      paths: (n_steps + 1, n_paths) price paths, row 0 = spot.

    Returns dict ``{"p5": (n_steps+1,), ...}``.
    """
    paths = jnp.asarray(paths)
    qs = percentile_linear(paths, jnp.asarray(PATH_PERCENTILES, paths.dtype),
                           axis=1)
    return {f"p{p}": qs[i] for i, p in enumerate(PATH_PERCENTILES)}
