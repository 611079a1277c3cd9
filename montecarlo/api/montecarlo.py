"""The reference's Monte Carlo entry point (app.py:586-657), on device.

``garch_monte_carlo(data, n_sims, n_days, current_price)`` takes the feature
dict (needs ``log_ret`` and ``rvol_20``), runs the bootstrap-GARCH(1,1)
simulation, and returns a dict with exactly the reference's keys:
``paths``, ``final_prices``, ``percentiles`` (p1..p99),
``path_percentiles`` (p5..p95 curves), ``expected_return``, ``expected_vol``,
``prob_profit``, ``var_95``, ``cvar_95``.

Differences (all upgrades, distribution unchanged):
- seeded counter-based RNG -> reproducible, shard-invariant (the reference
  uses the unseeded global NumPy RNG, app.py:620);
- runs jitted on the accelerator; terminal mode rides the fused path
  kernel on the GPU.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from montecarlo.engine.dispatch import terminal_prices
from montecarlo.engine.simulate import simulate
from montecarlo.processes.garch import GARCHBootstrap, MIN_HISTORY
from montecarlo.stats.risk import path_percentiles, terminal_statistics

# Module-level jit wrappers: constructing jax.jit(...) inside each call
# would discard the compiled cache and retrace per invocation.
_terminal_statistics_jit = jax.jit(terminal_statistics)
_path_percentiles_jit = jax.jit(path_percentiles)


def garch_monte_carlo(data: Dict[str, np.ndarray], n_sims: int, n_days: int,
                      current_price: float, progress_callback=None,
                      seed: int = 0, dtype=jnp.float32,
                      keep_paths: bool = True,
                      fit_params: bool = False,
                      antithetic: bool = False) -> Optional[Dict]:
    """Bootstrap-GARCH Monte Carlo with the reference's result contract.

    Returns None when fewer than 100 return observations exist
    (app.py:594-595).  ``keep_paths=False`` skips materializing the full
    path array (terminal statistics only) for large ``n_sims``.
    ``fit_params=True`` replaces the reference's hardcoded omega/alpha/beta
    (app.py:601-603) with a Gaussian-QMLE fit to the return history
    (processes/garch_fit.py).  ``antithetic=True`` mirrors the bootstrap
    uniforms (u -> 1-u over the sorted shock table — sound for skewed
    empirical tables, see processes/garch.py): tighter bands at the same
    ``n_sims`` (requires even ``n_sims``).
    """
    returns = np.asarray(data["log_ret"], np.float64)
    returns = returns[~np.isnan(returns)]
    if len(returns) < MIN_HISTORY:
        return None
    if progress_callback:
        progress_callback("Running Monte Carlo simulation...")

    var0 = float(np.asarray(data["rvol_20"])[-1]) ** 2 / 252.0
    if not np.isfinite(var0):
        return None  # graceful-degradation contract: never emit NaN risk
    garch_kw = {}
    if fit_params:
        from montecarlo.processes.garch_fit import fit_garch

        est = fit_garch(returns)
        garch_kw = dict(omega=est.omega, alpha=est.alpha, beta=est.beta)
    proc = GARCHBootstrap.create(returns, s0=current_price, var0=var0,
                                 dtype=dtype, **garch_kw)

    sampler = None
    if antithetic:
        from montecarlo.samplers import AntitheticSampler

        if n_sims % 2:
            raise ValueError("antithetic pairing needs an even n_sims")
        sampler = AntitheticSampler()
    if keep_paths:
        paths = simulate(proc, n_sims, n_days, seed=seed, mode="paths",
                         sampler=sampler, dtype=dtype)
        final_prices = paths[-1]
    else:
        # No (n_days+1, n_sims) materialization: terminal prices from the
        # fused kernel, percentile *curves* from streaming per-step
        # histogram sketches (O(steps x bins) memory at any path count).
        paths = None
        final_prices = terminal_prices(proc, n_sims, n_days, seed=seed,
                                       sampler=sampler, dtype=dtype)

    stats = _terminal_statistics_jit(final_prices,
                                     jnp.asarray(current_price))
    out = {k: (np.asarray(v) if hasattr(v, "shape") else v)
           for k, v in stats.items()}
    out["percentiles"] = {k: float(v) for k, v in out["percentiles"].items()}
    for k in ("expected_return", "expected_vol", "prob_profit", "var_95",
              "cvar_95"):
        out[k] = float(out[k])
    out["final_prices"] = np.asarray(final_prices)
    if keep_paths:
        out["paths"] = np.asarray(paths)
        out["path_percentiles"] = {
            k: np.asarray(v)
            for k, v in _path_percentiles_jit(paths).items()}
    else:
        from montecarlo.engine.path_sketch import (
            path_histograms,
            percentiles_from_histograms,
        )

        fp = np.asarray(final_prices)
        span = float(fp.max() - fp.min()) + 1e-6
        lo = min(float(fp.min()), current_price) - 0.25 * span
        hi = max(float(fp.max()), current_price) + 0.25 * span
        hists = path_histograms(proc, n_sims, n_days, seed=seed, lo=lo,
                                hi=hi, bins=2048, dtype=dtype)
        out["path_percentiles"] = percentiles_from_histograms(
            np.asarray(hists), lo, hi)
    return out
