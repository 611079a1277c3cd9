#!/usr/bin/env python
"""End-to-end tour of the framework. Run: python examples/quickstart.py

Covers: option pricing with variance reduction, pathwise Greeks, exotics,
American exercise, the quant pipeline (features -> CV model -> Monte Carlo
-> backtest), sharded estimation, and streaming VaR with checkpointing.

Runs anywhere (CPU or GPU); pass --cpu to force the host backend.
"""

import os
import sys

import numpy as np

# Allow running straight from the repo checkout.
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

if "--cpu" in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")


def main():
    import jax.numpy as jnp

    from montecarlo import GBM, Heston, make_mesh
    from montecarlo.api import analyze_ticker, garch_monte_carlo, portfolio_var
    from montecarlo.config import ModelConfig
    from montecarlo.data import get_stock_data
    from montecarlo.engine import (
        ARITH_MEAN,
        asian_call,
        black_scholes_call,
        discount_factor,
        european_call,
        lsm_price,
        mc_estimate,
        price_and_greeks,
        simulate,
        simulate_functionals,
    )
    from montecarlo.samplers import AntitheticSampler

    print("== 1. European call: MC vs Black-Scholes ==")
    proc = GBM.create(s0=100.0, mu=0.03, sigma=0.2, dt=1 / 252)
    s_t = simulate(proc, 200_000, 252, seed=7, sampler=AntitheticSampler())
    est = mc_estimate(european_call(s_t, 105.0), discount_factor(0.03, 1.0))
    bs = float(black_scholes_call(100.0, 105.0, 0.03, 0.2, 1.0))
    print(f"   MC {float(est['price']):.4f} ± {float(est['std_err']):.4f}"
          f"  (Black-Scholes {bs:.4f})")

    print("== 2. Pathwise Greeks via autodiff ==")
    price, g = price_and_greeks(proc, lambda s: european_call(s, 105.0),
                                100_000, 252, seed=3,
                                discount=float(np.exp(-0.03)))
    print(f"   delta {float(g.s0):.4f}  vega {float(g.sigma):.3f}  "
          f"rho-like {float(g.mu):.3f}")

    print("== 3. Asian option (streaming path functional) ==")
    out = simulate_functionals(proc, 100_000, 252, seed=5,
                               functionals={"avg": ARITH_MEAN})
    asian = mc_estimate(asian_call(out["avg"], 100.0),
                        discount_factor(0.03, 1.0))
    print(f"   arithmetic Asian call: {float(asian['price']):.4f}")

    print("== 4. American put (Longstaff-Schwartz) ==")
    am = lsm_price(GBM.create(s0=36.0, mu=0.06, sigma=0.2, dt=1 / 50),
                   lambda s: jnp.maximum(40.0 - s, 0.0),
                   100_000, 50, seed=11, rate=0.06, dt=1 / 50, degree=3)
    print(f"   price {float(am['price']):.4f} ± {float(am['std_err']):.4f}")

    print("== 5. Heston stochastic vol ==")
    hest = Heston.create(s0=100.0, v0=0.04, mu=0.03, kappa=2.0, theta=0.04,
                         xi=0.5, rho=-0.7, dt=1 / 252)
    s_h = simulate(hest, 100_000, 252, seed=13)
    h_est = mc_estimate(european_call(s_h, 105.0),
                        discount_factor(0.03, 1.0))
    print(f"   Heston call: {float(h_est['price']):.4f}")

    print("== 6. Quant pipeline (reference-app parity) ==")
    analysis = analyze_ticker("NVDA", forecast_horizon=20, n_sims=1000,
                              model_config=ModelConfig.fast(),
                              provider="synthetic", period="3y")
    r = analysis["results"]
    mc = analysis["mc_results"]
    bt = analysis["backtest_results"]
    print(f"   dir. accuracy {r['directional_accuracy'] * 100:.1f}%  "
          f"signal {r['signal']}  MC VaR95 {mc['var_95']:.2f}%  "
          f"backtest Sharpe {bt['metrics']['sharpe_ratio']:.2f}")

    print("== 7. GARCH MC with fitted parameters ==")
    data = get_stock_data("NVDA", "3y", provider="synthetic")
    mc_fit = garch_monte_carlo(data, 2000, 20, float(data["Close"][-1]),
                               fit_params=True, seed=1)
    print(f"   p5 {mc_fit['percentiles']['p5']:.2f}  "
          f"p95 {mc_fit['percentiles']['p95']:.2f}  "
          f"CVaR95 {mc_fit['cvar_95']:.2f}%")

    print("== 8. Sharded + streaming VaR ==")
    import jax

    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev) if n_dev > 1 else None
    risk = portfolio_var(proc, 1 << 18, 20, 100.0, seed=2, bins=2048,
                         mesh=mesh, chunk_paths=1 << 16)
    print(f"   {risk['n_paths']:,} paths on {n_dev} device(s): "
          f"VaR95 {risk['var_95']:.2f}%  CVaR95 {risk['cvar_95']:.2f}%")


if __name__ == "__main__":
    main()
