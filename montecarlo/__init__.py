"""montecarlo — a GPU-accelerated quantitative Monte Carlo framework.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of the reference
"Quantitative Trading System" (reference: /root/reference/app.py, a single-file
Streamlit app).  Design goals, in order:

1.  **Accelerator-first Monte Carlo engine** — counter-based (Threefry-2x32) RNG so every
    path is independently seedable and bitwise reproducible under any
    `jax.sharding.Mesh` shape; a fused Pallas path kernel (RNG -> transform ->
    SDE step) with no device-memory round-trip per time step; mergeable statistics
    (Welford mean/M2, quantile sketches) reduced in a shard-shape-invariant
    order.
2.  **Capability parity** with the reference app: ~60-column feature
    engineering (reference app.py:210-395), walk-forward cross-validated
    GBT forecasting (app.py:400-581), GARCH(1,1)-bootstrap Monte Carlo
    (app.py:586-657), walk-forward backtesting (app.py:662-882), and a
    multi-ticker scanner (app.py:1262-1532) — all returning result records
    with the same keys as the reference so parity checks are mechanical.

Subpackages
-----------
- ``rng``        counter-based RNG (Threefry-2x32, Box-Muller, Sobol)
- ``ops``        the fused path kernel (Pallas through Triton, GPU)
- ``processes``  SDE / stochastic process step functions (GBM, GARCH bootstrap,
                 correlated multi-asset GBM, Heston)
- ``engine``     the path-simulation engine (`lax.scan` reference engine and
                 the Pallas fast path) and payoffs
- ``stats``      mergeable accumulators: Welford, exact percentiles, quantile
                 sketch, VaR/CVaR
- ``parallel``   mesh construction and `shard_map`-sharded simulation
- ``samplers``   plain / antithetic / Sobol QMC draw providers
- ``quant``      feature engineering (the reference's ~60 columns) in JAX
- ``ml``         StandardScaler, TimeSeriesSplit, a JAX histogram-GBT
                 regressor, and the walk-forward-validated forecast model
- ``backtest``   walk-forward backtesting engine + risk metrics (single and
                 vmapped multi-ticker)
- ``data``       ticker universes, data fetching (gated), synthetic OHLCV,
                 native C++ CSV loader
- ``api``        single-ticker analysis, scanners (threaded and batched),
                 Monte Carlo and portfolio-VaR entry points
- ``models``     alias namespace re-exporting the market models + ML model
- ``native``     C++ sources for the runtime pieces (ctypes-bridged)
- ``utils``      profiling/tracing and timing helpers
"""

__version__ = "0.1.0"

from montecarlo.config import ModelConfig, TradingConfig  # noqa: F401

# Convenience top-level re-exports of the most-used entry points.
from montecarlo.processes import (  # noqa: F401
    GBM,
    GARCHBootstrap,
    Heston,
    MultiGBM,
)
from montecarlo.engine import (  # noqa: F401
    mc_estimate,
    price_to_tolerance,
    price_to_tolerance_rqmc,
    simulate,
    terminal_prices,
)
from montecarlo.parallel import make_mesh, sharded_mc_estimate  # noqa: F401
