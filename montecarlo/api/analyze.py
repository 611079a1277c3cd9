"""Single-ticker deep-dive pipeline — the reference's 'Single Stock' mode
(app.py:1182-1257): fetch -> train -> Monte Carlo -> backtest, with the
None-sentinel graceful degradation at every stage."""

from __future__ import annotations

from typing import Dict, Optional

from montecarlo.api.montecarlo import garch_monte_carlo
from montecarlo.backtest import WalkForwardBacktester
from montecarlo.config import ModelConfig, TradingConfig
from montecarlo.data.fetch import get_stock_data
from montecarlo.ml.model import ForecastModel


def analyze_ticker(ticker: str, *, forecast_horizon: int = 20,
                   n_sims: int = 1000, run_backtest: bool = True,
                   retrain_frequency: int = 60, period: str = "5y",
                   model_config: Optional[ModelConfig] = None,
                   trading_config: Optional[TradingConfig] = None,
                   provider: Optional[str] = None,
                   seed: int = 0, fit_garch_params: bool = False,
                   progress_callback=None) -> Optional[Dict]:
    """Full analysis for one ticker.

    Returns ``{"ticker", "data", "model", "results", "mc_results",
    "backtest_results"}`` or None when data/training fails — mirroring the
    reference pipeline's stages and defaults (horizon 20, 1000 sims,
    retrain every 60 days, 5y history; app.py:1186-1257).
    """
    cb = progress_callback or (lambda msg: None)
    model_config = model_config or ModelConfig()
    trading_config = trading_config or TradingConfig()

    cb(f"Fetching data for {ticker}...")
    data = get_stock_data(ticker, period, provider=provider)
    if data is None:
        return None

    cb("Training model...")
    model = ForecastModel(forecast_horizon=forecast_horizon,
                          config=model_config)
    results = model.train(data, cb)
    if results is None:
        return None

    cb("Running Monte Carlo simulation...")
    mc = garch_monte_carlo(data, n_sims, forecast_horizon,
                           results["current_price"], cb, seed=seed,
                           fit_params=fit_garch_params)

    bt = None
    if run_backtest:
        cb("Running backtest...")
        bt = WalkForwardBacktester(trading_config, model_config).run(
            data, forecast_horizon, retrain_frequency, cb)

    return {
        "ticker": ticker,
        "data": data,
        "model": model,
        "results": results,
        "mc_results": mc,
        "backtest_results": bt,
    }
