"""Batched multi-ticker backtesting — whole portfolios on device at once.

The reference backtests one ticker at a time (its scanner doesn't backtest
at all).  Here a universe backtests as a few vmapped device programs:

1. group tickers by sample length (static shapes);
2. ONE vmapped masked-GBT program trains every retrain window of every
   ticker — (tickers x retrains) fits in a single XLA computation;
3. the daily trade loop runs as a vmapped `lax.scan` over the ticker axis;
4. per-ticker trade logs/metrics assemble host-side via the same
   `assemble_results` as the single-ticker engine — identical semantics
   (differentially tested).
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from montecarlo.backtest.engine import _trade_scan, assemble_results
from montecarlo.config import ModelConfig, TradingConfig
from montecarlo.ml.model import ForecastModel, _fit_folds, _gbt_cfg, make_target

_fit_folds_tickers = jax.jit(
    jax.vmap(_fit_folds, in_axes=(0, 0, 0, None)),
    static_argnames=("cfg",))

_trade_scan_tickers = jax.jit(
    jax.vmap(_trade_scan, in_axes=(0, 0, None)),
    static_argnames=("trading",))


def backtest_tickers_batched(
        data_by_ticker: Dict[str, dict], forecast_horizon: int = 20,
        retrain_frequency: int = 60,
        trading_config: Optional[TradingConfig] = None,
        model_config: Optional[ModelConfig] = None,
        progress_callback=None) -> Dict[str, Optional[dict]]:
    """Walk-forward backtests for a whole universe.

    Args:
      data_by_ticker: ticker -> featurized data dict (`get_stock_data`).

    Returns ticker -> the single-ticker result dict (or None per the usual
    insufficient-data guards).
    """
    trading_config = trading_config or TradingConfig()
    model_config = model_config or ModelConfig()

    prepared = {}
    results: Dict[str, Optional[dict]] = {}
    for ticker, data in data_by_ticker.items():
        target = make_target(data["log_ret"], forecast_horizon)
        ok = ~np.isnan(target)
        n = int(ok.sum())
        train_end = int(n * 0.6)
        if n < model_config.min_data_points or train_end < 252:
            results[ticker] = None
            continue
        feats = [f for f in ForecastModel.FEATURE_COLS if f in data]
        x = np.stack([np.asarray(data[f], np.float64)[ok] for f in feats],
                     axis=1)
        prepared.setdefault(n, []).append((
            ticker, x, target[ok],
            np.asarray(data["Close"], np.float64)[ok],
            np.asarray(data["rvol_20"], np.float64)[ok],
        ))

    done = 0
    total = len(data_by_ticker)
    for n, group in sorted(prepared.items()):
        tickers = [g[0] for g in group]
        x = jnp.asarray(np.stack([g[1] for g in group]), jnp.float32)
        y = jnp.asarray(np.stack([g[2] for g in group]), jnp.float32)
        close = np.stack([g[3] for g in group])
        rvol = np.stack([g[4] for g in group])

        train_end = int(n * 0.6)
        retrain_points = list(range(train_end, n, retrain_frequency))
        idx = np.arange(n)
        masks = np.stack([(idx < r).astype(np.float32)
                          for r in retrain_points])  # (K, n)
        masks_b = jnp.asarray(np.broadcast_to(
            masks, (len(group),) + masks.shape))
        cfg = _gbt_cfg(model_config, regularized=False)
        preds_all = np.asarray(_fit_folds_tickers(x, y, masks_b, cfg))

        test_days = np.arange(train_end, n)
        model_of_day = (test_days - train_end) // retrain_frequency
        preds = preds_all[:, model_of_day, test_days]  # (B, n_test)

        thresh = (rvol[:, test_days] / np.sqrt(252.0)
                  * np.sqrt(float(forecast_horizon)) * 0.5)
        signals = np.where(preds > thresh, 1,
                           np.where(preds < -thresh, -1, 0)).astype(np.int32)

        outs = _trade_scan_tickers(
            jnp.asarray(close[:, test_days], jnp.float32),
            jnp.asarray(signals), trading_config)
        outs_np = [np.asarray(o) for o in outs]

        for b, ticker in enumerate(tickers):
            per = tuple(o[b] for o in outs_np)
            results[ticker] = assemble_results(per, test_days,
                                               trading_config)
            done += 1
            if progress_callback:
                progress_callback(done, total, results)
    return results
