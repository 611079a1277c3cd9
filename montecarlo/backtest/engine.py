"""Walk-forward backtesting engine — reference parity (app.py:662-882).

Behavioral contract (identical to the reference):

- target = forward cumulative log return over the horizon (app.py:681);
- 60/40 train/test split, >= min_data_points rows, >= 252 train days
  (app.py:684-694);
- the model retrains every ``retrain_frequency`` days on *all* data up to
  the current day (app.py:723-744) — the backtest GBT omits the CV model's
  reg_alpha (XGBoost default alpha=0, app.py:732-743);
- vol-adjusted signal threshold `rvol_20/sqrt(252)*sqrt(h)*0.5`
  (app.py:752-753), long/short/flat;
- position changes close-then-open with slippage on both sides, commission
  x2 on close, sizing = max_position_pct * current capital (app.py:768-803);
- the full risk-metric suite with the reference's exact formulas
  (app.py:815-858).

Differences from the reference:
- all K retrains fit as ONE vmapped JAX histogram-GBT program (masked
  weights; the reference loops XGBoost sequentially);
- the daily event loop is a `lax.scan` (vmap-able over tickers).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from montecarlo.config import ModelConfig, TradingConfig
from montecarlo.ml.model import _fit_folds, _gbt_cfg, prepare_matrix


@partial(jax.jit, static_argnames=("trading",))
def _trade_scan(prices, signals, trading: TradingConfig):
    """The daily trade loop (app.py:715-813) as a scan.

    Returns per-day arrays: equity, returns, positions, plus trade-close
    records (flag, direction, entry/exit prices, trade return, pnl,
    entry day index).
    """
    slip = jnp.float32(trading.slippage_pct)
    comm = jnp.float32(trading.commission_pct)
    max_pos = jnp.float32(trading.max_position_pct)

    def step(carry, inp):
        position, entry_price, entry_day, capital, peak = carry
        price, signal, day = inp

        change = signal != position
        closes = change & (position != 0)
        pos_sign = jnp.sign(position).astype(jnp.float32)
        exit_price = price * (1.0 - slip * pos_sign)
        safe_entry = jnp.where(entry_price > 0, entry_price, 1.0)
        tr_long = (exit_price - safe_entry) / safe_entry
        tr_short = (safe_entry - exit_price) / safe_entry
        trade_ret = jnp.where(position == 1, tr_long, tr_short) - comm * 2.0
        daily_pnl = jnp.where(closes, trade_ret * max_pos * capital, 0.0)

        opens = change & (signal != 0)
        new_entry = jnp.where(opens,
                              price * (1.0 + slip * jnp.sign(signal)
                                       .astype(jnp.float32)),
                              entry_price)
        new_entry_day = jnp.where(opens, day, entry_day)
        new_position = jnp.where(change, signal, position)

        new_capital = capital + daily_pnl
        ret = daily_pnl / jnp.where(capital > 0, capital, 1.0)
        new_peak = jnp.maximum(peak, new_capital)

        out = (new_capital, ret, new_position, closes, position,
               entry_price, exit_price, trade_ret, daily_pnl, entry_day)
        return ((new_position, new_entry, new_entry_day, new_capital,
                 new_peak), out)

    init = (jnp.int32(0), jnp.float32(0.0), jnp.int32(0),
            jnp.float32(trading.initial_capital),
            jnp.float32(trading.initial_capital))
    days = jnp.arange(prices.shape[0], dtype=jnp.int32)
    _, outs = jax.lax.scan(step, init,
                           (prices.astype(jnp.float32),
                            signals.astype(jnp.int32), days))
    return outs


class WalkForwardBacktester:
    """Walk-forward backtest with periodic retraining."""

    def __init__(self, config: TradingConfig, model_config: ModelConfig):
        self.config = config
        self.model_config = model_config

    def run(self, data: Dict[str, np.ndarray], forecast_horizon: int,
            retrain_frequency: int = 60,
            progress_callback=None) -> Optional[Dict]:
        # One preparation path with the model (ml.model.prepare_matrix):
        # the backtest must trade on exactly the matrix the CV gate scored.
        x, y, feats, extras = prepare_matrix(
            data, forecast_horizon, extra_keys=("Close", "rvol_20", "Date"))
        n = len(y)
        if n < self.model_config.min_data_points:
            return None
        close = np.asarray(extras["Close"], np.float64)
        rvol20 = np.asarray(extras["rvol_20"], np.float64)
        dates = extras.get("Date", np.arange(n))

        train_end = int(n * 0.6)
        if train_end < 252:
            return None

        if progress_callback:
            progress_callback("Backtesting (batched retrains on device)...")

        # --- all retrains as one vmapped fit --------------------------------
        retrain_points = list(range(train_end, n, retrain_frequency))
        idx = np.arange(n)
        masks = np.stack([(idx < r).astype(np.float32)
                          for r in retrain_points])
        cfg = _gbt_cfg(self.model_config, regularized=False)
        preds_all = np.asarray(_fit_folds(
            jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
            jnp.asarray(masks), cfg))  # (K, n)

        test_days = np.arange(train_end, n)
        model_of_day = (test_days - train_end) // retrain_frequency
        preds = preds_all[model_of_day, test_days]

        # --- signals (app.py:752-761) ---------------------------------------
        thresh = (rvol20[test_days] / np.sqrt(252.0)
                  * np.sqrt(float(forecast_horizon)) * 0.5)
        signals = np.where(preds > thresh, 1,
                           np.where(preds < -thresh, -1, 0)).astype(np.int32)

        # --- the event loop --------------------------------------------------
        outs = _trade_scan(jnp.asarray(close[test_days]),
                           jnp.asarray(signals), self.config)
        return assemble_results(outs, dates[test_days], self.config)


def assemble_results(outs, test_dates, config: TradingConfig) -> Dict:
    """Trade log + the reference's risk-metric suite (app.py:787-882) from
    the trade-scan outputs — shared by the single and batched backtests."""
    (equity, returns, positions, closes, close_dir, entry_px, exit_px,
     trade_ret, pnl, entry_day) = (np.asarray(o) for o in outs)

    # --- trade log (app.py:787-795) --------------------------------------
    trades = []
    for i in np.nonzero(closes)[0]:
        trades.append({
            "entry_date": test_dates[int(entry_day[i])],
            "exit_date": test_dates[i],
            "direction": "LONG" if close_dir[i] == 1 else "SHORT",
            "entry_price": float(entry_px[i]),
            "exit_price": float(exit_px[i]),
            "return": float(trade_ret[i]) * 100.0,
            "pnl": float(pnl[i]),
        })

    # --- metrics (app.py:815-858) -----------------------------------------
    current_capital = float(equity[-1])
    returns_arr = returns.astype(np.float64)
    equity_arr = equity.astype(np.float64)

    running_max = np.maximum.accumulate(equity_arr)
    drawdowns = (running_max - equity_arr) / running_max

    total_days = len(returns_arr)
    total_return = (current_capital / config.initial_capital
                    - 1.0) * 100.0
    ann_return = ((1.0 + total_return / 100.0)
                  ** (252.0 / max(total_days, 1)) - 1.0) * 100.0
    ann_vol = float(np.std(returns_arr)) * np.sqrt(252.0) * 100.0
    sharpe = ann_return / ann_vol if ann_vol > 0 else 0.0
    max_dd = float(np.max(drawdowns)) * 100.0 if len(drawdowns) else 0.0

    if trades:
        wins = [t for t in trades if t["return"] > 0]
        losses = [t for t in trades if t["return"] <= 0]
        win_rate = len(wins) / len(trades) * 100.0
        avg_win = float(np.mean([t["return"] for t in wins])) if wins else 0.0
        avg_loss = (float(np.mean([t["return"] for t in losses]))
                    if losses else 0.0)
        total_wins = sum(t["pnl"] for t in wins) if wins else 0.0
        total_losses = sum(t["pnl"] for t in losses) if losses else 0.0
        profit_factor = (abs(total_wins / total_losses)
                         if total_losses != 0 else 0.0)
    else:
        win_rate = avg_win = avg_loss = profit_factor = 0.0

    calmar = ann_return / max_dd if max_dd > 0 else 0.0
    neg = returns_arr[returns_arr < 0]
    downside_std = (float(np.std(neg)) * np.sqrt(252.0) * 100.0
                    if len(neg) > 0 else 1.0)
    sortino = ann_return / downside_std

    return {
        "dates": list(test_dates),
        "equity": equity_arr.tolist(),
        "returns": returns_arr.tolist(),
        "positions": positions.tolist(),
        "drawdowns": drawdowns.tolist(),
        "trades": trades,
        "metrics": {
            "total_return": total_return,
            "annualized_return": ann_return,
            "annualized_volatility": ann_vol,
            "sharpe_ratio": sharpe,
            "sortino_ratio": sortino,
            "calmar_ratio": calmar,
            "max_drawdown": max_dd,
            "win_rate": win_rate,
            "avg_win": avg_win,
            "avg_loss": avg_loss,
            "profit_factor": profit_factor,
            "num_trades": len(trades),
            "trading_days": total_days,
        },
    }
