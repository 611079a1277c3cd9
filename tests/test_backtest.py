"""Backtester: trade mechanics against a hand-rolled oracle, guards, metrics."""

import numpy as np
import jax.numpy as jnp
import pytest

from montecarlo.backtest import WalkForwardBacktester
from montecarlo.backtest.engine import _trade_scan
from montecarlo.config import ModelConfig, TradingConfig
from montecarlo.data.synthetic import generate_ohlcv
from montecarlo.quant import features_to_numpy


def _python_trade_oracle(prices, signals, cfg: TradingConfig):
    """Literal transcription of the reference's trade loop semantics
    (app.py:697-813) for differential testing."""
    equity = [cfg.initial_capital]
    returns, positions, trades = [], [], []
    capital = cfg.initial_capital
    position, entry_price, entry_i = 0, 0.0, 0
    for i, (price, signal) in enumerate(zip(prices, signals)):
        daily_pnl = 0.0
        if signal != position:
            if position != 0:
                exit_price = price * (1 - cfg.slippage_pct * np.sign(position))
                if position == 1:
                    tr = (exit_price - entry_price) / entry_price
                else:
                    tr = (entry_price - exit_price) / entry_price
                tr -= cfg.commission_pct * 2
                daily_pnl = tr * cfg.max_position_pct * capital
                trades.append({"entry_i": entry_i, "exit_i": i,
                               "direction": position, "return": tr * 100,
                               "pnl": daily_pnl})
            if signal != 0:
                entry_price = price * (1 + cfg.slippage_pct * np.sign(signal))
                entry_i = i
                position = signal
            else:
                position = 0
        capital += daily_pnl
        equity.append(capital)
        returns.append(daily_pnl / (equity[-2] if equity[-2] > 0 else 1))
        positions.append(position)
    return np.array(equity[1:]), np.array(returns), np.array(positions), trades


def test_trade_scan_matches_python_oracle():
    rng = np.random.default_rng(0)
    n = 300
    prices = 100 * np.exp(np.cumsum(rng.normal(0, 0.02, n)))
    signals = rng.choice([-1, 0, 1], size=n).astype(np.int32)
    cfg = TradingConfig()
    outs = _trade_scan(jnp.asarray(prices, jnp.float32),
                       jnp.asarray(signals), cfg)
    equity, returns, positions = (np.asarray(outs[0]), np.asarray(outs[1]),
                                  np.asarray(outs[2]))
    closes, close_dir, entry_px, exit_px, trade_ret, pnl, entry_day = (
        np.asarray(o) for o in outs[3:])

    ref_eq, ref_ret, ref_pos, ref_trades = _python_trade_oracle(
        prices, signals, cfg)
    np.testing.assert_allclose(equity, ref_eq, rtol=1e-5)
    np.testing.assert_allclose(returns, ref_ret, atol=1e-7)
    np.testing.assert_array_equal(positions, ref_pos)
    got_trades = np.nonzero(closes)[0]
    assert len(got_trades) == len(ref_trades)
    for i, t in zip(got_trades, ref_trades):
        assert int(i) == t["exit_i"]
        assert int(entry_day[i]) == t["entry_i"]
        assert int(close_dir[i]) == t["direction"]
        # f32 prices (~100) cancel to small moves: |err| ~ 1e-5 absolute.
        np.testing.assert_allclose(float(trade_ret[i]) * 100, t["return"],
                                   atol=2e-3)


@pytest.fixture(scope="module")
def feature_data():
    ohlcv = generate_ohlcv(n_days=1100, seed=3)
    return features_to_numpy(ohlcv["Open"], ohlcv["High"], ohlcv["Low"],
                             ohlcv["Close"], ohlcv["Volume"])


def test_backtester_contract(feature_data):
    bt = WalkForwardBacktester(TradingConfig(), ModelConfig.fast())
    out = bt.run(feature_data, forecast_horizon=20, retrain_frequency=60)
    assert out is not None
    assert set(out) == {"dates", "equity", "returns", "positions",
                        "drawdowns", "trades", "metrics"}
    m = out["metrics"]
    for key in ("total_return", "annualized_return", "annualized_volatility",
                "sharpe_ratio", "sortino_ratio", "calmar_ratio",
                "max_drawdown", "win_rate", "avg_win", "avg_loss",
                "profit_factor", "num_trades", "trading_days"):
        assert key in m, key
    assert m["trading_days"] == len(out["equity"]) == len(out["returns"])
    assert 0.0 <= m["max_drawdown"] <= 100.0
    assert m["num_trades"] == len(out["trades"])
    # Equity consistency: total return recomputed from the equity curve.
    np.testing.assert_allclose(
        m["total_return"],
        (out["equity"][-1] / TradingConfig().initial_capital - 1) * 100,
        rtol=1e-6)
    for t in out["trades"]:
        assert t["direction"] in ("LONG", "SHORT")
        assert t["exit_date"] >= t["entry_date"]


def test_backtester_insufficient_data_returns_none():
    ohlcv = generate_ohlcv(n_days=300, seed=5)
    data = features_to_numpy(ohlcv["Open"], ohlcv["High"], ohlcv["Low"],
                             ohlcv["Close"], ohlcv["Volume"])
    bt = WalkForwardBacktester(TradingConfig(), ModelConfig.full())
    assert bt.run(data, forecast_horizon=20) is None


def test_batched_backtest_matches_single(feature_data):
    """Vmapped portfolio backtest == the single-ticker engine per ticker."""
    from montecarlo.backtest import backtest_tickers_batched
    from montecarlo.data import get_stock_data

    data_by_ticker = {t: get_stock_data(t, "5y", provider="synthetic")
                      for t in ("AAPL", "MSFT")}
    cfg_t, cfg_m = TradingConfig(), ModelConfig.fast()
    batched = backtest_tickers_batched(data_by_ticker, forecast_horizon=20,
                                       retrain_frequency=60,
                                       trading_config=cfg_t,
                                       model_config=cfg_m)
    single_engine = WalkForwardBacktester(cfg_t, cfg_m)
    for t, data in data_by_ticker.items():
        single = single_engine.run(data, 20, 60)
        got = batched[t]
        assert (got is None) == (single is None)
        if single is None:
            continue
        for key in ("total_return", "num_trades", "win_rate",
                    "sharpe_ratio", "max_drawdown"):
            a, b = got["metrics"][key], single["metrics"][key]
            assert abs(a - b) < max(1e-6 * max(abs(a), abs(b), 1.0), 1e-6), (
                t, key, a, b)


def test_batched_backtest_guards():
    from montecarlo.backtest import backtest_tickers_batched
    from montecarlo.data import get_stock_data

    short = get_stock_data("TSLA", "2y", provider="synthetic")
    out = backtest_tickers_batched({"TSLA": short},
                                   model_config=ModelConfig.full())
    assert out["TSLA"] is None


def test_zero_trades_metrics():
    """All-flat signals: no trades, flat equity, zeroed trade statistics."""
    from montecarlo.backtest.engine import assemble_results

    prices = np.linspace(100, 110, 50).astype(np.float32)
    signals = np.zeros(50, np.int32)
    cfg = TradingConfig()
    outs = _trade_scan(jnp.asarray(prices), jnp.asarray(signals), cfg)
    res = assemble_results(outs, np.arange(50), cfg)
    m = res["metrics"]
    assert m["num_trades"] == 0
    assert m["total_return"] == 0.0
    assert m["win_rate"] == 0.0 and m["profit_factor"] == 0.0
    assert m["max_drawdown"] == 0.0
    assert all(e == cfg.initial_capital for e in res["equity"])
