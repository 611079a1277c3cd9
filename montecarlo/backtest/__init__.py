"""Walk-forward backtesting (reference app.py:662-882 parity)."""

from montecarlo.backtest.engine import WalkForwardBacktester  # noqa: F401
from montecarlo.backtest.portfolio import backtest_tickers_batched  # noqa: F401
