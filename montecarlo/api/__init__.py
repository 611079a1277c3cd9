"""Public API: Monte Carlo, single-ticker analysis, scanner."""

from montecarlo.api.montecarlo import garch_monte_carlo  # noqa: F401
from montecarlo.api.var import portfolio_var, portfolio_var_on_device  # noqa: F401
from montecarlo.api.analyze import analyze_ticker  # noqa: F401
from montecarlo.api.batch_scan import scan_tickers_batched  # noqa: F401
from montecarlo.api.scanner import (  # noqa: F401
    ScanResult,
    scan_single_ticker,
    scan_tickers,
    signal_label,
)
