"""Data layer: universes, providers (yfinance/synthetic/csv), synthetic OHLCV."""

from montecarlo.data.synthetic import generate_ohlcv  # noqa: F401
from montecarlo.data.universes import (  # noqa: F401
    ETF_TICKERS,
    MEGA_CAP_TICKERS,
    NASDAQ100_TICKERS,
    POPULAR_TICKERS,
    SOURCES,
    SP500_TICKERS,
    get_ticker_list,
)
from montecarlo.data.fetch import (  # noqa: F401
    PERIOD_DAYS,
    clear_cache,
    default_provider,
    get_stock_data,
)
