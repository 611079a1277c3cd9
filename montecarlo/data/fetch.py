"""Data acquisition with provider abstraction and TTL caching.

The reference fetches OHLCV from yfinance behind a 1-hour Streamlit cache
and requires >= 200 rows (reference app.py:887-896).  This layer keeps that
contract but adds providers so every pipeline runs without network access:

- ``yfinance`` — live market data (gated import; the default when installed)
- ``synthetic`` — deterministic per-ticker series (hash of the symbol seeds
  the generator); the hermetic default in this image
- ``csv``      — local files ``<dir>/<ticker>.csv`` with OHLCV columns

All providers return the *featurized* dict (through the JAX feature factory)
or None on insufficient data, exactly like the reference's
``get_stock_data``.
"""

from __future__ import annotations

import hashlib
import time
from typing import Dict, Optional

import numpy as np

from montecarlo.data.synthetic import generate_ohlcv
from montecarlo.quant.features import features_to_numpy

#: period string -> trading days (the reference's scanner periods,
#: app.py:1303-1322 map reliability modes to 2y/3y/5y).
PERIOD_DAYS = {"1y": 252, "2y": 504, "3y": 756, "5y": 1260, "10y": 2520,
               "max": 5040}

MIN_ROWS = 200  # reference guard (app.py:892)
_CACHE: dict = {}
CACHE_TTL_SECONDS = 3600.0  # reference: st.cache_data(ttl=3600)


def _featurize(ohlcv: Dict[str, np.ndarray]) -> Optional[Dict]:
    if len(ohlcv["Close"]) < MIN_ROWS:
        return None
    extras = {k: v for k, v in ohlcv.items()
              if k not in ("Open", "High", "Low", "Close", "Volume")}
    out, mask = features_to_numpy(ohlcv["Open"], ohlcv["High"], ohlcv["Low"],
                                  ohlcv["Close"], ohlcv["Volume"],
                                  return_mask=True)
    # Apply the exact dropna mask to passthrough columns (e.g. Date): the
    # dropped rows are usually a warm-up prefix, but a mid-series NaN
    # (halted ticker, zero volume) drops interior rows too — a prefix slice
    # would silently misalign dates against prices in trade logs.
    for k, v in extras.items():
        out[k] = np.asarray(v)[mask]
    return out


def _synthetic_ohlcv(ticker: str, period: str) -> Dict[str, np.ndarray]:
    n_days = PERIOD_DAYS.get(period, 1260)
    seed = int(hashlib.sha256(ticker.encode()).hexdigest()[:8], 16)
    return generate_ohlcv(n_days=n_days, seed=seed)


def _yfinance_ohlcv(ticker: str, period: str) -> Optional[Dict]:
    import yfinance as yf  # gated: not installed in offline images

    df = yf.Ticker(ticker).history(period=period)
    if len(df) < MIN_ROWS:
        return None
    return {
        "Open": df["Open"].to_numpy(), "High": df["High"].to_numpy(),
        "Low": df["Low"].to_numpy(), "Close": df["Close"].to_numpy(),
        "Volume": df["Volume"].to_numpy(),
        "Date": df.index.to_numpy(),
    }


def _read_date_column(path: str) -> Optional[np.ndarray]:
    """Date column with the native loader's row semantics (header row, then
    every non-blank line in file order) so the two stay aligned."""
    with open(path, "r") as f:
        header = f.readline().rstrip("\r\n").split(",")
        names = [h.strip().strip('"').lower() for h in header]
        if "date" not in names:
            return None
        col = names.index("date")
        dates = []
        for line in f:
            if line.strip() == "":
                continue
            cells = line.rstrip("\r\n").split(",")
            dates.append(cells[col].strip().strip('"') if col < len(cells)
                         else "")
        return np.asarray(dates)


def _csv_ohlcv(ticker: str, data_dir: str) -> Optional[Dict]:
    path = f"{data_dir}/{ticker}.csv"
    # Native mmap loader first (montecarlo/native/csv_loader.cc);
    # pandas as the portable fallback.
    from montecarlo.data._native import load_ohlcv_csv

    native = load_ohlcv_csv(path)
    if native is not None:
        # The native loader returns only the numeric columns; pull Date
        # host-side so both csv paths carry the same passthrough columns.
        dates = _read_date_column(path)
        if dates is not None and len(dates) == len(native["Close"]):
            native["Date"] = dates
        return native

    import pandas as pd

    df = pd.read_csv(path)
    cols = {c.lower(): c for c in df.columns}
    out = {name: df[cols[name.lower()]].to_numpy(np.float64)
           for name in ("Open", "High", "Low", "Close", "Volume")}
    if "date" in cols:
        out["Date"] = df[cols["date"]].to_numpy()
    return out


def default_provider() -> str:
    try:
        import yfinance  # noqa: F401
        return "yfinance"
    except ImportError:
        return "synthetic"


def get_stock_data(ticker: str, period: str = "5y", *,
                   provider: Optional[str] = None,
                   data_dir: str = ".") -> Optional[Dict]:
    """Fetch + featurize with a 1h TTL cache; None on failure/short data
    (the reference's graceful-degradation contract, app.py:887-896)."""
    provider = provider or default_provider()
    key = (ticker, period, provider, data_dir)
    hit = _CACHE.get(key)
    now = time.monotonic()
    if hit is not None and now - hit[0] < CACHE_TTL_SECONDS:
        return hit[1]
    try:
        if provider == "synthetic":
            ohlcv = _synthetic_ohlcv(ticker, period)
        elif provider == "yfinance":
            ohlcv = _yfinance_ohlcv(ticker, period)
        elif provider == "csv":
            ohlcv = _csv_ohlcv(ticker, data_dir)
        else:
            raise ValueError(f"unknown provider: {provider}")
        result = _featurize(ohlcv) if ohlcv is not None else None
    except Exception:
        # Do NOT negative-cache transient failures (network blip, rate
        # limit): the reference's st.cache_data never caches exceptions
        # (app.py:887), so a retry there hits the network immediately —
        # caching None here would blind the scanner for the whole TTL.
        return None
    _CACHE[key] = (now, result)
    return result


def get_stock_ohlcv(ticker: str, period: str = "5y", *,
                    provider: Optional[str] = None,
                    data_dir: str = ".") -> Optional[Dict]:
    """Raw (un-featurized) OHLCV — the batched scanner's input, so a whole
    ticker batch can be featurized as one vmapped device program."""
    provider = provider or default_provider()
    key = ("raw", ticker, period, provider, data_dir)
    hit = _CACHE.get(key)
    now = time.monotonic()
    if hit is not None and now - hit[0] < CACHE_TTL_SECONDS:
        return hit[1]
    try:
        if provider == "synthetic":
            ohlcv = _synthetic_ohlcv(ticker, period)
        elif provider == "yfinance":
            ohlcv = _yfinance_ohlcv(ticker, period)
        elif provider == "csv":
            ohlcv = _csv_ohlcv(ticker, data_dir)
        else:
            raise ValueError(f"unknown provider: {provider}")
        if ohlcv is not None and len(ohlcv["Close"]) < MIN_ROWS:
            ohlcv = None
    except Exception:
        return None  # transient failure: not cached (see get_stock_data)
    _CACHE[key] = (now, ohlcv)
    return ohlcv


def clear_cache() -> None:
    _CACHE.clear()
