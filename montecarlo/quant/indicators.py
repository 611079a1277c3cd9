"""Technical indicators — formula parity with the reference.

RSI (reference app.py:183-191), ATR (app.py:193-199), MACD (app.py:201-208),
plus the stochastic oscillator and Bollinger/Keltner channels used inside the
feature factory (app.py:260-304).
"""

from __future__ import annotations

import jax.numpy as jnp

from montecarlo.quant.rolling import (
    diff,
    ewm_mean,
    rolling_max,
    rolling_mean,
    rolling_min,
    rolling_std,
    shift,
)

EPS = 1e-10  # the reference's universal denominator guard


def rsi(close, period: int = 14):
    """EWM-based RSI: 100 - 100/(1+rs), rs = ewm(gain)/(ewm(loss)+1e-10)."""
    delta = diff(close)
    gain = jnp.clip(delta, 0.0, None)
    loss = jnp.clip(-delta, 0.0, None)
    avg_gain = ewm_mean(gain, period)
    avg_loss = ewm_mean(loss, period)
    rs = avg_gain / (avg_loss + EPS)
    return 100.0 - (100.0 / (1.0 + rs))


def atr(high, low, close, period: int = 14):
    """True range = max(H-L, |H-C_1|, |L-C_1|), rolling mean."""
    prev_close = shift(close)
    # fmax ignores NaN, matching pandas' skipna row-max: on day 0 (no
    # previous close) the true range degrades to high - low.
    tr = jnp.fmax(high - low,
                  jnp.fmax(jnp.abs(high - prev_close),
                           jnp.abs(low - prev_close)))
    return rolling_mean(tr, period)


def macd(close):
    """Returns (macd_line, signal_line, histogram)."""
    ema12 = ewm_mean(close, 12)
    ema26 = ewm_mean(close, 26)
    macd_line = ema12 - ema26
    signal_line = ewm_mean(macd_line, 9)
    return macd_line, signal_line, macd_line - signal_line


def stochastic(high, low, close, period: int = 14, smooth: int = 3):
    """Returns (%K, %D) — app.py:281-284."""
    low_n = rolling_min(low, period)
    high_n = rolling_max(high, period)
    k = 100.0 * (close - low_n) / (high_n - low_n + EPS)
    d = rolling_mean(k, smooth)
    return k, d


def bollinger(close, period: int = 20, n_std: float = 2.0):
    """Returns (upper, lower, width, position[clipped 0..1]) — app.py:260-267."""
    sma = rolling_mean(close, period)
    std = rolling_std(close, period)
    upper = sma + n_std * std
    lower = sma - n_std * std
    width = (upper - lower) / (sma + EPS)
    position = jnp.clip((close - lower) / (upper - lower + EPS), 0.0, 1.0)
    return upper, lower, width, position


def keltner(close, high, low, period: int = 20, atr_period: int = 14):
    """Returns (upper, lower, position) — app.py:300-304."""
    ema = ewm_mean(close, period)
    a = atr(high, low, close, atr_period)
    upper = ema + 2.0 * a
    lower = ema - 2.0 * a
    position = (close - lower) / (upper - lower + EPS)
    return upper, lower, position
