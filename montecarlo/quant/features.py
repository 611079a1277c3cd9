"""The feature factory: ~60 engineered columns from OHLCV, in JAX.

Column-for-column capability parity with the reference's
``add_all_features`` (reference app.py:210-395): same names, same formulas,
same NaN/cleanup semantics (inf -> 0, then drop any row with a NaN).  Works
on (T,) arrays; `jax.vmap` over a leading ticker axis turns the whole
factory into one batched device program (the scanner's fast path).
"""

from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from montecarlo.quant.indicators import (
    EPS,
    atr,
    bollinger,
    keltner,
    macd,
    rsi,
    stochastic,
)
from montecarlo.quant.rolling import (
    cumsum_skipna,
    pct_change,
    rolling_max,
    rolling_mean,
    rolling_median,
    rolling_min,
    rolling_std,
    rolling_sum,
    shift,
)

#: Intermediates the reference drops before ML (app.py:385-389).
DROPPED_INTERMEDIATES = (
    "sma_10", "sma_20", "sma_50", "sma_100", "sma_200",
    "ema_12", "ema_26", "ema_50", "bb_upper", "bb_lower",
    "kc_upper", "kc_lower", "volume_sma_20", "high_20", "low_20",
    "vpt", "vpt_sma", "macd", "macd_signal",
)


def compute_features(open_, high, low, close, volume,
                     dtype=jnp.float64) -> Dict[str, jnp.ndarray]:
    """All feature columns (reference app.py:210-395), NaNs preserved.

    Returns a dict of (T,) arrays including the raw OHLCV columns, exactly
    the columns the reference DataFrame carries after its intermediate-drop.
    Call :func:`finalize` to apply the reference's inf->0 + dropna cleanup.
    """
    as_ = lambda v: jnp.asarray(v, dtype)
    open_, high, low = as_(open_), as_(high), as_(low)
    close, volume = as_(close), as_(volume)
    d: Dict[str, jnp.ndarray] = {
        "Open": open_, "High": high, "Low": low,
        "Close": close, "Volume": volume,
    }

    # --- returns & volatility (app.py:224-241) ---
    log_ret = jnp.log(close / shift(close))
    d["log_ret"] = log_ret
    for w in (2, 5, 10, 20):
        d[f"log_ret_{w}d"] = rolling_sum(log_ret, w)
    sqrt252 = jnp.sqrt(jnp.asarray(252.0, dtype))
    for w in (5, 10, 20, 60):
        d[f"rvol_{w}"] = rolling_std(log_ret, w) * sqrt252
    d["vol_ratio_5_20"] = d["rvol_5"] / (d["rvol_20"] + EPS)
    d["vol_ratio_20_60"] = d["rvol_20"] / (d["rvol_60"] + EPS)
    d["vol_change"] = pct_change(d["rvol_20"], 5)

    # --- momentum & mean reversion (app.py:246-267) ---
    for w in (5, 10, 20, 60):
        d[f"roc_{w}"] = pct_change(close, w)
    sma = {}
    for w in (10, 20, 50, 100, 200):
        sma[w] = rolling_mean(close, w)
        d[f"dist_sma_{w}"] = (close - sma[w]) / (sma[w] + EPS)
    _, _, d["bb_width"], d["bb_position"] = bollinger(close)

    # --- oscillators (app.py:272-292) ---
    d["rsi_14"] = rsi(close, 14)
    d["rsi_norm"] = (d["rsi_14"] - 50.0) / 50.0
    d["rsi_ob"] = (d["rsi_14"] > 70).astype(dtype)
    d["rsi_os"] = (d["rsi_14"] < 30).astype(dtype)
    d["stoch_k"], d["stoch_d"] = stochastic(high, low, close)
    d["stoch_norm"] = (d["stoch_k"] - 50.0) / 50.0
    macd_line, signal_line, hist = macd(close)
    d["macd_hist"] = hist
    d["macd_hist_norm"] = hist / (close + EPS)

    # --- volatility indicators (app.py:297-304) ---
    d["atr_14"] = atr(high, low, close, 14)
    d["atr_pct"] = d["atr_14"] / (close + EPS)
    _, _, d["kc_position"] = keltner(close, high, low)

    # --- volume (app.py:309-320) ---
    vol_sma_20 = rolling_mean(volume, 20)
    d["rel_volume"] = volume / (vol_sma_20 + EPS)
    d["volume_trend"] = rolling_mean(volume, 5) / (vol_sma_20 + EPS)
    vpt = cumsum_skipna(log_ret * volume)
    vpt_sma = rolling_mean(vpt, 20)
    d["vpt_signal"] = (vpt > vpt_sma).astype(dtype)
    obv = cumsum_skipna(jnp.sign(log_ret) * volume)
    d["obv_pct_change"] = pct_change(obv, 10)

    # --- higher-order statistics (app.py:326-336) ---
    r_mean = rolling_mean(log_ret, 20)
    r_std = rolling_std(log_ret, 20)
    r_median = rolling_median(log_ret, 20)
    d["ret_skew_proxy"] = (r_mean - r_median) / (r_std + EPS)
    r_max = rolling_max(log_ret, 20)
    r_min = rolling_min(log_ret, 20)
    d["ret_range_norm"] = (r_max - r_min) / (r_std + EPS)

    # --- trend (app.py:342-357) ---
    d["trend_strength"] = jnp.abs(d["dist_sma_50"]) * 100.0
    high_20 = rolling_max(high, 20)
    low_20 = rolling_min(low, 20)
    d["price_position"] = (close - low_20) / (high_20 - low_20 + EPS)
    d["uptrend"] = (close > sma[50]).astype(dtype)
    d["downtrend"] = (close < sma[50]).astype(dtype)
    d["golden_cross"] = ((sma[50] > sma[200])
                         & (shift(sma[50]) <= shift(sma[200]))).astype(dtype)
    d["death_cross"] = ((sma[50] < sma[200])
                        & (shift(sma[50]) >= shift(sma[200]))).astype(dtype)

    # --- regime flags (app.py:362-365) ---
    d["high_vol_regime"] = (d["rvol_20"] > d["rvol_60"]).astype(dtype)
    d["low_vol_regime"] = (d["rvol_20"] < d["rvol_60"] * 0.8).astype(dtype)
    d["trending_regime"] = (jnp.abs(d["dist_sma_50"]) > 0.05).astype(dtype)
    d["mean_revert_regime"] = (jnp.abs(d["dist_sma_20"])
                               > jnp.abs(d["dist_sma_50"])).astype(dtype)

    # --- lags (app.py:370-372) ---
    for lag in (1, 2, 3, 5, 10):
        d[f"ret_lag_{lag}"] = shift(log_ret, lag)
        d[f"vol_lag_{lag}"] = shift(d["rvol_20"], lag)

    # --- interactions (app.py:377-379) ---
    d["momentum_vol_adj"] = d["roc_20"] / (d["rvol_20"] + EPS)
    d["rsi_vol_interaction"] = d["rsi_norm"] * d["vol_ratio_5_20"]
    d["volume_momentum"] = d["rel_volume"] * d["roc_5"]

    # NaN-flag caveat parity: the boolean->float casts above turn NaN
    # comparisons into 0.0/False exactly as pandas' ``(cond).astype(float)``
    # does, so flag columns carry no NaNs — matching the reference.
    return d


def finalize(features: Dict[str, jnp.ndarray]):
    """The reference's cleanup (app.py:392-393): inf -> 0, drop NaN rows.

    Returns ``(clean, valid)`` where ``clean`` maps column -> (T,) array with
    infs zeroed, and ``valid`` is the (T,) bool mask of rows that survive
    ``dropna`` (row-wise: every column finite).  Callers index with
    ``clean[c][valid]`` (host-side, shapes become data-dependent).
    """
    clean = {k: jnp.where(jnp.isinf(v), 0.0, v) for k, v in features.items()}
    valid = jnp.ones_like(next(iter(clean.values())), dtype=bool)
    for v in clean.values():
        valid = valid & ~jnp.isnan(v)
    return clean, valid


@functools.lru_cache(maxsize=4)
def _jitted_pipeline(dtype_name: str):
    """One fused program for compute_features+finalize per dtype — the whole
    factory is a single device dispatch (hundreds of eager ops would each
    pay a dispatch)."""
    dtype = jnp.dtype(dtype_name)

    @jax.jit
    def run(o, h, l, c, v):
        return finalize(compute_features(o, h, l, c, v, dtype))

    return run


def features_to_numpy(open_, high, low, close, volume, dtype=jnp.float64,
                      return_mask: bool = False):
    """Host convenience: compute, finalize, and dropna -> dict of np arrays.

    With ``return_mask=True`` also returns the (T,) bool dropna mask so
    callers can align passthrough columns (e.g. dates) exactly — the mask is
    NOT always a leading prefix (a mid-series NaN from a halted ticker or
    zero volume drops interior rows too).
    """
    clean, valid = _jitted_pipeline(jnp.dtype(dtype).name)(
        np.asarray(open_), np.asarray(high), np.asarray(low),
        np.asarray(close), np.asarray(volume))
    mask = np.asarray(valid)
    out = {k: np.asarray(v)[mask] for k, v in clean.items()}
    return (out, mask) if return_mask else out
