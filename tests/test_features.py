"""Feature-factory parity against a pandas oracle.

The oracle re-expresses the reference's documented formulas
(SURVEY.md §2 row 'Feature factory', reference app.py:210-395) in idiomatic
pandas; the JAX factory must match every column to float64 precision.
"""

import numpy as np
import pandas as pd
import pytest

from montecarlo.data.synthetic import generate_ohlcv
from montecarlo.quant import compute_features, features_to_numpy


def _pandas_oracle(ohlcv: dict) -> pd.DataFrame:
    c = pd.Series(ohlcv["Close"])
    h = pd.Series(ohlcv["High"])
    lo = pd.Series(ohlcv["Low"])
    v = pd.Series(ohlcv["Volume"])
    eps = 1e-10
    out = pd.DataFrame({"Close": c, "High": h, "Low": lo, "Volume": v,
                        "Open": pd.Series(ohlcv["Open"])})

    lr = np.log(c / c.shift(1))
    out["log_ret"] = lr
    for w in (2, 5, 10, 20):
        out[f"log_ret_{w}d"] = lr.rolling(w).sum()
    for w in (5, 10, 20, 60):
        out[f"rvol_{w}"] = lr.rolling(w).std() * np.sqrt(252)
    out["vol_ratio_5_20"] = out["rvol_5"] / (out["rvol_20"] + eps)
    out["vol_ratio_20_60"] = out["rvol_20"] / (out["rvol_60"] + eps)
    out["vol_change"] = out["rvol_20"].pct_change(5)

    for w in (5, 10, 20, 60):
        out[f"roc_{w}"] = c.pct_change(w)
    sma = {w: c.rolling(w).mean() for w in (10, 20, 50, 100, 200)}
    for w, s in sma.items():
        out[f"dist_sma_{w}"] = (c - s) / (s + eps)
    sma20, std20 = c.rolling(20).mean(), c.rolling(20).std()
    upper, lower = sma20 + 2 * std20, sma20 - 2 * std20
    out["bb_width"] = (upper - lower) / (sma20 + eps)
    out["bb_position"] = ((c - lower) / (upper - lower + eps)).clip(0, 1)

    delta = c.diff()
    avg_gain = delta.clip(lower=0).ewm(span=14, adjust=False).mean()
    avg_loss = (-delta).clip(lower=0).ewm(span=14, adjust=False).mean()
    out["rsi_14"] = 100 - 100 / (1 + avg_gain / (avg_loss + eps))
    out["rsi_norm"] = (out["rsi_14"] - 50) / 50
    out["rsi_ob"] = (out["rsi_14"] > 70).astype(float)
    out["rsi_os"] = (out["rsi_14"] < 30).astype(float)
    l14, h14 = lo.rolling(14).min(), h.rolling(14).max()
    out["stoch_k"] = 100 * (c - l14) / (h14 - l14 + eps)
    out["stoch_d"] = out["stoch_k"].rolling(3).mean()
    out["stoch_norm"] = (out["stoch_k"] - 50) / 50
    ema12 = c.ewm(span=12, adjust=False).mean()
    ema26 = c.ewm(span=26, adjust=False).mean()
    macd_line = ema12 - ema26
    signal = macd_line.ewm(span=9, adjust=False).mean()
    out["macd_hist"] = macd_line - signal
    out["macd_hist_norm"] = out["macd_hist"] / (c + eps)

    tr = pd.concat([h - lo, (h - c.shift(1)).abs(), (lo - c.shift(1)).abs()],
                   axis=1).max(axis=1)
    out["atr_14"] = tr.rolling(14).mean()
    out["atr_pct"] = out["atr_14"] / (c + eps)
    ema20 = c.ewm(span=20, adjust=False).mean()
    kc_u, kc_l = ema20 + 2 * out["atr_14"], ema20 - 2 * out["atr_14"]
    out["kc_position"] = (c - kc_l) / (kc_u - kc_l + eps)

    vsma20 = v.rolling(20).mean()
    out["rel_volume"] = v / (vsma20 + eps)
    out["volume_trend"] = v.rolling(5).mean() / (vsma20 + eps)
    vpt = (lr * v).cumsum()
    out["vpt_signal"] = (vpt > vpt.rolling(20).mean()).astype(float)
    obv = (np.sign(lr) * v).cumsum()
    out["obv_pct_change"] = obv.pct_change(10)

    rm, rs = lr.rolling(20).mean(), lr.rolling(20).std()
    out["ret_skew_proxy"] = (rm - lr.rolling(20).median()) / (rs + eps)
    out["ret_range_norm"] = (lr.rolling(20).max() - lr.rolling(20).min()) / (rs + eps)

    out["trend_strength"] = out["dist_sma_50"].abs() * 100
    h20, l20 = h.rolling(20).max(), lo.rolling(20).min()
    out["price_position"] = (c - l20) / (h20 - l20 + eps)
    out["uptrend"] = (c > sma[50]).astype(float)
    out["downtrend"] = (c < sma[50]).astype(float)
    out["golden_cross"] = ((sma[50] > sma[200])
                           & (sma[50].shift(1) <= sma[200].shift(1))).astype(float)
    out["death_cross"] = ((sma[50] < sma[200])
                          & (sma[50].shift(1) >= sma[200].shift(1))).astype(float)

    out["high_vol_regime"] = (out["rvol_20"] > out["rvol_60"]).astype(float)
    out["low_vol_regime"] = (out["rvol_20"] < out["rvol_60"] * 0.8).astype(float)
    out["trending_regime"] = (out["dist_sma_50"].abs() > 0.05).astype(float)
    out["mean_revert_regime"] = (out["dist_sma_20"].abs()
                                 > out["dist_sma_50"].abs()).astype(float)

    for lag in (1, 2, 3, 5, 10):
        out[f"ret_lag_{lag}"] = lr.shift(lag)
        out[f"vol_lag_{lag}"] = out["rvol_20"].shift(lag)

    out["momentum_vol_adj"] = out["roc_20"] / (out["rvol_20"] + eps)
    out["rsi_vol_interaction"] = out["rsi_norm"] * out["vol_ratio_5_20"]
    out["volume_momentum"] = out["rel_volume"] * out["roc_5"]
    return out


@pytest.fixture(scope="module")
def data():
    ohlcv = generate_ohlcv(n_days=600, seed=42)
    ours = compute_features(ohlcv["Open"], ohlcv["High"], ohlcv["Low"],
                            ohlcv["Close"], ohlcv["Volume"])
    oracle = _pandas_oracle(ohlcv)
    return ours, oracle


def test_all_columns_present(data):
    ours, oracle = data
    missing = set(oracle.columns) - set(ours)
    assert not missing, f"missing columns: {missing}"


def test_every_column_matches_pandas(data):
    ours, oracle = data
    for col in oracle.columns:
        ref = oracle[col].to_numpy()
        got = np.asarray(ours[col])
        assert got.shape == ref.shape, col
        nan_ref = np.isnan(ref)
        np.testing.assert_array_equal(np.isnan(got), nan_ref,
                                      err_msg=f"NaN pattern differs: {col}")
        np.testing.assert_allclose(
            got[~nan_ref], ref[~nan_ref], rtol=1e-9, atol=1e-10,
            err_msg=f"values differ: {col}")


def test_finalize_matches_pandas_dropna(data):
    ours, oracle = data
    final = features_to_numpy(
        *[np.asarray(ours[k]) for k in ("Open", "High", "Low", "Close",
                                        "Volume")])
    oracle_clean = oracle.replace([np.inf, -np.inf], 0).dropna()
    n = len(oracle_clean)
    assert len(final["Close"]) == n
    np.testing.assert_allclose(final["rvol_20"],
                               oracle_clean["rvol_20"].to_numpy(), rtol=1e-9)


def test_feature_count_is_reference_scale(data):
    ours, _ = data
    # Reference ends with ~65 columns post-drop (60 features + OHLCV).
    assert len(ours) >= 60
