"""ML layer: scaler/splits vs sklearn, GBT learning power, ForecastModel."""

import numpy as np
import jax.numpy as jnp
import pytest

from montecarlo.config import ModelConfig
from montecarlo.data.synthetic import generate_ohlcv
from montecarlo.ml import (
    ForecastModel,
    GBTConfig,
    gbt_feature_importance,
    gbt_fit,
    gbt_predict,
    make_target,
    scaler_fit,
    scaler_transform,
    time_series_split,
)
from montecarlo.quant import features_to_numpy


def test_scaler_matches_sklearn():
    from sklearn.preprocessing import StandardScaler

    rng = np.random.default_rng(0)
    x = rng.normal(3, 2, size=(500, 7))
    x[:, 3] = 1.0  # constant column
    ours = scaler_fit(jnp.asarray(x))
    theirs = StandardScaler().fit(x)
    np.testing.assert_allclose(np.asarray(ours.mean), theirs.mean_, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(ours.scale), theirs.scale_,
                               rtol=1e-9)
    np.testing.assert_allclose(
        np.asarray(scaler_transform(ours, jnp.asarray(x))),
        theirs.transform(x), rtol=1e-7, atol=1e-9)


def test_scaler_masked_fit():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(100, 3))
    w = np.zeros(100); w[:60] = 1
    masked = scaler_fit(jnp.asarray(x), weights=jnp.asarray(w))
    direct = scaler_fit(jnp.asarray(x[:60]))
    np.testing.assert_allclose(np.asarray(masked.mean),
                               np.asarray(direct.mean), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(masked.scale),
                               np.asarray(direct.scale), rtol=1e-9)


@pytest.mark.parametrize("n,k", [(504, 5), (252, 3), (1000, 4)])
def test_splits_match_sklearn(n, k):
    from sklearn.model_selection import TimeSeriesSplit

    ours = list(time_series_split(n, k))
    theirs = list(TimeSeriesSplit(n_splits=k).split(np.zeros((n, 1))))
    assert len(ours) == len(theirs) == k
    for (otr, ote), (ttr, tte) in zip(ours, theirs):
        np.testing.assert_array_equal(otr, ttr)
        np.testing.assert_array_equal(ote, tte)


def test_make_target_matches_pandas():
    import pandas as pd

    rng = np.random.default_rng(2)
    lr = rng.normal(0, 0.02, size=300)
    lr[0] = np.nan
    h = 20
    ref = pd.Series(lr).rolling(h).sum().shift(-h).to_numpy()
    got = make_target(lr, h)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got[~np.isnan(got)], ref[~np.isnan(ref)],
                               rtol=1e-12)


def test_gbt_learns_nonlinear_signal():
    rng = np.random.default_rng(3)
    n, F = 1200, 20
    x = rng.normal(size=(n, F)).astype(np.float32)
    y = np.sin(2 * x[:, 0]) + 0.5 * x[:, 1] ** 2 + 0.1 * rng.normal(size=n)
    cfg = GBTConfig(n_estimators=100, max_depth=3, learning_rate=0.1)
    model = gbt_fit(x[:900], y[:900].astype(np.float32), cfg, seed=0)
    pred = np.asarray(gbt_predict(model, x[900:], max_depth=3))
    rmse = np.sqrt(np.mean((pred - y[900:]) ** 2))
    rmse_base = np.std(y[900:])
    assert rmse < 0.5 * rmse_base
    imp = np.asarray(gbt_feature_importance(model, F))
    assert set(np.argsort(-imp)[:2]) == {0, 1}


def test_gbt_masked_weights_equal_subset_fit():
    """A 0/1 weight mask must behave like training on the subset."""
    rng = np.random.default_rng(4)
    n, F = 600, 8
    x = rng.normal(size=(n, F)).astype(np.float32)
    y = (x[:, 0] + 0.1 * rng.normal(size=n)).astype(np.float32)
    cfg = GBTConfig(n_estimators=30, max_depth=3, learning_rate=0.1,
                    subsample=1.0, colsample_bytree=1.0)
    w = np.zeros(n, np.float32); w[:400] = 1
    masked = gbt_fit(x, y, cfg, weights=jnp.asarray(w), seed=0)
    pred_m = np.asarray(gbt_predict(masked, x[400:], max_depth=3))
    rmse = np.sqrt(np.mean((pred_m - y[400:]) ** 2))
    assert rmse < 0.3  # learned x0 from only the masked window


def test_gbt_deterministic():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(300, 5)).astype(np.float32)
    y = x[:, 0].astype(np.float32)
    cfg = GBTConfig(n_estimators=10, max_depth=3, learning_rate=0.3)
    a = gbt_fit(x, y, cfg, seed=7)
    b = gbt_fit(x, y, cfg, seed=7)
    np.testing.assert_array_equal(np.asarray(a.leaf_value),
                                  np.asarray(b.leaf_value))


@pytest.fixture(scope="module")
def feature_data():
    ohlcv = generate_ohlcv(n_days=900, seed=11)
    return features_to_numpy(ohlcv["Open"], ohlcv["High"], ohlcv["Low"],
                             ohlcv["Close"], ohlcv["Volume"])


def test_forecast_model_train_contract(feature_data):
    model = ForecastModel(forecast_horizon=20, config=ModelConfig.fast())
    out = model.train(feature_data)
    assert out is not None
    # Reference result keys (app.py:509-519, 575-579).
    for key in ("rmse_mean", "rmse_std", "rmse_scores",
                "directional_accuracy", "da_std", "da_scores",
                "fold_predictions", "has_edge", "confidence",
                "predicted_log_return", "predicted_pct_return",
                "current_volatility", "current_price", "signal"):
        assert key in out, key
    assert len(out["rmse_scores"]) == 3  # fast preset cv_folds
    assert 0.0 <= out["directional_accuracy"] <= 1.0
    assert out["signal"] in (-1, 0, 1)
    assert out["current_price"] > 0
    assert model.feature_importance is not None
    assert len(model.feature_importance["feature"]) == 36


def test_forecast_model_insufficient_data_returns_none():
    ohlcv = generate_ohlcv(n_days=260, seed=1)  # < min_data_points post-drop
    data = features_to_numpy(ohlcv["Open"], ohlcv["High"], ohlcv["Low"],
                             ohlcv["Close"], ohlcv["Volume"])
    model = ForecastModel(forecast_horizon=20, config=ModelConfig.full())
    assert model.cross_validate(data) is None


def test_forecast_model_insufficient_features_returns_none(feature_data):
    slim = {k: feature_data[k] for k in
            ("Close", "rvol_20", "log_ret", "roc_5", "roc_10")}
    model = ForecastModel(forecast_horizon=20, config=ModelConfig.fast())
    assert model.cross_validate(slim) is None
