"""The walk-forward-validated forecast model — `ProfessionalModel` parity.

Mirrors the reference (reference app.py:400-581): same 36 ``FEATURE_COLS``,
same forward-cumulative-log-return target (app.py:443), same
TimeSeriesSplit walk-forward CV with per-fold scaling (app.py:446-519), the
same result-dict keys, the 52% edge threshold and confidence scale
(app.py:517-518), and the same train-then-predict-last-row flow
(app.py:521-581).

Difference from the reference: the reference fits ``cv_folds`` XGBoost models
sequentially through C++/OpenMP; here all folds are **one vmapped JAX
histogram-GBT program** — masked sample weights give every fold the same
static shapes, so fold parallelism is free data parallelism on the device.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from montecarlo.config import ModelConfig
from montecarlo.ml.gbt import (
    GBTConfig,
    gbt_feature_importance,
    gbt_fit,
    gbt_predict,
)
from montecarlo.ml.scaler import scaler_fit, scaler_transform
from montecarlo.ml.splits import split_bounds

#: The reference's 36 model features (app.py:404-424).
#: Edge / confidence thresholds (reference app.py:517-518) — shared with
#: the batched scanner so the two paths can never disagree.
EDGE_THRESHOLD = 0.52
CONFIDENCE_BASE = 0.50
CONFIDENCE_SCALE = 0.10


def edge_and_confidence(avg_da: float) -> tuple:
    """(has_edge, confidence in [0,1]) from average directional accuracy."""
    return (avg_da > EDGE_THRESHOLD,
            min(1.0, (avg_da - CONFIDENCE_BASE) / CONFIDENCE_SCALE))


def prepare_matrix(data, horizon: int, extra_keys=("Close", "rvol_20")):
    """Target + feature-matrix assembly shared by the model and the
    backtester: attach the forward-return target, drop NaN-target rows,
    stack available FEATURE_COLS, and carry the requested passthrough
    columns (aligned by the same mask)."""
    target = make_target(data["log_ret"], horizon)
    ok = ~np.isnan(target)
    feats = [f for f in FEATURE_COLS if f in data]
    x = np.stack([np.asarray(data[f], np.float64)[ok] for f in feats],
                 axis=1) if feats else np.zeros((int(ok.sum()), 0))
    y = target[ok]
    extras = {k: np.asarray(data[k])[ok] for k in extra_keys if k in data}
    return x, y, feats, extras


FEATURE_COLS = [
    # Volatility
    "rvol_20", "vol_ratio_5_20", "vol_ratio_20_60", "vol_change", "atr_pct",
    # Momentum
    "roc_5", "roc_10", "roc_20", "roc_60",
    "dist_sma_20", "dist_sma_50", "dist_sma_100", "dist_sma_200",
    # Oscillators
    "rsi_norm", "stoch_norm", "macd_hist_norm", "bb_position", "kc_position",
    # Volume
    "rel_volume", "volume_trend", "obv_pct_change", "vpt_signal",
    # Regime
    "high_vol_regime", "trending_regime", "mean_revert_regime",
    # Lagged
    "ret_lag_1", "ret_lag_2", "ret_lag_5",
    # Higher-order
    "ret_skew_proxy", "ret_range_norm",
    # Interaction
    "momentum_vol_adj", "rsi_vol_interaction", "volume_momentum",
    # Trend
    "trend_strength", "price_position", "uptrend",
]


def make_target(log_ret, horizon: int):
    """Forward cumulative log return: rolling(h).sum().shift(-h)
    (app.py:443).  Returns (T,) with NaNs at the tail."""
    log_ret = np.asarray(log_ret, np.float64)
    csum = np.cumsum(np.where(np.isnan(log_ret), 0.0, log_ret))
    nan_c = np.cumsum(np.isnan(log_ret).astype(np.int64))
    out = np.full_like(log_ret, np.nan)
    # rolling(h).sum() at t covers [t-h+1, t]; shifted by -h -> covers
    # [t+1, t+h].
    t = np.arange(len(log_ret))
    hi = t + horizon
    ok = hi < len(log_ret)
    hi_c = np.clip(hi, 0, len(log_ret) - 1)
    window_sum = csum[hi_c] - csum[t]
    window_nan = nan_c[hi_c] - nan_c[t]
    out[ok & (window_nan == 0)] = window_sum[ok & (window_nan == 0)]
    out[~(ok & (window_nan == 0))] = np.nan
    return out


def _gbt_cfg(config: ModelConfig, *, regularized: bool = True) -> GBTConfig:
    """Reference XGB hyperparameters (app.py:480-493).  The backtester's
    retrain model omits reg_alpha/reg_lambda (app.py:732-743) — XGBoost's
    defaults there are alpha=0, lambda=1."""
    return GBTConfig(
        n_estimators=config.n_estimators,
        max_depth=config.max_depth,
        learning_rate=config.learning_rate,
        min_child_weight=5.0,
        subsample=0.8,
        colsample_bytree=0.8,
        reg_alpha=0.1 if regularized else 0.0,
        reg_lambda=1.0,
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def _fit_fold(x, y, train_mask, cfg: GBTConfig):
    """Scale on the train window, fit, predict everything."""
    scaler = scaler_fit(x, weights=train_mask)
    xs = scaler_transform(scaler, x)
    model = gbt_fit(xs, y, cfg, weights=train_mask, seed=42)
    return gbt_predict(model, xs, max_depth=cfg.max_depth)


_fit_folds = jax.jit(
    jax.vmap(_fit_fold, in_axes=(None, None, 0, None)),
    static_argnames=("cfg",))


class ForecastModel:
    """Walk-forward cross-validated GBT return forecaster."""

    FEATURE_COLS = FEATURE_COLS

    def __init__(self, forecast_horizon: int = 20,
                 config: ModelConfig | None = None):
        self.forecast_horizon = forecast_horizon
        self.config = config or ModelConfig()
        self.model = None
        self.scaler = None
        self.feature_importance = None
        self.cv_results: Dict = {}
        self.available_features: list[str] = []

    # -- data preparation ---------------------------------------------------

    def _get_available_features(self, data: Dict[str, np.ndarray]):
        return [f for f in FEATURE_COLS if f in data]

    def _prepare(self, data: Dict[str, np.ndarray]):
        """Attach the target and drop rows with NaN target (the feature dict
        is already NaN-free after quant.finalize)."""
        cached = getattr(self, "_prep_cache", None)
        if cached is not None and cached[0] is data:
            return cached[1]
        out = prepare_matrix(data, self.forecast_horizon)
        # Memoize on object identity: train() always re-prepares the same
        # dict cross_validate just prepared (doubling host-side work per
        # ticker in a scan).  Identity, not equality: a mutated dict is a
        # different object in every supported call pattern.
        self._prep_cache = (data, out)
        return out

    # -- the reference API ----------------------------------------------------

    def cross_validate(self, data: Dict[str, np.ndarray],
                       progress_callback=None) -> Optional[Dict]:
        """Walk-forward CV (app.py:446-519).  Returns the reference's dict
        or None on insufficient data/features."""
        x, y, feats, _ = self._prepare(data)
        if len(y) < self.config.min_data_points:
            return None
        self.available_features = feats
        if len(feats) < 10:
            return None
        if progress_callback:
            progress_callback(
                f"CV {self.config.cv_folds} folds (batched on device)")

        n = len(y)
        bounds = split_bounds(n, self.config.cv_folds)
        idx = np.arange(n)
        train_masks = np.stack([(idx < tr).astype(np.float32)
                                for tr, _ in bounds])
        cfg = _gbt_cfg(self.config)
        preds = np.asarray(_fit_folds(
            jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
            jnp.asarray(train_masks), cfg))

        rmse_scores, da_scores, fold_predictions = [], [], []
        for k, (tr, te) in enumerate(bounds):
            p, a = preds[k, tr:te], y[tr:te]
            rmse_scores.append(float(np.sqrt(np.mean((p - a) ** 2))))
            da_scores.append(float(np.mean(np.sign(p) == np.sign(a))))
            fold_predictions.append({"actual": a, "predicted": p})

        avg_da = float(np.mean(da_scores))
        has_edge, confidence = edge_and_confidence(avg_da)
        return {
            "rmse_mean": float(np.mean(rmse_scores)),
            "rmse_std": float(np.std(rmse_scores)),
            "rmse_scores": rmse_scores,
            "directional_accuracy": avg_da,
            "da_std": float(np.std(da_scores)),
            "da_scores": da_scores,
            "fold_predictions": fold_predictions,
            "has_edge": has_edge,
            "confidence": confidence,
        }

    def train(self, data: Dict[str, np.ndarray],
              progress_callback=None) -> Optional[Dict]:
        """CV gate -> refit on all data -> predict the latest row
        (app.py:521-581)."""
        if progress_callback:
            progress_callback("Running cross-validation...")
        cv = self.cross_validate(data, progress_callback)
        if cv is None:
            return None
        self.cv_results = cv

        if progress_callback:
            progress_callback("Training final model...")
        x, y, feats, extras = self._prepare(data)
        xj = jnp.asarray(x, jnp.float32)
        self.scaler = scaler_fit(xj)
        xs = scaler_transform(self.scaler, xj)
        cfg = _gbt_cfg(self.config)
        self.model = gbt_fit(xs, jnp.asarray(y, jnp.float32), cfg, seed=42)

        imp = np.asarray(gbt_feature_importance(self.model, len(feats)))
        order = np.argsort(-imp)
        self.feature_importance = {
            "feature": [feats[i] for i in order],
            "importance": imp[order],
        }

        last = scaler_transform(self.scaler, xj[-1:])
        pred_log_return = float(
            gbt_predict(self.model, last, max_depth=cfg.max_depth)[0])
        cv["predicted_log_return"] = pred_log_return
        cv["predicted_pct_return"] = (np.exp(pred_log_return) - 1.0) * 100.0
        # Parity note: these come from the LAST TARGET-VALID row, i.e. one
        # horizon before the latest bar — exactly what the reference does
        # (app.py:577-578 reads them from the target-dropped frame), even
        # though its own MC seeds var0 from the full frame (app.py:606).
        # Faithful reproduction of the reference, inconsistency included.
        cv["current_volatility"] = float(extras["rvol_20"][-1])
        cv["current_price"] = float(extras["Close"][-1])
        cv["signal"] = (1 if pred_log_return > 0
                        else -1 if pred_log_return < 0 else 0)
        return cv
