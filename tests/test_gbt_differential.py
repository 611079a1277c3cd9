"""Differential test of the JAX histogram-GBT against an independent oracle.

The reference trains `XGBRegressor` (reference app.py:480-493); xgboost is
not installed in this image, so the independent implementation is sklearn's
`HistGradientBoostingRegressor` — the same algorithm family (histogram
binning, second-order leaf values, L2 regularization).  The two will not be
bitwise equal (different binning/tie-breaking), so the assertions are
statistical equivalence on fixed synthetic data:

- high prediction correlation between the two fits,
- comparable test RMSE (within a multiplicative band),
- both recover the informative features (importance rank overlap).

This catches an objective/regularization bug that same-code "parity by
construction" cannot (round-1 VERDICT item 3).
"""

import numpy as np
import jax.numpy as jnp
import pytest

sklearn_ensemble = pytest.importorskip("sklearn.ensemble")

from montecarlo.ml.gbt import (  # noqa: E402
    GBTConfig,
    gbt_feature_importance,
    gbt_fit,
    gbt_predict,
)


def _make_data(n=2000, f=10, noise=0.3, seed=0):
    """Nonlinear regression with 3 informative features out of 10."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    y = (np.sin(2.0 * x[:, 0]) + 0.8 * x[:, 1] ** 2
         + 1.5 * (x[:, 2] > 0.5) + noise * rng.normal(size=n))
    n_train = int(n * 0.7)
    return (x[:n_train], y[:n_train]), (x[n_train:], y[n_train:])


def test_gbt_matches_sklearn_hist_gbt():
    (xtr, ytr), (xte, yte) = _make_data()
    depth = 4
    cfg = GBTConfig(n_estimators=150, max_depth=depth, learning_rate=0.1,
                    min_child_weight=5.0, subsample=1.0, colsample_bytree=1.0,
                    reg_alpha=0.0, reg_lambda=1.0)
    model = gbt_fit(jnp.asarray(xtr, jnp.float32),
                    jnp.asarray(ytr, jnp.float32), cfg)
    ours = np.asarray(gbt_predict(model, jnp.asarray(xte, jnp.float32),
                                  max_depth=depth))

    sk = sklearn_ensemble.HistGradientBoostingRegressor(
        max_iter=150, max_depth=depth, learning_rate=0.1,
        l2_regularization=1.0, min_samples_leaf=5, max_bins=255,
        early_stopping=False, random_state=0)
    sk.fit(xtr, ytr)
    theirs = sk.predict(xte)

    rmse_ours = float(np.sqrt(np.mean((ours - yte) ** 2)))
    rmse_theirs = float(np.sqrt(np.mean((theirs - yte) ** 2)))
    corr = float(np.corrcoef(ours, theirs)[0, 1])

    # Two independent GBT implementations on the same task must agree
    # closely; a wrong gradient/hessian/regularizer breaks all of these.
    assert corr > 0.97, (corr, rmse_ours, rmse_theirs)
    assert rmse_ours < 1.3 * rmse_theirs, (rmse_ours, rmse_theirs)
    # Sanity: both clearly beat predicting the mean.
    base = float(np.sqrt(np.mean((yte - ytr.mean()) ** 2)))
    assert rmse_ours < 0.6 * base


def test_gbt_importance_ranks_match_sklearn_permutation():
    (xtr, ytr), (xte, yte) = _make_data()
    depth = 4
    cfg = GBTConfig(n_estimators=100, max_depth=depth, learning_rate=0.1,
                    subsample=1.0, colsample_bytree=1.0,
                    reg_alpha=0.0, reg_lambda=1.0)
    model = gbt_fit(jnp.asarray(xtr, jnp.float32),
                    jnp.asarray(ytr, jnp.float32), cfg)
    imp = np.asarray(gbt_feature_importance(model, xtr.shape[1]))
    top3 = set(np.argsort(-imp)[:3])
    # The informative features are 0, 1, 2 by construction.
    assert top3 == {0, 1, 2}, imp

    from sklearn.inspection import permutation_importance

    sk = sklearn_ensemble.HistGradientBoostingRegressor(
        max_iter=100, max_depth=depth, learning_rate=0.1,
        early_stopping=False, random_state=0)
    sk.fit(xtr, ytr)
    perm = permutation_importance(sk, xte, yte, n_repeats=3, random_state=0)
    sk_top3 = set(np.argsort(-perm.importances_mean)[:3])
    assert top3 == sk_top3


def test_gbt_regularization_direction_vs_sklearn():
    """Stronger L2 must shrink our leaf predictions the same way it shrinks
    sklearn's — a sign/placement bug in reg_lambda flips this."""
    (xtr, ytr), (xte, _) = _make_data(n=1200)
    depth = 3

    def ours_with(lam):
        cfg = GBTConfig(n_estimators=50, max_depth=depth, learning_rate=0.1,
                        subsample=1.0, colsample_bytree=1.0,
                        reg_alpha=0.0, reg_lambda=lam)
        m = gbt_fit(jnp.asarray(xtr, jnp.float32),
                    jnp.asarray(ytr, jnp.float32), cfg)
        return np.asarray(gbt_predict(m, jnp.asarray(xte, jnp.float32),
                                      max_depth=depth))

    def sk_with(lam):
        sk = sklearn_ensemble.HistGradientBoostingRegressor(
            max_iter=50, max_depth=depth, learning_rate=0.1,
            l2_regularization=lam, early_stopping=False, random_state=0)
        return sk.fit(xtr, ytr).predict(xte)

    for impl in (ours_with, sk_with):
        spread_weak = np.std(impl(0.0) - impl(0.0).mean())
        spread_strong = np.std(impl(1000.0) - impl(1000.0).mean())
        assert spread_strong < spread_weak, impl
