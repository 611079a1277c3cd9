"""XGBoost-objective algebra fixtures for the JAX histogram GBT.

Real XGBoost is not installable in this image (verdict r2 missing #2), so
these tests pin the *documented* XGBoost formulas exactly, with an
independent brute-force oracle over every candidate split — the class of
objective/regularization bug no correlation-based differential test
(`test_gbt_differential.py`) can catch:

    gain       = S(G_L, H_L) + S(G_R, H_R) - S(G, H)
    S(G, H)    = soft(G, alpha)^2 / (H + lambda)
    soft(G, a) = sign(G) * max(|G| - a, 0)
    leaf       = -soft(G, alpha) / (H + lambda) * learning_rate

with min_child_weight lower-bounding each child's hessian sum
(reference hyperparameters: app.py:480-493).
"""

import numpy as np
import pytest

from montecarlo.ml.gbt import (
    GBTConfig,
    N_BINS,
    bin_features,
    gbt_fit,
    gbt_predict,
    quantile_bin_edges,
)


def _soft(g, alpha):
    return np.sign(g) * max(abs(g) - alpha, 0.0)


def _score(g, h, alpha, lam):
    if h + lam <= 0:
        return 0.0  # empty child at lambda=0: soft(0, a) = 0, score 0
    return _soft(g, alpha) ** 2 / (h + lam)


def _leaf(g, h, alpha, lam, lr):
    return -_soft(g, alpha) / (h + lam) * lr


def _brute_force_split(xbin, g, h, alpha, lam, mcw):
    """Independent oracle: evaluate the gain of EVERY candidate
    (feature, bin) split in the same flattened order as the histogram
    implementation (feature-major, first maximum wins)."""
    n, n_feat = xbin.shape
    best = (-np.inf, None, None)
    for f in range(n_feat):
        for b in range(N_BINS - 1):
            left = xbin[:, f] <= b
            hl, hr = h[left].sum(), h[~left].sum()
            if hl < mcw or hr < mcw:
                continue
            gl, gr = g[left].sum(), g[~left].sum()
            gain = (_score(gl, hl, alpha, lam) + _score(gr, hr, alpha, lam)
                    - _score(gl + gr, hl + hr, alpha, lam))
            if gain > best[0]:
                best = (gain, f, b)
    return best


def _cfg(**kw):
    # Deterministic: no row/feature subsampling, one depth-1 tree.
    base = dict(n_estimators=1, max_depth=1, learning_rate=0.5,
                min_child_weight=0.0, subsample=1.0, colsample_bytree=1.0,
                reg_alpha=0.0, reg_lambda=1.0)
    base.update(kw)
    return GBTConfig(**base)


def _first_tree_stats(x, y, cfg):
    """(xbin, g, h) of the first boosting round: pred = base = mean(y),
    squared loss -> g_i = base - y_i, h_i = 1."""
    import jax.numpy as jnp

    w = jnp.ones(len(y), jnp.float32)
    edges = np.asarray(quantile_bin_edges(jnp.asarray(x, jnp.float32), w))
    xbin = np.asarray(bin_features(np.asarray(x, np.float32), edges))
    base = float(np.mean(y))
    g = base - np.asarray(y, np.float64)
    h = np.ones(len(y), np.float64)
    return xbin, g, h, base


@pytest.mark.parametrize("alpha,lam", [(0.0, 1.0), (0.3, 2.5), (1.0, 0.0)])
def test_single_split_gain_and_leaves_match_xgboost_algebra(alpha, lam):
    """The fitted tree's split choice, recorded gain, and both leaf values
    must equal the hand-evaluated XGBoost formulas exactly."""
    x = np.array([[0.0], [1.0], [2.0], [3.0], [4.0], [5.0]])
    y = np.array([0.0, 0.2, 0.1, 2.0, 2.5, 2.2])
    cfg = _cfg(reg_alpha=alpha, reg_lambda=lam)
    model = gbt_fit(x, y, cfg)

    xbin, g, h, base = _first_tree_stats(x, y, cfg)
    exp_gain, exp_feat, exp_bin = _brute_force_split(
        xbin, g, h, alpha, lam, cfg.min_child_weight)
    assert exp_gain > 0
    assert int(model.split_feature[0, 0]) == exp_feat
    assert int(model.split_bin[0, 0]) == exp_bin
    np.testing.assert_allclose(float(model.split_gain[0, 0]), exp_gain,
                               rtol=1e-5)
    left = xbin[:, exp_feat] <= exp_bin
    exp_leaves = [
        _leaf(g[left].sum(), h[left].sum(), alpha, lam, cfg.learning_rate),
        _leaf(g[~left].sum(), h[~left].sum(), alpha, lam,
              cfg.learning_rate),
    ]
    np.testing.assert_allclose(np.asarray(model.leaf_value[0]), exp_leaves,
                               rtol=1e-5, atol=1e-7)
    # Predictions: base + the leaf of each side.
    pred = np.asarray(gbt_predict(model, np.asarray(x, np.float32)))
    exp_pred = base + np.where(left, exp_leaves[0], exp_leaves[1])
    np.testing.assert_allclose(pred, exp_pred, rtol=1e-5)


def test_min_child_weight_forbids_small_children():
    """The unconstrained best split isolates the outlier row; with
    min_child_weight=2 that child (hessian sum 1) is infeasible and the
    tree must pick the constrained optimum instead — the boundary case the
    sklearn differential cannot pin."""
    x = np.array([[0.0], [1.0], [2.0], [3.0], [4.0], [5.0]])
    y = np.array([10.0, 0.1, 0.0, 0.2, 0.1, 0.0])

    free = _cfg(min_child_weight=0.0)
    xbin, g, h, _ = _first_tree_stats(x, y, free)
    gain0, feat0, bin0 = _brute_force_split(xbin, g, h, 0.0, 1.0, 0.0)
    m_free = gbt_fit(x, y, free)
    assert int(m_free.split_bin[0, 0]) == bin0
    assert (xbin[:, feat0] <= bin0).sum() == 1  # isolates the outlier

    mcw = 2.0
    constrained = _cfg(min_child_weight=mcw)
    gain2, feat2, bin2 = _brute_force_split(xbin, g, h, 0.0, 1.0, mcw)
    assert bin2 != bin0 and gain2 < gain0
    m = gbt_fit(x, y, constrained)
    assert int(m.split_bin[0, 0]) == bin2
    np.testing.assert_allclose(float(m.split_gain[0, 0]), gain2, rtol=1e-5)
    left = xbin[:, 0] <= bin2
    assert left.sum() >= mcw and (~left).sum() >= mcw


def test_alpha_soft_threshold_zeroes_small_leaves():
    """reg_alpha > |G| of a child must zero that child's leaf exactly
    (XGBoost's L1 thresholding), not merely shrink it."""
    x = np.array([[0.0], [1.0], [2.0], [3.0]])
    y = np.array([0.0, 0.0, 1.0, 1.0])
    # First-round child gradients: each child has |G| = 1.0 (2 rows of
    # residual +-0.5). alpha=1.2 > 1.0 -> both leaves exactly 0.
    m = gbt_fit(x, y, _cfg(reg_alpha=1.2, reg_lambda=1.0))
    np.testing.assert_array_equal(np.asarray(m.leaf_value[0]), [0.0, 0.0])
    # alpha just below: leaf = -soft(G, a)/(H+lam)*lr with soft = +-0.2.
    m2 = gbt_fit(x, y, _cfg(reg_alpha=0.8, reg_lambda=1.0))
    np.testing.assert_allclose(
        np.asarray(m2.leaf_value[0]),
        [_leaf(1.0, 2.0, 0.8, 1.0, 0.5), _leaf(-1.0, 2.0, 0.8, 1.0, 0.5)],
        rtol=1e-5)


def test_no_positive_gain_keeps_sentinel_and_base_prediction():
    """Constant targets: every gain is <= 0, the node must record the
    no-split sentinel (bin == N_BINS, gain 0) and predict the base."""
    x = np.array([[0.0], [1.0], [2.0], [3.0]])
    y = np.full(4, 1.5)
    m = gbt_fit(x, y, _cfg())
    assert int(m.split_bin[0, 0]) == N_BINS
    assert float(m.split_gain[0, 0]) == 0.0
    pred = np.asarray(gbt_predict(m, np.asarray(x, np.float32)))
    np.testing.assert_allclose(pred, 1.5, rtol=1e-6)


def test_depth_two_recursion_matches_per_node_oracle():
    """Level-wise depth-2 growth: each level's split must equal the oracle
    applied to that node's own sample set (gains conditional on the level-1
    partition) — pins the recursion, not just the root."""
    # Noise-free, well-separated gains with min_child_weight forbidding
    # 1-sample splits: near-tied candidates would let f32-vs-f64 rounding
    # legitimately flip the argmax and make the fixture flaky.
    rng = np.random.default_rng(7)
    x = rng.normal(size=(64, 3)).astype(np.float64)
    y = (np.where(x[:, 0] > 0, 2.0, -1.0)
         + np.where(x[:, 1] > 0.5, 0.7, 0.0))
    cfg = _cfg(max_depth=2, reg_alpha=0.1, reg_lambda=1.0,
               min_child_weight=4.0)
    model = gbt_fit(x, y, cfg)

    xbin, g, h, base = _first_tree_stats(x, y, cfg)
    gain, feat, b = _brute_force_split(xbin, g, h, 0.1, 1.0, 4.0)
    assert (int(model.split_feature[0, 0]), int(model.split_bin[0, 0])) \
        == (feat, b)
    left = xbin[:, feat] <= b
    saw_split = saw_sentinel = False
    for child, mask in ((1, left), (2, ~left)):
        cg, cf, cb = _brute_force_split(xbin[mask], g[mask], h[mask],
                                        0.1, 1.0, 4.0)
        if cg is not None and cg > 0:
            saw_split = True
            assert int(model.split_feature[0, child]) == cf, child
            assert int(model.split_bin[0, child]) == cb, child
            np.testing.assert_allclose(float(model.split_gain[0, child]),
                                       cg, rtol=1e-4)
        else:
            # Oracle best gain <= 0 (the alpha penalty can make every
            # refinement unprofitable): the node must record the no-split
            # sentinel, not force a negative-gain split.
            saw_sentinel = True
            assert int(model.split_bin[0, child]) == N_BINS, child
            assert float(model.split_gain[0, child]) == 0.0, child
    # The fixture exercises BOTH outcomes at depth 2 (x1 refines the left
    # branch; the right branch's refinement is alpha-unprofitable).
    assert saw_split and saw_sentinel
