"""Histogram gradient-boosted regression trees, entirely in JAX.

The reference trains `XGBRegressor` models (reference app.py:480-493,
547-560, 732-743: n_estimators, max_depth, learning_rate, min_child_weight=5,
subsample=0.8, colsample_bytree=0.8, reg_alpha, reg_lambda).  XGBoost is
C++/OpenMP; this is the JAX rebuild:

- features quantile-binned to uint8 (256 bins) — histogram method;
- level-wise tree growth to a fixed ``max_depth`` (XGBoost's policy for
  small depths): every tensor shape is static, so the **entire fit is one
  XLA program** — jittable, differentiable-free, and `vmap`-able over CV
  folds or walk-forward retrain points (the reference retrains sequentially,
  app.py:723-744; here all retrains train as one batched device program);
- sample weights everywhere: a 0/1 weight mask turns variable-length
  training windows into static shapes (no recompile per fold/window);
- the XGBoost objective: squared loss, L1 soft-thresholding (reg_alpha),
  L2 (reg_lambda), min_child_weight, per-tree row subsampling and feature
  subsampling driven by counter-based RNG.

Nodes that find no positive-gain split send every sample left with a
sentinel threshold, which reproduces XGBoost's early-stop predictions
without dynamic shapes (the surviving child inherits the parent's samples
and therefore its would-be leaf value).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

N_BINS = 256


class GBTConfig(NamedTuple):
    """Static hyperparameters (hashable — jit static argument)."""

    n_estimators: int = 100
    max_depth: int = 3
    learning_rate: float = 0.05
    min_child_weight: float = 5.0
    subsample: float = 0.8
    colsample_bytree: float = 0.8
    reg_alpha: float = 0.1
    reg_lambda: float = 1.0


class GBTModel(NamedTuple):
    """A fitted forest (pytree of arrays; leading axes may be vmapped)."""

    edges: jnp.ndarray        # (F, N_BINS - 1) bin edges
    base: jnp.ndarray         # scalar base prediction
    split_feature: jnp.ndarray  # (T, n_internal) int32
    split_bin: jnp.ndarray      # (T, n_internal) int32 (bin <= thr -> left)
    leaf_value: jnp.ndarray     # (T, n_leaves) f32, learning rate folded in
    split_gain: jnp.ndarray     # (T, n_internal) f32, 0 where no split


def _soft_threshold(g, alpha):
    return jnp.sign(g) * jnp.maximum(jnp.abs(g) - alpha, 0.0)


def _score(g, h, alpha, lam):
    # Guarded division: with reg_lambda=0 and min_child_weight=0 an
    # empty-child candidate has g=h=0 and the naive 0/0 NaN would poison
    # the argmax into rejecting EVERY split (caught by the XGBoost-algebra
    # fixtures). The correct limit is score 0 (soft(0, a) = 0).
    t = _soft_threshold(g, alpha)
    denom = h + lam
    safe = jnp.where(denom > 0, denom, 1.0)
    return jnp.where(denom > 0, jnp.square(t) / safe, 0.0)


def _leaf_weight(g, h, alpha, lam):
    denom = h + lam
    safe = jnp.where(denom > 0, denom, 1.0)
    return jnp.where(denom > 0, -_soft_threshold(g, alpha) / safe, 0.0)


def quantile_bin_edges(x, w):
    """Per-feature weighted-quantile bin edges.

    Args:
      x: (n, F) raw features; w: (n,) weights (0 excludes a row).
    Returns:
      (F, N_BINS - 1) edges.  Bin of a value v is
      ``searchsorted(edges, v, side='right')``.
    """
    n = x.shape[0]

    def per_feature(col):
        # Excluded rows (w == 0) sort to the end so their values can never
        # become edges (no leakage from masked-out windows).
        col = jnp.where(w > 0, col, jnp.inf)
        order = jnp.argsort(col)
        xs = col[order]
        cw = jnp.cumsum(w[order])
        total = cw[-1]
        targets = (jnp.arange(1, N_BINS, dtype=x.dtype) / N_BINS) * total
        idx = jnp.clip(jnp.searchsorted(cw, targets), 0, n - 1)
        return xs[idx]

    return jax.vmap(per_feature, in_axes=1)(x)


def bin_features(x, edges):
    """(n, F) raw -> (n, F) int32 bin indices in [0, N_BINS)."""

    def per_feature(col, e):
        return jnp.searchsorted(e, col, side="right").astype(jnp.int32)

    return jax.vmap(per_feature, in_axes=(1, 0), out_axes=1)(x, edges)


def _build_tree(xbin, g, h, feat_mask, cfg: GBTConfig):
    """Grow one level-wise tree. Returns (split_feature, split_bin,
    leaf_value) with shapes ((n_internal,), (n_internal,), (n_leaves,))."""
    n, n_feat = xbin.shape
    max_depth = cfg.max_depth
    n_internal = 2 ** max_depth - 1
    alpha = jnp.asarray(cfg.reg_alpha, g.dtype)
    lam = jnp.asarray(cfg.reg_lambda, g.dtype)

    split_feature = jnp.zeros((n_internal,), jnp.int32)
    split_bin = jnp.full((n_internal,), N_BINS, jnp.int32)  # all -> left
    split_gain = jnp.zeros((n_internal,), g.dtype)
    node = jnp.zeros((n,), jnp.int32)  # node id within the current level

    for depth in range(max_depth):
        n_nodes = 2 ** depth
        level_base = n_nodes - 1  # heap offset of this level

        # Histograms: (F, n_nodes * N_BINS) via segment-sum per feature.
        seg = node[:, None] * N_BINS + xbin  # (n, F)

        def hists(vals, seg=seg, n_nodes=n_nodes):
            def per_feature(s):
                return jax.ops.segment_sum(vals, s,
                                           num_segments=n_nodes * N_BINS)
            return jax.vmap(per_feature, in_axes=1)(seg).reshape(
                n_feat, n_nodes, N_BINS)

        hg = hists(g)  # (F, nodes, B)
        hh = hists(h)

        # Split "bin <= b" for b in [0, B-1): left stats are inclusive
        # prefix sums; evaluate gain for every (feature, node, b).
        gl = jnp.cumsum(hg, axis=-1)[..., :-1]
        hl = jnp.cumsum(hh, axis=-1)[..., :-1]
        gt = jnp.sum(hg, axis=-1, keepdims=True)
        ht = jnp.sum(hh, axis=-1, keepdims=True)
        gr = gt - gl
        hr = ht - hl
        gain = (_score(gl, hl, alpha, lam) + _score(gr, hr, alpha, lam)
                - _score(gt, ht, alpha, lam))
        ok = ((hl >= cfg.min_child_weight) & (hr >= cfg.min_child_weight)
              & feat_mask[:, None, None])
        gain = jnp.where(ok, gain, -jnp.inf)

        flat = gain.transpose(1, 0, 2).reshape(n_nodes, n_feat * (N_BINS - 1))
        best = jnp.argmax(flat, axis=1)
        best_gain = jnp.take_along_axis(flat, best[:, None], axis=1)[:, 0]
        best_feat = (best // (N_BINS - 1)).astype(jnp.int32)
        best_bin = (best % (N_BINS - 1)).astype(jnp.int32)
        # No positive gain -> no split: sentinel keeps every sample left.
        no_split = ~(best_gain > 0)
        best_feat = jnp.where(no_split, 0, best_feat)
        best_bin = jnp.where(no_split, N_BINS, best_bin)

        idx = level_base + jnp.arange(n_nodes)
        split_feature = split_feature.at[idx].set(best_feat)
        split_bin = split_bin.at[idx].set(best_bin)
        split_gain = split_gain.at[idx].set(
            jnp.where(no_split, 0.0, best_gain))

        # Route samples.
        sample_bin = jnp.take_along_axis(xbin, best_feat[node][:, None],
                                         axis=1)[:, 0]
        go_right = sample_bin > best_bin[node]
        node = node * 2 + go_right.astype(jnp.int32)

    # Leaf values from the final partition.
    n_leaves = 2 ** max_depth
    leaf_g = jax.ops.segment_sum(g, node, num_segments=n_leaves)
    leaf_h = jax.ops.segment_sum(h, node, num_segments=n_leaves)
    leaf_value = (_leaf_weight(leaf_g, leaf_h, alpha, lam)
                  * cfg.learning_rate)
    # `node` is every training row's final leaf — returned so boosting can
    # apply the update as leaf_value[node] instead of re-routing the whole
    # matrix through _predict_binned (max_depth rounds of gathers saved).
    return split_feature, split_bin, leaf_value, split_gain, node


def _predict_binned(xbin, split_feature, split_bin, leaf_value,
                    max_depth: int):
    """Predict one tree on binned features."""
    n = xbin.shape[0]
    node = jnp.zeros((n,), jnp.int32)
    for _ in range(max_depth):
        f = split_feature[node]
        b = split_bin[node]
        sample_bin = jnp.take_along_axis(xbin, f[:, None], axis=1)[:, 0]
        go_right = sample_bin > b
        node = node * 2 + 1 + go_right.astype(jnp.int32)
    leaf = node - (2 ** max_depth - 1)
    return leaf_value[leaf]


@functools.partial(jax.jit, static_argnames=("cfg",))
def gbt_fit(x, y, cfg: GBTConfig, *, weights=None, seed=0) -> GBTModel:
    """Fit a forest on (n, F) features / (n,) targets.

    ``weights``: optional (n,) — 0 excludes a row entirely (masked windows).
    ``seed``: drives row/feature subsampling (counter-based, reproducible).
    """
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    n, n_feat = x.shape
    w = (jnp.ones((n,), jnp.float32) if weights is None
         else jnp.asarray(weights, jnp.float32))

    edges = quantile_bin_edges(x, w)
    xbin = bin_features(x, edges)

    w_total = jnp.maximum(jnp.sum(w), 1.0)
    base = jnp.sum(y * w) / w_total

    from montecarlo.rng.normal import uniform_draw

    def boost(carry, t):
        pred = carry
        # Row subsample (Bernoulli, rate cfg.subsample) and feature
        # subsample, both keyed by (seed, tree index) — reproducible.
        row_ids = jnp.arange(n, dtype=jnp.uint32)
        u_rows = uniform_draw(0, 11, row_ids, t.astype(jnp.uint32),
                              jnp.float32)
        sub_w = w * (u_rows < cfg.subsample)
        feat_ids = jnp.arange(n_feat, dtype=jnp.uint32)
        u_feat = uniform_draw(0, 13, feat_ids, t.astype(jnp.uint32),
                              jnp.float32)
        feat_mask = u_feat < cfg.colsample_bytree
        # Never mask every feature out.
        feat_mask = feat_mask.at[0].set(
            feat_mask[0] | ~jnp.any(feat_mask))

        grad = (pred - y) * sub_w
        hess = sub_w
        sf, sb, lv, sg, node = _build_tree(xbin, grad, hess, feat_mask, cfg)
        pred = pred + lv[node]
        return pred, (sf, sb, lv, sg)

    init_pred = jnp.full((n,), base, jnp.float32)
    # Fold the seed into the subsample streams via the tree index offset.
    t_idx = (jnp.arange(cfg.n_estimators, dtype=jnp.int32)
             + jnp.asarray(seed, jnp.int32) * 65536)
    _, (sfs, sbs, lvs, sgs) = jax.lax.scan(boost, init_pred, t_idx)
    return GBTModel(edges=edges, base=base, split_feature=sfs,
                    split_bin=sbs, leaf_value=lvs, split_gain=sgs)


@functools.partial(jax.jit, static_argnames=("max_depth",))
def gbt_predict(model: GBTModel, x, *, max_depth: int | None = None):
    """Predict (n,) targets for (n, F) raw features.

    ``max_depth`` is derived from the model's leaf array (2^depth leaves);
    passing a mismatching value used to mis-route every sample silently,
    so an explicit value is now validated instead of trusted.
    """
    depth = int(model.leaf_value.shape[-1]).bit_length() - 1
    if max_depth is not None and max_depth != depth:
        raise ValueError(
            f"max_depth={max_depth} does not match the model "
            f"({model.leaf_value.shape[-1]} leaves -> depth {depth})")
    x = jnp.asarray(x, jnp.float32)
    xbin = bin_features(x, model.edges)

    def one_tree(pred, tree):
        sf, sb, lv = tree
        return pred + _predict_binned(xbin, sf, sb, lv, depth), None

    init = jnp.full((x.shape[0],), model.base, jnp.float32)
    pred, _ = jax.lax.scan(
        one_tree, init,
        (model.split_feature, model.split_bin, model.leaf_value))
    return pred


def gbt_feature_importance(model: GBTModel, n_features: int | None = None,
                           kind: str = "gain"):
    """Normalized feature importances (reference reads
    `.feature_importances_`, app.py:563-566).

    ``kind="gain"`` (total split gain, modern XGBoost's default) or
    ``kind="split"`` (split counts).
    """
    if n_features is None:
        n_features = int(model.edges.shape[0])
    is_split = model.split_bin < N_BINS
    if kind == "gain":
        weight = jnp.where(is_split, model.split_gain, 0.0)
    elif kind == "split":
        weight = jnp.where(is_split, 1.0, 0.0)
    else:
        raise ValueError(f"unknown importance kind: {kind}")
    counts = jax.ops.segment_sum(
        weight.reshape(-1),
        model.split_feature.reshape(-1).astype(jnp.int32),
        num_segments=n_features)
    total = jnp.maximum(jnp.sum(counts), 1e-12)
    return counts / total
