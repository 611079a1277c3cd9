"""Batched scanner — the whole universe as a few vmapped device programs.

The reference scans tickers with a thread pool (one XGBoost pipeline per
ticker, reference app.py:1391-1418).  On an accelerator the right
structure is data parallelism over the *ticker* axis:

1. fetch raw OHLCV host-side (I/O), group tickers by series length;
2. `vmap(compute_features)` — one program featurizes the whole group;
3. one `vmap`'d masked-weight GBT program trains **every CV fold of every
   ticker at once** ((tickers x folds) fits in a single XLA computation),
   and one more trains the final models and predicts the latest row;
4. metrics/record assembly host-side, same schema and failure taxonomy as
   the threaded scanner.

Produces the same `ScanResult` schema as `scan_tickers`; records agree with
the threaded path up to float32-vs-float64 feature round-off (the batched
featurizer runs in f32 on-device).

Device programs are chunked along the ticker axis (``device_batch``,
default 30, a value chosen on the previous accelerator and not yet
re-chosen for the GPU): a bounded chunk bounds device memory per
program, and a fixed chunk shape means ONE compile reused across the
universe —
the tail chunk is padded by repetition and the padded rows discarded.
Per-ticker results are chunking-invariant: every fit is keyed by
(seed=42, tree index), never by batch position (ml/gbt.py:236-242).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from montecarlo.api.scanner import ScanResult, signal_label
from montecarlo.config import ModelConfig
from montecarlo.data.fetch import get_stock_ohlcv
from montecarlo.ml.model import (FEATURE_COLS, _fit_folds, _gbt_cfg,
                                     edge_and_confidence, make_target)
from montecarlo.ml.splits import split_bounds
from montecarlo.quant.features import compute_features, finalize

_batched_features = jax.jit(jax.vmap(
    lambda o, h, l, c, v: finalize(compute_features(o, h, l, c, v,
                                                    dtype=jnp.float32))))

# vmap the fold-batched fitter over the ticker axis:
# x (B, n, F), y (B, n), masks (B, K, n) -> preds (B, K, n)
_fit_folds_tickers = jax.jit(
    jax.vmap(_fit_folds, in_axes=(0, 0, 0, None)),
    static_argnames=("cfg",))


def scan_tickers_batched(tickers: List[str], *, forecast_horizon: int = 20,
                         config: Optional[ModelConfig] = None,
                         period: str = "5y",
                         provider: Optional[str] = None,
                         progress_callback=None,
                         device_batch: int = 30) -> ScanResult:
    """Scan a universe with batched device execution.

    ``device_batch`` bounds the ticker axis of each device program (see
    module docstring); results are invariant to its value.
    """
    if device_batch < 1:
        raise ValueError(f"device_batch must be >= 1, got {device_batch}")
    config = config or ModelConfig()
    out = ScanResult()

    # --- host-side fetch + grouping by raw length -------------------------
    groups: Dict[int, List[tuple]] = {}
    for t in tickers:
        ohlcv = get_stock_ohlcv(t, period, provider=provider)
        if ohlcv is None:
            out.failed.append({"Ticker": t, "Reason": "No data available"})
            continue
        groups.setdefault(len(ohlcv["Close"]), []).append((t, ohlcv))
    if progress_callback:
        progress_callback(0, len(tickers), out)

    done = len(out.failed)
    for _, members in sorted(groups.items()):
        done = _scan_group(members, forecast_horizon, config, out,
                           progress_callback, len(tickers), done,
                           device_batch)
    return out


def _padded_chunks(n_items: int, size: int):
    """Yield (start, stop, pad) covering [0, n_items) in ``size`` chunks.

    When the whole range fits in one chunk it runs unpadded (one compile
    either way); otherwise every chunk is padded to exactly ``size`` so the
    one compiled program is reused, tail included.
    """
    if n_items <= size:
        yield 0, n_items, 0
        return
    for s in range(0, n_items, size):
        e = min(s + size, n_items)
        yield s, e, size - (e - s)


def _pad_rows(a: np.ndarray, pad: int) -> np.ndarray:
    return np.concatenate([a, np.repeat(a[:1], pad, axis=0)]) if pad else a


def _scan_group(members, horizon: int, config: ModelConfig, out: ScanResult,
                progress_callback, total: int, done: int,
                device_batch: int) -> int:
    names = [t for t, _ in members]
    stack = {k: np.stack([np.asarray(o[k], np.float64) for _, o in members])
             for k in ("Open", "High", "Low", "Close", "Volume")}

    valid_parts, feat_parts = [], []
    for s, e, pad in _padded_chunks(len(names), device_batch):
        f, v = _batched_features(*[
            jnp.asarray(_pad_rows(stack[k][s:e], pad), jnp.float32)
            for k in ("Open", "High", "Low", "Close", "Volume")])
        n_real = e - s
        valid_parts.append(np.asarray(v)[:n_real])
        feat_parts.append({k: np.asarray(x)[:n_real] for k, x in f.items()})
    valid = np.concatenate(valid_parts)  # (B, T)
    feats = {k: np.concatenate([p[k] for p in feat_parts])
             for k in feat_parts[0]}

    # Group tickers by surviving row count so shapes stay static.  (NaN
    # survivors are NOT always a suffix — mid-series NaNs drop interior
    # rows, see quant/features.py finalize — hence np.nonzero below.)
    sub_groups: Dict[int, List[int]] = {}
    for i in range(len(names)):
        sub_groups.setdefault(int(valid[i].sum()), []).append(i)

    for n_valid, idxs in sorted(sub_groups.items()):
        batch_names = [names[i] for i in idxs]
        # Same two-gate failure taxonomy as the threaded scanner
        # (api/scanner.py:41-50, mirroring reference app.py:1356-1371):
        # short history -> "Insufficient data"; history that passes the
        # scan gate but whose target-dropped length fails the CV guard
        # -> "Model training failed".
        if n_valid < config.min_data_points:
            reason = (f"Insufficient data: {n_valid}/"
                      f"{config.min_data_points} days")
        elif n_valid - horizon < config.min_data_points:
            reason = "Model training failed"
        else:
            reason = None
        if reason is not None:
            for t in batch_names:
                out.failed.append({"Ticker": t, "Reason": reason})
            done += len(idxs)
            if progress_callback:
                progress_callback(done, total, out)
            continue

        # Assemble (B, n, F) features and (B, n) targets on the suffix.
        xs, ys, vols, prices = [], [], [], []
        for i in idxs:
            rows = np.nonzero(valid[i])[0]
            lr = feats["log_ret"][i][rows]
            target = make_target(lr, horizon)
            ok = ~np.isnan(target)
            xs.append(np.stack([feats[f][i][rows][ok]
                                for f in FEATURE_COLS], axis=1))
            ys.append(target[ok])
            vols.append(float(feats["rvol_20"][i][rows][ok][-1]))
            prices.append(float(feats["Close"][i][rows][ok][-1]))
        x_np = np.stack(xs).astype(np.float32)   # (B, n, F)
        y_np = np.stack(ys).astype(np.float32)   # (B, n)

        n = y_np.shape[1]
        bounds = split_bounds(n, config.cv_folds)
        arange = np.arange(n)
        fold_masks = np.stack([(arange < tr).astype(np.float32)
                               for tr, _ in bounds])            # (K, n)
        cfg = _gbt_cfg(config)

        pred_parts, final_parts = [], []
        for s, e, pad in _padded_chunks(len(idxs), device_batch):
            xb = jnp.asarray(_pad_rows(x_np[s:e], pad))
            yb = jnp.asarray(_pad_rows(y_np[s:e], pad))
            b = xb.shape[0]
            masks = jnp.asarray(np.broadcast_to(
                fold_masks, (b,) + fold_masks.shape))           # (b, K, n)
            n_real = e - s
            pred_parts.append(
                np.asarray(_fit_folds_tickers(xb, yb, masks, cfg))[:n_real])
            # Final models: one more vmapped fit with full-ones masks.
            full = jnp.ones((b, 1, n), jnp.float32)
            final_parts.append(
                np.asarray(_fit_folds_tickers(xb, yb, full, cfg))[:n_real, 0])
        preds = np.concatenate(pred_parts)        # (B, K, n)
        final_preds = np.concatenate(final_parts)  # (B, n)
        for b, t in enumerate(batch_names):
            rmse, da = [], []
            for k, (tr, te) in enumerate(bounds):
                p, a = preds[b, k, tr:te], y_np[b, tr:te]
                rmse.append(float(np.sqrt(np.mean((p - a) ** 2))))
                da.append(float(np.mean(np.sign(p) == np.sign(a))))
            avg_da = float(np.mean(da))
            has_edge, confidence = edge_and_confidence(avg_da)
            pred_log = float(final_preds[b, -1])
            out.results.append({
                "Ticker": t,
                "Price": prices[b],
                "Dir. Accuracy": avg_da * 100.0,
                "Pred. Return": (np.exp(pred_log) - 1.0) * 100.0,
                "Volatility": vols[b] * 100.0,
                "Signal": signal_label(1 if pred_log > 0
                                       else -1 if pred_log < 0 else 0),
                "Edge": has_edge,
                "Confidence": confidence * 100.0,
            })
            done += 1
            if progress_callback:
                progress_callback(done, total, out)
    return done
