"""Rolling-window and EWM primitives with pandas-compatible semantics.

The reference's feature factory (reference app.py:210-395) is ~40 pandas
rolling ops and ~10 EWM chains.  These are rebuilt as pure JAX:

- rolling reductions gather a (T, W) window matrix and reduce along the
  window axis — embarrassingly parallel across time *and* tickers (vmap),
  and a single fused XLA loop on device;
- EWMs are first-order linear recurrences via `lax.scan` (T is ~1e3 here;
  for long series swap in `lax.associative_scan`, same recurrence).

NaN semantics match pandas defaults: a rolling window returns NaN until it
has W valid values (min_periods = W) and whenever the window contains a NaN;
rolling std uses ddof=1; EWM (adjust=False) starts at the first valid value.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp


def shift(x, k: int = 1):
    """pandas `Series.shift(k)`: moves values forward by k, NaN-fills."""
    x = jnp.asarray(x)
    nan = jnp.asarray(jnp.nan, x.dtype)
    if k == 0:
        return x
    if k > 0:
        return jnp.concatenate([jnp.full((k,), nan, x.dtype), x[:-k]])
    return jnp.concatenate([x[-k:], jnp.full((-k,), nan, x.dtype)])


def diff(x, k: int = 1):
    return jnp.asarray(x) - shift(x, k)


def pct_change(x, k: int = 1):
    return jnp.asarray(x) / shift(x, k) - 1.0


def _window_matrix(x, w: int):
    """(T, W) matrix whose row t is x[t-w+1 : t+1], NaN-padded at the top."""
    x = jnp.asarray(x)
    nan = jnp.asarray(jnp.nan, x.dtype)
    padded = jnp.concatenate([jnp.full((w - 1,), nan, x.dtype), x])
    idx = jnp.arange(x.shape[0])[:, None] + jnp.arange(w)[None, :]
    return padded[idx]


def rolling_sum(x, w: int):
    return jnp.sum(_window_matrix(x, w), axis=1)


def rolling_mean(x, w: int):
    return jnp.mean(_window_matrix(x, w), axis=1)


def rolling_std(x, w: int, ddof: int = 1):
    """pandas `.rolling(w).std()` (ddof=1)."""
    m = _window_matrix(x, w)
    mean = jnp.mean(m, axis=1, keepdims=True)
    return jnp.sqrt(jnp.sum(jnp.square(m - mean), axis=1) / (w - ddof))


def rolling_min(x, w: int):
    m = _window_matrix(x, w)
    # NaN must poison the window (jnp.min already propagates NaN).
    return jnp.min(m, axis=1)


def rolling_max(x, w: int):
    return jnp.max(_window_matrix(x, w), axis=1)


def rolling_median(x, w: int):
    m = _window_matrix(x, w)
    return jnp.median(m, axis=1)


def ewm_mean(x, span: float):
    """pandas `.ewm(span=span, adjust=False).mean()`.

    y_0* = first valid x; y_t = (1-a) y_{t-1} + a x_t with a = 2/(span+1).
    Output is NaN before the first valid input; interior NaNs hold the
    previous value (matching pandas for the leading-NaN series this
    framework produces).
    """
    x = jnp.asarray(x)
    alpha = jnp.asarray(2.0 / (span + 1.0), x.dtype)

    def step(carry, xt):
        y, started = carry
        valid = ~jnp.isnan(xt)
        first = valid & ~started
        y_new = jnp.where(first, xt,
                          jnp.where(valid & started,
                                    (1 - alpha) * y + alpha * xt, y))
        started_new = started | valid
        out = jnp.where(started_new, y_new, jnp.asarray(jnp.nan, x.dtype))
        return (y_new, started_new), out

    (_, _), ys = jax.lax.scan(
        step, (jnp.asarray(0.0, x.dtype), jnp.asarray(False)), x)
    return ys


def cumsum_skipna(x):
    """pandas `Series.cumsum()`: accumulates past NaNs, outputs NaN at them."""
    x = jnp.asarray(x)
    filled = jnp.where(jnp.isnan(x), 0.0, x)
    out = jnp.cumsum(filled)
    return jnp.where(jnp.isnan(x), jnp.nan, out)
