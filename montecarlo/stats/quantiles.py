"""Quantiles: exact (NumPy-`linear` compatible) and a mergeable streaming sketch.

Two regimes:

- **Exact** — sorts the sample; matches `np.percentile(..., method="linear")`
  which is what the reference app uses for its percentile bands, VaR and CVaR
  (reference app.py:639-656).  Right answer up to ~10^7-10^8 values per chip.
- **Sketch** — a fixed-grid histogram over a data-driven range.  Counts are
  plain integers, so the merge is an exact `+` (commutative, associative,
  psum-able): the pod-scale path for 10^9+-path VaR/CVaR where sorting is
  impossible.  Quantile error is bounded by one bin width.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


def percentile_linear(x, q, axis=None):
    """`np.percentile` with the default linear interpolation, in JAX."""
    return jnp.percentile(jnp.asarray(x), jnp.asarray(q), axis=axis,
                          method="linear")


def histogram_counts(idx, bins: int, dtype=jnp.int32):
    """Exact counts of int32 bin indices in [0, bins): one `segment_sum`
    (an atomic scatter-add on the GPU).  Counts accumulate in int32, exact
    up to 2^31 per bin regardless of the requested output ``dtype``."""
    import jax

    idx = jnp.asarray(idx, jnp.int32).reshape(-1)
    return jax.ops.segment_sum(jnp.ones(idx.shape, jnp.int32), idx,
                               num_segments=bins).astype(dtype)


# ---------------------------------------------------------------------------
# Fixed-grid histogram sketch
# ---------------------------------------------------------------------------

class HistogramSketch(NamedTuple):
    """Histogram over [lo, hi) with ``bins`` equal cells plus under/overflow.

    All fields are arrays so the sketch is a pytree: it can be vmapped,
    psum-ed, checkpointed with orbax, and merged exactly (integer adds).
    """

    lo: jnp.ndarray        # scalar f32/f64 (value dtype)
    hi: jnp.ndarray        # scalar (value dtype)
    counts: jnp.ndarray    # (bins,) count dtype — int32 default: exact adds
    total: jnp.ndarray     # scalar float — includes under/overflow
    underflow: jnp.ndarray  # scalar float
    overflow: jnp.ndarray   # scalar float
    vmin: jnp.ndarray      # running min/max for exact tail endpoints
    vmax: jnp.ndarray


#: Default count carrier: int32 — exact to 2^31 per bin (f32 silently loses
#: counts past 2^24).  Beyond-2^31 accumulation (host streaming) passes
#: float64 (exact to 2^53).
DEFAULT_COUNT_DTYPE = jnp.int32


def sketch_empty(lo: float, hi: float, bins: int = 4096,
                 dtype=jnp.float32,
                 count_dtype=DEFAULT_COUNT_DTYPE) -> HistogramSketch:
    """Empty sketch.

    Per-bin ``counts`` carry ``count_dtype`` (int32 default — exact integer
    adds and exact psum merges to 2^31 per bin).  The scalar totals carry
    the float value dtype instead: integer scalars would *wrap* past 2^31
    at pod-scale path counts and corrupt every quantile silently, while a
    float total only loses relative precision (2^-24 in f32), which moves a
    quantile target by far less than a bin width.
    """
    z = jnp.zeros((), dtype)
    return HistogramSketch(
        lo=jnp.asarray(lo, dtype),
        hi=jnp.asarray(hi, dtype),
        counts=jnp.zeros((bins,), count_dtype),
        total=z,
        underflow=z,
        overflow=z,
        vmin=jnp.asarray(jnp.inf, dtype),
        vmax=jnp.asarray(-jnp.inf, dtype),
    )


def sketch_add(s: HistogramSketch, x) -> HistogramSketch:
    """Absorb a batch of values (any shape) into the sketch."""
    cdt = s.counts.dtype
    x = jnp.ravel(jnp.asarray(x, s.lo.dtype))
    bins = s.counts.shape[0]
    width = (s.hi - s.lo) / bins
    idx = jnp.floor((x - s.lo) / width).astype(jnp.int32)
    under = idx < 0
    over = idx >= bins
    in_range = ~(under | over)
    # Route out-of-range values to bin 0 and subtract them afterwards
    # (histogram_counts counts everything it is given).
    idx = jnp.where(in_range, jnp.clip(idx, 0, bins - 1), 0)
    batch = histogram_counts(idx, bins, cdt)
    # dtype=cdt: jnp.sum would otherwise promote int32 -> int64 under x64.
    n_oob = jnp.sum(~in_range, dtype=cdt)
    batch = batch.at[0].add(-n_oob)
    counts = s.counts + batch
    tdt = s.total.dtype  # float scalar totals: wrap-free (see sketch_empty)
    return HistogramSketch(
        lo=s.lo,
        hi=s.hi,
        counts=counts,
        total=s.total + jnp.asarray(x.size, tdt),
        underflow=s.underflow + jnp.sum(under, dtype=cdt).astype(tdt),
        overflow=s.overflow + jnp.sum(over, dtype=cdt).astype(tdt),
        vmin=jnp.minimum(s.vmin, jnp.min(x)),
        vmax=jnp.maximum(s.vmax, jnp.max(x)),
    )


def sketch_from_array(x, lo: float, hi: float, bins: int = 4096,
                      dtype=jnp.float32,
                      count_dtype=DEFAULT_COUNT_DTYPE) -> HistogramSketch:
    return sketch_add(sketch_empty(lo, hi, bins, dtype, count_dtype), x)


def sketch_merge(a: HistogramSketch, b: HistogramSketch) -> HistogramSketch:
    """Exact merge — grids must match (same lo/hi/bins by construction)."""
    return HistogramSketch(
        lo=a.lo,
        hi=a.hi,
        counts=a.counts + b.counts,
        total=a.total + b.total,
        underflow=a.underflow + b.underflow,
        overflow=a.overflow + b.overflow,
        vmin=jnp.minimum(a.vmin, b.vmin),
        vmax=jnp.maximum(a.vmax, b.vmax),
    )


def sketch_quantile(s: HistogramSketch, q):
    """Quantile estimate with within-bin linear interpolation.

    ``q`` in [0, 100] (percentile convention, matching the reference and
    `np.percentile`).  Error <= one bin width for in-range quantiles.
    """
    vdt = s.lo.dtype
    q = jnp.asarray(q, vdt) / 100.0
    bins = s.counts.shape[0]
    width = (s.hi - s.lo) / bins
    # CDF at the right edge of each bin (underflow counts first).  The
    # cumsum runs in float: an int32 cumsum would wrap past 2^31 total
    # samples and make the CDF non-monotone; float partial sums only lose
    # relative precision and stay monotone (adding non-negatives).
    cdf = s.underflow.astype(vdt) + jnp.cumsum(s.counts.astype(vdt))
    target = q * s.total.astype(vdt)
    # First bin whose right-edge CDF reaches the target.
    k = jnp.searchsorted(cdf, target, side="left")
    k = jnp.clip(k, 0, bins - 1)
    cdf_left = jnp.where(k > 0, cdf[jnp.maximum(k - 1, 0)],
                         s.underflow.astype(vdt))
    in_bin = jnp.maximum(cdf[k] - cdf_left, 1e-12)
    frac = jnp.clip((target - cdf_left) / in_bin, 0.0, 1.0)
    est = s.lo + (k.astype(vdt) + frac) * width
    # Clamp to the observed range; exact at the extremes.
    return jnp.clip(est, s.vmin, s.vmax)


def sketch_quantile_std_err(s: HistogramSketch, q, smooth_bins: int = 9):
    """Asymptotic standard error of the q-th percentile estimate.

    se(x_q) = sqrt(q(1-q)/n) / f(x_q) — the density at the quantile is
    estimated from the histogram itself (counts in a ``smooth_bins`` window
    around the quantile's bin).  This is the error of the *estimator* given
    n samples; the sketch's own grid error (<= one bin width) is separate
    and usually far smaller.
    """
    vdt = s.lo.dtype
    qf = jnp.asarray(q, vdt) / 100.0
    bins = s.counts.shape[0]
    width = (s.hi - s.lo) / bins
    x_q = sketch_quantile(s, q)
    k = jnp.clip(jnp.floor((x_q - s.lo) / width).astype(jnp.int32),
                 0, bins - 1)
    h = smooth_bins // 2
    idx = k + jnp.arange(-h, h + 1)
    valid = (idx >= 0) & (idx < bins)
    # Mask out-of-grid window positions instead of clipping them onto the
    # edge bins — clipping double-counts bin 0 / bins-1 for quantiles near
    # the grid edges, overestimating the density (underestimating the se).
    win = jnp.sum(jnp.where(valid,
                            s.counts[jnp.clip(idx, 0, bins - 1)],
                            0).astype(vdt))
    n_win = jnp.sum(valid.astype(vdt))
    n = jnp.maximum(s.total.astype(vdt), 1.0)
    dens = jnp.maximum(win / (n * n_win * width), 1e-30)
    return jnp.sqrt(qf * (1.0 - qf) / n) / dens


def sketch_cdf(s: HistogramSketch, x):
    """P(value <= x) with within-bin linear interpolation."""
    vdt = s.lo.dtype
    counts = s.counts.astype(vdt)
    bins = s.counts.shape[0]
    width = (s.hi - s.lo) / bins
    k = jnp.clip(jnp.floor((jnp.asarray(x, vdt) - s.lo) / width)
                 .astype(jnp.int32), 0, bins - 1)
    below = jnp.sum(jnp.where(
        jnp.arange(bins) < k, counts, 0.0)) + s.underflow.astype(vdt)
    frac = jnp.clip((x - (s.lo + k.astype(vdt) * width)) / width,
                    0.0, 1.0)
    below = below + counts[k] * frac
    return below / jnp.maximum(s.total.astype(vdt), 1.0)


def sketch_tail_mean_below(s: HistogramSketch, threshold):
    """Mean of all values <= threshold (bin-midpoint approximation).

    Used for CVaR at pod scale; the exact path (`masked tail mean`, reference
    app.py:656) is preferred whenever the sample fits on-chip.
    """
    vdt = s.lo.dtype
    counts = s.counts.astype(vdt)
    bins = s.counts.shape[0]
    width = (s.hi - s.lo) / bins
    mids = s.lo + (jnp.arange(bins, dtype=vdt) + 0.5) * width
    right_edges = s.lo + (jnp.arange(1, bins + 1, dtype=vdt)) * width
    w = jnp.where(right_edges <= threshold, counts, 0.0)
    # Partial bin containing the threshold: include proportionally.
    k = jnp.clip(jnp.floor((threshold - s.lo) / width).astype(jnp.int32),
                 0, bins - 1)
    frac = jnp.clip((threshold - (s.lo + k.astype(vdt) * width))
                    / width, 0.0, 1.0)
    w = w.at[k].set(counts[k] * frac)
    # Underflow mass: approximate at vmin.
    under = s.underflow.astype(vdt)
    tot = jnp.sum(w) + under
    acc = jnp.sum(w * mids) + under * s.vmin
    return acc / jnp.maximum(tot, 1e-12)
