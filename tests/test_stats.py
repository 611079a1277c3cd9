"""Statistics layer: Welford merge law, percentiles, sketch, risk formulas."""

import pytest
import numpy as np
import jax.numpy as jnp

from montecarlo.stats import (
    moments_from_array,
    moments_merge,
    moments_reduce,
    percentile_linear,
    path_percentiles,
    sketch_from_array,
    sketch_merge,
    sketch_quantile,
    sketch_tail_mean_below,
    std,
    std_error,
    terminal_statistics,
    variance,
)


def test_moments_match_numpy():
    rng = np.random.default_rng(0)
    x = rng.normal(3.0, 2.0, size=10_000)
    st = moments_from_array(jnp.asarray(x))
    assert abs(float(st.mean) - x.mean()) < 1e-9
    assert abs(float(variance(st)) - x.var()) < 1e-9
    assert abs(float(std(st, ddof=1)) - x.std(ddof=1)) < 1e-9
    assert abs(float(std_error(st)) - x.std(ddof=1) / np.sqrt(len(x))) < 1e-12


def test_moments_merge_law():
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=1000), rng.normal(loc=5, size=2000)
    merged = moments_merge(moments_from_array(jnp.asarray(a)),
                           moments_from_array(jnp.asarray(b)))
    both = np.concatenate([a, b])
    assert abs(float(merged.mean) - both.mean()) < 1e-9
    assert abs(float(variance(merged)) - both.var()) < 1e-9
    assert int(merged.count) == 3000


def test_moments_reduce_tree():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(7, 512))  # odd number of blocks exercises the tail
    st = moments_reduce(moments_from_array(jnp.asarray(x), axis=-1))
    flat = x.ravel()
    assert abs(float(st.mean) - flat.mean()) < 1e-9
    assert abs(float(variance(st)) - flat.var()) < 1e-9


def test_percentile_matches_numpy_linear():
    rng = np.random.default_rng(3)
    x = rng.normal(size=10_001)
    for q in (1, 5, 25, 50, 75, 95, 99):
        np.testing.assert_allclose(
            float(percentile_linear(jnp.asarray(x), q)),
            np.percentile(x, q), rtol=1e-12)


def test_sketch_quantile_accuracy_and_merge():
    rng = np.random.default_rng(4)
    x = rng.normal(100.0, 15.0, size=200_000)
    bins, lo, hi = 2048, 20.0, 180.0
    s_all = sketch_from_array(jnp.asarray(x, jnp.float64), lo, hi, bins,
                              jnp.float64)
    halves = sketch_merge(
        sketch_from_array(jnp.asarray(x[:100_000], jnp.float64), lo, hi, bins,
                          jnp.float64),
        sketch_from_array(jnp.asarray(x[100_000:], jnp.float64), lo, hi, bins,
                          jnp.float64),
    )
    np.testing.assert_array_equal(np.asarray(s_all.counts),
                                  np.asarray(halves.counts))
    width = (hi - lo) / bins
    for q in (1, 5, 50, 95, 99):
        exact = np.percentile(x, q)
        assert abs(float(sketch_quantile(s_all, q)) - exact) < 2 * width


def test_sketch_tail_mean():
    rng = np.random.default_rng(5)
    x = rng.normal(100.0, 10.0, size=100_000)
    s = sketch_from_array(jnp.asarray(x, jnp.float64), 50.0, 150.0, 4096,
                          jnp.float64)
    thr = np.percentile(x, 5)
    exact = x[x <= thr].mean()
    assert abs(float(sketch_tail_mean_below(s, thr)) - exact) < 0.05


def test_terminal_statistics_reference_formulas():
    """Every key/formula of the reference MC result dict (app.py:647-657)."""
    rng = np.random.default_rng(6)
    s0 = 100.0
    final = rng.lognormal(np.log(s0), 0.1, size=50_000)
    out = terminal_statistics(jnp.asarray(final), s0)

    assert set(out) == {"percentiles", "expected_return", "expected_vol",
                        "prob_profit", "var_95", "cvar_95"}
    for p in (1, 5, 10, 25, 50, 75, 90, 95, 99):
        np.testing.assert_allclose(float(out["percentiles"][f"p{p}"]),
                                   np.percentile(final, p), rtol=1e-10)
    np.testing.assert_allclose(float(out["expected_return"]),
                               (final.mean() / s0 - 1) * 100, rtol=1e-9)
    np.testing.assert_allclose(float(out["expected_vol"]),
                               final.std() / s0 * 100, rtol=1e-9)
    np.testing.assert_allclose(float(out["prob_profit"]),
                               (final > s0).mean() * 100, rtol=1e-12)
    p5 = np.percentile(final, 5)
    np.testing.assert_allclose(float(out["var_95"]),
                               (s0 - p5) / s0 * 100, rtol=1e-9)
    np.testing.assert_allclose(float(out["cvar_95"]),
                               (s0 - final[final <= p5].mean()) / s0 * 100,
                               rtol=1e-9)


def test_path_percentiles_layout():
    rng = np.random.default_rng(7)
    paths = rng.lognormal(0, 0.05, size=(21, 1000)).cumprod(axis=0) * 100
    out = path_percentiles(jnp.asarray(paths))
    assert set(out) == {"p5", "p25", "p50", "p75", "p95"}
    for p in (5, 25, 50, 75, 95):
        np.testing.assert_allclose(np.asarray(out[f"p{p}"]),
                                   np.percentile(paths, p, axis=1), rtol=1e-10)


def test_sketch_counts_exact_past_f32_precision():
    """Counts are integer by default: adding one value to a bin already at
    2^24 must increment it (f32 lanes would silently drop it — the round-1
    silent-wrongness bug at pod-scale path counts)."""
    from montecarlo.stats.quantiles import HistogramSketch, sketch_add

    bins = 64
    big = 1 << 24
    s = HistogramSketch(
        lo=jnp.float32(0.0), hi=jnp.float32(64.0),
        counts=jnp.zeros((bins,), jnp.int32).at[3].set(big),
        total=jnp.int32(big), underflow=jnp.int32(0), overflow=jnp.int32(0),
        vmin=jnp.float32(3.0), vmax=jnp.float32(3.9),
    )
    s2 = sketch_add(s, jnp.asarray([3.5], jnp.float32))
    assert int(s2.counts[3]) == big + 1
    assert int(s2.total) == big + 1
    # Default construction: integer per-bin counts (exact adds), float
    # scalar totals (an int total would WRAP past 2^31 at pod scale; float
    # only loses relative precision and stays monotone).
    fresh = sketch_from_array(jnp.asarray([1.0, 2.0]), 0.0, 64.0, bins)
    assert jnp.issubdtype(fresh.counts.dtype, jnp.integer)
    assert jnp.issubdtype(fresh.total.dtype, jnp.floating)


def test_sketch_quantile_survives_past_int32_total():
    """Quantiles stay correct when the accumulated total exceeds 2^31 —
    an int32 total/cdf would wrap negative and return garbage."""
    from montecarlo.stats.quantiles import HistogramSketch

    bins = 64
    per_bin = (1 << 31) // 16  # 32 hot bins -> total = 2^32 > int32 max
    counts = jnp.zeros((bins,), jnp.int32).at[16:48].set(per_bin)
    total = jnp.float64(32.0 * per_bin)
    s = HistogramSketch(
        lo=jnp.float64(0.0), hi=jnp.float64(64.0), counts=counts,
        total=total, underflow=jnp.float64(0.0), overflow=jnp.float64(0.0),
        vmin=jnp.float64(16.0), vmax=jnp.float64(48.0))
    # Uniform mass over [16, 48): the median is 32, p25 is 24.
    assert abs(float(sketch_quantile(s, 50.0)) - 32.0) < 1.1
    assert abs(float(sketch_quantile(s, 25.0)) - 24.0) < 1.1


def test_sketch_int_counts_quantile_math_still_float():
    rng = np.random.default_rng(7)
    x = rng.normal(100.0, 10.0, size=50_000)
    s = sketch_from_array(jnp.asarray(x, jnp.float64), 50.0, 150.0, 4096,
                          jnp.float64)
    for q in (5.0, 50.0, 95.0):
        exact = np.percentile(x, q)
        assert abs(float(sketch_quantile(s, q)) - exact) < 0.1
    thr = float(np.percentile(x, 5.0))
    tail = x[x <= thr].mean()
    assert abs(float(sketch_tail_mean_below(s, thr)) - tail) < 0.1


def test_sketch_quantile_std_err_calibrated():
    """The reported asymptotic quantile se must match the empirical spread
    of the estimator across independent replications (factor < ~1.7)."""
    from montecarlo.stats import sketch_from_array, sketch_quantile_std_err

    rng = np.random.default_rng(0)
    n = 1 << 14
    ests, ses = [], []
    for _ in range(24):
        x = rng.normal(0.0, 1.0, n)
        sk = sketch_from_array(x, -6.0, 6.0, bins=2048)
        ests.append(float(sketch_quantile(sk, 5.0)))
        ses.append(float(sketch_quantile_std_err(sk, 5.0)))
    emp = np.std(ests, ddof=1)
    rep = np.mean(ses)
    assert 0.6 < rep / emp < 1.7, (rep, emp)
    # and the magnitude matches the normal-theory value
    from scipy.stats import norm
    theory = np.sqrt(0.05 * 0.95 / n) / norm.pdf(norm.ppf(0.05))
    assert 0.7 < rep / theory < 1.4, (rep, theory)


@pytest.mark.parametrize("bins,n", [(7, 10), (64, 1000), (100, 12345),
                                    (4096, 1 << 16)])
def test_histogram_counts_match_bincount(bins, n):
    """The one histogram path (`segment_sum`) counts exactly like
    `np.bincount`, with a peaked distribution so many indices collide."""
    from montecarlo.stats.quantiles import histogram_counts

    rng = np.random.default_rng(bins)
    idx = np.clip((rng.normal(size=n) * bins / 8 + bins / 2).astype(np.int64),
                  0, bins - 1).astype(np.int32)
    got = np.asarray(histogram_counts(jnp.asarray(idx), bins))
    np.testing.assert_array_equal(got, np.bincount(idx, minlength=bins))
    assert got.dtype == np.int32
