"""Statistical parity with the reference's Monte Carlo (BASELINE acceptance).

The reference's MC is unseeded (app.py:620), so parity is distributional:
our engine and an independent NumPy oracle of the reference's recurrence must
agree on every reported statistic within Monte Carlo tolerance (<= ~3-4
sigma of the estimator's standard error at matched path counts).
"""

import numpy as np
import pytest

from montecarlo.api import garch_monte_carlo
from montecarlo.data.synthetic import generate_ohlcv
from montecarlo.quant import features_to_numpy

N_SIMS = 30_000
N_DAYS = 20


def numpy_garch_oracle(returns, current_price, current_var, n_sims, n_days,
                       rng):
    """Fresh NumPy implementation of the reference dynamics
    (app.py:600-657): bootstrap shocks from standardized returns,
    r = shock*sqrt(var), multiplicative price update, GARCH(1,1) variance."""
    omega, alpha, beta = 1e-5, 0.10, 0.85
    std_returns = returns / (returns.std() + 1e-10)
    prices = np.full(n_sims, current_price)
    var = np.full(n_sims, current_var)
    for _ in range(n_days):
        shocks = rng.choice(std_returns, size=n_sims)
        r = shocks * np.sqrt(var)
        prices = prices * np.exp(r)
        var = omega + alpha * r**2 + beta * var
    final = prices
    p = {q: np.percentile(final, q) for q in (1, 5, 10, 25, 50, 75, 90, 95, 99)}
    s0 = current_price
    return {
        "final": final,
        "percentiles": p,
        "expected_return": (final.mean() / s0 - 1) * 100,
        "expected_vol": final.std() / s0 * 100,
        "prob_profit": (final > s0).mean() * 100,
        "var_95": (s0 - p[5]) / s0 * 100,
        "cvar_95": (s0 - final[final <= p[5]].mean()) / s0 * 100,
    }


@pytest.fixture(scope="module")
def setup():
    ohlcv = generate_ohlcv(n_days=800, seed=21)
    data = features_to_numpy(ohlcv["Open"], ohlcv["High"], ohlcv["Low"],
                             ohlcv["Close"], ohlcv["Volume"])
    s0 = float(data["Close"][-1])
    returns = data["log_ret"]
    var0 = float(data["rvol_20"][-1]) ** 2 / 252.0

    ours = garch_monte_carlo(data, N_SIMS, N_DAYS, s0, seed=4)

    rng = np.random.default_rng(0)
    reps = [numpy_garch_oracle(returns, s0, var0, N_SIMS, N_DAYS,
                               rng) for _ in range(5)]
    return ours, reps, s0


def _check(ours_val, oracle_vals, k_sigma=4.0, floor=1e-6):
    mean = np.mean(oracle_vals)
    # std across oracle replications estimates the estimator's std-err.
    se = max(np.std(oracle_vals, ddof=1), floor)
    assert abs(ours_val - mean) < k_sigma * se + 1e-9, (
        f"ours={ours_val} oracle={mean} +- {se}")


def test_result_keys_match_reference(setup):
    ours, _, _ = setup
    for key in ("paths", "final_prices", "percentiles", "path_percentiles",
                "expected_return", "expected_vol", "prob_profit", "var_95",
                "cvar_95"):
        assert key in ours, key
    assert ours["paths"].shape == (N_DAYS + 1, N_SIMS)
    assert set(ours["percentiles"]) == {f"p{q}" for q in
                                        (1, 5, 10, 25, 50, 75, 90, 95, 99)}
    assert set(ours["path_percentiles"]) == {"p5", "p25", "p50", "p75", "p95"}


def test_moments_match_oracle(setup):
    ours, reps, _ = setup
    _check(ours["expected_return"], [r["expected_return"] for r in reps])
    _check(ours["expected_vol"], [r["expected_vol"] for r in reps])
    _check(ours["prob_profit"], [r["prob_profit"] for r in reps])


def test_risk_metrics_match_oracle(setup):
    ours, reps, _ = setup
    _check(ours["var_95"], [r["var_95"] for r in reps])
    _check(ours["cvar_95"], [r["cvar_95"] for r in reps])


def test_percentile_bands_match_oracle(setup):
    ours, reps, _ = setup
    for q in (1, 5, 10, 25, 50, 75, 90, 95, 99):
        _check(ours["percentiles"][f"p{q}"],
               [r["percentiles"][q] for r in reps])


def test_reproducible_at_fixed_seed(setup):
    _, _, s0 = setup
    ohlcv = generate_ohlcv(n_days=800, seed=21)
    data = features_to_numpy(ohlcv["Open"], ohlcv["High"], ohlcv["Low"],
                             ohlcv["Close"], ohlcv["Volume"])
    a = garch_monte_carlo(data, 2000, N_DAYS, s0, seed=9)
    b = garch_monte_carlo(data, 2000, N_DAYS, s0, seed=9)
    np.testing.assert_array_equal(a["final_prices"], b["final_prices"])
    c = garch_monte_carlo(data, 2000, N_DAYS, s0, seed=10)
    assert not np.array_equal(a["final_prices"], c["final_prices"])


def test_insufficient_history_returns_none():
    data = {"log_ret": np.full(50, 0.01), "rvol_20": np.full(50, 0.2)}
    assert garch_monte_carlo(data, 100, 10, 100.0) is None


def test_keep_paths_false_preserves_contract(setup):
    """keep_paths=False must still return percentile curves (sketch-based)
    matching the materialized ones within sketch resolution."""
    _, _, s0 = setup
    ohlcv = generate_ohlcv(n_days=800, seed=21)
    data = features_to_numpy(ohlcv["Open"], ohlcv["High"], ohlcv["Low"],
                             ohlcv["Close"], ohlcv["Volume"])
    full = garch_monte_carlo(data, 4096, N_DAYS, s0, seed=4, keep_paths=True)
    lean = garch_monte_carlo(data, 4096, N_DAYS, s0, seed=4,
                             keep_paths=False)
    assert "paths" not in lean
    np.testing.assert_array_equal(lean["final_prices"],
                                  full["final_prices"])
    for q in ("p5", "p50", "p95"):
        ref_curve = full["path_percentiles"][q]
        got_curve = lean["path_percentiles"][q]
        # Sketch bins are fine; allow a small relative tolerance.
        np.testing.assert_allclose(got_curve, ref_curve, rtol=5e-3,
                                   err_msg=q)
