"""Engine correctness: GBM vs Black-Scholes / closed moments, process sanity."""

import numpy as np
import jax.numpy as jnp
import pytest

from montecarlo.engine import (
    black_scholes_call,
    discount_factor,
    european_call,
    mc_estimate,
    simulate,
)
from montecarlo.processes import GBM, GARCHBootstrap, Heston, MultiGBM

S0, R, SIGMA, T_YEARS, STRIKE = 100.0, 0.03, 0.2, 1.0, 105.0
N_STEPS = 252
DT = T_YEARS / N_STEPS


def _gbm():
    return GBM.create(s0=S0, mu=R, sigma=SIGMA, dt=DT)


def test_gbm_martingale_and_variance():
    """E[S_T] = S0 e^{rT}; Var[log S_T] = sigma^2 T."""
    n = 1 << 16
    s_t = np.asarray(simulate(_gbm(), n, N_STEPS, seed=1))
    log_ret = np.log(s_t / S0)
    exp_mean = (R - 0.5 * SIGMA**2) * T_YEARS
    se_mean = SIGMA * np.sqrt(T_YEARS) / np.sqrt(n)
    assert abs(log_ret.mean() - exp_mean) < 4 * se_mean
    assert abs(log_ret.var() - SIGMA**2 * T_YEARS) < 5 * SIGMA**2 * T_YEARS * np.sqrt(2 / n)
    mc_fwd = s_t.mean()
    se_fwd = s_t.std() / np.sqrt(n)
    assert abs(mc_fwd - S0 * np.exp(R * T_YEARS)) < 4 * se_fwd


def test_gbm_european_call_matches_black_scholes():
    """The BASELINE.json config-1 workload: 100k paths x 252 steps."""
    n = 100_000
    s_t = simulate(_gbm(), n, N_STEPS, seed=7)
    est = mc_estimate(european_call(s_t, STRIKE),
                      discount_factor(R, T_YEARS))
    bs = float(black_scholes_call(S0, STRIKE, R, SIGMA, T_YEARS))
    err = abs(float(est["price"]) - bs)
    assert err < 3.5 * float(est["std_err"]), (
        f"MC {float(est['price']):.4f} vs BS {bs:.4f}, "
        f"se {float(est['std_err']):.4f}"
    )
    assert float(est["std_err"]) < 0.2


def test_paths_mode_layout_and_consistency():
    """paths mode: (T+1, N), row 0 = spot, last row == terminal mode."""
    n = 4096
    paths = np.asarray(simulate(_gbm(), n, 20, seed=3, mode="paths"))
    assert paths.shape == (21, n)
    np.testing.assert_allclose(paths[0], S0, rtol=1e-4)  # f32 exp(log(S0))
    terminal = np.asarray(simulate(_gbm(), n, 20, seed=3))
    np.testing.assert_array_equal(paths[-1], terminal)


def test_path_offset_shard_invariance():
    """Simulating [0,N) in one go == two halves with path offsets (bitwise)."""
    n = 8192
    full = np.asarray(simulate(_gbm(), n, 16, seed=5))
    lo = np.asarray(simulate(_gbm(), n // 2, 16, seed=5, path_offset=0))
    hi = np.asarray(simulate(_gbm(), n // 2, 16, seed=5, path_offset=n // 2))
    np.testing.assert_array_equal(full, np.concatenate([lo, hi]))


def test_garch_bootstrap_properties():
    rng = np.random.default_rng(0)
    hist = rng.normal(0, 0.02, size=1260)
    var0 = float(hist[-20:].std() ** 2)
    proc = GARCHBootstrap.create(hist, s0=S0, var0=var0)
    n = 1 << 15
    s_t = np.asarray(simulate(proc, n, 20, seed=9))
    assert np.all(s_t > 0)
    # Terminal distribution centered near spot for zero-mean shocks.
    assert abs(np.median(s_t) / S0 - 1.0) < 0.05
    # Variance stationarity: with omega=1e-5, a=0.1, b=0.85 the long-run
    # daily var is omega/(1-a-b) = 2e-4 -> 20-day log-return std ~ sqrt(20*var).
    spread = np.log(s_t / S0).std()
    assert 0.3 * np.sqrt(20 * var0) < spread < 3.0 * np.sqrt(20 * 2e-4) + 0.1


def test_garch_requires_min_history():
    with pytest.raises(ValueError):
        GARCHBootstrap.create(np.zeros(50), s0=1.0, var0=0.01)


def test_multi_gbm_correlation_recovered():
    corr = np.array([[1.0, 0.6, 0.3], [0.6, 1.0, 0.5], [0.3, 0.5, 1.0]])
    proc = MultiGBM.create(
        s0=[100.0, 50.0, 75.0], mu=[0.03] * 3, sigma=[0.2, 0.3, 0.25],
        corr=corr, dt=1 / 252,
    )
    n = 1 << 15
    paths = np.asarray(simulate(proc, n, 64, seed=11, mode="paths"))
    assert paths.shape == (65, n, 3)
    log_rets = np.diff(np.log(paths), axis=0).reshape(-1, 3)
    est = np.corrcoef(log_rets.T)
    np.testing.assert_allclose(est, corr, atol=0.02)


def test_heston_full_truncation():
    proc = Heston.create(s0=S0, v0=0.04, mu=R, kappa=2.0, theta=0.04,
                         xi=0.5, rho=-0.7, dt=1 / 252)
    n = 1 << 15
    s_t = np.asarray(simulate(proc, n, 252, seed=13))
    assert np.all(np.isfinite(s_t)) and np.all(s_t > 0)
    # Martingale check under the risk-neutral drift.
    se = s_t.std() / np.sqrt(n)
    assert abs(s_t.mean() - S0 * np.exp(R * T_YEARS)) < 5 * se
    # Leverage effect: negative rho -> negative skew of log returns.
    skew = ((np.log(s_t / S0) - np.log(s_t / S0).mean()) ** 3).mean()
    assert skew < 0


def test_heston_reduces_to_gbm_when_xi_zero():
    """xi=0, v0=theta: variance is constant -> matches GBM distribution."""
    v0 = SIGMA**2
    proc = Heston.create(s0=S0, v0=v0, mu=R, kappa=0.0, theta=v0,
                         xi=0.0, rho=0.0, dt=DT)
    n = 1 << 15
    s_h = np.asarray(simulate(proc, n, N_STEPS, seed=17))
    log_ret = np.log(s_h / S0)
    assert abs(log_ret.mean() - (R - 0.5 * v0) * T_YEARS) < 4 * SIGMA / np.sqrt(n)
    assert abs(log_ret.std() - SIGMA) < 0.01


def test_heston_matches_semianalytic_price():
    """Full-truncation Euler vs the characteristic-function price."""
    import warnings

    from tests.oracles import heston_call_price

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # quad roundoff warning
        analytic = heston_call_price(100.0, 105.0, 1.0, 0.03, 0.04,
                                     2.0, 0.04, 0.5, -0.7)
    n, steps = 1 << 16, 128
    proc = Heston.create(s0=100.0, v0=0.04, mu=0.03, kappa=2.0, theta=0.04,
                         xi=0.5, rho=-0.7, dt=1.0 / steps)
    s_t = np.asarray(simulate(proc, n, steps, seed=21))
    payoff = np.maximum(s_t - 105.0, 0.0) * np.exp(-0.03)
    price, se = payoff.mean(), payoff.std() / np.sqrt(n)
    # 4 sigma MC tolerance + a small Euler discretization-bias allowance.
    assert abs(price - analytic) < 4 * se + 0.03, (price, analytic, se)


def test_replay_arbitrary_paths_bit_exact():
    """Any subset of a run regenerates bit-exactly from ids + seed alone —
    the failure-recovery / audit primitive."""
    from montecarlo.engine import replay_paths

    full = np.asarray(simulate(_gbm(), 4096, 16, seed=5))
    ids = jnp.asarray([0, 17, 1000, 4095, 2048], jnp.uint32)
    replayed = np.asarray(replay_paths(_gbm(), ids, 16, seed=5))
    np.testing.assert_array_equal(replayed, full[np.asarray(ids)])


def test_zero_steps_and_tiny_counts():
    proc = _gbm()
    paths = np.asarray(simulate(proc, 8, 0, seed=1, mode="paths"))
    assert paths.shape == (1, 8)
    np.testing.assert_allclose(paths[0], S0, rtol=1e-4)
    term = np.asarray(simulate(proc, 1, 5, seed=1))
    assert term.shape == (1,) and np.isfinite(term[0])


def test_price_to_tolerance_non_block_aligned_chunks():
    """chunk_paths need not be a multiple of the 4096 stats block — the
    fallback path computes one state per chunk (code-review regression)."""
    import jax.numpy as jnp

    from montecarlo.engine.pricing import price_to_tolerance

    proc = GBM.create(s0=100.0, mu=0.03, sigma=0.2, dt=1.0 / 16.0)
    out = price_to_tolerance(
        proc, lambda s: jnp.maximum(s - 105.0, 0.0), target_std_err=0.5,
        seed=0, chunk_paths=100_000, n_steps=16)
    assert float(out["std_err"]) > 0
    assert int(out["n_paths"]) % 100_000 == 0


def test_quanto_call_matches_closed_form():
    """A quanto option is the drift-adjusted GBM's vanilla: MC under
    mu = r_f - rho sigma_S sigma_FX discounted at the DOMESTIC rate must
    match the closed form; rho = 0 degenerates to plain BS with r_f drift."""
    import numpy as np

    from montecarlo.engine import (black_scholes_quanto_call,
                                       european_call, mc_estimate,
                                       quanto_drift, simulate)
    from montecarlo.processes import GBM

    s0, k, r_d, r_f = 100.0, 105.0, 0.05, 0.01
    sig, sig_fx, rho, T = 0.25, 0.12, -0.45, 1.0
    steps = 64
    proc = GBM.create(s0, quanto_drift(r_f, sig, sig_fx, rho), sig,
                      T / steps)
    term = simulate(proc, 1 << 17, steps, seed=9)
    est = mc_estimate(european_call(term, k), float(np.exp(-r_d * T)))
    cf = float(black_scholes_quanto_call(s0, k, r_d, r_f, sig, sig_fx,
                                         rho, T))
    assert abs(float(est["price"]) - cf) < 4 * float(est["std_err"]), \
        (float(est["price"]), cf)
    # rho = 0: reduces to BS with drift r_f, domestic discounting.
    from montecarlo.engine import black_scholes_call

    cf0 = float(black_scholes_quanto_call(s0, k, r_d, r_f, sig, sig_fx,
                                          0.0, T))
    bs = float(black_scholes_call(s0 * np.exp((r_f - r_d) * T), k, r_d,
                                  sig, T))
    np.testing.assert_allclose(cf0, bs, rtol=1e-6)
