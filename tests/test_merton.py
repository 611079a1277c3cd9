"""Merton jump-diffusion: oracle pricing, jump statistics, fused parity."""

import numpy as np
import jax.numpy as jnp

from montecarlo.engine import simulate
from montecarlo.ops.fused_engine import fused_terminal_pallas
from montecarlo.processes import Merton, merton_call_series

S0, R, SIGMA, T = 100.0, 0.03, 0.2, 1.0
LAM, J_MEAN, J_STD = 1.0, -0.05, 0.1
N_STEPS = 252


def _merton():
    return Merton.create(s0=S0, mu=R, sigma=SIGMA, lam=LAM,
                         jump_mean=J_MEAN, jump_std=J_STD, dt=T / N_STEPS)


def test_merton_call_matches_series_oracle():
    n = 1 << 17
    s_t = np.asarray(simulate(_merton(), n, N_STEPS, seed=7))
    payoff = np.maximum(s_t - 105.0, 0.0) * np.exp(-R * T)
    price, se = payoff.mean(), payoff.std() / np.sqrt(n)
    analytic = merton_call_series(S0, 105.0, R, SIGMA, LAM, J_MEAN, J_STD, T)
    assert abs(price - analytic) < 4 * se + 1e-3, (price, analytic, se)


def test_merton_martingale_under_compensated_drift():
    n = 1 << 16
    s_t = np.asarray(simulate(_merton(), n, N_STEPS, seed=3))
    se = s_t.std() / np.sqrt(n)
    assert abs(s_t.mean() - S0 * np.exp(R * T)) < 5 * se


def test_merton_fatter_tails_than_gbm():
    from montecarlo.processes import GBM

    n = 1 << 16
    s_m = np.asarray(simulate(_merton(), n, N_STEPS, seed=5))
    gbm = GBM.create(s0=S0, mu=R, sigma=SIGMA, dt=T / N_STEPS)
    s_g = np.asarray(simulate(gbm, n, N_STEPS, seed=5))
    lr_m, lr_g = np.log(s_m / S0), np.log(s_g / S0)
    kurt = lambda x: ((x - x.mean()) ** 4).mean() / x.var() ** 2
    assert kurt(lr_m) > kurt(lr_g) + 0.1


def test_merton_fused_kernel_parity():
    n = 128 * 128
    ref = np.asarray(simulate(_merton(), n, 17, seed=5))
    ker = np.asarray(fused_terminal_pallas(_merton(), n, 17, seed=5,
                                           block=256, interpret=True))
    np.testing.assert_array_equal(ker, ref)


def test_poisson_count_distribution():
    proc = _merton()
    ids = jnp.arange(1 << 16, dtype=jnp.uint32)
    _, u, _ = proc.draws(0, 0, ids, 0)
    counts = np.asarray(proc._poisson_count(u, jnp.float32))
    rate = LAM * T / N_STEPS
    from scipy.stats import poisson

    for k in (0, 1, 2):
        expected = poisson.pmf(k, rate)
        got = (counts == k).mean()
        assert abs(got - expected) < 5 * np.sqrt(expected / len(counts)) + 1e-4


def test_coarse_jump_grid_rejected():
    """lam*dt beyond the K_MAX truncation budget must error, not silently
    clamp jump counts (review finding r2)."""
    import pytest

    with pytest.raises(ValueError, match="lam\\*dt"):
        Merton.create(s0=100.0, mu=0.03, sigma=0.2, lam=20.0,
                      jump_mean=-0.05, jump_std=0.1, dt=1 / 12)
