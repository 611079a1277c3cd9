"""Kou double-exponential jump-diffusion: CF-oracle pricing, jump law,
martingale property, fused-kernel parity, and the generic CF pricer itself
(cross-checked against the Merton 1976 series)."""

import numpy as np
import jax.numpy as jnp

from montecarlo.engine import simulate
from montecarlo.engine.cf_pricing import (
    cf_call_price,
    kou_log_cf,
    merton_log_cf,
)
from montecarlo.ops.fused_engine import fused_terminal_pallas
from montecarlo.processes import Kou, merton_call_series

S0, R, SIGMA, T = 100.0, 0.03, 0.2, 1.0
LAM, P_UP, ETA1, ETA2 = 1.0, 0.4, 10.0, 5.0
N_STEPS = 252


def _kou(dtype=jnp.float32):
    return Kou.create(s0=S0, mu=R, sigma=SIGMA, lam=LAM, p_up=P_UP,
                      eta1=ETA1, eta2=ETA2, dt=T / N_STEPS, dtype=dtype)


def test_cf_pricer_reproduces_merton_series():
    """The generic Gil-Pelaez pricer must match the independent Merton
    series oracle — validates the quadrature machinery itself."""
    phi = merton_log_cf(S0, R, 0.2, 1.0, -0.05, 0.1, T)
    got = float(cf_call_price(phi, S0, 105.0, T, R))
    want = merton_call_series(S0, 105.0, R, 0.2, 1.0, -0.05, 0.1, T)
    assert abs(got - want) < 2e-3, (got, want)


def test_kou_call_matches_cf_oracle():
    n = 1 << 17
    s_t = np.asarray(simulate(_kou(), n, N_STEPS, seed=7))
    payoff = np.maximum(s_t - 105.0, 0.0) * np.exp(-R * T)
    price, se = payoff.mean(), payoff.std() / np.sqrt(n)
    phi = kou_log_cf(S0, R, SIGMA, LAM, P_UP, ETA1, ETA2, T)
    analytic = float(cf_call_price(phi, S0, 105.0, T, R))
    assert abs(price - analytic) < 4 * se + 2e-3, (price, analytic, se)


def test_kou_martingale_under_compensated_drift():
    n = 1 << 16
    s_t = np.asarray(simulate(_kou(), n, N_STEPS, seed=3))
    se = s_t.std() / np.sqrt(n)
    assert abs(s_t.mean() - S0 * np.exp(R * T)) < 5 * se


def test_jump_size_law():
    """Inverse-CDF jump sizes: sign split = p_up; conditional means 1/eta."""
    proc = _kou(jnp.float64)
    ids = jnp.arange(1 << 16, dtype=jnp.uint32)
    u = proc.draws(0, 0, ids, 0, jnp.float64)[2]
    j = np.asarray(proc._jump_size(u, jnp.float64))
    n = j.size
    up = j > 0
    assert abs(up.mean() - P_UP) < 5 * np.sqrt(P_UP * (1 - P_UP) / n)
    assert abs(j[up].mean() - 1 / ETA1) < 5 / (ETA1 * np.sqrt(up.sum()))
    assert abs(j[~up].mean() + 1 / ETA2) < 5 / (ETA2 * np.sqrt((~up).sum()))
    # E[e^J] matches the compensator's closed form.
    m_emp = np.exp(j).mean()
    m_cf = float(proc.mean_jump_factor())
    assert abs(m_emp - m_cf) < 5 * np.exp(j).std() / np.sqrt(n)


def test_kou_asymmetric_skew():
    """p_up < 0.5 with fatter down-jumps: log returns skew negative."""
    n = 1 << 16
    s_t = np.asarray(simulate(_kou(), n, N_STEPS, seed=5))
    lr = np.log(s_t / S0)
    skew = ((lr - lr.mean()) ** 3).mean() / lr.std() ** 3
    assert skew < -0.05, skew


def test_kou_fused_kernel_parity():
    n = 128 * 128
    ref = np.asarray(simulate(_kou(), n, 17, seed=5))
    ker = np.asarray(fused_terminal_pallas(_kou(), n, 17, seed=5,
                                           block=256, interpret=True))
    np.testing.assert_array_equal(ker, ref)


def test_kou_antithetic_reduces_variance():
    from montecarlo.samplers import AntitheticSampler

    n = 1 << 15
    plain = np.asarray(simulate(_kou(), n, 32, seed=9))
    anti = np.asarray(simulate(_kou(), n, 32, seed=9,
                               sampler=AntitheticSampler()))
    p_pay = np.maximum(plain - 105.0, 0.0)
    a_pay = np.maximum(anti - 105.0, 0.0)
    pair_means = a_pay.reshape(-1, 2).mean(axis=1)  # pairs are (2k, 2k+1)
    assert pair_means.var() < p_pay.reshape(-1, 2).mean(axis=1).var()


def test_cf_call_price_uses_passed_spot():
    """The s0 argument must enter the S0*P1 term (it used to be dead code,
    silently ignoring spot bumps)."""
    from montecarlo.engine.cf_pricing import cf_call_price, kou_log_cf

    phi = kou_log_cf(100.0, 0.03, 0.2, 1.0, 0.4, 10.0, 5.0, 1.0)
    base = float(cf_call_price(phi, 100.0, 105.0, 1.0, 0.03))
    bumped = float(cf_call_price(phi, 101.0, 105.0, 1.0, 0.03))
    assert bumped > base + 0.3  # ~delta * 1.0, not identical
