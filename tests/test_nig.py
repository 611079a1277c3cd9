"""Normal-inverse-Gaussian process: exact IG subordinator law (moments +
KS against scipy), CF-oracle pricing at two step counts (NIG increments
have zero discretization error), martingale drift, skew direction,
fused-kernel parity, and antithetic validity."""

import numpy as np
import jax.numpy as jnp
import pytest

from montecarlo.engine import simulate
from montecarlo.engine.cf_pricing import cf_call_price, nig_log_cf
from montecarlo.ops.fused_engine import fused_terminal_pallas
from montecarlo.processes import NIG

S0, R, T = 100.0, 0.03, 1.0
ALPHA, BETA, DELTA = 15.0, -5.0, 0.5
N_STEPS = 64


def _nig(dtype=jnp.float32, n_steps=N_STEPS):
    return NIG.create(s0=S0, mu=R, alpha=ALPHA, beta=BETA, delta=DELTA,
                      dt=T / n_steps, dtype=dtype)


def test_create_validation():
    with pytest.raises(ValueError):
        NIG.create(s0=S0, mu=R, alpha=4.0, beta=-5.0, delta=0.5, dt=0.01)
    with pytest.raises(ValueError):
        # gamma real but alpha <= |beta + 1| breaks the correction.
        NIG.create(s0=S0, mu=R, alpha=5.5, beta=-6.6, delta=0.5, dt=0.01)
    with pytest.raises(ValueError):
        NIG.create(s0=S0, mu=R, alpha=15.0, beta=-5.0, delta=0.0, dt=0.01)


def test_ig_subordinator_moments():
    """IG(a, gamma) increment: mean a/gamma, variance a/gamma^3 — checks
    the rationalized Michael-Schucany-Haas transform end to end."""
    proc = _nig(jnp.float64)
    ids = jnp.arange(1 << 16, dtype=jnp.uint32)
    z_ig, u, _ = proc.draws(11, 0, ids, 0, jnp.float64)
    inc = np.asarray(proc._ig_increment(z_ig, u, jnp.float64))
    gamma = float(np.sqrt(ALPHA**2 - BETA**2))
    a = DELTA * (T / N_STEPS)
    mean, var = a / gamma, a / gamma**3
    n = inc.size
    assert inc.min() > 0.0
    assert abs(inc.mean() - mean) < 5 * inc.std() / np.sqrt(n)
    # IG variance estimator noise: bound via the sample fourth moment.
    se_var = np.sqrt(((inc - inc.mean()) ** 4).mean() / n)
    assert abs(inc.var() - var) < 5 * se_var + 1e-12


def test_ig_matches_scipy_ks():
    """Distribution-level check: KS against scipy's invgauss (IG with mean
    m and shape lam is scipy invgauss(mu=m/lam, scale=lam))."""
    from scipy.stats import kstest

    proc = _nig(jnp.float64)
    ids = jnp.arange(1 << 14, dtype=jnp.uint32)
    z_ig, u, _ = proc.draws(23, 0, ids, 0, jnp.float64)
    inc = np.asarray(proc._ig_increment(z_ig, u, jnp.float64))
    gamma = float(np.sqrt(ALPHA**2 - BETA**2))
    a = DELTA * (T / N_STEPS)
    m, lam = a / gamma, a * a
    # scipy invgauss(mu, loc=0, scale) has mean mu*scale, shape scale —
    # so inc/lam ~ invgauss(m/lam) at unit scale.
    res = kstest(inc / lam, "invgauss", args=(m / lam,))
    assert res.pvalue > 1e-4, res


@pytest.mark.parametrize("n_steps", [16, N_STEPS])
def test_nig_call_matches_cf_oracle(n_steps):
    """Prices agree with the closed-form CF at BOTH step counts — NIG
    increments are exactly NIG, so there is no discretization bias."""
    n = 1 << 17
    s_t = np.asarray(simulate(_nig(n_steps=n_steps), n, n_steps, seed=7))
    payoff = np.maximum(s_t - 105.0, 0.0) * np.exp(-R * T)
    price, se = payoff.mean(), payoff.std() / np.sqrt(n)
    phi = nig_log_cf(S0, R, ALPHA, BETA, DELTA, T)
    analytic = float(cf_call_price(phi, S0, 105.0, T, R))
    assert abs(price - analytic) < 4 * se + 2e-3, (price, analytic, se)


def test_nig_martingale_under_corrected_drift():
    n = 1 << 16
    s_t = np.asarray(simulate(_nig(), n, N_STEPS, seed=3))
    se = s_t.std() / np.sqrt(n)
    assert abs(s_t.mean() - S0 * np.exp(R * T)) < 5 * se


def test_nig_negative_beta_skews_down():
    n = 1 << 16
    s_t = np.asarray(simulate(_nig(), n, N_STEPS, seed=5))
    lr = np.log(s_t / S0)
    skew = ((lr - lr.mean()) ** 3).mean() / lr.std() ** 3
    assert skew < -0.05, skew


def test_nig_fused_kernel_parity():
    n = 128 * 128
    ref = np.asarray(simulate(_nig(), n, 17, seed=5))
    ker = np.asarray(fused_terminal_pallas(_nig(), n, 17, seed=5,
                                           block=256, interpret=True))
    np.testing.assert_array_equal(ker, ref)


def test_nig_antithetic_reduces_variance():
    from montecarlo.samplers import AntitheticSampler

    n = 1 << 15
    plain = np.asarray(simulate(_nig(), n, 32, seed=9))
    anti = np.asarray(simulate(_nig(), n, 32, seed=9,
                               sampler=AntitheticSampler()))
    p_pay = np.maximum(plain - 105.0, 0.0)
    a_pay = np.maximum(anti - 105.0, 0.0)
    pair_means = a_pay.reshape(-1, 2).mean(axis=1)  # pairs are (2k, 2k+1)
    assert pair_means.var() < p_pay.reshape(-1, 2).mean(axis=1).var()


def test_nig_draws_pair_matches_draws():
    """Explicit cipher sharing must be bitwise identical to per-step draws."""
    proc = _nig()
    ids = jnp.arange(256, dtype=jnp.uint32)
    for j in (0, 3):
        a, b = proc.draws_pair(5, 1, ids, j)
        ref_a = proc.draws(5, 1, ids, 2 * j)
        ref_b = proc.draws(5, 1, ids, 2 * j + 1)
        for x, y in zip(a + b, ref_a + ref_b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
