"""Variance-gamma process: CF-oracle pricing at two step counts (VG
increments have zero discretization error), martingale drift, excess
kurtosis + skew direction, fused-kernel parity, antithetic validity, and
creation-time validation."""

import numpy as np
import jax.numpy as jnp
import pytest

from montecarlo.engine import simulate
from montecarlo.engine.cf_pricing import cf_call_price, vg_log_cf
from montecarlo.ops.fused_engine import fused_terminal_pallas
from montecarlo.processes import VarianceGamma

S0, R, T = 100.0, 0.03, 1.0
SIGMA, THETA, NU = 0.2, -0.14, 0.2   # Madan-Carr-Chang 1998 ballpark
N_STEPS = 64


def _vg(dtype=jnp.float32, n_steps=N_STEPS):
    return VarianceGamma.create(s0=S0, mu=R, sigma=SIGMA, theta=THETA,
                                nu=NU, dt=T / n_steps, dtype=dtype)


def test_create_validation():
    with pytest.raises(ValueError):
        VarianceGamma.create(s0=S0, mu=R, sigma=0.0, theta=THETA, nu=NU,
                             dt=0.01)
    with pytest.raises(ValueError):
        # dt > nu breaks the boost sampler's shape <= 1 requirement.
        VarianceGamma.create(s0=S0, mu=R, sigma=SIGMA, theta=THETA, nu=0.1,
                             dt=0.25)
    with pytest.raises(ValueError):
        # theta*nu + sigma^2*nu/2 >= 1: no martingale correction exists.
        VarianceGamma.create(s0=S0, mu=R, sigma=0.5, theta=1.9, nu=1.0,
                             dt=0.01)


@pytest.mark.parametrize("n_steps", [16, N_STEPS])
def test_vg_call_matches_cf_oracle(n_steps):
    """Prices agree with the closed-form CF at BOTH step counts — VG
    increments are exactly VG, so there is no discretization bias."""
    n = 1 << 17
    s_t = np.asarray(simulate(_vg(n_steps=n_steps), n, n_steps, seed=7))
    payoff = np.maximum(s_t - 105.0, 0.0) * np.exp(-R * T)
    price, se = payoff.mean(), payoff.std() / np.sqrt(n)
    phi = vg_log_cf(S0, R, SIGMA, THETA, NU, T)
    analytic = float(cf_call_price(phi, S0, 105.0, T, R))
    assert abs(price - analytic) < 4 * se + 2e-3, (price, analytic, se)


def test_vg_martingale_under_corrected_drift():
    n = 1 << 16
    s_t = np.asarray(simulate(_vg(), n, N_STEPS, seed=3))
    se = s_t.std() / np.sqrt(n)
    assert abs(s_t.mean() - S0 * np.exp(R * T)) < 5 * se


def test_vg_return_moments():
    """Log-return variance/skew/kurtosis match the VG closed forms
    (Madan-Carr-Chang 1998): var = (sigma^2 + theta^2*nu)*T, negative skew
    for theta < 0, excess kurtosis > 0 (the whole point of the model)."""
    n = 1 << 17
    s_t = np.asarray(simulate(_vg(), n, N_STEPS, seed=5))
    lr = np.log(s_t / S0)
    var_ref = (SIGMA**2 + THETA**2 * NU) * T
    se_var = np.sqrt(((lr - lr.mean()) ** 4).mean() / n)
    assert abs(lr.var() - var_ref) < 5 * se_var
    skew = ((lr - lr.mean()) ** 3).mean() / lr.std() ** 3
    kurt = ((lr - lr.mean()) ** 4).mean() / lr.var() ** 2 - 3.0
    assert skew < -0.05, skew
    assert kurt > 0.2, kurt


def test_vg_fused_kernel_parity():
    """ULP-tight, not bitwise: the gamma inversion's long mul-add chains
    are exactly where XLA picks different FMA contractions between the two
    compilations (same group as the short-rate trio / DCC / Bates —
    DEVNOTES)."""
    n = 128 * 128
    ref = np.asarray(simulate(_vg(), n, 17, seed=5))
    ker = np.asarray(fused_terminal_pallas(_vg(), n, 17, seed=5,
                                           block=256, interpret=True))
    np.testing.assert_allclose(ker, ref, rtol=2e-6)


def test_vg_antithetic_reduces_variance():
    from montecarlo.samplers import AntitheticSampler

    n = 1 << 15
    plain = np.asarray(simulate(_vg(), n, 32, seed=9))
    anti = np.asarray(simulate(_vg(), n, 32, seed=9,
                               sampler=AntitheticSampler()))
    p_pay = np.maximum(plain - 105.0, 0.0)
    a_pay = np.maximum(anti - 105.0, 0.0)
    pair_means = a_pay.reshape(-1, 2).mean(axis=1)  # pairs are (2k, 2k+1)
    assert pair_means.var() < p_pay.reshape(-1, 2).mean(axis=1).var()


def test_vg_draws_pair_matches_draws():
    """Explicit cipher sharing must be bitwise identical to per-step draws."""
    proc = _vg()
    ids = jnp.arange(256, dtype=jnp.uint32)
    for j in (0, 3):
        a, b = proc.draws_pair(5, 1, ids, j)
        ref_a = proc.draws(5, 1, ids, 2 * j)
        ref_b = proc.draws(5, 1, ids, 2 * j + 1)
        for x, y in zip(a + b, ref_a + ref_b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
