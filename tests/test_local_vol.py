"""Local-volatility process: degenerate oracles, CEV closed form, smile."""

import jax.numpy as jnp
import numpy as np
import pytest

from montecarlo.engine import simulate
from montecarlo.engine.payoffs import black_scholes_call
from montecarlo.ops.fused_engine import fused_terminal_pallas
from montecarlo.processes import GBM, LocalVolGBM

S0, R = 100.0, 0.03


def test_flat_surface_matches_gbm():
    """sigma(t, S) = const must reproduce plain GBM exactly (same draw
    convention, same update algebra)."""
    steps, dt = 32, 1.0 / 64.0
    lv = LocalVolGBM.create(S0, R, dt, steps,
                            lambda t, s: np.full_like(s, 0.2))
    gbm = GBM.create(s0=S0, mu=R, sigma=0.2, dt=dt)
    a = np.asarray(simulate(lv, 8192, steps, seed=3))
    b = np.asarray(simulate(gbm, 8192, steps, seed=3))
    np.testing.assert_allclose(a, b, rtol=3e-6)


def test_time_dependent_vol_matches_bs_with_integrated_variance():
    """sigma(t) (no strike dependence): the European call equals BS at the
    root-mean-square vol — a closed-form oracle for the time axis."""
    steps, dt = 64, 1.0 / 64.0
    sig_of_t = lambda t: 0.15 + 0.2 * t  # rising term structure

    lv = LocalVolGBM.create(
        S0, R, dt, steps, lambda t, s: np.full_like(s, sig_of_t(t)))
    n = 1 << 17
    term = simulate(lv, n, steps, seed=7)
    strike = 105.0
    disc = float(np.exp(-R))
    pay = np.asarray(jnp.maximum(term - strike, 0.0))
    price = disc * pay.mean()
    se = disc * pay.std(ddof=1) / np.sqrt(n)

    # Integrated variance over the step grid (vol constant within steps).
    var = sum(sig_of_t(t * dt) ** 2 * dt for t in range(steps))
    bs = float(black_scholes_call(S0, strike, R, np.sqrt(var), 1.0))
    assert abs(price - bs) < 4 * se + 1e-3, (price, bs, se)


def test_cev_surface_matches_ncx2_closed_form():
    """sigma(S) = sigma0 (S/S0)^(beta-1) is the CEV model, whose European
    call has a noncentral-chi-square closed form — an independent oracle
    for the strike axis of the surface lookup."""
    from scipy.stats import ncx2

    beta, sigma0, T = 0.6, 0.25, 0.5
    steps = 64
    dt = T / steps
    lv = LocalVolGBM.create(
        S0, R, dt, steps,
        lambda t, s: sigma0 * (s / S0) ** (beta - 1.0),
        x_min=-2.0, x_max=2.0)
    n = 1 << 17
    term = simulate(lv, n, steps, seed=11)

    def cev_call(strike):
        # Hull's CEV parametrization (validated here against the BS limit
        # beta->1 and an independent fine-grid numpy Euler MC); the
        # lognormal-vol surface sigma_LN(S) = sigma0 (S/S0)^(beta-1) is
        # CEV dS = rS dt + d S^beta dW with d = sigma0 * S0^(1-beta).
        delta = sigma0 * S0 ** (1 - beta)
        v = (delta ** 2 / (2 * R * (beta - 1))
             * (np.exp(2 * R * (beta - 1) * T) - 1))
        a = ((strike * np.exp(-R * T)) ** (2 * (1 - beta))
             / ((1 - beta) ** 2 * v))
        b = 1 / (1 - beta)
        c = S0 ** (2 * (1 - beta)) / ((1 - beta) ** 2 * v)
        return (S0 * (1 - ncx2.cdf(a, b + 2, c))
                - strike * np.exp(-R * T) * ncx2.cdf(c, b, a))

    disc = float(np.exp(-R * T))
    for strike in (90.0, 100.0, 110.0):
        pay = np.asarray(jnp.maximum(term - strike, 0.0))
        price = disc * pay.mean()
        se = disc * pay.std(ddof=1) / np.sqrt(n)
        exact = cev_call(strike)
        # Euler discretization bias ~O(dt) on top of MC error.
        assert abs(price - exact) < 5 * se + 0.05, (strike, price, exact)


def test_skewed_surface_produces_downward_smile():
    """A downward-sloping sigma(S) must produce higher implied vol at low
    strikes (the equity skew) in the simulated prices."""
    from montecarlo.engine.implied_vol import implied_vol_call

    steps, dt = 32, 1.0 / 32.0
    lv = LocalVolGBM.create(
        S0, R, dt, steps,
        lambda t, s: np.clip(0.2 - 0.25 * np.log(s / S0), 0.05, 0.8))
    n = 1 << 16
    term = simulate(lv, n, steps, seed=13)
    disc = float(np.exp(-R))
    ivs = {}
    for strike in (85.0, 100.0, 115.0):
        price = disc * float(jnp.mean(jnp.maximum(term - strike, 0.0)))
        ivs[strike] = float(implied_vol_call(price, S0, strike, R, 1.0))
    assert ivs[85.0] > ivs[100.0] > ivs[115.0], ivs


def test_fused_kernel_bitwise_parity():
    steps, dt = 9, 1.0 / 32.0
    lv = LocalVolGBM.create(
        S0, R, dt, steps,
        lambda t, s: 0.2 + 0.1 * np.tanh(np.log(s / S0)) + 0.05 * t)
    a = fused_terminal_pallas(lv, 8192, steps, seed=5, interpret=True,
                              block=128)
    b = simulate(lv, 8192, steps, seed=5)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_create_validation():
    with pytest.raises(ValueError):
        LocalVolGBM.create(S0, R, 0.01, 4, lambda t, s: np.zeros_like(s))
    with pytest.raises(ValueError):
        LocalVolGBM.create(S0, R, 0.01, 4,
                           lambda t, s: np.full(7, 0.2))  # wrong width
