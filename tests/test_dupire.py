"""Dupire local-vol calibration: flat/term-structure exactness and the
vanilla-repricing roundtrip through a Heston-generated surface."""

import numpy as np
import jax.numpy as jnp

from montecarlo.engine import european_call, mc_estimate, simulate
from montecarlo.engine.heston_analytic import HestonParams, heston_call_cf
from montecarlo.engine.implied_vol import implied_vol_call
from montecarlo.processes.dupire import (
    dupire_local_vol_grid,
    local_vol_fn_from_ivs,
)
from montecarlo.processes.local_vol import LocalVolGBM

S0, RATE = 100.0, 0.03
STRIKES = np.linspace(70.0, 140.0, 15)
MATS = np.array([0.25, 0.5, 1.0, 1.5, 2.0])


def test_flat_surface_recovers_flat_vol():
    ivs = np.full((MATS.size, STRIKES.size), 0.2)
    _, _, sig = dupire_local_vol_grid(STRIKES, MATS, ivs, s0=S0, rate=RATE)
    np.testing.assert_allclose(sig, 0.2, atol=2e-3)


def test_term_structure_only():
    """w(T) = s0^2 T + c T^2  =>  sigma_loc^2(T) = s0^2 + 2 c T."""
    sig0sq, c = 0.04, 0.012
    w = sig0sq * MATS + c * MATS**2
    ivs = np.sqrt(w / MATS)[:, None] * np.ones((1, STRIKES.size))
    mats, _, sig = dupire_local_vol_grid(STRIKES, MATS, ivs, s0=S0,
                                         rate=RATE)
    want = np.sqrt(sig0sq + 2 * c * mats)
    # interior pillars: central differences are second order
    np.testing.assert_allclose(sig[1:-1].mean(axis=1), want[1:-1],
                               rtol=5e-3)


def test_heston_roundtrip_reprices_vanillas():
    """The Dupire property: the calibrated local-vol model must reprice the
    input vanilla surface.  Generate IVs from Heston, calibrate, MC-price
    under LocalVolGBM, compare to the Heston CF prices."""
    hp = HestonParams(v0=jnp.float64(0.04), kappa=jnp.float64(1.5),
                      theta=jnp.float64(0.05), xi=jnp.float64(0.4),
                      rho=jnp.float64(-0.5))
    ivs = np.zeros((MATS.size, STRIKES.size))
    for j, T in enumerate(MATS):
        prices = np.asarray(heston_call_cf(S0, jnp.asarray(STRIKES),
                                           float(T), RATE, hp))
        ivs[j] = np.asarray(implied_vol_call(jnp.asarray(prices), S0,
                                             jnp.asarray(STRIKES), RATE,
                                             float(T)))
    vol_fn = local_vol_fn_from_ivs(STRIKES, MATS, ivs, s0=S0, rate=RATE)

    n_steps = 128
    proc = LocalVolGBM.create(S0, RATE, 1.0 / n_steps, n_steps, vol_fn,
                              x_min=-0.8, x_max=0.8)
    term = simulate(proc, 1 << 17, n_steps, seed=7)
    for k in (85.0, 100.0, 115.0):
        est = mc_estimate(european_call(term, k), np.exp(-RATE * 1.0))
        cf = float(heston_call_cf(S0, float(k), 1.0, RATE, hp))
        err = abs(float(est["price"]) - cf)
        tol = 4 * float(est["std_err"]) + 0.0075 * cf + 0.03
        assert err < tol, (k, float(est["price"]), cf, err, tol)


def test_skewed_surface_produces_skewed_local_vol():
    """A downward IV skew must map to higher local vol at low strikes."""
    skew = -0.15  # per unit log-moneyness
    y = np.log(STRIKES / S0)
    ivs = 0.2 + skew * y[None, :] * np.ones((MATS.size, 1))
    _, y_grid, sig = dupire_local_vol_grid(STRIKES, MATS, ivs, s0=S0,
                                           rate=RATE)
    mid = MATS.size // 2
    low = sig[mid, : len(y_grid) // 4].mean()
    high = sig[mid, -len(y_grid) // 4:].mean()
    assert low > high + 0.03, (low, high)
