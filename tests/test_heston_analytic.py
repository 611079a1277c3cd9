"""Jittable Heston CF pricer vs the adaptive-quad oracle; calibration."""

import warnings

import numpy as np
import jax.numpy as jnp
import pytest

from montecarlo.engine.heston_analytic import (
    HestonParams,
    calibrate_heston,
    heston_call_cf,
)

S0, R = 100.0, 0.03
TRUE = dict(v0=0.04, kappa=2.0, theta=0.04, xi=0.5, rho=-0.7)


def _params(**kw):
    d = {**TRUE, **kw}
    return HestonParams(**{k: jnp.asarray(v) for k, v in d.items()})


def test_cf_pricer_matches_adaptive_quad_oracle():
    from tests.oracles import heston_call_price

    for strike, T in [(105.0, 1.0), (90.0, 0.5), (120.0, 2.0)]:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = heston_call_price(S0, strike, T, R, **TRUE)
        got = float(heston_call_cf(S0, strike, T, R, _params()))
        assert abs(got - ref) < 5e-3, (strike, T, got, ref)


def test_cf_pricer_vectorizes_over_surface():
    strikes = jnp.asarray([80.0, 100.0, 120.0])
    mats = jnp.asarray([0.5, 1.0, 2.0])
    kk, tt = jnp.meshgrid(strikes, mats)
    prices = heston_call_cf(S0, kk.ravel(), tt.ravel(), R, _params())
    assert prices.shape == (9,)
    p = np.asarray(prices)
    assert np.all(p > 0) and np.all(np.isfinite(p))
    # Monotone in strike at fixed maturity.
    assert p[0] > p[1] > p[2]


def test_calibration_recovers_parameters():
    strikes = np.array([80, 90, 100, 110, 120, 90, 100, 110], np.float64)
    mats = np.array([1.0] * 5 + [0.5] * 3, np.float64)
    market = np.asarray(heston_call_cf(S0, strikes, mats, R, _params()))
    est = calibrate_heston(strikes, mats, market, s0=S0, r=R, n_iters=600)
    # Repricing error is the real criterion (parameters can trade off).
    repriced = np.asarray(heston_call_cf(
        S0, strikes, mats, R,
        HestonParams(**{k: jnp.asarray(v) for k, v in est._asdict().items()})))
    assert np.abs(repriced - market).max() < 0.05, est
    assert abs(est.rho - TRUE["rho"]) < 0.25
    assert abs(est.v0 - TRUE["v0"]) < 0.02


def test_calibrate_to_implied_vols_recovers_surface():
    """IV-space calibration: generate the IV surface of known params,
    recalibrate from a different start, and demand the repriced IV surface
    matches within a few vol bps."""
    import numpy as np

    from montecarlo.engine.heston_analytic import calibrate_heston_to_ivs
    from montecarlo.engine.implied_vol import implied_vol_call

    strikes = jnp.asarray([80.0, 90.0, 100.0, 110.0, 120.0] * 2)
    mats = jnp.asarray([0.5] * 5 + [1.5] * 5)
    market_px = heston_call_cf(S0, strikes, mats, R, _params())
    market_iv = implied_vol_call(market_px, S0, strikes, R, mats)
    assert bool(jnp.all(jnp.isfinite(market_iv)))

    est = calibrate_heston_to_ivs(strikes, mats, market_iv, s0=S0, r=R,
                                  n_iters=600)
    repriced = heston_call_cf(
        S0, strikes, mats, R,
        HestonParams(**{k: jnp.asarray(v) for k, v in est._asdict().items()}))
    fit_iv = implied_vol_call(repriced, S0, strikes, R, mats)
    err = np.abs(np.asarray(fit_iv) - np.asarray(market_iv))
    assert err.max() < 0.004, (err.max(), est)  # 40 vol bps worst-case
    assert abs(est.v0 - TRUE["v0"]) < 0.02
