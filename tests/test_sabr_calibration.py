"""SABR smile calibration: recover generated parameters via Adam on the
Hagan expansion's exact gradients."""

import numpy as np
import jax.numpy as jnp

from montecarlo.processes.sabr import calibrate_sabr, sabr_hagan_iv

F0, T, BETA = 100.0, 1.0, 0.7
TRUE = {"alpha": 0.2 * F0 ** (1 - BETA), "nu": 0.35, "rho": -0.4}


def _smile(strikes):
    return np.asarray(sabr_hagan_iv(F0, jnp.asarray(strikes), T,
                                    TRUE["alpha"], BETA, TRUE["nu"],
                                    TRUE["rho"]))


def test_calibration_recovers_generated_smile():
    strikes = np.linspace(80.0, 125.0, 10)
    fit = calibrate_sabr(strikes, _smile(strikes), f0=F0, T=T, beta=BETA)
    assert fit["rmse_vol"] < 5e-4, fit
    assert abs(fit["alpha"] - TRUE["alpha"]) / TRUE["alpha"] < 0.05, fit
    assert abs(fit["nu"] - TRUE["nu"]) < 0.05, fit
    assert abs(fit["rho"] - TRUE["rho"]) < 0.08, fit


def test_calibration_tolerates_noise():
    rng = np.random.default_rng(3)
    strikes = np.linspace(80.0, 125.0, 14)
    noisy = _smile(strikes) + rng.normal(0, 5e-4, size=strikes.size)
    fit = calibrate_sabr(strikes, noisy, f0=F0, T=T, beta=BETA)
    refit = np.asarray(sabr_hagan_iv(F0, jnp.asarray(strikes), T,
                                     fit["alpha"], BETA, fit["nu"],
                                     fit["rho"]))
    assert np.sqrt(((refit - _smile(strikes)) ** 2).mean()) < 1.5e-3


def test_hagan_iv_atm_continuity():
    """The z->0 guard: IV must be continuous through the ATM point."""
    ks = jnp.asarray([99.999, 100.0, 100.001])
    ivs = np.asarray(sabr_hagan_iv(F0, ks, T, TRUE["alpha"], BETA,
                                   TRUE["nu"], TRUE["rho"]))
    assert np.all(np.isfinite(ivs))
    assert abs(ivs[0] - ivs[2]) < 1e-5
    assert abs(ivs[1] - 0.5 * (ivs[0] + ivs[2])) < 1e-5
