"""Levy-model calibration (`engine/levy_calibration.py`): exact recovery
of generated VG / NIG implied-vol surfaces, constraint validity of every
returned parameter set, and the CLI round-trip."""

import json

import numpy as np
import jax.numpy as jnp
import pytest

from montecarlo.engine.cf_pricing import (cf_call_price, nig_log_cf,
                                              vg_log_cf)
from montecarlo.engine.implied_vol import implied_vol_call
from montecarlo.engine.levy_calibration import calibrate_levy_to_ivs

S0, R = 100.0, 0.03
KS = np.array([80.0, 90.0, 100.0, 110.0, 120.0] * 3, np.float64)
TS = np.repeat([0.25, 0.5, 1.0], 5).astype(np.float64)


def _surface(phi):
    prices = cf_call_price(phi, S0, jnp.asarray(KS), jnp.asarray(TS), R)
    return np.asarray(implied_vol_call(prices, S0, jnp.asarray(KS), R,
                                       jnp.asarray(TS)))


def test_vg_surface_recovery():
    truth = dict(sigma=0.18, theta=-0.12, nu=0.25)
    ivs = _surface(vg_log_cf(S0, R, truth["sigma"], truth["theta"],
                             truth["nu"], jnp.asarray(TS)))
    fit = calibrate_levy_to_ivs("vg", KS, TS, ivs, s0=S0, r=R)
    assert fit["rmse_vol"] < 5e-4, fit
    for k, v in truth.items():
        assert abs(fit[k] - v) < 0.01 * max(abs(v), 0.1), (k, fit)


def test_nig_surface_recovery():
    truth = dict(alpha=12.0, beta=-4.0, delta=0.4)
    ivs = _surface(nig_log_cf(S0, R, truth["alpha"], truth["beta"],
                              truth["delta"], jnp.asarray(TS)))
    fit = calibrate_levy_to_ivs("nig", KS, TS, ivs, s0=S0, r=R)
    assert fit["rmse_vol"] < 5e-4, fit
    # alpha/beta trade off along the skew; delta is sharply identified.
    assert abs(fit["delta"] - truth["delta"]) < 0.02, fit
    assert abs(fit["beta"] - truth["beta"]) < 0.2, fit
    assert abs(fit["alpha"] - truth["alpha"]) < 0.5, fit


def test_fit_params_always_valid():
    """Whatever surface comes in (here: a flat 20% surface neither family
    can match exactly), the returned parameters must satisfy the models'
    own create() constraints — the constraint mapping, not luck."""
    from montecarlo.processes import NIG, VarianceGamma

    ivs = np.full(KS.shape, 0.2)
    vg = calibrate_levy_to_ivs("vg", KS, TS, ivs, s0=S0, r=R, n_iters=300)
    VarianceGamma.create(s0=S0, mu=R, sigma=vg["sigma"], theta=vg["theta"],
                         nu=vg["nu"], dt=min(vg["nu"], 1.0) / 2)
    nig = calibrate_levy_to_ivs("nig", KS, TS, ivs, s0=S0, r=R,
                                n_iters=300)
    NIG.create(s0=S0, mu=R, alpha=nig["alpha"], beta=nig["beta"],
               delta=nig["delta"], dt=0.01)


def test_unknown_family_rejected():
    with pytest.raises(ValueError):
        calibrate_levy_to_ivs("cgmy", KS, TS, np.full(KS.shape, 0.2),
                              s0=S0, r=R)


def test_cli_calibrate_vg_demo(capsys):
    from montecarlo import cli

    rc = cli.main(["calibrate", "--model", "vg"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["rmse_vol"] < 5e-4
    assert abs(out["sigma"] - out["demo_truth"]["sigma"]) < 0.01


def test_merton_surface_recovery():
    from montecarlo.engine.cf_pricing import merton_log_cf

    truth = dict(sigma=0.15, lam=0.8, jump_mean=-0.08, jump_std=0.12)
    ivs = _surface(merton_log_cf(S0, R, truth["sigma"], truth["lam"],
                                 truth["jump_mean"], truth["jump_std"],
                                 jnp.asarray(TS)))
    fit = calibrate_levy_to_ivs("merton", KS, TS, ivs, s0=S0, r=R,
                                n_iters=2500)
    assert fit["rmse_vol"] < 1e-3, fit
    # sigma and the jump-variance contribution are well identified; the
    # (lam, jump_mean, jump_std) triple trades off along equal-smile lines.
    assert abs(fit["sigma"] - truth["sigma"]) < 0.015, fit


def test_kou_surface_recovery():
    from montecarlo.engine.cf_pricing import kou_log_cf

    truth = dict(sigma=0.15, lam=1.0, p_up=0.35, eta1=9.0, eta2=4.0)
    ivs = _surface(kou_log_cf(S0, R, truth["sigma"], truth["lam"],
                              truth["p_up"], truth["eta1"], truth["eta2"],
                              jnp.asarray(TS)))
    fit = calibrate_levy_to_ivs("kou", KS, TS, ivs, s0=S0, r=R,
                                n_iters=2500)
    assert fit["rmse_vol"] < 1e-3, fit
    assert abs(fit["sigma"] - truth["sigma"]) < 0.02, fit
    assert fit["eta1"] > 1.0 and fit["eta2"] > 0.0 and 0 < fit["p_up"] < 1
