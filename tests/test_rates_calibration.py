"""Vasicek swaption calibration (`engine.rates_calibration`): the batched
traced-Newton Jamshidian pricer vs the host-brentq oracle, demo parameter
recovery, and the CLI path."""

import numpy as np

from montecarlo.engine.bermudan import vasicek_swaption_jamshidian
from montecarlo.engine.rates_calibration import (
    calibrate_vasicek_to_swaptions, vasicek_swaption_prices)

KAP, TH, SG, R0 = 0.8, 0.05, 0.015, 0.03


def _quotes():
    exp_, pdt, ks, nper = [], [], [], []
    for t0 in (1.0, 2.0, 3.0):
        for m in (4, 8):
            for k in (0.036, 0.045, 0.054):
                exp_.append(t0)
                pdt.append(0.5)
                ks.append(k)
                nper.append(m)
    return (np.asarray(exp_), np.asarray(pdt), np.asarray(ks),
            np.asarray(nper))


def test_batched_pricer_matches_jamshidian_oracle():
    e, d, k, m = _quotes()
    prices = np.asarray(vasicek_swaption_prices(R0, KAP, TH, SG, e, d, k,
                                                m))
    assert np.all(prices > 0)
    for i in range(len(e)):
        want = vasicek_swaption_jamshidian(
            (KAP, TH, SG), float(k[i]), float(e[i]), float(d[i]),
            int(m[i]), R0)
        np.testing.assert_allclose(prices[i], want, rtol=1e-10,
                                   err_msg=str(i))


def test_demo_surface_recovery():
    """18 quotes across 3 expiries x 2 tenors x 3 strikes generated from
    known parameters: the calibrator must recover them from a cold start
    and reprice the surface to well under a relative basis point."""
    e, d, k, m = _quotes()
    prices = np.asarray(vasicek_swaption_prices(R0, KAP, TH, SG, e, d, k,
                                                m))
    out = calibrate_vasicek_to_swaptions(e, d, k, m, prices, r0=R0)
    assert out["rmse_rel"] < 5e-4, out
    np.testing.assert_allclose(out["kappa"], KAP, rtol=0.05)
    np.testing.assert_allclose(out["theta"], TH, rtol=0.03)
    np.testing.assert_allclose(out["sigma"], SG, rtol=0.03)


def test_cli_calibrate_vasicek(capsys):
    import json

    from montecarlo import cli

    rc = cli.main(["calibrate", "--model", "vasicek", "--iters", "1500"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["rmse_rel"] < 2e-3
    assert abs(out["kappa"] - out["demo_truth"]["kappa"]) < 0.1
