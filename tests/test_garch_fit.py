"""GARCH(1,1) QMLE: parameter recovery on simulated data."""

import numpy as np
import pytest

from montecarlo.processes.garch_fit import fit_garch


def _simulate_garch(omega, alpha, beta, n, seed):
    rng = np.random.default_rng(seed)
    var = omega / (1 - alpha - beta)
    out = np.empty(n)
    for t in range(n):
        r = np.sqrt(var) * rng.normal()
        out[t] = r
        var = omega + alpha * r * r + beta * var
    return out


def test_recovers_known_parameters():
    true = dict(omega=2e-5, alpha=0.12, beta=0.80)
    r = _simulate_garch(n=8000, seed=0, **true)
    est = fit_garch(r, n_iters=800)
    # QMLE sampling error at n=8000: generous but discriminating bounds.
    assert abs(est.alpha - true["alpha"]) < 0.05, est
    assert abs(est.beta - true["beta"]) < 0.08, est
    assert 0.3 * true["omega"] < est.omega < 3 * true["omega"], est
    # Persistence (the quantity that drives forecasts) is tight.
    assert abs((est.alpha + est.beta) - 0.92) < 0.05, est


def test_stationarity_constraints_hold():
    rng = np.random.default_rng(1)
    est = fit_garch(rng.normal(0, 0.01, 2000), n_iters=300)
    assert est.omega > 0 and est.alpha > 0 and est.beta > 0
    assert est.alpha + est.beta < 1.0


def test_fitted_params_drive_the_process():
    from montecarlo.engine import simulate
    from montecarlo.processes import GARCHBootstrap

    r = _simulate_garch(2e-5, 0.1, 0.85, 3000, seed=2)
    est = fit_garch(r, n_iters=400)
    proc = GARCHBootstrap.create(r, s0=100.0, var0=float(r[-20:].var()),
                                 omega=est.omega, alpha=est.alpha,
                                 beta=est.beta)
    s_t = np.asarray(simulate(proc, 4096, 20, seed=3))
    assert np.all(np.isfinite(s_t)) and np.all(s_t > 0)
