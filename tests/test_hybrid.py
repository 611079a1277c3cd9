"""Equity x Vasicek hybrid (`processes/hybrid.py`): exact-transition
claims — closed-form call at FOUR steps, pathwise-martingale discounted
stock, ZCB recovery from the same simulation — plus sampler hygiene."""

import numpy as np
import jax.numpy as jnp
import pytest

from montecarlo.engine import simulate
from montecarlo.engine.rates import vasicek_zcb
from montecarlo.processes import (EquityVasicekHybrid,
                                      hybrid_call_closed_form,
                                      hybrid_price_mc)

S0, R0, KAP, TH, SR, SS, RHO = 100.0, 0.03, 0.6, 0.05, 0.015, 0.22, -0.35


def _proc(T, n_steps):
    return EquityVasicekHybrid.create(S0, R0, KAP, TH, SR, SS, RHO,
                                      T / n_steps)


@pytest.mark.parametrize("n_steps", [4, 64])
def test_call_matches_closed_form_any_step_count(n_steps):
    """ZERO discretization error: the 5y call price agrees with the
    stochastic-rates Black closed form at 4 steps as well as 64."""
    T, k = 5.0, 110.0
    est = hybrid_price_mc(_proc(T, n_steps),
                          lambda s: jnp.maximum(s - k, 0.0), 1 << 17,
                          n_steps, seed=3)
    cf = hybrid_call_closed_form(S0, k, T, R0, KAP, TH, SR, SS, RHO)
    assert abs(float(est["price"]) - cf) < 4 * float(est["std_err"]), \
        (n_steps, float(est["price"]), cf)


def test_rates_matter_vs_flat_gbm():
    """The hybrid premium over flat-rate BS is real at 5y (positive
    rate-equity variance contribution dominates here)."""
    from montecarlo.engine import black_scholes_call

    T, k = 5.0, 110.0
    cf = hybrid_call_closed_form(S0, k, T, R0, KAP, TH, SR, SS, RHO)
    bs = float(black_scholes_call(S0, k, R0, SS, T))
    assert abs(cf - bs) > 0.1, (cf, bs)


def test_discounted_stock_martingale_pathwise():
    """e^{-int r} S_T = s0 exp(sigma_s W_s - sigma_s^2 t/2) PATHWISE (the
    rate integral cancels exactly in the exact scheme), so the discounted
    mean hits s0 within tight MC error and has rate-free variance."""
    n_steps, T = 8, 2.0
    proc = _proc(T, n_steps)
    est = hybrid_price_mc(proc, lambda s: s, 1 << 17, n_steps, seed=7)
    se = float(est["std_err"])
    assert abs(float(est["price"]) - S0) < 4 * se, est
    # The cancellation means the std-err matches a PURE GBM's (no rate
    # noise): sigma of e^{-r t}S_T under flat GBM = s0 sqrt(e^{v}-1).
    v = SS * SS * T
    pure = S0 * np.sqrt(np.exp(v) - 1.0) / np.sqrt(1 << 17)
    assert abs(se - pure) < 0.15 * pure, (se, pure)


def test_zcb_recovered_exactly():
    """E[e^{-int r}] from the hybrid's exact integral == the Vasicek
    affine bond at ANY step count."""
    T, n_steps = 3.0, 2
    est = hybrid_price_mc(_proc(T, n_steps), lambda s: jnp.ones_like(s),
                          1 << 17, n_steps, seed=11)
    cf = float(vasicek_zcb(R0, KAP, TH, SR, T))
    assert abs(float(est["price"]) - cf) < 4 * float(est["std_err"]), \
        (float(est["price"]), cf)


def test_create_validation():
    with pytest.raises(ValueError):
        EquityVasicekHybrid.create(S0, R0, 0.0, TH, SR, SS, RHO, 0.01)
    with pytest.raises(ValueError):
        EquityVasicekHybrid.create(S0, R0, KAP, TH, SR, SS, 1.5, 0.01)


def test_simulate_paths_mode_works():
    """The generic engine runs the hybrid (prices mode) — percentile
    charts etc. reuse the standard machinery."""
    paths = simulate(_proc(1.0, 16), 1024, 16, seed=5, mode="paths")
    assert paths.shape == (17, 1024)
    assert np.isfinite(np.asarray(paths)).all()


def test_cli_price_hybrid(capsys):
    import json

    from montecarlo import cli

    rc = cli.main(["price", "--process", "hybrid", "--maturity", "5",
                   "--strike", "110", "--steps", "8", "--paths", "32768",
                   "--theta", "0.05", "--kappa", "0.6", "--rho", "-0.35"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert abs(out["price"] - out["closed_form"]) < 5 * out["std_err"], out
