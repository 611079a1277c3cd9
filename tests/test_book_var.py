"""Desk market-risk VaR on the netted trade book
(`engine.exposure.book_var`): full-revaluation horizon P&L vs closed-form
normal/lognormal quantiles, tail coherence, and the AMC rejection."""

import numpy as np
import pytest
import jax.numpy as jnp
from scipy.stats import norm

from montecarlo.engine.exposure import (book_var, swap_value_fn,
                                            swaption_value_fn)
from montecarlo.processes import GBM, Vasicek

H = 10.0 / 252.0
N = 1 << 15


def test_linear_rate_trade_matches_normal_var():
    """V = c (r - r0) under near-Brownian rates: horizon P&L is (up to the
    deterministic discount) c sigma_h Z, so VaR_q = e^{-r0 h} c sigma_h
    z_q in closed form."""
    r0, sig, c = 0.03, 0.01, 100.0
    model = Vasicek.create(r0, 1e-9, r0, sig, H / 10, dtype=jnp.float64)
    res = book_var(model, (lambda r, t: c * (r - r0),), N, horizon=H,
                   n_steps=10, seed=3)
    sig_h = sig * np.sqrt(H)
    for q in (0.95, 0.99):
        want = np.exp(-r0 * H) * c * sig_h * norm.ppf(q)
        got = float(res[f"var_{int(q * 100)}"])
        se = float(res[f"var_{int(q * 100)}_std_err"])
        assert abs(got - want) < 4 * se + 1e-4, (q, got, want, se)
        # CVaR of a normal: sigma phi(z_q)/(1-q) — also closed form.
        want_c = np.exp(-r0 * H) * c * sig_h * norm.pdf(norm.ppf(q)) / (1 - q)
        got_c = float(res[f"cvar_{int(q * 100)}"])
        se_c = float(res[f"cvar_{int(q * 100)}_std_err"])
        assert abs(got_c - want_c) < 5 * se_c + 1e-4, (q, got_c, want_c)


def test_equity_forward_matches_lognormal_var():
    """Forward P&L collapses to e^{-rh} S_h - S_0 (strike-independent), so
    VaR_q = S_0 (1 - exp(-sigma^2 h / 2 + sigma sqrt(h) z_{1-q}))."""
    s0, r, sigma, t_mat = 100.0, 0.03, 0.25, 1.0
    model = GBM.create(s0, r, sigma, H / 10, dtype=jnp.float64)
    k = s0 * np.exp(r * t_mat)
    fwd = lambda s, t: s - k * jnp.exp(-r * (t_mat - t))
    res = book_var(model, (fwd,), N, horizon=H, n_steps=10, seed=5,
                   flat_rate=r)
    for q in (0.95, 0.99):
        z = norm.ppf(1 - q)
        want = s0 * (1.0 - np.exp(-0.5 * sigma**2 * H
                                  + sigma * np.sqrt(H) * z))
        got = float(res[f"var_{int(q * 100)}"])
        se = float(res[f"var_{int(q * 100)}_std_err"])
        assert abs(got - want) < 4 * se + 1e-3, (q, got, want, se)
    # v0 is the time-0 book value (here 0: par-forward strike).
    assert abs(float(res["v0"])) < 1e-10


def test_tail_coherence_and_swaption_book():
    model = Vasicek.create(0.03, 0.6, 0.04, 0.012, H / 10,
                           dtype=jnp.float64)
    pay = tuple(1.0 + 0.25 * np.arange(1, 5))
    book = (swap_value_fn(model, 0.035, pay, 0.25),
            swaption_value_fn(model, 0.035, 1.0, pay, 0.25))
    res = book_var(model, book, 1 << 14, horizon=H, n_steps=10, seed=7)
    v95, v99 = float(res["var_95"]), float(res["var_99"])
    c95, c99 = float(res["cvar_95"]), float(res["cvar_99"])
    assert np.isfinite(v95) and np.isfinite(c99)
    assert v99 >= v95 and c95 >= v95 and c99 >= v99


def test_amc_trades_rejected():
    from montecarlo.engine.amc import bermudan_swaption_amc_trade

    model = Vasicek.create(0.03, 0.6, 0.04, 0.012, H / 10,
                           dtype=jnp.float64)
    pay = tuple(1.0 + 0.25 * np.arange(1, 5))
    amc = bermudan_swaption_amc_trade(model, 0.035, pay, 0.25,
                                      n_exercise=2)
    with pytest.raises(TypeError, match="netting_set_profile"):
        book_var(model, (amc,), 1024, horizon=H, seed=1)


def test_cli_book_var(capsys):
    import json

    from montecarlo import cli

    rc = cli.main(["xva", "--portfolio", "--no-csa", "--paths", "4096",
                   "--steps", "40", "--var-horizon", str(H)])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["book_var_99"] >= out["book_var_95"] > 0


def test_horizon_dt_mismatch_rejected():
    """Regression: simulate() advances by the MODEL's dt, so a model
    built for the exposure grid must be rejected rather than silently
    diffusing n_steps * dt instead of the horizon (caught in review:
    the CLI once inflated VaR ~3.5x this way)."""
    model = Vasicek.create(0.03, 0.6, 0.04, 0.012, 0.05,
                           dtype=jnp.float64)  # dt != H/10
    with pytest.raises(ValueError, match="horizon"):
        book_var(model, (lambda r, t: r,), 256, horizon=H, n_steps=10,
                 seed=1)
