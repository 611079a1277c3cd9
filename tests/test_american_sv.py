"""Stochastic-vol American LSM (`engine/american.py::lsm_policy_sv`):
degenerate-Heston parity with the binomial oracle, the (S, v)-basis's
bracket under real Heston dynamics, and GARCH-American on the reference's
own process."""

import numpy as np
import jax.numpy as jnp

from montecarlo.engine import (andersen_broadie_bound_sv,
                                   binomial_american_put, lsm_policy_sv,
                                   lsm_price, lsm_price_sv)
from montecarlo.engine.heston_analytic import HestonParams, heston_call_cf
from montecarlo.processes import GARCHBootstrap, Heston


def _put(k):
    return lambda s: jnp.maximum(k - s, 0.0)


def test_heston_xi_zero_matches_binomial():
    """xi ~ 0 with v0 = theta freezes the variance: the Heston American
    put must match the constant-vol binomial oracle (the degenerate limit
    that catches basis/discounting bugs)."""
    s0, k, r, sig, t = 36.0, 40.0, 0.06, 0.2, 1.0
    steps = 50
    proc = Heston.create(s0=s0, v0=sig**2, mu=r, kappa=1.0, theta=sig**2,
                         xi=1e-6, rho=0.0, dt=t / steps)
    est = lsm_price_sv(proc, _put(k), 1 << 17, steps, seed=3, rate=r,
                       dt=t / steps, degree=2)
    oracle = binomial_american_put(s0, k, r, sig, t, n_steps=1000)
    err = abs(float(est["price"]) - oracle)
    assert err < 4 * float(est["std_err"]) + 0.05, (est, oracle)


def test_heston_sv_bracket_and_policy_gain():
    """Real Heston dynamics (the Ikonen-Toivanen parameter set): the
    (S, v) policy's LSM/dual bracket is tight, sits above the European CF
    floor, and the vol-aware policy prices at least as well as the
    spot-only regression."""
    s0, k, r, t = 10.0, 10.0, 0.1, 0.25
    v0, kappa, theta, xi, rho = 0.0625, 5.0, 0.16, 0.9, 0.1
    steps = 50
    dt = t / steps
    proc = Heston.create(s0=s0, v0=v0, mu=r, kappa=kappa, theta=theta,
                         xi=xi, rho=rho, dt=dt)
    res, policy = lsm_policy_sv(proc, _put(k), 1 << 17, steps, seed=7,
                                rate=r, dt=dt, degree=2, value_degree=5)
    lo, lo_se = float(res["price"]), float(res["std_err"])
    ub = andersen_broadie_bound_sv(proc, _put(k), policy, 2048, 256, steps,
                                   seed=7, rate=r, dt=dt, degree=2,
                                   value_degree=5)
    hi, hi_se = float(ub["upper"]), float(ub["std_err"])
    assert lo <= hi + 4 * (lo_se + hi_se), (lo, hi)
    assert hi - lo < 0.05 * lo + 4 * (lo_se + hi_se), (lo, hi)
    # European floor from the CF price via put-call parity.
    hp = HestonParams(v0=jnp.float32(v0), kappa=jnp.float32(kappa),
                      theta=jnp.float32(theta), xi=jnp.float32(xi),
                      rho=jnp.float32(rho))
    euro_put = (float(heston_call_cf(s0, k, t, r, hp))
                - s0 + k * np.exp(-r * t))
    assert lo > euro_put - 4 * lo_se, (lo, euro_put)
    assert hi > euro_put, (hi, euro_put)
    # The spot-only policy cannot beat the (S, v) policy beyond noise.
    plain = lsm_price(proc, _put(k), 1 << 17, steps, seed=7, rate=r, dt=dt,
                      degree=2)
    assert lo > float(plain["price"]) - 4 * (lo_se
                                             + float(plain["std_err"]))


def test_garch_american_put():
    """American exercise on the reference's own process: the GARCH
    conditional variance is the natural second regressor (GARCHState.var);
    the American put must dominate its own European value."""
    rng = np.random.default_rng(5)
    returns = rng.normal(0.0, 0.013, 500)
    s0, k, r = 100.0, 102.0, 0.03
    steps = 20
    dt = 1.0 / 252.0
    proc = GARCHBootstrap.create(returns, s0, var0=0.013**2)
    est = lsm_price_sv(proc, _put(k), 1 << 16, steps, seed=11, rate=r,
                       dt=dt, degree=2)
    # European on the same paths/payoff.
    from montecarlo.engine import mc_estimate, simulate

    term = simulate(proc, 1 << 16, steps, seed=11)
    euro = mc_estimate(jnp.maximum(k - term, 0.0),
                       float(np.exp(-r * dt * steps)))
    assert float(est["price"]) >= float(euro["price"]) - 4 * (
        float(est["std_err"]) + float(euro["std_err"]))
    # ITM American put on a short grid: early exercise is worth something,
    # so the price should also be at least intrinsic.
    assert float(est["price"]) >= (k - s0) - 4 * float(est["std_err"])
