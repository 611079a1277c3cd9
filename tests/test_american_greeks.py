"""American Greeks by policy freezing
(`engine/american.py::american_price_and_greeks`): delta/vega against
central differences of the CRR binomial oracle, the no-dividend-call
European degeneracy, and out-of-sample price consistency."""

import numpy as np
import jax.numpy as jnp

from montecarlo.engine import (american_price_and_greeks,
                                   binomial_american_put,
                                   black_scholes_delta, lsm_exercise_policy,
                                   lsm_price)
from montecarlo.processes import GBM

S0, K, R, SIG, T = 36.0, 40.0, 0.06, 0.2, 1.0
STEPS = 50
DT = T / STEPS


def _put(s):
    return jnp.maximum(K - s, 0.0)


def _setup(n_paths=1 << 17):
    proc = GBM.create(s0=S0, mu=R, sigma=SIG, dt=DT)
    policy = lsm_exercise_policy(proc, _put, n_paths, STEPS, seed=3,
                                 rate=R, dt=DT, degree=3)
    return proc, policy


def test_american_put_delta_vs_binomial_fd():
    proc, policy = _setup()
    price, g = american_price_and_greeks(proc, _put, policy, 1 << 17,
                                         STEPS, seed=3, rate=R, dt=DT,
                                         degree=3)
    # Out-of-sample frozen-policy price agrees with the in-sample LSM.
    ls = lsm_price(proc, _put, 1 << 17, STEPS, seed=3, rate=R, dt=DT,
                   degree=3)
    assert abs(float(price) - float(ls["price"])) < \
        8 * float(ls["std_err"]), (float(price), ls)
    # CRR central differences as the delta/vega oracle.
    h = 0.25
    delta_oracle = (binomial_american_put(S0 + h, K, R, SIG, T, 1500)
                    - binomial_american_put(S0 - h, K, R, SIG, T, 1500)) \
        / (2 * h)
    assert abs(float(g.s0) - delta_oracle) < 0.02, (float(g.s0),
                                                    delta_oracle)
    hv = 0.005
    vega_oracle = (binomial_american_put(S0, K, R, SIG + hv, T, 1500)
                   - binomial_american_put(S0, K, R, SIG - hv, T, 1500)) \
        / (2 * hv)
    assert abs(float(g.sigma) - vega_oracle) < 0.05 * vega_oracle + 0.3, \
        (float(g.sigma), vega_oracle)


def test_american_call_no_dividend_degenerates_to_european():
    """An American call on a non-dividend asset is never exercised early,
    so its delta must match the Black-Scholes European delta."""
    proc = GBM.create(s0=100.0, mu=R, sigma=SIG, dt=DT)
    call = lambda s: jnp.maximum(s - 105.0, 0.0)
    policy = lsm_exercise_policy(proc, call, 1 << 16, STEPS, seed=5,
                                 rate=R, dt=DT, degree=3)
    price, g = american_price_and_greeks(proc, call, policy, 1 << 17,
                                         STEPS, seed=5, rate=R, dt=DT,
                                         degree=3)
    bs_delta = float(black_scholes_delta(100.0, 105.0, R, SIG, T))
    assert abs(float(g.s0) - bs_delta) < 0.01, (float(g.s0), bs_delta)
