"""Stress/scenario grids: closed-form parity per scenario, common-random-
number smoothness, and the named-scenario report."""

import jax.numpy as jnp
import numpy as np

from montecarlo.api.stress import (ladder, standard_scenarios,
                                       stress_grid, stress_report)
from montecarlo.engine import black_scholes_call
from montecarlo.processes import GBM

S0, R, SIGMA, STRIKE, T, N_STEPS = 100.0, 0.03, 0.2, 105.0, 1.0, 32
N = 1 << 15


def _proc():
    return GBM.create(s0=S0, mu=R, sigma=SIGMA, dt=T / N_STEPS,
                      dtype=jnp.float64)


def _call(s):
    return jnp.maximum(s - STRIKE, 0.0)


def test_grid_matches_black_scholes_per_scenario():
    """Each bumped GBM scenario is itself a BS model — the whole price
    surface has a closed form."""
    ba = ladder(-0.2, 0.2, 5)
    bb = ladder(-0.5, 0.5, 5)
    g = stress_grid(_proc(), _call, N, N_STEPS, bumps_a=ba, bumps_b=bb,
                    seed=3, discount=float(np.exp(-R * T)),
                    dtype=jnp.float64)
    prices = np.asarray(g["prices"])
    for i, a in enumerate(ba):
        for j, b in enumerate(bb):
            bs = float(black_scholes_call(S0 * (1 + a), STRIKE, R,
                                          SIGMA * (1 + b), T))
            assert abs(prices[i, j] - bs) < 0.25, (a, b, prices[i, j], bs)


def test_grid_monotone_and_zero_base_pnl():
    ba = ladder(-0.2, 0.2, 5)
    bb = ladder(-0.5, 0.5, 5)
    g = stress_grid(_proc(), _call, N, N_STEPS, bumps_a=ba, bumps_b=bb,
                    seed=3, discount=float(np.exp(-R * T)),
                    dtype=jnp.float64)
    prices = np.asarray(g["prices"])
    pnl = np.asarray(g["pnl"])
    # Call price increases in spot and in vol — common random numbers make
    # this hold pathwise, not just in expectation.
    assert (np.diff(prices, axis=0) > 0).all()
    assert (np.diff(prices, axis=1) > 0).all()
    i0 = int(np.argmin(np.abs(ba)))
    j0 = int(np.argmin(np.abs(bb)))
    assert pnl[i0, j0] == 0.0
    assert float(g["base_price"]) == prices[i0, j0]


def test_stress_report_named_scenarios():
    rep = stress_report(_proc(), _call, N, N_STEPS, seed=3,
                        discount=float(np.exp(-R * T)), dtype=jnp.float64)
    scen = rep["scenarios"]
    assert set(scen) == set(standard_scenarios())
    assert scen["base"]["pnl"] == 0.0
    # A long call loses in a crash (spot -30% dominates vol +100% here) and
    # gains in a melt-up.
    assert scen["spot_down_20"]["pnl"] < 0 < scen["spot_up_20"]["pnl"]
    assert scen["vol_up_50"]["pnl"] > 0 > scen["vol_down_30"]["pnl"]
    assert scen["melt_up"]["pnl"] > 0


def test_ladder_contains_base():
    g = ladder(-0.15, 0.15, 4)
    assert (g == 0.0).any()
    assert g.min() == -0.15 and g.max() == 0.15
