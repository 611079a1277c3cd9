"""Bermudan swaptions under Vasicek: European limit vs Jamshidian's closed
form, and exercise-right monotonicity."""

import numpy as np
import jax.numpy as jnp

from montecarlo.engine.bermudan import (
    bermudan_swaption_lsm,
    vasicek_swaption_jamshidian,
)
from montecarlo.engine.rates import vasicek_zcb
from montecarlo.processes import Vasicek

R0, KAPPA, THETA, SIGMA = 0.03, 0.5, 0.04, 0.012
STEPS_PER_PERIOD, N_PERIODS = 16, 8
DELTA = 0.25  # quarterly
DT = DELTA / STEPS_PER_PERIOD


def _model():
    return Vasicek.create(R0, KAPPA, THETA, SIGMA, DT, dtype=jnp.float64)


def _par_strike():
    """ATM-ish fixed rate for the swap paid at (2..N_PERIODS) * DELTA seen
    from the first reset (the European underlying)."""
    ps = [vasicek_zcb(R0, KAPPA, THETA, SIGMA, i * DELTA)
          for i in range(2, N_PERIODS + 1)]
    p1 = vasicek_zcb(R0, KAPPA, THETA, SIGMA, DELTA)
    return (p1 - ps[-1]) / (DELTA * sum(ps))


def test_european_limit_matches_jamshidian():
    strike = _par_strike()
    res = bermudan_swaption_lsm(_model(), strike, n_paths=1 << 16,
                                steps_per_period=STEPS_PER_PERIOD,
                                n_periods=N_PERIODS, n_exercise=1, seed=3)
    cf = vasicek_swaption_jamshidian((KAPPA, THETA, SIGMA), strike,
                                     t0=DELTA, delta=DELTA,
                                     n_periods=N_PERIODS - 1, r0=R0)
    se = float(res["std_err"])
    # trapezoid-discounting bias is O(dt^2), tiny at 16 steps/period
    assert abs(float(res["price"]) - cf) < 4 * se + 5e-5, (
        float(res["price"]), cf, se)


def test_more_exercise_dates_add_value():
    strike = _par_strike()
    prices = []
    for n_ex in (1, 3, 6):
        res = bermudan_swaption_lsm(_model(), strike, n_paths=1 << 15,
                                    steps_per_period=STEPS_PER_PERIOD,
                                    n_periods=N_PERIODS, n_exercise=n_ex,
                                    seed=7)
        prices.append((float(res["price"]), float(res["std_err"])))
    for (lo, lo_se), (hi, hi_se) in zip(prices, prices[1:]):
        assert hi > lo - 2 * (lo_se + hi_se), prices
    # The extra rights must be worth something real at the money.
    assert prices[-1][0] > prices[0][0] + prices[0][1], prices


def test_deterministic():
    strike = _par_strike()
    kw = dict(n_paths=1 << 13, steps_per_period=STEPS_PER_PERIOD,
              n_periods=N_PERIODS, n_exercise=3, seed=11)
    a = bermudan_swaption_lsm(_model(), strike, **kw)
    b = bermudan_swaption_lsm(_model(), strike, **kw)
    assert float(a["price"]) == float(b["price"])


def test_jamshidian_degenerates_to_bond_option():
    """One-period swap: the swaption IS a single bond put (scaled)."""
    from montecarlo.engine.rates import vasicek_bond_option

    strike = 0.035
    cf = vasicek_swaption_jamshidian((KAPPA, THETA, SIGMA), strike, t0=1.0,
                                     delta=0.5, n_periods=1, r0=R0)
    # payer swaption on one payment = (1 + K*delta) * put on the T2-bond
    # struck at 1/(1+K*delta)
    c = 1.0 + strike * 0.5
    direct = c * vasicek_bond_option(R0, KAPPA, THETA, SIGMA, 1.0, 1.5,
                                     1.0 / c, call=False)
    assert abs(cf - direct) < 1e-12


def test_n_exercise_bounds_validated():
    import pytest

    model = Vasicek.create(r0=0.03, kappa=0.8, theta=0.05, sigma=0.015,
                           dt=1 / 16)
    with pytest.raises(ValueError, match="n_exercise"):
        bermudan_swaption_lsm(model, 0.05, n_paths=256, steps_per_period=4,
                              n_periods=4, n_exercise=4, seed=0)
