"""Euler trade-level xVA allocation (`engine.exposure.xva_trade_allocations`):
exact additivity under positive homogeneity, single-trade identity, sign of
risk-reducing trades, and the reported gap when a CSA threshold breaks
homogeneity."""

import numpy as np
import pytest
import jax.numpy as jnp

from montecarlo.engine.exposure import (CSA, netting_set_profile,
                                            xva_trade_allocations)
from montecarlo.processes import Vasicek

R0, KAPPA, THETA, SIG = 0.03, 0.6, 0.04, 0.012
T, N_STEPS, N = 2.0, 32, 2048


def _model():
    return Vasicek.create(R0, KAPPA, THETA, SIG, T / N_STEPS,
                          dtype=jnp.float64)


def _book(model):
    from montecarlo.engine.exposure import swap_value_fn

    pay = np.arange(1, 5) * 0.5
    v1 = swap_value_fn(model, 0.035, pay, 0.5)
    v2 = swap_value_fn(model, 0.04, pay[:2], 0.5)
    return v1, lambda r, t: -0.5 * v2(r, t)


def test_allocations_sum_to_totals_uncollateralized():
    model = _model()
    trades = _book(model)
    kw = dict(T=T, seed=11, hazard_rate=0.02, own_hazard_rate=0.01,
              funding_spread=0.004, im_spread=0.003, kva_cost=0.10,
              wwr_beta=0.4)
    outs = ("cva", "dva", "bcva", "fca", "fba", "fva", "kva", "mva",
            "cva_wwr")
    res = xva_trade_allocations(model, trades, N, N_STEPS, outputs=outs,
                                **kw)
    want = netting_set_profile(model, trades, N, N_STEPS, **kw)
    for k in outs:
        # Totals are the engine's own numbers (same seed, same body).
        np.testing.assert_allclose(float(res["values"][k]),
                                   float(want[k]), rtol=1e-12, atol=1e-15,
                                   err_msg=k)
        # Euler's theorem: positively homogeneous book -> exact additivity.
        np.testing.assert_allclose(float(jnp.sum(res["allocations"][k])),
                                   float(want[k]), rtol=1e-9, atol=1e-13,
                                   err_msg=k)
        assert abs(float(res["allocation_gap"][k])) <= (
            1e-9 * abs(float(want[k])) + 1e-13), k


def test_single_trade_allocation_is_the_total():
    model = _model()
    v1, _ = _book(model)
    res = xva_trade_allocations(model, (v1,), N, N_STEPS, T=T, seed=3,
                                hazard_rate=0.02, outputs=("cva",))
    np.testing.assert_allclose(float(res["allocations"]["cva"][0]),
                               float(res["values"]["cva"]), rtol=1e-9)


def test_offsetting_trade_gets_negative_cva_allocation():
    """A trade that hedges the netted exposure should be PAID a credit
    charge (negative allocation) — the Euler decomposition's signature
    property that standalone CVAs can never show."""
    model = _model()
    v1, _ = _book(model)
    neg = lambda r, t: -0.4 * v1(r, t)
    res = xva_trade_allocations(model, (v1, neg), N, N_STEPS, T=T, seed=5,
                                hazard_rate=0.02, outputs=("cva",))
    alloc = np.asarray(res["allocations"]["cva"])
    assert alloc[0] > 0 and alloc[1] < 0
    np.testing.assert_allclose(alloc.sum(), float(res["values"]["cva"]),
                               rtol=1e-9)


def test_zero_threshold_csa_still_additive():
    """Zero-threshold/MTA variation margin is itself homogeneous in the
    trade scales, so the collateralized CVA still allocates exactly."""
    model = _model()
    trades = _book(model)
    csa = CSA(threshold=0.0, own_threshold=0.0, mta=0.0, mpor=4 * T / 32)
    res = xva_trade_allocations(model, trades, N, N_STEPS, T=T, seed=7,
                                csa=csa, hazard_rate=0.02,
                                outputs=("cva", "fva"))
    for k in ("cva", "fva"):
        np.testing.assert_allclose(float(jnp.sum(res["allocations"][k])),
                                   float(res["values"][k]), rtol=1e-9,
                                   atol=1e-13, err_msg=k)


def test_threshold_breaks_additivity_and_gap_reports_it():
    model = _model()
    trades = _book(model)
    csa = CSA(threshold=0.004, mpor=4 * T / 32)
    with pytest.warns(UserWarning, match="not sum to the total"):
        res = xva_trade_allocations(model, trades, N, N_STEPS, T=T,
                                    seed=7, csa=csa, hazard_rate=0.02,
                                    outputs=("cva",))
    gap = float(res["allocation_gap"]["cva"])
    got = float(jnp.sum(res["allocations"]["cva"]))
    total = float(res["values"]["cva"])
    np.testing.assert_allclose(gap, total - got, rtol=1e-12)
    assert abs(gap) > 1e-7 * abs(total)  # genuinely non-additive


def test_rejects_vector_outputs():
    model = _model()
    v1, _ = _book(model)
    with pytest.raises(ValueError, match="epe"):
        xva_trade_allocations(model, (v1,), N, N_STEPS, T=T, seed=1,
                              outputs=("epe",))
