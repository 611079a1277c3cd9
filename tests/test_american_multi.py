"""Multi-asset Bermudan LSM + Andersen-Broadie dual
(`engine/american.py::lsm_policy_multi` / `andersen_broadie_bound_multi`)
against the PUBLISHED max-call benchmarks.

The setting is the standard one (Longstaff-Schwartz 2001 §8.1;
Andersen-Broadie 2004 Tables 2-3; Broadie-Cao 2008): call on the max of A
symmetric assets, K=100, r=5%, dividend yield 10%, sigma=20%, rho=0, T=3y,
9 equally spaced exercise dates.  Published true values: A=2 at
S0=90/100/110 -> 8.075 / 13.902 / 21.345; A=5 at S0=100 -> 26.15.
A valid implementation must produce LSM (low-biased) / dual (high-biased)
brackets containing these — an end-to-end check no unit oracle provides.
"""

import numpy as np
import jax.numpy as jnp

from montecarlo.engine import (andersen_broadie_bound_multi, lsm_price,
                                   lsm_policy_multi, lsm_price_multi,
                                   max_call)
from montecarlo.processes import GBM, MultiGBM

R, DIV, SIG, T, K = 0.05, 0.10, 0.20, 3.0, 100.0
N_EX = 9          # exercise dates (GBM is exact over any dt)
DT = T / N_EX


def _proc(a, s0):
    return MultiGBM.create(s0=[s0] * a, mu=[R - DIV] * a, sigma=[SIG] * a,
                           corr=np.eye(a), dt=DT)


def _payoff(p):
    return max_call(p, K)


def test_max_call_2asset_brackets_published():
    """LSM lower / AB-dual upper bracket the published 13.902."""
    true = 13.902
    res, policy = lsm_policy_multi(_proc(2, 100.0), _payoff, 1 << 17, N_EX,
                                   seed=11, rate=R, dt=DT, degree=3,
                                   value_degree=3)
    lo, lo_se = float(res["price"]), float(res["std_err"])
    ub = andersen_broadie_bound_multi(_proc(2, 100.0), _payoff, policy,
                                      1024, 128, N_EX, seed=11, rate=R,
                                      dt=DT, degree=3, value_degree=3)
    hi, hi_se = float(ub["upper"]), float(ub["std_err"])
    assert lo - 4 * lo_se <= true <= hi + 4 * hi_se, (lo, hi)
    assert lo <= hi, (lo, hi)
    # Policy quality: the LSM low bias stays small and the dual stays tight.
    assert true - lo < 0.20, lo
    assert hi - true < 0.40, hi


def test_max_call_2asset_itm_otm():
    """The other two published 2-asset points (LSM side only)."""
    for s0, true in ((90.0, 8.075), (110.0, 21.345)):
        res = lsm_price_multi(_proc(2, s0), _payoff, 1 << 17, N_EX, seed=11,
                              rate=R, dt=DT, degree=3)
        price, se = float(res["price"]), float(res["std_err"])
        assert true - 0.15 - 4 * se < price < true + 4 * se, (s0, price)


def test_max_call_5asset():
    """5-asset max-call at S0=100: published 26.15 (degree-2 sorted basis
    — 21 terms; higher degrees overfit 2^16 paths in-sample)."""
    res = lsm_price_multi(_proc(5, 100.0), _payoff, 1 << 16, N_EX, seed=13,
                          rate=R, dt=DT, degree=2)
    price, se = float(res["price"]), float(res["std_err"])
    assert abs(price - 26.15) < 4 * se + 0.08, (price, se)


def test_unsorted_basis_still_prices():
    """sort_assets=False (the non-exchangeable-payoff path) loses a little
    fit quality but must stay consistent."""
    res = lsm_price_multi(_proc(2, 100.0), _payoff, 1 << 16, N_EX, seed=19,
                          rate=R, dt=DT, degree=3, sort_assets=False)
    assert abs(float(res["price"]) - 13.902) < 0.30, res


def test_cli_max_call(capsys):
    """CLI round-trip: Bermudan 2-asset max-call lands near the published
    13.902 even at smoke-test path counts."""
    import json

    from montecarlo import cli

    rc = cli.main(["price", "--payoff", "max-call", "--n-assets", "2",
                   "--div", "0.10", "--rate", "0.05", "--sigma", "0.2",
                   "--maturity", "3", "--steps", "9", "--paths", "32768",
                   "--strike", "100", "--american"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n_assets"] == 2
    assert 13.0 < out["price"] < 14.5, out


def test_singleton_matches_single_asset_engine():
    """A=1 MultiGBM through the multi LSM equals the single-asset LSM
    engine on the same seed (same draws, same regression family)."""
    p1 = MultiGBM.create(s0=[100.0], mu=[R - DIV], sigma=[SIG],
                         corr=np.eye(1), dt=DT)
    g1 = GBM.create(s0=100.0, mu=R - DIV, sigma=SIG, dt=DT)
    rm = lsm_price_multi(p1, _payoff, 1 << 15, N_EX, seed=17, rate=R, dt=DT,
                         degree=3)
    rs = lsm_price(g1, lambda s: jnp.maximum(s - K, 0.0), 1 << 15, N_EX,
                   seed=17, rate=R, dt=DT, degree=3)
    np.testing.assert_allclose(float(rm["price"]), float(rs["price"]),
                               rtol=1e-5)
