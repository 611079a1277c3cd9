"""European swaptions as netting-set trades (`swaption_value_fn`):
Jamshidian closed-form marks, cash vs physical settlement tails, the
PathDependentTrade plumbing, sharding parity, and differentiability."""

import numpy as np
import pytest
import jax.numpy as jnp

from montecarlo.engine.bermudan import vasicek_swaption_jamshidian
from montecarlo.engine.exposure import (netting_set_profile,
                                            swap_value_fn,
                                            swaption_value_fn, xva_greeks)
from montecarlo.engine.rates import vasicek_zcb
from montecarlo.engine.simulate import simulate
from montecarlo.processes import Vasicek

R0, KAPPA, THETA, SIG = 0.03, 0.6, 0.04, 0.012
T_END, N_STEPS = 2.0, 64
DT = T_END / N_STEPS
T0, DELTA, N_PAY, K = 1.0, 0.25, 4, 0.035
PAY_TIMES = tuple(T0 + DELTA * np.arange(1, N_PAY + 1))
SEED = 13


def _model():
    return Vasicek.create(R0, KAPPA, THETA, SIG, DT, dtype=jnp.float64)


def test_t0_mark_matches_jamshidian_oracle_and_parity():
    model = _model()
    payer = swaption_value_fn(model, K, T0, PAY_TIMES, DELTA, payer=True)
    recv = swaption_value_fn(model, K, T0, PAY_TIMES, DELTA, payer=False)
    r = jnp.full((4,), R0, jnp.float64)
    t = jnp.float64(0.0)
    v_p = float(payer.value_fn(r, t, r)[0])
    v_r = float(recv.value_fn(r, t, r)[0])
    oracle = vasicek_swaption_jamshidian((KAPPA, THETA, SIG), K, T0, DELTA,
                                         N_PAY, R0)
    np.testing.assert_allclose(v_p, oracle, rtol=1e-12)
    # payer - receiver = forward payer swap value at 0 (both decompositions
    # share r*, so the parity is exact up to the Newton root's roundoff).
    ps = [vasicek_zcb(R0, KAPPA, THETA, SIG, t_) for t_ in PAY_TIMES]
    fwd_swap = (vasicek_zcb(R0, KAPPA, THETA, SIG, T0) - ps[-1]) \
        - K * DELTA * sum(ps)
    np.testing.assert_allclose(v_p - v_r, fwd_swap, rtol=1e-10)


def test_payment_before_expiry_rejected():
    with pytest.raises(ValueError, match="after the swaption expiry"):
        swaption_value_fn(_model(), K, T0, (0.5, 1.5), 0.25)


def test_cash_settled_exposure_dies_at_expiry():
    model = _model()
    tr = swaption_value_fn(model, K, T0, PAY_TIMES, DELTA, physical=False)
    prof = netting_set_profile(model, (tr,), 2048, N_STEPS, T=T_END,
                               seed=SEED, hazard_rate=0.02)
    epe = np.asarray(prof["epe"])
    times = np.asarray(prof["times"])
    # An option's exposure is nonnegative and alive up to expiry...
    assert epe[times <= T0 + 1e-12].min() > 0.0
    # ...and identically zero once the cash settles.
    assert np.all(epe[times > T0 + 1e-12] == 0.0)


def test_physical_exposure_tail_is_indicator_times_swap():
    """Past expiry the netted mark must be exactly 1{exercise} * remaining
    swap value, with the indicator read from the path row AT expiry —
    recomputed here directly from the same simulation (validates the
    PathDependentTrade observation plumbing, not just the formula)."""
    model = _model()
    tr = swaption_value_fn(model, K, T0, PAY_TIMES, DELTA, physical=True)
    n = 2048
    prof = netting_set_profile(model, (tr,), n, N_STEPS, T=T_END,
                               seed=SEED, hazard_rate=0.02)
    paths = np.asarray(simulate(model, n, N_STEPS, seed=SEED, mode="paths",
                                dtype=jnp.float64))
    swap = swap_value_fn(model, K, PAY_TIMES, DELTA)
    k0 = int(round(T0 / DT))
    ind = np.asarray(swap(jnp.asarray(paths[k0]), jnp.float64(T0))) > 0
    assert 0 < ind.sum() < n  # a real mixture of exercised / lapsed paths
    resets = [T0 + i * DELTA for i in range(N_PAY)]
    epe = np.asarray(prof["epe"])
    for k in range(k0 + 1, N_STEPS + 1):
        t = k * DT
        t_fix = max(rs for rs in resets if rs <= t + 1e-9)
        k_fix = int(round(t_fix / DT))
        v_swap = np.asarray(swap(jnp.asarray(paths[k]), jnp.float64(t),
                                 jnp.asarray(paths[k_fix]),
                                 jnp.float64(t_fix)))
        want = np.mean(np.maximum(np.where(ind, v_swap, 0.0), 0.0))
        np.testing.assert_allclose(epe[k], want, rtol=1e-12, atol=1e-15,
                                   err_msg=f"row {k}")


def test_discounted_physical_mark_plus_paid_flows_is_martingale():
    """The closed-form mark is the conditional expectation of the
    REMAINING discounted cashflows, so

        E[D_t V_t + sum_{payments t_j <= t} D_{t_j} 1{ex} flow_j] = V_0

    must hold at every t — across the option phase, mid-period in the
    exercised-swap tail (this is what the exact in-period fixing buys;
    the reset-date float-leg approximation fails it by ~30 sigma), and
    past payment dates once the paid coupons are added back.  3.5-sigma
    MC band: the sharp end-to-end consistency check on the contract."""
    from montecarlo.engine.rates import vasicek_bond_from_rate

    model = _model()
    tr = swaption_value_fn(model, K, T0, PAY_TIMES, DELTA, physical=True)
    n = 1 << 15
    paths = simulate(model, n, N_STEPS, seed=SEED, mode="paths",
                     dtype=jnp.float64)
    mid = 0.5 * (paths[:-1] + paths[1:]) * DT
    disc = jnp.exp(-jnp.concatenate(
        [jnp.zeros((1, n), jnp.float64), jnp.cumsum(mid, axis=0)], axis=0))
    k0 = int(round(T0 / DT))
    obs_rows = lambda k: tuple(
        paths[min(k, int(round(ot / DT)))] for ot in tr.obs_times)
    v0 = float(tr.value_fn(paths[0], jnp.float64(0.0), *obs_rows(0))[0])
    swap = swap_value_fn(model, K, PAY_TIMES, DELTA)
    exercised = np.asarray(swap(paths[k0], jnp.float64(T0))) > 0

    def paid_flows_to(t):
        """Discounted payer netflows (float received - fixed paid) on
        exercised paths, for payments at or before t."""
        total = np.zeros(n)
        for j, t_j in enumerate(PAY_TIMES):
            if t_j > t + 1e-9:
                break
            k_j = int(round(t_j / DT))
            k_fix = int(round((t_j - DELTA) / DT))
            p_fix = np.asarray(vasicek_bond_from_rate(
                paths[k_fix], KAPPA, THETA, SIG, DELTA))
            flow = (1.0 / p_fix - 1.0) - K * DELTA
            total += np.asarray(disc[k_j]) * np.where(exercised, flow, 0.0)
        return total

    # Rows: option phase, expiry, mid-period before any payment, then
    # mid-period past one and past three payment dates.
    for k in (k0 // 2, k0, 36, 46, 62):
        t = k * DT
        dv = np.asarray(disc[k] * tr.value_fn(
            paths[k], jnp.float64(t), *obs_rows(k))) + paid_flows_to(t)
        se = dv.std(ddof=1) / np.sqrt(n)
        assert abs(dv.mean() - v0) < 3.5 * se + 1e-12, (k, dv.mean(), v0,
                                                        se)


def test_sharded_netting_with_swaption_matches_and_mesh_invariant():
    from montecarlo.parallel import make_mesh, sharded_netting_profile

    model = _model()
    swap = swap_value_fn(model, 0.03, PAY_TIMES, DELTA)
    tr = swaption_value_fn(model, K, T0, PAY_TIMES, DELTA, physical=True)
    trades = (tr, lambda r, t: -0.5 * swap(r, t))
    kw = dict(T=T_END, seed=SEED, hazard_rate=0.02)
    want = netting_set_profile(model, trades, 2048, N_STEPS, **kw)
    got = {n_dev: sharded_netting_profile(
        model, trades, 2048, N_STEPS, mesh=make_mesh(n_dev),
        block_size=256, pfe_bins=64, **kw) for n_dev in (2, 8)}
    for k, v in got[2].items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(got[8][k]),
                                      err_msg=k)
    np.testing.assert_allclose(np.asarray(got[8]["epe"]),
                               np.asarray(want["epe"]), rtol=1e-10,
                               atol=1e-15)
    np.testing.assert_allclose(float(got[8]["cva"]), float(want["cva"]),
                               rtol=1e-10)


def _build_swaption_book(p):
    model = Vasicek.create(p.get("r0", R0), KAPPA, THETA,
                           p.get("sigma", SIG), DT, dtype=jnp.float64)
    tr = swaption_value_fn(model, K, T0, PAY_TIMES, DELTA, physical=True)
    return model, (tr,), None


def test_swaption_book_greeks_match_finite_differences():
    """The Newton r* is differentiated through (no host root-finder), so
    swaption CVA greeks are exact derivatives of the seeded estimator —
    same-seed central differences must reproduce them."""
    kw = dict(T=T_END, seed=SEED, hazard_rate=0.02, recovery=0.4)
    res = xva_greeks(_build_swaption_book, {"r0": R0, "sigma": SIG},
                     2048, N_STEPS, outputs=("cva",), **kw)

    def level(r0, sigma):
        model, trades, _ = _build_swaption_book(
            {"r0": jnp.float64(r0), "sigma": jnp.float64(sigma)})
        return float(netting_set_profile(model, trades, 2048, N_STEPS,
                                         **kw)["cva"])

    h = 1e-5
    fd_r = (level(R0 + h, SIG) - level(R0 - h, SIG)) / (2 * h)
    fd_s = (level(R0, SIG + h) - level(R0, SIG - h)) / (2 * h)
    ad_r = float(res["greeks"]["cva"]["r0"])
    ad_s = float(res["greeks"]["cva"]["sigma"])
    assert abs(ad_r - fd_r) < 3e-3 * max(abs(fd_r), 1e-8), (ad_r, fd_r)
    assert abs(ad_s - fd_s) < 3e-3 * max(abs(fd_s), 1e-8), (ad_s, fd_s)


def test_cli_swaption_leg(capsys):
    import json

    from montecarlo import cli

    rc = cli.main(["xva", "--portfolio", "--no-csa", "--paths", "2048",
                   "--steps", "40", "--swaption-leg"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n_trades"] == 4 and out["cva"] > 0

    with pytest.raises(SystemExit, match="rates underlying"):
        cli.main(["xva", "--portfolio", "--underlying", "equity",
                  "--swaption-leg"])
