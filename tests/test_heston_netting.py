"""Equity + volatility netting sets on Heston (round 5,
`processes/heston_exposure.py`): variance swaps and equity forwards on
ONE stochastic-vol simulation through the multi-state netting protocol —
the exact par identity, the deterministic xi=0 limit, the discounted-
mark martingale within scheme bias, the rho-hedging and WWR-sign
directions, the pod-scale bitwise twins, and the CLI."""

import json

import numpy as np
import pytest
import jax.numpy as jnp

from montecarlo.engine.exposure import netting_set_profile
from montecarlo.engine.simulate import simulate
from montecarlo.processes import (HestonExposure,
                                      heston_forward_value_fn,
                                      heston_varswap_expected_total,
                                      heston_varswap_value_fn)

S0, V0, R, KAP, TH, XI, RHO = 100.0, 0.04, 0.03, 1.5, 0.05, 0.5, -0.7
T, N_STEPS, SEED = 1.0, 16, 13


def _model(rho=RHO, xi=XI, v0=V0, dt=T / N_STEPS, dtype=jnp.float64):
    return HestonExposure.create(S0, v0, R, KAP, TH, xi, rho, dt,
                                 dtype=dtype)


def _par(m, t=T):
    return heston_varswap_expected_total(m, t) / t


def _obs(m, n, n_steps, seed=SEED):
    paths = simulate(m, n, n_steps, seed=seed, mode="paths",
                     dtype=jnp.float64,
                     observe=lambda p, s: p.exposure_obs(s))
    return jnp.moveaxis(paths, -1, 1)          # (T+1, 3, N)


def test_par_varswap_marks_zero_at_inception():
    """The t=0 mark of the PAR variance swap is exactly zero — both
    sides are the same affine CIR expectation."""
    m = _model()
    vs = heston_varswap_value_fn(m, _par(m), T)
    cols0 = jnp.asarray([[S0], [V0], [0.0]], jnp.float64)
    assert abs(float(vs(cols0, 0.0)[0])) < 1e-14


def test_xi_zero_limit_is_deterministic():
    """xi = 0 with v0 = theta freezes the variance at theta under full
    truncation (v_{k+1} = v_k exactly), so the par variance swap's mark
    is IDENTICALLY zero on every path and date."""
    m = _model(xi=0.0, v0=TH)
    vs = heston_varswap_value_fn(m, _par(m), T)
    paths = _obs(m, 512, N_STEPS)
    np.testing.assert_array_equal(np.asarray(paths[:, 1]), TH)
    times = np.arange(N_STEPS + 1) * (T / N_STEPS)
    for k in (0, N_STEPS // 2, N_STEPS):
        np.testing.assert_allclose(np.asarray(vs(paths[k], times[k])),
                                   0.0, atol=1e-13)


def test_varswap_discounted_mark_martingale():
    """E[D(0,t) V_t] is flat across dates within MC bars + the O(dt)
    scheme bias (the mark's remaining leg is the CONTINUOUS affine
    expectation while the accrued leg sums the scheme's discrete v+ dt
    — documented discretization)."""
    n, steps = 1 << 15, 64
    m = _model(dt=T / steps)
    vs = heston_varswap_value_fn(m, _par(m), T)
    paths = _obs(m, n, steps)
    dt = T / steps
    disc = np.exp(-R * np.arange(steps + 1) * dt)
    vals = []
    # steps is excluded: the swap SETTLES at T (tau = 0 -> the exposure
    # mark is zero by contract, not a martingale point).
    for k in (0, steps // 4, steps // 2, 3 * steps // 4, steps - 1):
        vals.append(float(jnp.mean(vs(paths[k], k * dt))) * disc[k])
    scale = float(jnp.std(vs(paths[steps - 1],
                             (steps - 1) * dt))) / np.sqrt(n)
    # Drift bound: MC standard errors plus the documented O(dt) accrual
    # bias (discrete left-point sum vs the continuous affine remaining
    # leg: ~ kappa dt |v0 - theta| ~ 2.3e-4 at these params; measured
    # mid-grid drift 4.4e-5).
    tol = 4 * scale + 0.5 * KAP * dt * (abs(V0 - TH) + 0.1 * TH)
    for v in vals[1:]:
        assert abs(v - vals[0]) < tol, (vals, scale, tol)


def test_rho_hedging_direction_and_netting():
    """A long-equity + long-variance book: with rho < 0 the legs move
    oppositely and the NETTED exposure must fall vs the rho = 0 book;
    netting beats no-netting in both."""
    def book(m):
        fwd = heston_forward_value_fn(m, S0 * np.exp(R * T), T)
        vs = heston_varswap_value_fn(m, _par(m), T, notional=5.0 * S0)
        return (lambda c, t: 0.2 * fwd(c, t), vs)

    kw = dict(T=T, seed=SEED, hazard_rate=0.02, flat_rate=R)
    prof = {}
    for rho in (-0.7, 0.0):
        m = _model(rho=rho)
        prof[rho] = netting_set_profile(m, book(m), 1 << 14, N_STEPS,
                                        **kw)
    for rho in (-0.7, 0.0):
        assert 0 < float(prof[rho]["cva"]) \
            < float(prof[rho]["cva_no_netting"])
    assert float(prof[-0.7]["cva"]) < float(prof[0.0]["cva"]), (
        float(prof[-0.7]["cva"]), float(prof[0.0]["cva"]))


def test_wwr_loads_on_variance():
    """wwr_beta > 0 tilts default mass onto HIGH-VARIANCE paths — a
    long variance swap's exposure is exactly there, so CVA must rise;
    beta = 0 reduces to the flat-hazard CVA exactly (generic engine
    contract)."""
    m = _model()
    vs = heston_varswap_value_fn(m, _par(m), T, notional=5.0 * S0)
    kw = dict(T=T, seed=SEED, hazard_rate=0.02, flat_rate=R)
    p0 = netting_set_profile(m, (vs,), 1 << 13, N_STEPS, wwr_beta=0.0,
                             **kw)
    p1 = netting_set_profile(m, (vs,), 1 << 13, N_STEPS, wwr_beta=1.0,
                             **kw)
    np.testing.assert_allclose(float(p0["cva_wwr"]), float(p0["cva"]),
                               rtol=1e-12)
    assert float(p1["cva_wwr"]) > 1.05 * float(p1["cva"])


def test_im_and_mva_positive():
    m = _model()
    fwd = heston_forward_value_fn(m, S0 * np.exp(R * T), T)
    vs = heston_varswap_value_fn(m, _par(m), T, notional=5.0 * S0)
    prof = netting_set_profile(m, (lambda c, t: 0.2 * fwd(c, t), vs),
                               4096, N_STEPS, T=T, seed=SEED,
                               hazard_rate=0.02, flat_rate=R,
                               im_spread=0.003)
    im = np.asarray(prof["im"])
    assert np.all(np.isfinite(im)) and im[1:-1].min() > 0
    assert float(prof["mva"]) > 0


def test_sharded_bitwise_and_unsharded_parity():
    """The generic pod-scale machinery carries the Heston book: every
    profile array and scalar bitwise across mesh shapes, and the means
    bitwise-match the unsharded engine at the same fixed block width
    (the determinism contract all multi-state underlyings share)."""
    from montecarlo.parallel import make_mesh, sharded_netting_profile

    m = _model()
    fwd = heston_forward_value_fn(m, S0 * np.exp(R * T), T)
    vs = heston_varswap_value_fn(m, _par(m), T, notional=5.0 * S0)
    trades = (lambda c, t: 0.2 * fwd(c, t), vs)
    kw = dict(T=T, seed=SEED, hazard_rate=0.02, flat_rate=R,
              im_spread=0.003, wwr_beta=0.5)
    got = {k: sharded_netting_profile(m, trades, 2048, N_STEPS,
                                      mesh=make_mesh(k), block_size=256,
                                      pfe_bins=64, **kw)
           for k in (1, 4)}
    for key, v in got[1].items():
        np.testing.assert_array_equal(np.asarray(v),
                                      np.asarray(got[4][key]),
                                      err_msg=key)
    want = netting_set_profile(m, trades, 2048, N_STEPS, **kw)
    for key in ("cva", "fva", "mva", "cva_wwr"):
        np.testing.assert_allclose(float(got[4][key]), float(want[key]),
                                   rtol=5e-7, err_msg=key)


def test_streaming_matches_sharded():
    """Streaming (checkpoint/resume) means are bitwise the sharded
    engine's on the Heston book — the shared `netting_block_stats`
    contract."""
    from montecarlo.engine.streaming import streaming_netting_profile
    from montecarlo.parallel import make_mesh, sharded_netting_profile

    m = _model()
    vs = heston_varswap_value_fn(m, _par(m), T, notional=5.0 * S0)
    trades = (vs,)
    kw = dict(T=T, seed=SEED, hazard_rate=0.02, flat_rate=R)
    sh = sharded_netting_profile(m, trades, 2048, N_STEPS,
                                 mesh=make_mesh(1), block_size=256,
                                 pfe_bins=64, **kw)
    st = streaming_netting_profile(m, trades, 2048, N_STEPS,
                                   chunk_paths=1024, block_size=256,
                                   pfe_bins=64, **kw)
    for key in ("epe", "ene", "im"):
        np.testing.assert_array_equal(np.asarray(sh[key]),
                                      np.asarray(st[key]), err_msg=key)


def test_cli_xva_heston(capsys):
    from montecarlo import cli

    args = ["xva", "--portfolio", "--underlying", "heston", "--no-csa",
            "--paths", "1024", "--steps", "8", "--maturity", "1.0",
            "--im-spread", "0.003"]
    rc = cli.main(args)
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["underlying"] == "heston" and out["n_trades"] == 2
    assert 0 < out["cva"] < out["cva_no_netting"]
    assert out["peak_im"] > 0 and out["mva"] > 0
    rc = cli.main(args + ["--mesh", "2"])
    assert rc == 0
    out_m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out_m["mesh"] == 2
    # Sharded vs unsharded agree to engine-boundary roundoff (different
    # closing reductions); peak_epe ~ 8.8 exposes the last printed digit.
    for k in ("cva", "mva", "peak_epe"):
        np.testing.assert_allclose(out_m[k], out[k], rtol=1e-5, err_msg=k)
    rc = cli.main(args + ["--greeks"])
    assert rc == 0
    out_g = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    g = out_g["greeks"]["cva"]
    assert g["hazard_rate"] > 0
    for o, gs in out_g["greeks"].items():
        for p_, v in gs.items():
            assert np.isfinite(v), (o, p_)
    with pytest.raises(SystemExit, match="multi-state"):
        cli.main(["xva", "--underlying", "heston", "--paths", "512"])
