"""Cross-asset netting sets on the equity x Vasicek hybrid (round 5):
rate trades AND equity forwards marked off ONE exact joint simulation
with EXACT pathwise bank-account discounting — the rho = 0 single-asset
pins, the rho-sign direction, the exact-discount martingale, the
multivariate delta-normal IM, and the CLI."""

import json

import numpy as np
import pytest
import jax.numpy as jnp

from montecarlo.engine.exposure import netting_set_profile, \
    swap_value_fn
from montecarlo.engine.rates import vasicek_bond_from_rate, vasicek_zcb
from montecarlo.engine.simulate import simulate
from montecarlo.processes import GBM, EquityVasicekHybrid, Vasicek

T, N_STEPS, N = 2.0, 16, 16384
R0, KAP, TH, SR, SS = 0.03, 0.8, 0.05, 0.015, 0.25


def _hyb(rho, sr=SR, th=TH):
    return EquityVasicekHybrid.create(100.0, R0, KAP, th, sr, SS, rho,
                                      T / N_STEPS, dtype=jnp.float64)


def _fwd(k, sr=SR, th=TH):
    return lambda c, t: c[0] - k * vasicek_bond_from_rate(
        c[1], KAP, th, sr, jnp.maximum(T - t, 1e-9))


_KW = dict(T=T, seed=7, hazard_rate=0.02)


def test_exact_pathwise_discount_reproduces_zcb():
    """The discount component is the EXACT running integral: E[D(0,T)]
    must reproduce the Vasicek ZCB within pure MC error at ANY step
    count (4 steps — no trapezoid bias to hide behind)."""
    m = _hyb(0.3)
    m4 = EquityVasicekHybrid.create(100.0, R0, KAP, TH, SR, SS, 0.3,
                                    T / 4, dtype=jnp.float64)
    for model, steps in ((m, N_STEPS), (m4, 4)):
        paths = simulate(model, N, steps, seed=3, mode="paths",
                         dtype=jnp.float64,
                         observe=lambda p, s: p.exposure_obs(s))
        d = model.pathwise_discount(jnp.moveaxis(paths, -1, 1))[-1]
        mc, se = float(jnp.mean(d)), float(jnp.std(d) / np.sqrt(N))
        cf = float(vasicek_zcb(R0, KAP, TH, SR, T))
        assert abs(mc - cf) < 4 * se, (steps, mc, cf, se)


def test_rho_zero_swap_leg_matches_vasicek_engine():
    """rho = 0: the hybrid's rate component IS the Vasicek model (exact
    OU marginal), so a swap-only book must reproduce the single-asset
    Vasicek netting engine's CVA statistically."""
    pay = np.arange(1, 5) * 0.5
    vas = Vasicek.create(R0, KAP, TH, SR, T / N_STEPS, dtype=jnp.float64)
    sw = swap_value_fn(vas, 0.035, pay, 0.5)
    h = netting_set_profile(_hyb(0.0), (lambda c, t: sw(c[1], t),), N,
                            N_STEPS, **_KW)
    v = netting_set_profile(vas, (sw,), N, N_STEPS, **_KW)
    np.testing.assert_allclose(float(h["cva"]), float(v["cva"]), rtol=0.03)
    np.testing.assert_allclose(np.asarray(h["epe"]), np.asarray(v["epe"]),
                               rtol=0.06, atol=2e-5)


def test_deterministic_rate_limit_matches_flat_gbm_engine():
    """sigma_r -> 0 with theta = r0: rates are constant r0, so the
    equity-forward book must collapse to the flat-rate GBM engine's
    numbers (same lognormal exposure, same discounting)."""
    tiny = 1e-8
    k0 = 100.0 * float(np.exp(R0 * T))
    gbm = GBM.create(100.0, R0, SS, T / N_STEPS, dtype=jnp.float64)
    g = netting_set_profile(
        gbm, (lambda s, t: s - k0 * jnp.exp(-R0 * (T - t)),), N, N_STEPS,
        flat_rate=R0, **_KW)
    h = netting_set_profile(
        _hyb(0.0, sr=tiny, th=R0),
        (_fwd(100.0 / float(vasicek_zcb(R0, KAP, R0, tiny, T)), sr=tiny,
              th=R0),), N, N_STEPS, **_KW)
    np.testing.assert_allclose(float(h["cva"]), float(g["cva"]), rtol=0.03)


def test_rho_sign_direction_on_equity_forward():
    """rho > 0: high-S states coincide with high rates, so the forward's
    two legs (S up, K*P down) move together — fatter exposure, larger
    CVA than rho < 0.  The single-asset engines cannot see this at all."""
    k_fwd = 100.0 / float(vasicek_zcb(R0, KAP, TH, SR, T))
    cvas = {rho: float(netting_set_profile(
        _hyb(rho), (_fwd(k_fwd),), N, N_STEPS, **_KW)["cva"])
        for rho in (0.6, -0.6)}
    assert cvas[0.6] > 1.03 * cvas[-0.6], cvas


def test_cross_asset_netting_and_multivariate_im():
    """A swap + opposing equity forwards in ONE set: netted CVA strictly
    below the no-netting sum (the cross-asset offset the engine exists
    to measure), and the multivariate delta-normal IM folds equity and
    rate deltas (nonzero, finite, vanishing at maturity)."""
    pay = np.arange(1, 5) * 0.5
    vas = Vasicek.create(R0, KAP, TH, SR, T / N_STEPS, dtype=jnp.float64)
    sw = swap_value_fn(vas, 0.035, pay, 0.5)
    k_fwd = 100.0 / float(vasicek_zcb(R0, KAP, TH, SR, T))
    trades = (lambda c, t: 300.0 * sw(c[1], t),   # rate leg, fwd-scale
              _fwd(0.9 * k_fwd),
              lambda c, t: -0.6 * _fwd(1.05 * k_fwd)(c, t))
    prof = netting_set_profile(_hyb(0.4), trades, N, N_STEPS,
                               im_spread=0.003, **_KW)
    assert 0 < float(prof["cva"]) < float(prof["cva_no_netting"])
    im = np.asarray(prof["im"])
    assert np.all(np.isfinite(im)) and im.max() > 0
    assert float(prof["mva"]) > 0
    # WWR loads on the equity spot for the hybrid.
    p2 = netting_set_profile(_hyb(0.4), (_fwd(k_fwd),), 4096, N_STEPS,
                             wwr_beta=1.0, **_KW)
    assert float(p2["cva_wwr"]) > float(p2["cva"])


def test_sharded_hybrid_bitwise_and_matches_unsharded():
    """Cross-asset books at pod scale: the hybrid netting set through
    `sharded_netting_profile` — bitwise mesh-invariant, matching the
    unsharded engine, exact-integral discounting preserved per block."""
    from montecarlo.parallel import make_mesh, sharded_netting_profile

    pay = np.arange(1, 5) * 0.5
    vas = Vasicek.create(R0, KAP, TH, SR, T / N_STEPS, dtype=jnp.float64)
    sw = swap_value_fn(vas, 0.035, pay, 0.5)
    k_fwd = 100.0 / float(vasicek_zcb(R0, KAP, TH, SR, T))
    trades = (lambda c, t: 300.0 * sw(c[1], t), _fwd(k_fwd))
    kw = dict(T=T, seed=7, hazard_rate=0.02, im_spread=0.003)
    n = 4096
    want = netting_set_profile(_hyb(0.4), trades, n, N_STEPS, **kw)
    got = {m: sharded_netting_profile(_hyb(0.4), trades, n, N_STEPS,
                                      mesh=make_mesh(m), block_size=256,
                                      pfe_bins=64, **kw)
           for m in (1, 4)}
    for k, v in got[1].items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(got[4][k]),
                                      err_msg=k)
    for k in ("cva", "mva"):
        np.testing.assert_allclose(float(got[4][k]), float(want[k]),
                                   rtol=1e-9, err_msg=k)
    np.testing.assert_allclose(np.asarray(got[4]["epe"]),
                               np.asarray(want["epe"]), rtol=1e-10,
                               atol=1e-12)


def test_book_var_multistate():
    """Desk VaR by full revaluation over the hybrid state (multi-state
    book_var plumbing): finite, positive, exact-discount horizon."""
    from montecarlo.engine.exposure import book_var

    k_fwd = 100.0 / float(vasicek_zcb(R0, KAP, TH, SR, T))
    var_steps = 8
    m = EquityVasicekHybrid.create(100.0, R0, KAP, TH, SR, SS, 0.3,
                                   (10.0 / 252.0) / var_steps,
                                   dtype=jnp.float64)
    bv = book_var(m, (_fwd(k_fwd),), 8192, horizon=10.0 / 252.0,
                  n_steps=var_steps, seed=3)
    assert np.isfinite(bv["var_95"]) and float(bv["var_95"]) > 0
    assert float(bv["cvar_95"]) >= float(bv["var_95"])
    # Lognormal sanity: 10d 95% VaR of a ~forward ~ S*sigma*sqrt(h)*1.645.
    approx = 100.0 * SS * np.sqrt(10.0 / 252.0) * 1.645
    np.testing.assert_allclose(float(bv["var_95"]), approx, rtol=0.15)


def test_cli_xva_hybrid(capsys):
    from montecarlo import cli

    rc = cli.main(["xva", "--portfolio", "--underlying", "hybrid",
                   "--no-csa", "--paths", "2048", "--steps", "16",
                   "--im-spread", "0.003"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["underlying"] == "hybrid" and out["n_trades"] == 3
    assert 0 < out["cva"] < out["cva_no_netting"]
    assert out["peak_im"] > 0 and out["mva"] > 0
    with pytest.raises(SystemExit, match="multi-state"):
        cli.main(["xva", "--underlying", "hybrid", "--paths", "512"])


def test_cli_xva_hybrid_greeks_counterparties(capsys):
    """Round 5: the multi-state CLI guard is gone — pathwise xVA greeks
    (d cva/d s0 AND d cva/d r0 through the joint transition) and the
    multi-counterparty split run on the cross-asset hybrid book."""
    from montecarlo import cli

    rc = cli.main(["xva", "--portfolio", "--underlying", "hybrid",
                   "--no-csa", "--paths", "1024", "--steps", "8",
                   "--greeks"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    g = out["greeks"]["cva"]
    assert g["hazard_rate"] > 0
    for k in ("s0", "r0"):
        assert np.isfinite(g[k]), k
    for o, gs in out["greeks"].items():     # no NaN tangents (im sqrt(0))
        for p, v in gs.items():
            assert np.isfinite(v), (o, p)
    rc = cli.main(["xva", "--portfolio", "--underlying", "hybrid",
                   "--no-csa", "--paths", "1024", "--steps", "8",
                   "--counterparties", "2"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["counterparties"] == 2
    assert abs(out["cva_total"] - out["cva_cpty_a"]
               - out["cva_cpty_b"]) < 2e-6
