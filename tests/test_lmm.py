"""Libor Market Model (round 5): Black-exact caplet repricing (the
predictor-corrector drift oracle), the bank-account / ZCB martingale,
MC swaptions vs the Rebonato approximation, dead-forward freezing, the
multi-tenor netting book with its correlation-structure direction test,
and the pod twin's bitwise mesh invariance."""

import numpy as np
import pytest
import jax.numpy as jnp

from montecarlo.engine.exposure import netting_set_profile
from montecarlo.engine.simulate import simulate
from montecarlo.processes.lmm import (LMM, exp_decay_corr,
                                          lmm_caplet_mc, lmm_par_strike,
                                          lmm_swap_value_fn,
                                          lmm_swaption_mc,
                                          lmm_swaption_rebonato, lmm_zcb0)

K, DELTA = 12, 0.25
F0 = 0.03 + 0.004 * np.arange(K) / K        # gently upward curve
SIG = 0.22 - 0.06 * np.arange(K) / K        # decaying vol


def _model(corr_beta=0.1, dtype=jnp.float64):
    return LMM.create(F0, SIG, DELTA, corr_beta=corr_beta, dtype=dtype)


def _obs_paths(m, n, n_steps, seed=3):
    paths = simulate(m, n, n_steps, seed=seed, mode="paths",
                     dtype=jnp.float64,
                     observe=lambda p, s: p.exposure_obs(s))
    return jnp.moveaxis(paths, -1, 1)          # (T+1, K+1, N)


def test_caplet_matches_black():
    """Caplets are EXACT Black under the lognormal LMM — the sharpest
    oracle for the spot-measure predictor-corrector drift at tenor-sized
    steps (plain log-Euler fails this at the same grid)."""
    m = _model()
    for k_idx, strike in ((4, 0.030), (8, 0.034), (11, 0.028)):
        est = lmm_caplet_mc(m, k_idx, strike, 1 << 17, seed=11)
        tol = 4.0 * est["std_err"] + 2e-4 * est["black"]
        assert abs(est["price"] - est["black"]) < tol, (k_idx, est)


def test_zcb_martingale():
    """E[1/B(T_i)] = P(0, T_i): the bank account built from the fixed
    forwards must reproduce the initial curve (spot-measure numeraire
    consistency — tests the compounding indexing AND the drift)."""
    m = _model()
    n = 1 << 16
    obs = _obs_paths(m, n, K)                  # (K+1, K+1, N)
    for i in (3, 7, K):
        d = np.asarray(jnp.exp(-obs[i, -1, :]))
        se = d.std(ddof=1) / np.sqrt(n)
        assert abs(d.mean() - lmm_zcb0(m, i)) < 4 * se + 2e-5, i


def test_dead_forwards_frozen():
    """F_k must be FROZEN at its T_k fixing for every later date — the
    frozen value is what the swap closure reads for the in-flight
    payment."""
    m = _model()
    obs = np.asarray(_obs_paths(m, 256, K))     # (K+1, K+1, N)
    for k_dead in (0, 3, 8):
        rows = obs[k_dead + 1:, k_dead, :]      # dates > T_k
        assert (rows == rows[0]).all(), k_dead
    # ... and live forwards genuinely move.
    assert np.std(obs[5, 9, :]) > 0


def test_swap_closure_par_value_zero_and_fixed_leg():
    """The netting-trade closure at t=0 prices the par swap to zero; at
    a mid-life date its value decomposes into the forward-curve closed
    form computed independently in NumPy."""
    m = _model()
    par = lmm_par_strike(m, 2, 10)
    v = lmm_swap_value_fn(m, par, 2, 10)
    cols0 = jnp.concatenate([jnp.asarray(F0)[:, None]
                             * jnp.ones((1, 5)),
                             jnp.zeros((1, 5))], axis=0)
    np.testing.assert_allclose(np.asarray(v(cols0, jnp.float64(0.0))),
                               0.0, atol=1e-14)
    # Mid-life mark vs independent NumPy algebra at a bumped curve.
    f_mid = F0 + 0.01
    i = 4
    cols = jnp.concatenate([jnp.asarray(f_mid)[:, None]
                            * jnp.ones((1, 3)),
                            jnp.full((1, 3), 0.7)], axis=0)
    got = np.asarray(v(cols, jnp.float64(i * DELTA)))[0]
    p = np.cumprod(np.where(np.arange(K) >= i,
                            1.0 / (1.0 + DELTA * f_mid), 1.0))
    want = sum(DELTA * (f_mid[j] - par) * p[j] for j in range(i, 10))
    np.testing.assert_allclose(got, want, rtol=1e-13)


def test_swaption_matches_rebonato():
    """MC (exact marks, exact discounting) vs the frozen-weight Rebonato
    vol: agreement to the approximation's documented quality (0.5%
    relative) plus MC bars — both ATM and away from the money."""
    m = _model()
    for s, e, rel in ((4, 12, 0.005), (2, 8, 0.005)):
        strike = lmm_par_strike(m, s, e)
        est = lmm_swaption_mc(m, s, e, strike, 1 << 17, seed=5)
        tol = 4.0 * est["std_err"] + rel * est["rebonato"]
        assert abs(est["price"] - est["rebonato"]) < tol, (s, e, est)
    # OTM: 1.25x par strike.
    strike = 1.25 * lmm_par_strike(m, 4, 12)
    est = lmm_swaption_mc(m, 4, 12, strike, 1 << 17, seed=6)
    tol = 4.0 * est["std_err"] + 0.01 * est["rebonato"]
    assert abs(est["price"] - est["rebonato"]) < tol, est


def test_netting_correlation_direction():
    """THE reason the LMM exists (full curve dynamics): a curve book —
    long the front of the curve, short the back — nets BETTER the more
    the forwards comove; as the correlation decays faster across the
    curve (larger beta), netting erodes and the net-to-gross CVA ratio
    rises.  A short-rate model (even G2++ at fixed factor corr) cannot
    express a term-structure-of-correlation knob at all."""
    ratios = []
    for beta in (0.0, 0.2, 0.8):
        m = _model(corr_beta=beta)
        v_front = lmm_swap_value_fn(m, lmm_par_strike(m, 1, 5), 1, 5)
        v_back = lmm_swap_value_fn(m, lmm_par_strike(m, 7, 12), 7, 12)
        trades = (lambda c, t: 2.0 * v_front(c, t),
                  lambda c, t: -1.2 * v_back(c, t))
        prof = netting_set_profile(m, trades, 8192, K, T=K * DELTA,
                                   seed=7, hazard_rate=0.02)
        ratios.append(float(prof["cva"]) / float(prof["cva_no_netting"]))
    assert ratios == sorted(ratios), ratios
    assert ratios[-1] > ratios[0] * 1.02, ratios


def test_multistate_netting_im_mva_wwr_run():
    """The full adjustment surface over the LMM: multivariate IM with
    live-forward masking, MVA, and WWR loading on the spot LIBOR."""
    m = _model()
    v = lmm_swap_value_fn(m, 0.03, 1, 12)
    prof = netting_set_profile(m, (v,), 4096, K, T=K * DELTA, seed=7,
                               hazard_rate=0.02, im_spread=0.003,
                               wwr_beta=1.0)
    im = np.asarray(prof["im"])
    assert np.all(im >= 0) and im.max() > 0
    # All forwards dead at the last date -> IM is exactly zero there.
    assert im[-1] == 0.0
    assert float(prof["mva"]) > 0
    # Payer swap exposure rises with rates; beta > 0 is wrong-way.
    assert float(prof["cva_wwr"]) > float(prof["cva"])
    np.testing.assert_allclose(np.asarray(prof["survival_wwr"]),
                               np.exp(-0.02 * np.asarray(prof["times"])),
                               rtol=1e-9)


def test_sharded_multistate_bitwise_and_matches_unsharded():
    """LMM books ride the pod twin: bitwise mesh-shape invariance,
    scalars matching the unsharded engine to fp-reassociation noise, and
    bitwise-shared means with the streaming engine."""
    from montecarlo.engine.streaming import streaming_netting_profile
    from montecarlo.parallel import make_mesh, sharded_netting_profile

    n, block = 4096, 256
    m = _model()
    v_front = lmm_swap_value_fn(m, 0.031, 1, 5)
    v_back = lmm_swap_value_fn(m, 0.032, 5, 12)
    trades = (lambda c, t: 2.0 * v_front(c, t),
              lambda c, t: -1.0 * v_back(c, t))
    kw = dict(T=K * DELTA, seed=7, hazard_rate=0.02, im_spread=0.003,
              wwr_beta=0.8)
    want = netting_set_profile(m, trades, n, K, **kw)
    got = {k: sharded_netting_profile(m, trades, n, K,
                                      mesh=make_mesh(k), block_size=block,
                                      pfe_bins=64, **kw)
           for k in (1, 4)}
    for key, val in got[1].items():
        np.testing.assert_array_equal(np.asarray(val),
                                      np.asarray(got[4][key]),
                                      err_msg=key)
    for key in ("cva", "mva", "cva_wwr"):
        np.testing.assert_allclose(float(got[4][key]), float(want[key]),
                                   rtol=1e-9, atol=1e-18, err_msg=key)
    np.testing.assert_allclose(np.asarray(got[4]["im"]),
                               np.asarray(want["im"]), rtol=1e-9)
    st = streaming_netting_profile(m, trades, n, K, chunk_paths=2048,
                                   block_size=block, pfe_bins=64,
                                   **{k_: v_ for k_, v_ in kw.items()
                                      if k_ != "wwr_beta"})
    for key in ("epe", "ene", "im"):
        np.testing.assert_array_equal(np.asarray(st[key]),
                                      np.asarray(got[4][key]),
                                      err_msg=key)


def test_deterministic_and_sobol_eligible():
    """Same seed -> bitwise identical paths; the all-normal draw pattern
    makes the LMM Sobol-eligible (QMC caplet matches Black tighter than
    plain MC at the same path count)."""
    from montecarlo.samplers import SobolSampler

    m = _model()
    a = np.asarray(_obs_paths(m, 512, K, seed=9))
    b = np.asarray(_obs_paths(m, 512, K, seed=9))
    np.testing.assert_array_equal(a, b)
    sampler = SobolSampler.for_process(m, 4096, 7, seed=1,
                                       dtype=jnp.float64)
    est = lmm_caplet_mc(m, 6, 0.031, 4096, seed=3, sampler=sampler)
    assert abs(est["price"] - est["black"]) < 5e-5, est


def test_create_validation():
    with pytest.raises(ValueError, match="dt .* must equal delta"):
        LMM.create(F0, SIG, DELTA, dt=0.5)
    with pytest.raises(ValueError, match="positive"):
        LMM.create([-0.01, 0.02], [0.2, 0.2], DELTA)
    with pytest.raises(ValueError, match=r"sigma must be \(1,\)"):
        LMM.create([0.03], [0.2, 0.2], DELTA)
    with pytest.raises(ValueError, match="corr must be"):
        LMM.create([0.03, 0.03], [0.2, 0.2], DELTA,
                   corr=np.eye(3))
    with pytest.raises(ValueError, match="start"):
        lmm_swap_value_fn(_model(), 0.03, 5, 5)
    # exp_decay_corr is a valid correlation (PSD, unit diagonal).
    c = exp_decay_corr(8, 0.3, 0.25)
    np.testing.assert_allclose(np.diag(c), 1.0)
    assert np.linalg.eigvalsh(c).min() > 0


def test_cli_bond_lmm(capsys):
    import json

    from montecarlo import cli

    rc = cli.main(["bond", "--model", "lmm", "--paths", "8192",
                   "--maturity", "2.0"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert abs(out["zcb_price"] - out["closed_form"]) \
        < 5 * out["std_err"] + 1e-4
    rc = cli.main(["bond", "--model", "lmm", "--caplet", "--t1", "1.0",
                   "--paths", "16384"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert abs(out["mc_price"] - out["black_exact"]) \
        < 5 * out["mc_std_err"] + 2e-3 * out["black_exact"]
    rc = cli.main(["bond", "--model", "lmm", "--swaption",
                   "--paths", "16384", "--maturity", "3.0"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert abs(out["mc_price"] - out["rebonato"]) \
        < 5 * out["mc_std_err"] + 0.01 * out["rebonato"]


def test_cli_xva_lmm(capsys):
    import json

    from montecarlo import cli

    rc = cli.main(["xva", "--portfolio", "--underlying", "lmm",
                   "--no-csa", "--paths", "2048", "--steps", "12",
                   "--maturity", "3.0", "--im-spread", "0.003",
                   "--wwr-beta", "0.5"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["underlying"] == "lmm"
    assert out["cva"] > 0 and out["mva"] > 0 and out["peak_im"] > 0
    assert out["cva_wwr"] > 0
    rc = cli.main(["xva", "--portfolio", "--underlying", "lmm",
                   "--no-csa", "--paths", "2048", "--steps", "12",
                   "--maturity", "3.0", "--im-spread", "0.003",
                   "--wwr-beta", "0.5", "--mesh", "2"])
    assert rc == 0
    out_m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out_m["mesh"] == 2
    for k in ("cva", "mva", "cva_wwr", "peak_epe"):
        assert out_m[k] == out[k], k


def test_time_dependent_vols():
    """Deterministic vol paths (the sig_steps table): a time-homogeneous
    humped vol_ttm model reprices its caplets against the EXACT piecewise
    Black variance, the Rebonato map integrates the same covariance, a
    constant-sigma model is BITWISE the explicit constant table, and the
    ttm bootstrap round-trips the generating table."""
    from montecarlo.engine.rates_calibration import (
        bootstrap_lmm_ttm_vols)

    ttm = 0.14 + 0.3 * (0.25 + 0.25 * np.arange(K)) \
        * np.exp(-0.6 * 0.25 * np.arange(K))            # humped in ttm
    m = LMM.create(F0, vol_ttm=ttm, delta=DELTA, corr_beta=0.1,
                   dtype=jnp.float64)
    for k_idx, strike in ((4, 0.030), (9, 0.034)):
        est = lmm_caplet_mc(m, k_idx, strike, 1 << 16, seed=12)
        tol = 4.0 * est["std_err"] + 2e-4 * est["black"]
        assert abs(est["price"] - est["black"]) < tol, (k_idx, est)
    strike = lmm_par_strike(m, 4, 12)
    est = lmm_swaption_mc(m, 4, 12, strike, 1 << 16, seed=13)
    tol = 4.0 * est["std_err"] + 0.01 * est["rebonato"]
    assert abs(est["price"] - est["rebonato"]) < tol, est
    # Bitwise: (K,) constant sigma == the explicit constant (K, K) table.
    m1 = _model()
    m2 = LMM.create(F0, np.broadcast_to(SIG, (K, K)).copy(), DELTA,
                    corr_beta=0.1, dtype=jnp.float64)
    np.testing.assert_array_equal(np.asarray(_obs_paths(m1, 256, K)),
                                  np.asarray(_obs_paths(m2, 256, K)))
    # ttm bootstrap round-trip: generate the cap strip from the exact
    # piecewise Black variances, recover the table.
    from scipy.stats import norm

    p = np.cumprod(1.0 / (1.0 + DELTA * F0))
    v_tot = np.sqrt(DELTA * np.cumsum(np.square(ttm)))  # sd of caplet k

    def black(f, k_, sd):
        d1 = (np.log(f / k_) + 0.5 * sd * sd) / sd
        return f * norm.cdf(d1) - k_ * norm.cdf(d1 - sd)

    caps = np.cumsum([DELTA * p[k] * black(F0[k], 0.03, v_tot[k - 1])
                      for k in range(1, K)])
    got = bootstrap_lmm_ttm_vols(F0, DELTA, 0.03, caps)
    np.testing.assert_allclose(got[:K - 1], ttm[:K - 1], atol=1e-10)
    with pytest.raises(ValueError, match="exactly one of"):
        LMM.create(F0, SIG, DELTA, vol_ttm=ttm)
    with pytest.raises(ValueError, match="exactly one of"):
        LMM.create(F0, delta=DELTA)


def test_displaced_diffusion():
    """Displaced LMM (shift d): caplets are Black on (F+d, K+d) EXACTLY —
    the MC must reprice them within bars; the ZCB martingale still holds
    (the drift derivation under displacement); negative forwards are
    reachable (the point of the shift); and the closed form produces the
    downward lognormal-vol skew."""
    from scipy.optimize import brentq
    from scipy.stats import norm

    d = 0.02
    m = LMM.create(np.full(K, 0.005), SIG, DELTA, corr_beta=0.1,
                   shift=d, dtype=jnp.float64)
    # Caplet repricing at two strikes (one below the forward, one above).
    for strike in (0.002, 0.012):
        est = lmm_caplet_mc(m, 6, strike, 1 << 16, seed=4)
        tol = 4.0 * est["std_err"] + 2e-4 * est["black"]
        assert abs(est["price"] - est["black"]) < tol, (strike, est)
    # ZCB martingale under displacement.
    n = 1 << 15
    obs = _obs_paths(m, n, K)
    disc = np.asarray(jnp.exp(-obs[K, -1, :]))
    from montecarlo.processes.lmm import lmm_zcb0
    se = disc.std(ddof=1) / np.sqrt(n)
    assert abs(disc.mean() - lmm_zcb0(m, K)) < 4 * se + 2e-5
    # Negative forwards occur (f0 = 0.5%, shift 2%: plenty of mass < 0).
    assert np.asarray(obs[K // 2, :K, :]).min() < 0.0
    # Downward skew: lognormal implied vol from the displaced closed form
    # falls with strike.
    f0, sd_tot = 0.005 + d, float(SIG[6]) * np.sqrt(6 * DELTA)

    def black(f, k_, sd):
        d1 = (np.log(f / k_) + 0.5 * sd * sd) / sd
        return f * norm.cdf(d1) - k_ * norm.cdf(d1 - sd)

    def ln_iv(k_true):
        px = black(f0, k_true + d, sd_tot)
        return brentq(lambda v: black(0.005, k_true,
                                      v * np.sqrt(6 * DELTA)) - px,
                      1e-4, 30.0)

    assert ln_iv(0.003) > ln_iv(0.005) > ln_iv(0.008)
    # Swaption: MC vs the displaced Rebonato map at shift > 0.
    strike = lmm_par_strike(m, 4, 12)
    est = lmm_swaption_mc(m, 4, 12, strike, 1 << 16, seed=5)
    tol = 4.0 * est["std_err"] + 0.01 * est["rebonato"]
    assert abs(est["price"] - est["rebonato"]) < tol, est
    with pytest.raises(ValueError, match="shift"):
        LMM.create([0.03], [0.2], DELTA, shift=-0.01)
    with pytest.raises(ValueError, match="shifted"):
        LMM.create([-0.03], [0.2], DELTA, shift=0.01)


def test_bermudan_swaption_lsm():
    """LMM Bermudan swaption by LSM: the n_exercise=1 case reproduces
    the European MC estimator at the same seed (same scan, bitwise
    pathwise cashflows — only the closing mean compiles differently),
    and value is monotone nondecreasing in the exercise rights."""
    from montecarlo.engine.bermudan import lmm_bermudan_swaption_lsm

    m = _model()
    s, e = 4, 12
    strike = lmm_par_strike(m, s, e)
    n = 1 << 15
    eur = lmm_swaption_mc(m, s, e, strike, n, seed=11)
    prices = []
    for n_ex in (1, 2, 4, 8):
        b = lmm_bermudan_swaption_lsm(m, strike, s, e, n_exercise=n_ex,
                                      n_paths=n, seed=11)
        prices.append(float(b["price"]))
    np.testing.assert_allclose(prices[0], eur["price"], rtol=1e-12)
    se = float(eur["std_err"])
    for a, b_ in zip(prices, prices[1:]):
        assert b_ > a - 3 * se, prices      # monotone within MC noise
    assert prices[-1] > prices[0] + 2 * se, prices  # rights have value
    with pytest.raises(ValueError, match="n_exercise"):
        lmm_bermudan_swaption_lsm(m, strike, s, e, n_exercise=9,
                                  n_paths=64, seed=1)


def test_cli_bond_lmm_bermudan(capsys):
    import json

    from montecarlo import cli

    rc = cli.main(["bond", "--model", "lmm", "--swaption", "--paths",
                   "8192", "--maturity", "3.0", "--n-exercise", "4"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["instrument"] == "lmm_bermudan_swaption"
    assert out["bermudan_price"] >= out["mc_price"] - 3 * out["mc_std_err"]


def test_calibration_roundtrip():
    """Two-stage LMM calibration: the cap-strip bootstrap recovers a
    humped vol term structure to bisection precision (caplets are EXACT
    Black), and the Rebonato swaption fit recovers the generating
    correlation decay."""
    from scipy.stats import norm

    from montecarlo.engine.rates_calibration import (
        bootstrap_lmm_vols, calibrate_lmm_corr_to_swaptions)
    from montecarlo.processes.lmm import lmm_swaption_rebonato

    delta, k_fwd, beta_true, strike = 0.25, 12, 0.45, 0.03
    t = delta * np.arange(k_fwd)
    sig_true = 0.12 + 0.25 * (0.3 + t) * np.exp(-0.8 * t)
    f0 = np.full(k_fwd, 0.03)
    p = np.cumprod(1.0 / (1.0 + delta * f0))

    def black(f, k_, sd):
        d1 = (np.log(f / k_) + 0.5 * sd * sd) / sd
        return f * norm.cdf(d1) - k_ * norm.cdf(d1 - sd)

    caps = np.cumsum([delta * p[k] * black(
        f0[k], strike, sig_true[k] * np.sqrt(k * delta))
        for k in range(1, k_fwd)])
    sig_fit = bootstrap_lmm_vols(f0, delta, strike, caps)
    np.testing.assert_allclose(sig_fit[1:], sig_true[1:], atol=1e-10)
    m_true = LMM.create(f0, sig_true, delta, corr_beta=beta_true)
    quotes = [(s, e, lmm_par_strike(m_true, s, e),
               lmm_swaption_rebonato(m_true, s, e,
                                     lmm_par_strike(m_true, s, e)))
              for s, e in ((2, 8), (4, 12), (6, 12))]
    fit = calibrate_lmm_corr_to_swaptions(f0, sig_fit, delta, quotes)
    assert abs(fit["corr_beta"] - beta_true) < 1e-4, fit
    assert fit["rmse_rel"] < 1e-6
    # Guards: a non-increasing strip and an unattainable caplet raise.
    bad = caps.copy()
    bad[3] = bad[2]
    with pytest.raises(ValueError, match="strictly increasing"):
        bootstrap_lmm_vols(f0, delta, strike, bad)
    bad2 = caps.copy()
    bad2[-1] = bad2[-2] + 1.0
    with pytest.raises(ValueError, match="bound"):
        bootstrap_lmm_vols(f0, delta, strike, bad2)


def test_cli_calibrate_lmm(capsys):
    import json

    from montecarlo import cli

    rc = cli.main(["calibrate", "--model", "lmm"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert abs(out["corr_beta"] - 0.35) < 1e-3
    assert out["vol_max_abs_err"] < 1e-9


def test_cli_xva_lmm_greeks_counterparties(capsys):
    import json

    from montecarlo import cli

    rc = cli.main(["xva", "--portfolio", "--underlying", "lmm",
                   "--no-csa", "--paths", "1024", "--steps", "8",
                   "--maturity", "2.0", "--greeks"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["greeks"]["cva"]["hazard_rate"] > 0
    assert out["state_param"] == "r0"
    # EVERY greek finite — the mva tangent NaN'd through im_norm's
    # sqrt(0) before grad_safe_sqrt (dates with all forwards fixed).
    for o, gs in out["greeks"].items():
        for p, v in gs.items():
            assert np.isfinite(v), (o, p)
    rc = cli.main(["xva", "--portfolio", "--underlying", "lmm",
                   "--no-csa", "--paths", "1024", "--steps", "8",
                   "--maturity", "2.0", "--counterparties", "2"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["counterparties"] == 2
    assert abs(out["cva_total"] - out["cva_cpty_a"] - out["cva_cpty_b"]) \
        < 2e-6
    # --var-horizon is structurally undefined on the reset-calendar grid.
    with pytest.raises(SystemExit, match="reset calendar"):
        cli.main(["xva", "--portfolio", "--underlying", "lmm",
                  "--no-csa", "--paths", "256", "--steps", "8",
                  "--maturity", "2.0", "--var-horizon", "0.04"])


def test_rebonato_atm_sanity():
    """The Rebonato price is bracketed by intrinsic and the annuity-vol
    upper bound, and collapses to the single-caplet Black in the
    one-period degenerate case."""
    m = _model()
    strike = lmm_par_strike(m, 6, 7)
    one = lmm_swaption_rebonato(m, 6, 7, strike)
    cap = lmm_caplet_mc(m, 6, strike, 64, seed=1)["black"]
    np.testing.assert_allclose(one, cap, rtol=1e-12)
