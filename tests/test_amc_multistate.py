"""Bermudan swaptions by AMC on MULTI-STATE books (round 5): the
regression-marked `SimulationMarkedTrade` protocol extended to the full
curve models — G2++ (two factors, `bermudan_swaption_amc_trade_g2pp`)
and the LMM (`bermudan_swaption_amc_trade_lmm`).  Oracles: the G2++
European limit against the exact Brigo–Mercurio quadrature, the LMM t=0
mark against the standalone `lmm_bermudan_swaption_lsm` pricer, the
exact-swap exercised tail, the Bermudan premium direction, netting/IM
integration, the SHARDED distributed fit (bitwise mesh invariance +
unsharded parity), and the CLI."""

import json

import numpy as np
import pytest
import jax.numpy as jnp

from montecarlo.engine.amc import (bermudan_swaption_amc_trade_g2pp,
                                       bermudan_swaption_amc_trade_lmm)
from montecarlo.engine.exposure import netting_set_profile
from montecarlo.engine.simulate import simulate
from montecarlo.processes.g2pp import (G2PP, g2pp_swap_value_fn,
                                           g2pp_swaption)
from montecarlo.processes.lmm import LMM, lmm_par_strike, \
    lmm_swap_value_fn

PHI, A, SG, B, ET, RHO = 0.03, 0.8, 0.01, 0.08, 0.012, -0.7
T_END, N_STEPS = 2.0, 20
DT = T_END / N_STEPS                          # 0.1 — resets land on it
T0, PAY_DT, KSTRIKE = 0.8, 0.4, 0.032
PAY_TIMES = (1.2, 1.6, 2.0)
SEED = 13

K_FWD, DELTA = 12, 0.25
F0 = 0.03 + 0.004 * np.arange(K_FWD) / K_FWD
SIGF = 0.22 - 0.06 * np.arange(K_FWD) / K_FWD


def _g2(dt=DT):
    return G2PP.create(PHI, A, SG, B, ET, RHO, dt, dtype=jnp.float64)


def _lmm():
    return LMM.create(F0, SIGF, DELTA, corr_beta=0.1, dtype=jnp.float64)


def _obs(m, n, n_steps, seed=SEED):
    paths = simulate(m, n, n_steps, seed=seed, mode="paths",
                     dtype=jnp.float64,
                     observe=lambda p, s: p.exposure_obs(s))
    return jnp.moveaxis(paths, -1, 1)          # (T+1, C, N)


def test_g2pp_european_limit_vs_quadrature_and_exact_tail():
    """n_exercise=1 under G2++: the t=0 AMC mark must reproduce the exact
    Brigo–Mercurio quadrature price within regression/MC tolerance, and
    AFTER expiry the marks must equal the exercise-indicator times the
    exact remaining swap (the tail is closed-form, not regressed) —
    verified against a hand-built mark from the same paths."""
    m = _g2()
    n = 1 << 14
    trade = bermudan_swaption_amc_trade_g2pp(m, KSTRIKE, PAY_TIMES, PAY_DT,
                                             n_exercise=1)
    paths = _obs(m, n, N_STEPS)
    times = jnp.arange(N_STEPS + 1, dtype=jnp.float64) * DT
    vals, dvs = trade.mark_fn(paths, times, T_END)
    assert vals.shape == (N_STEPS + 1, n)
    assert dvs.shape == (N_STEPS + 1, 2, n)
    oracle = float(g2pp_swaption(m, KSTRIKE, T0, PAY_TIMES, PAY_DT))
    t0_mark = float(jnp.mean(vals[0]))
    assert abs(t0_mark - oracle) < 0.03 * oracle + 2e-5, (t0_mark, oracle)
    # Exercised tail: indicator(z_T0 > 0) * exact remaining swap with the
    # in-period fixing row — recomputed directly from the same paths.
    swap = g2pp_swap_value_fn(m, KSTRIKE, PAY_TIMES, PAY_DT)
    k0 = int(round(T0 / DT))
    ind = np.asarray(swap(paths[k0], T0) > 0)
    resets = [t - PAY_DT for t in PAY_TIMES]
    for k in range(k0 + 1, N_STEPS + 1):
        t = float(times[k])
        t_fix = max(e for e in resets if e <= t + 1e-9)
        c_fix = paths[int(round(t_fix / DT))]
        want = np.where(ind, np.asarray(swap(paths[k], t, c_fix, t_fix)),
                        0.0)
        np.testing.assert_allclose(np.asarray(vals[k]), want,
                                   rtol=1e-12, atol=1e-15, err_msg=str(k))


def test_g2pp_bermudan_premium_and_netting():
    """More exercise rights cannot be worth less (within MC/regression
    noise), and the trade integrates with netting/IM/CVA."""
    m = _g2()
    n = 1 << 13
    kw = dict(T=T_END, seed=SEED, hazard_rate=0.02, im_spread=0.003)
    e = {}
    for n_ex in (1, 3):
        tr = bermudan_swaption_amc_trade_g2pp(m, KSTRIKE, PAY_TIMES,
                                              PAY_DT, n_exercise=n_ex)
        e[n_ex] = netting_set_profile(m, (tr,), n, N_STEPS, **kw)
    assert float(e[3]["epe"][0]) >= float(e[1]["epe"][0]) - 3e-5
    swap = g2pp_swap_value_fn(m, KSTRIKE, PAY_TIMES, PAY_DT)
    tr = bermudan_swaption_amc_trade_g2pp(m, KSTRIKE, PAY_TIMES, PAY_DT,
                                          n_exercise=3)
    prof = netting_set_profile(m, (tr, lambda c, t: -0.4 * swap(c, t)),
                               n, N_STEPS, **kw)
    assert np.all(np.isfinite(np.asarray(prof["epe"])))
    assert np.all(np.asarray(prof["im"]) >= 0.0)
    assert 0.0 < float(prof["cva"]) < float(prof["cva_no_netting"])
    assert float(prof["mva"]) > 0.0


def test_lmm_t0_mark_matches_standalone_lsm_pricer():
    """The AMC t=0 mark under the LMM must agree with the standalone
    `lmm_bermudan_swaption_lsm` pricer (same contract, same regression
    family, independent implementation/grid) within joint MC bars, and
    carry the Bermudan premium direction."""
    from montecarlo.engine.bermudan import lmm_bermudan_swaption_lsm

    m = _lmm()
    start, end, n_ex = 4, 10, 3
    k_par = lmm_par_strike(m, start, end)
    n = 1 << 13
    n_steps = start + n_ex - 1                 # simulate to last exercise
    paths = _obs(m, n, n_steps)
    times = jnp.arange(n_steps + 1, dtype=jnp.float64) * DELTA
    vals = {}
    for ne in (1, n_ex):
        tr = bermudan_swaption_amc_trade_lmm(m, k_par, start, end,
                                             n_exercise=ne)
        v, dv = tr.mark_fn(paths, times, n_steps * DELTA)
        assert dv.shape == (n_steps + 1, K_FWD + 1, n)
        vals[ne] = float(jnp.mean(v[0]))
    res = lmm_bermudan_swaption_lsm(m, k_par, start, end, n_exercise=n_ex,
                                    n_paths=1 << 14, seed=7)
    price, se = float(res["price"]), float(res["std_err"])
    assert abs(vals[n_ex] - price) < 0.05 * price + 4.0 * se, (
        vals[n_ex], price, se)
    assert vals[n_ex] >= vals[1] - 3e-5


def test_lmm_netting_profile_with_bermudan_leg():
    m = _lmm()
    k_par = lmm_par_strike(m, 4, 12)
    swap = lmm_swap_value_fn(m, k_par, 4, 12)
    tr = bermudan_swaption_amc_trade_lmm(m, k_par, 4, 12, n_exercise=4,
                                         notional=0.5)
    prof = netting_set_profile(
        m, (swap, tr), 4096, K_FWD, T=K_FWD * DELTA, seed=SEED,
        hazard_rate=0.02, im_spread=0.003)
    assert np.all(np.isfinite(np.asarray(prof["epe"])))
    assert 0.0 < float(prof["cva"]) < float(prof["cva_no_netting"])
    assert float(prof["mva"]) > 0.0


def test_sharded_ms_amc_bitwise_mesh_invariant_and_matches_unsharded():
    """The distributed multi-state AMC fit: every profile array and
    scalar bitwise identical across 1/2/4-device meshes, and the
    unsharded engine agrees to regression-conditioning noise (one-pass
    vs two-pass standardization, block-ordered sums) — the same contract
    the scalar AMC test pins."""
    from montecarlo.parallel import make_mesh, sharded_netting_profile

    m = _g2()
    swap = g2pp_swap_value_fn(m, KSTRIKE, PAY_TIMES, PAY_DT)
    tr = bermudan_swaption_amc_trade_g2pp(m, KSTRIKE, PAY_TIMES, PAY_DT,
                                          n_exercise=3, notional=0.5)
    trades = (swap, tr)
    kw = dict(T=T_END, seed=11, hazard_rate=0.02, funding_spread=0.004,
              im_spread=0.003)
    got = {k: sharded_netting_profile(m, trades, 2048, N_STEPS,
                                      mesh=make_mesh(k), block_size=256,
                                      pfe_bins=64, **kw)
           for k in (1, 2, 4)}
    for key, v in got[1].items():
        for k in (2, 4):
            np.testing.assert_array_equal(np.asarray(v),
                                          np.asarray(got[k][key]),
                                          err_msg=f"{key}@{k}")
    want = netting_set_profile(m, trades, 2048, N_STEPS, **kw)
    for key in ("epe", "ene", "im"):
        np.testing.assert_allclose(np.asarray(got[4][key]),
                                   np.asarray(want[key]), rtol=5e-7,
                                   atol=1e-12, err_msg=key)
    for key in ("cva", "fva", "mva", "cva_no_netting"):
        np.testing.assert_allclose(float(got[4][key]), float(want[key]),
                                   rtol=5e-7, atol=1e-15, err_msg=key)


def test_sharded_lmm_amc_mesh_invariant():
    """Same bitwise contract on the LMM (K+1 state components)."""
    from montecarlo.parallel import make_mesh, sharded_netting_profile

    m = _lmm()
    k_par = lmm_par_strike(m, 4, 12)
    trades = (lmm_swap_value_fn(m, k_par, 4, 12),
              bermudan_swaption_amc_trade_lmm(m, k_par, 4, 12,
                                              n_exercise=3, notional=0.5))
    kw = dict(T=K_FWD * DELTA, seed=11, hazard_rate=0.02, im_spread=0.003)
    got = {k: sharded_netting_profile(m, trades, 1024, K_FWD,
                                      mesh=make_mesh(k), block_size=256,
                                      pfe_bins=64, **kw)
           for k in (1, 4)}
    for key, v in got[1].items():
        np.testing.assert_array_equal(np.asarray(v),
                                      np.asarray(got[4][key]),
                                      err_msg=key)
    want = netting_set_profile(m, trades, 1024, K_FWD, **kw)
    np.testing.assert_allclose(float(got[4]["cva"]), float(want["cva"]),
                               rtol=5e-6)


def test_scalar_amc_bitwise_at_one_block_per_shard():
    """n_paths == mesh * block_size (ONE block per shard): the trip-1
    lax.map regime where the old batched (n_blk, bs, k) Gram einsums
    compiled differently per mesh shape and flipped fit ULPs — the fit
    now produces every per-block partial with a fixed single-block body
    (found on the LMM book, fixed for the scalar fit too)."""
    from montecarlo.engine.amc import bermudan_swaption_amc_trade
    from montecarlo.engine.exposure import swap_value_fn
    from montecarlo.parallel import make_mesh, sharded_netting_profile
    from montecarlo.processes import Vasicek

    vas = Vasicek.create(0.03, 0.6, 0.04, 0.012, DT, dtype=jnp.float64)
    trades = (swap_value_fn(vas, 0.035, PAY_TIMES, PAY_DT),
              bermudan_swaption_amc_trade(vas, 0.035, PAY_TIMES, PAY_DT,
                                          n_exercise=2, notional=0.5))
    kw = dict(T=T_END, seed=11, hazard_rate=0.02, im_spread=0.003)
    got = {k: sharded_netting_profile(vas, trades, 1024, N_STEPS,
                                      mesh=make_mesh(k), block_size=256,
                                      pfe_bins=64, **kw)
           for k in (1, 4)}
    for key, v in got[1].items():
        np.testing.assert_array_equal(np.asarray(v),
                                      np.asarray(got[4][key]),
                                      err_msg=key)


def test_degenerate_date_slope_zeroed_at_f32():
    """Date 0 has NO cross-sectional spread (every path holds the same
    state), so the regression slope carries no information — at float32
    the old ``poly'(z)/sd`` divided summation noise by the 1e-12
    variance floor and the date-0 IM exploded ~1e6x over the book scale
    (g2pp 3792 vs peak 0.01, caught driving the CLI on chip; the scalar
    Vasicek AMC shared the bug).  The `_slope_ok` floor zeroes it in
    BOTH engines; real-spread dates keep their IM."""
    from montecarlo.engine.amc import bermudan_swaption_amc_trade
    from montecarlo.parallel import make_mesh, sharded_netting_profile
    from montecarlo.processes import Vasicek

    m = G2PP.create(PHI, A, SG, B, ET, RHO, 0.25, dtype=jnp.float32)
    tr = bermudan_swaption_amc_trade_g2pp(m, KSTRIKE, (1.5, 2.0), 0.5,
                                          n_exercise=2, notional=0.5,
                                          dtype=jnp.float32)
    prof = netting_set_profile(m, (tr,), 2048, 8, T=2.0, seed=7,
                               hazard_rate=0.02, dtype=jnp.float32)
    im = np.asarray(prof["im"])
    assert im[0] == 0.0
    assert im[1:6].min() > 0.0          # real-spread dates keep their IM
    v = Vasicek.create(0.03, 0.6, 0.04, 0.012, 0.25, dtype=jnp.float32)
    trv = bermudan_swaption_amc_trade(v, 0.03, (1.5, 2.0), 0.5,
                                      n_exercise=2, notional=0.5,
                                      dtype=jnp.float32)
    # The sharded fit's ONE-PASS variance has eps-linear cancellation
    # noise — its floor is thresholded accordingly (one_pass=True).
    ps = sharded_netting_profile(v, (trv,), 2048, 8, T=2.0, seed=7,
                                 hazard_rate=0.02, mesh=make_mesh(2),
                                 block_size=256, pfe_bins=64,
                                 dtype=jnp.float32)
    im_s = np.asarray(ps["im"])
    assert im_s[0] == 0.0
    assert im_s[1:6].min() > 0.0


def test_spec_mismatch_rejected():
    """A SCALAR AMC spec on a multi-state book (and vice versa) is a
    loud TypeError, not a shape crash inside the fit."""
    from montecarlo.engine.amc import bermudan_swaption_amc_trade
    from montecarlo.parallel import make_mesh, sharded_netting_profile
    from montecarlo.processes import Vasicek

    m = _g2()
    vas = Vasicek.create(0.03, 0.6, 0.04, 0.012, DT, dtype=jnp.float64)
    scalar_amc = bermudan_swaption_amc_trade(vas, KSTRIKE, PAY_TIMES,
                                             PAY_DT, n_exercise=2)
    with pytest.raises(TypeError, match="mismatch"):
        sharded_netting_profile(m, (scalar_amc,), 512, N_STEPS, T=T_END,
                                seed=1, mesh=make_mesh(1), block_size=256,
                                pfe_bins=64)
    ms_amc = bermudan_swaption_amc_trade_g2pp(m, KSTRIKE, PAY_TIMES,
                                              PAY_DT, n_exercise=2)
    with pytest.raises(TypeError, match="mismatch"):
        sharded_netting_profile(vas, (ms_amc,), 512, N_STEPS, T=T_END,
                                seed=1, mesh=make_mesh(1), block_size=256,
                                pfe_bins=64)


def test_streaming_ms_amc_bitwise_matches_sharded():
    """Multi-state AMC books STREAM too: the chunked fit regresses on the
    same signed-intrinsic rows, and the G2++ Bermudan netting profile's
    per-date means are BITWISE the sharded engine's (round 5 emptied the
    streaming exclusion list down to WWR)."""
    from montecarlo.engine.streaming import streaming_netting_profile
    from montecarlo.parallel import make_mesh, sharded_netting_profile

    m = _g2()
    tr = bermudan_swaption_amc_trade_g2pp(m, KSTRIKE, PAY_TIMES, PAY_DT,
                                          n_exercise=2)
    kw = dict(T=T_END, seed=5, hazard_rate=0.02, pfe_bins=64)
    got = streaming_netting_profile(m, (tr,), 1024, N_STEPS,
                                    chunk_paths=512, block_size=256, **kw)
    want = sharded_netting_profile(m, (tr,), 1024, N_STEPS,
                                   mesh=make_mesh(2), block_size=256, **kw)
    for k in ("epe", "ene", "eepe", "im"):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(float(got["cva"]), float(want["cva"]),
                               rtol=5e-16, atol=0)


def test_streaming_amc_requires_matching_spec_form():
    """A scalar-spec AMC trade on a multi-state underlying is rejected by
    the streaming engine with the same message as the sharded ones."""
    from montecarlo.engine.amc import bermudan_swaption_amc_trade
    from montecarlo.engine.streaming import streaming_netting_profile
    from montecarlo.processes import Vasicek

    vas = Vasicek.create(0.03, 0.6, 0.04, 0.012, DT, dtype=jnp.float64)
    scalar_tr = bermudan_swaption_amc_trade(vas, KSTRIKE, PAY_TIMES,
                                            PAY_DT, n_exercise=2)
    with pytest.raises(TypeError, match="spec/underlying mismatch"):
        streaming_netting_profile(_g2(), (scalar_tr,), 1024, N_STEPS,
                                  T=T_END, seed=1, chunk_paths=512,
                                  block_size=256)


def test_cli_xva_g2pp_swaption_leg(capsys):
    from montecarlo import cli

    # Calendar aligned with the grid: maturity 2y / 4 periods (pay_dt
    # 0.5) on 8 steps (dt 0.25) — exercise dates 1.0, 1.5 land on rows.
    rc = cli.main(["xva", "--portfolio", "--underlying", "g2pp",
                   "--no-csa", "--paths", "1024", "--steps", "8",
                   "--maturity", "2.0", "--periods", "4",
                   "--swaption-leg", "--swaption-exercise", "2"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n_trades"] == 3
    assert out["cva"] > 0
    # An off-grid exercise calendar fails LOUDLY (default steps=100 over
    # 5y -> dt 0.05 vs pay_dt 0.5 aligns; 8 steps over 5y does not).
    with pytest.raises(ValueError, match="exposure grid"):
        cli.main(["xva", "--portfolio", "--underlying", "g2pp",
                  "--no-csa", "--paths", "1024", "--steps", "8",
                  "--swaption-leg"])
    # Bermudan legs cannot stream on multi-state books.
    with pytest.raises(SystemExit, match="cannot stream"):
        cli.main(["xva", "--portfolio", "--underlying", "g2pp",
                  "--no-csa", "--paths", "1024", "--steps", "8",
                  "--swaption-leg", "--checkpoint", "/tmp/x.npz"])


def test_cli_xva_lmm_swaption_leg_mesh(capsys):
    from montecarlo import cli

    args = ["xva", "--portfolio", "--underlying", "lmm", "--no-csa",
            "--paths", "1024", "--steps", "8", "--maturity", "2.0",
            "--swaption-leg", "--swaption-exercise", "3"]
    rc = cli.main(args)
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n_trades"] == 3 and out["cva"] > 0
    rc = cli.main(args + ["--mesh", "2"])
    assert rc == 0
    out_m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out_m["mesh"] == 2
    # The sharded fit agrees with the unsharded engine to regression-
    # conditioning noise (different standardization algebra).
    np.testing.assert_allclose(out_m["cva"], out["cva"], rtol=0.02)
