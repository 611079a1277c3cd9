"""Variance swaps vs closed forms; counterparty exposure profiles (EPE/PFE/
CVA) for a Vasicek swap."""

import math

import numpy as np
import jax.numpy as jnp

from montecarlo.engine.exposure import exposure_profile, swap_value_fn
from montecarlo.engine.functionals import variance_swap_strike_mc
from montecarlo.processes import GBM, Heston, Vasicek


def test_variance_swap_strike_gbm():
    """Under GBM: E[sum (dlog S)^2] = n (m^2 dt^2 + sigma^2 dt), exactly."""
    sigma, mu, T, n = 0.2, 0.05, 1.0, 252
    dt = T / n
    proc = GBM.create(100.0, mu, sigma, dt, dtype=jnp.float64)
    est = variance_swap_strike_mc(proc, 1 << 16, n, T=T, seed=3,
                                  dtype=jnp.float64)
    m = mu - 0.5 * sigma**2
    want = n * (m * m * dt * dt + sigma * sigma * dt) / T
    assert abs(float(est["strike"]) - want) < 4 * float(est["std_err"])


def test_variance_swap_strike_heston():
    """Under Heston: E[int v dt]/T = theta + (v0-theta)(1-e^{-kT})/(kT)."""
    v0, kappa, theta, T, n = 0.09, 2.0, 0.04, 1.0, 256
    proc = Heston.create(s0=100.0, v0=v0, mu=0.0, kappa=kappa, theta=theta,
                         xi=0.3, rho=-0.5, dt=T / n, dtype=jnp.float64)
    est = variance_swap_strike_mc(proc, 1 << 16, n, T=T, seed=5,
                                  dtype=jnp.float64)
    want = theta + (v0 - theta) * (1 - math.exp(-kappa * T)) / (kappa * T)
    # O(dt) Euler bias allowance on top of MC error
    assert abs(float(est["strike"]) - want) < 4 * float(est["std_err"]) \
        + 0.003, (est, want)


R0, KAPPA, THETA, SIG = 0.03, 0.6, 0.04, 0.012
T, N_STEPS = 2.0, 64


def _profile(hazard=0.0):
    model = Vasicek.create(R0, KAPPA, THETA, SIG, T / N_STEPS,
                           dtype=jnp.float64)
    pay_times = np.arange(1, 5) * 0.5  # semiannual over 2y
    vfn = swap_value_fn(model, strike=0.035, payment_times=pay_times,
                        pay_dt=0.5)
    return model, vfn, exposure_profile(
        model, vfn, 1 << 14, N_STEPS, T=T, seed=7, hazard_rate=hazard)


def test_epe_profile_shape():
    model, vfn, prof = _profile()
    epe = np.asarray(prof["epe"])
    pfe = np.asarray(prof["pfe"])
    # t=0 exposure is deterministic: EPE(0) = max(V_0, 0)
    r0 = jnp.full((16,), R0, jnp.float64)
    v0 = float(vfn(r0, jnp.float64(0.0))[0])
    assert abs(epe[0] - max(v0, 0.0)) < 1e-12
    # all payments past at T: exposure dies
    assert epe[-1] < 1e-12
    # PFE dominates EPE where exposure probability is material (the 95th
    # percentile is legitimately 0 when P(V>0) < 5%, while the mean isn't)
    peak = int(np.argmax(epe))
    assert pfe[peak] >= epe[peak]
    assert np.all(pfe >= 0)
    # effective EPE is the running max
    eepe = np.asarray(prof["eepe"])
    assert np.all(np.diff(eepe) >= -1e-15)
    assert abs(eepe.max() - epe.max()) < 1e-15


def test_cva_scales_with_hazard():
    _, _, p0 = _profile(hazard=0.0)
    _, _, p1 = _profile(hazard=0.01)
    _, _, p2 = _profile(hazard=0.02)
    assert float(p0["cva"]) == 0.0
    assert 0.0 < float(p1["cva"]) < float(p2["cva"])
    # small-hazard linearity: cva(2l) ~ 2 cva(l) within 5%
    assert abs(float(p2["cva"]) / float(p1["cva"]) - 2.0) < 0.1


def test_mid_period_float_leg_carries_in_period_fixing():
    """Within-period martingale check: between payment dates no cashflow
    occurs, so E[D(0,t) V_t] must be CONSTANT across every grid time of
    one accrual period (it legitimately jumps by the discounted coupon AT
    payment dates). The reset-date approximation (float leg =
    1 - P(t,T_last), in-period fixing dropped) drifts by O(coupon) inside
    the period; the fixing-aware valuation must stay flat within MC
    tolerance (advisor finding r2 #3)."""
    from montecarlo.engine.simulate import simulate

    model = Vasicek.create(R0, KAPPA, THETA, SIG, T / N_STEPS,
                           dtype=jnp.float64)
    pay_times = np.arange(1, 5) * 0.5
    vfn = swap_value_fn(model, strike=0.035, payment_times=pay_times,
                        pay_dt=0.5)
    n = 1 << 15
    paths = np.asarray(simulate(model, n, N_STEPS, seed=11, mode="paths",
                                dtype=jnp.float64))
    dt = T / N_STEPS
    mid = 0.5 * (paths[:-1] + paths[1:]) * dt
    disc = np.exp(-np.concatenate([np.zeros((1, n)),
                                   np.cumsum(mid, axis=0)], axis=0))

    # Period [0.5, 1.0): fixing at t_fix = 0.5 (grid row 16).
    t_fix, k_fix = 0.5, int(round(0.5 / dt))
    r_fix = jnp.asarray(paths[k_fix])

    def dv(k, with_fixing):
        t = k * dt
        r_t = jnp.asarray(paths[k])
        v = (vfn(r_t, jnp.float64(t), r_fix, jnp.float64(t_fix))
             if with_fixing else vfn(r_t, jnp.float64(t)))
        x = disc[k] * np.asarray(v)
        return np.mean(x), np.std(x, ddof=1) / np.sqrt(n)

    ks = range(k_fix, int(round(1.0 / dt)))  # every grid time in-period
    base_mean, base_se = dv(k_fix, True)
    drift_fix = max(abs(dv(k, True)[0] - base_mean) for k in ks)
    drift_old = max(abs(dv(k, False)[0] - base_mean) for k in ks)
    assert drift_fix < 6 * base_se + 1e-4, (drift_fix, base_se)
    # Non-vacuous: the reset-date approximation drifts by O(coupon).
    assert drift_old > 20 * max(drift_fix, 1e-5), (drift_old, drift_fix)

    # At the period start both forms coincide (continuity of the fix).
    a = np.asarray(vfn(r_fix, jnp.float64(t_fix), r_fix,
                       jnp.float64(t_fix)))
    b = np.asarray(vfn(r_fix, jnp.float64(t_fix)))
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def test_exposure_profile_with_fixings_runs_and_matches_at_resets():
    """exposure_profile(fixing_times=...) wires the path fixings through;
    the EPE at t=0 (a reset date) matches the reset-date formula."""
    model = Vasicek.create(R0, KAPPA, THETA, SIG, T / N_STEPS,
                           dtype=jnp.float64)
    pay_times = np.arange(1, 5) * 0.5
    vfn = swap_value_fn(model, strike=0.035, payment_times=pay_times,
                        pay_dt=0.5)
    prof = exposure_profile(model, vfn, 1 << 13, N_STEPS, T=T, seed=7,
                            fixing_times=pay_times - 0.5)
    epe = np.asarray(prof["epe"])
    r0 = jnp.full((16,), R0, jnp.float64)
    v0 = float(vfn(r0, jnp.float64(0.0))[0])
    assert abs(epe[0] - max(v0, 0.0)) < 1e-9
    assert epe[-1] < 1e-12
    assert np.all(np.asarray(prof["pfe"]) >= 0)


def test_cva_dva_symmetry():
    """Negating the instrument swaps EPE<->ENE pathwise, so CVA under a
    counterparty hazard equals DVA under the same OWN hazard exactly."""
    model = Vasicek.create(R0, KAPPA, THETA, SIG, T / N_STEPS,
                           dtype=jnp.float64)
    pay_times = np.arange(1, 5) * 0.5
    vfn = swap_value_fn(model, strike=0.035, payment_times=pay_times,
                        pay_dt=0.5)
    neg_vfn = lambda r, t: -vfn(r, t)
    a = exposure_profile(model, vfn, 1 << 13, N_STEPS, T=T, seed=7,
                         hazard_rate=0.02, recovery=0.4)
    b = exposure_profile(model, neg_vfn, 1 << 13, N_STEPS, T=T, seed=7,
                         own_hazard_rate=0.02, own_recovery=0.4)
    np.testing.assert_allclose(float(a["cva"]), float(b["dva"]), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(a["epe"]), np.asarray(b["ene"]),
                               rtol=1e-12)
    assert float(a["dva"]) == 0.0 and float(b["cva"]) == 0.0


def test_xva_deterministic_closed_form():
    """sigma ~ 0 makes the rate path and discounting deterministic; a
    constant-value instrument then has every xVA in closed form — checks
    the survival weighting, dPD algebra, and funding accrual exactly."""
    sig0 = 1e-12
    model = Vasicek.create(R0, KAPPA, THETA, sig0, T / N_STEPS,
                           dtype=jnp.float64)
    c = 2.5
    vfn = lambda r, t: jnp.full_like(r, c)
    lam_c, lam_o, rec_c, rec_o, sf = 0.03, 0.015, 0.4, 0.35, 0.004
    prof = exposure_profile(model, vfn, 256, N_STEPS, T=T, seed=1,
                            hazard_rate=lam_c, recovery=rec_c,
                            own_hazard_rate=lam_o, own_recovery=rec_o,
                            funding_spread=sf)
    dt = T / N_STEPS
    times = dt * np.arange(N_STEPS + 1)
    # Exact OU path at sigma=0 and the engine's trapezoid discounting.
    r = THETA + (R0 - THETA) * np.exp(-KAPPA * times)
    mid = 0.5 * (r[:-1] + r[1:]) * dt
    disc = np.exp(-np.concatenate([[0.0], np.cumsum(mid)]))
    surv_c = np.exp(-lam_c * times)
    surv_o = np.exp(-lam_o * times)
    dpd_c = np.concatenate([[0.0], surv_c[:-1] - surv_c[1:]])
    dpd_o = np.concatenate([[0.0], surv_o[:-1] - surv_o[1:]])
    w_o = np.concatenate([[1.0], surv_o[:-1]])
    w_c = np.concatenate([[1.0], surv_c[:-1]])
    cva_want = (1 - rec_c) * np.sum(c * disc * dpd_c * w_o)
    np.testing.assert_allclose(float(prof["cva"]), cva_want, rtol=1e-9)
    # DVA = 0: the value never goes negative.
    assert float(prof["dva"]) == 0.0
    trap = np.full(N_STEPS + 1, dt)
    trap[0] = trap[-1] = 0.5 * dt
    fca_want = sf * np.sum(c * disc * surv_c * surv_o * trap)
    np.testing.assert_allclose(float(prof["fca"]), fca_want, rtol=1e-9)
    assert float(prof["fba"]) == 0.0
    np.testing.assert_allclose(float(prof["fva"]), fca_want, rtol=1e-9)
    np.testing.assert_allclose(float(prof["bcva"]), cva_want, rtol=1e-9)


def test_bilateral_reduces_to_unilateral():
    """own_hazard = 0: CVA must equal the unilateral formula bitwise (the
    backward-compatibility contract in the docstring)."""
    model, vfn, prof = _profile(hazard=0.02)
    prof2 = exposure_profile(model, vfn, 1 << 14, N_STEPS, T=T, seed=7,
                             hazard_rate=0.02, own_hazard_rate=0.0)
    np.testing.assert_allclose(float(prof["cva"]), float(prof2["cva"]),
                               rtol=1e-12)
    assert float(prof2["dva"]) == 0.0 and float(prof2["fva"]) == 0.0


def test_cli_xva(capsys):
    import json

    from montecarlo import cli

    rc = cli.main(["xva", "--paths", "4096", "--steps", "40"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["cva"] > 0 and out["dva"] > 0
    assert abs(out["bcva"] - (out["cva"] - out["dva"])) < 1e-9
    assert out["fva"] == round(out["fca"] - out["fba"], 6) or \
        abs(out["fva"] - (out["fca"] - out["fba"])) < 2e-6
    assert out["peak_epe"] > 0 and out["peak_pfe"] >= out["peak_epe"]


def test_mva_linear_instrument_closed_form():
    """V = c*r makes dV/dr = c exactly, so IM_t = z |c| sigma_r(MPOR) is a
    CONSTANT — E[D IM] then factors through the discount curve, and with
    sigma -> 0 the discounting is deterministic too: MVA in closed form."""
    sig0 = 1e-12
    model = Vasicek.create(R0, KAPPA, THETA, sig0, T / N_STEPS,
                           dtype=jnp.float64)
    c = 50.0
    vfn = lambda r, t: c * r
    s_im, q_im, mpor = 0.002, 0.99, 10.0 / 252.0
    prof = exposure_profile(model, vfn, 128, N_STEPS, T=T, seed=1,
                            im_spread=s_im, im_quantile=q_im, mpor=mpor)
    dt = T / N_STEPS
    times = dt * np.arange(N_STEPS + 1)
    r = THETA + (R0 - THETA) * np.exp(-KAPPA * times)
    mid = 0.5 * (r[:-1] + r[1:]) * dt
    disc = np.exp(-np.concatenate([[0.0], np.cumsum(mid)]))
    from scipy.stats import norm

    sig_mpor = sig0 * np.sqrt((1 - np.exp(-2 * KAPPA * mpor))
                              / (2 * KAPPA))
    im_const = norm.ppf(q_im) * c * sig_mpor
    np.testing.assert_allclose(np.asarray(prof["im"]), im_const,
                               rtol=1e-6)
    trap = np.full(N_STEPS + 1, dt)
    trap[0] = trap[-1] = 0.5 * dt
    mva_want = s_im * np.sum(im_const * disc * trap)
    np.testing.assert_allclose(float(prof["mva"]), mva_want, rtol=1e-9)


def test_mva_zero_spread_and_swap_im_shape():
    """im_spread = 0 -> mva 0; the swap's IM profile amortizes to ~0 at
    maturity (dV/dr -> 0 as payments roll off)."""
    model = Vasicek.create(R0, KAPPA, THETA, SIG, T / N_STEPS,
                           dtype=jnp.float64)
    pay_times = np.arange(1, 5) * 0.5
    vfn = swap_value_fn(model, strike=0.035, payment_times=pay_times,
                        pay_dt=0.5)
    prof = exposure_profile(model, vfn, 1 << 12, N_STEPS, T=T, seed=7)
    assert float(prof["mva"]) == 0.0
    im = np.asarray(prof["im"])
    assert im[0] > 0.0
    assert im[-1] < 0.05 * im[0], (im[0], im[-1])


def test_equity_forward_cva_black_scholes_oracle():
    """Equity-underlying exposure (flat_rate mode): for a forward on GBM,
    disc*EPE(t) = BS_call(s0, K e^{-r(T-t)}, r, sigma, t) in CLOSED FORM,
    so the whole CVA has an exact oracle; the delta-normal IM is
    z sigma sqrt(MPOR) E[S_t] exactly (dV/dS = 1)."""
    from scipy.stats import norm

    from montecarlo.engine import black_scholes_call
    from montecarlo.processes import GBM

    s0, strike, r, sigma, T_fwd = 100.0, 100.0, 0.03, 0.25, 2.0
    n_steps, n_paths = 64, 1 << 15
    lam, rec = 0.02, 0.4
    q_im, mpor = 0.99, 10.0 / 252.0
    gbm = GBM.create(s0, r, sigma, T_fwd / n_steps, dtype=jnp.float64)
    vfn = lambda s, t: s - strike * jnp.exp(-r * (T_fwd - t))
    prof = exposure_profile(gbm, vfn, n_paths, n_steps, T=T_fwd, seed=3,
                            hazard_rate=lam, recovery=rec, flat_rate=r,
                            im_spread=0.001, im_quantile=q_im, mpor=mpor)
    dt = T_fwd / n_steps
    times = dt * np.arange(n_steps + 1)
    depe_oracle = np.array([
        max(s0 - strike * np.exp(-r * T_fwd), 0.0) if t == 0.0 else
        float(black_scholes_call(s0, strike * np.exp(-r * (T_fwd - t)),
                                 r, sigma, t))
        for t in times])
    surv = np.exp(-lam * times)
    dpd = np.concatenate([[0.0], surv[:-1] - surv[1:]])
    cva_oracle = (1 - rec) * np.sum(depe_oracle * dpd)
    assert abs(float(prof["cva"]) - cva_oracle) < 0.03 * cva_oracle, \
        (float(prof["cva"]), cva_oracle)
    # IM oracle: z sigma sqrt(mpor) E[S_t] = z sigma sqrt(mpor) s0 e^{rt}.
    im_oracle = (norm.ppf(q_im) * sigma * np.sqrt(mpor)
                 * s0 * np.exp(r * times))
    got = np.asarray(prof["im"])
    np.testing.assert_allclose(got, im_oracle,
                               rtol=4 * sigma * np.sqrt(T_fwd)
                               / np.sqrt(n_paths) * 4 + 1e-3)


def test_cli_xva_equity(capsys):
    import json

    from montecarlo import cli

    rc = cli.main(["xva", "--underlying", "equity", "--paths", "4096",
                   "--steps", "32", "--im-spread", "0.001"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["underlying"] == "equity"
    # ATM forward: value 0 at inception, so EPE ~ ENE and FVA ~ 0.
    assert out["cva"] > 0 and out["mva"] > 0
    assert abs(out["fva"]) < 0.3 * max(out["fca"], 1e-9), out


# ---------------------------------------------------------------------------
# Netting sets + CSA collateral
# ---------------------------------------------------------------------------


def test_netting_zero_threshold_instant_collateral_kills_exposure():
    """H=0, MTA=0, MPoR=0: collateral tracks the netted value exactly, so
    the collateralized EPE/ENE are identically zero and every xVA on the
    collateralized exposure vanishes — the pinned CSA limit."""
    from montecarlo.engine.exposure import CSA, netting_set_profile

    model = Vasicek.create(R0, KAPPA, THETA, SIG, T / N_STEPS,
                           dtype=jnp.float64)
    pay_times = np.arange(1, 5) * 0.5
    v1 = swap_value_fn(model, 0.035, pay_times, 0.5)
    v2 = swap_value_fn(model, 0.04, pay_times[:2], 0.5)
    trades = (v1, lambda r, t: -0.5 * v2(r, t))
    prof = netting_set_profile(
        model, trades, 2048, N_STEPS, T=T, seed=3,
        csa=CSA(threshold=0.0, own_threshold=0.0, mta=0.0, mpor=0.0),
        hazard_rate=0.02, recovery=0.4, funding_spread=0.004)
    assert np.all(np.asarray(prof["epe"]) == 0.0)
    assert np.all(np.asarray(prof["ene"]) == 0.0)
    assert float(prof["cva"]) == 0.0
    assert float(prof["fva"]) == 0.0
    # The uncollateralized profile is NOT zero (the book has real risk).
    assert np.asarray(prof["epe_uncollateralized"]).max() > 0.0


def test_netting_mpor_gap_risk_closed_form():
    """Linear trade V = c*(r - r0) under near-Brownian rates (kappa ~ 0,
    theta = r0): with zero thresholds/MTA the collateralized exposure is
    the MPoR increment (V_t - V_{t-delta})^+, whose mean is the
    closed-form half-normal c*sigma*sqrt(delta)/sqrt(2*pi)."""
    from montecarlo.engine.exposure import CSA, netting_set_profile

    steps, t_end = 64, 2.0
    dt = t_end / steps
    lag_steps = 4
    mpor = lag_steps * dt
    c, sig = 50.0, 0.01
    model = Vasicek.create(R0, 1e-9, R0, sig, dt, dtype=jnp.float64)
    trades = (lambda r, t: c * (r - R0),)
    n = 1 << 14
    prof = netting_set_profile(
        model, trades, n, steps, T=t_end, seed=9,
        csa=CSA(threshold=0.0, own_threshold=0.0, mta=0.0, mpor=mpor))
    epe = np.asarray(prof["epe"])
    want = c * sig * np.sqrt(mpor) / np.sqrt(2 * np.pi)
    # Half-normal mean's MC std-err: std = c*sig*sqrt(mpor*(1 - 1/pi)).
    se = c * sig * np.sqrt(mpor * (1 - 1 / np.pi) / n)
    got = epe[lag_steps:]  # rows past the first full lag window
    np.testing.assert_allclose(got, want, atol=5 * se)
    # Before the lag window fills, the gap is shorter -> smaller EPE.
    assert epe[1] < want


def test_netting_offsets_and_no_netting_baseline():
    """A perfectly offsetting book nets to zero (cva == 0) while the
    standalone per-trade baseline still charges both legs; partial
    offsets land strictly between."""
    from montecarlo.engine.exposure import netting_set_profile

    model = Vasicek.create(R0, KAPPA, THETA, SIG, T / N_STEPS,
                           dtype=jnp.float64)
    pay_times = np.arange(1, 5) * 0.5
    v = swap_value_fn(model, 0.035, pay_times, 0.5)
    mirror = (v, lambda r, t: -v(r, t))
    prof0 = netting_set_profile(model, mirror, 2048, N_STEPS, T=T, seed=3,
                                hazard_rate=0.02, recovery=0.4)
    assert float(prof0["cva"]) == 0.0
    assert float(prof0["cva_no_netting"]) > 0.0

    partial = (v, lambda r, t: -0.5 * v(r, t))
    prof1 = netting_set_profile(model, partial, 2048, N_STEPS, T=T, seed=3,
                                hazard_rate=0.02, recovery=0.4)
    assert 0.0 < float(prof1["cva"]) < float(prof1["cva_no_netting"])


def test_netting_single_trade_matches_exposure_profile():
    """csa=None, one trade: the netting-set EPE equals the single-trade
    engine's EPE on the same seed/paths (same simulation, same marks)."""
    from montecarlo.engine.exposure import netting_set_profile

    model = Vasicek.create(R0, KAPPA, THETA, SIG, T / N_STEPS,
                           dtype=jnp.float64)
    pay_times = np.arange(1, 5) * 0.5
    v = swap_value_fn(model, 0.035, pay_times, 0.5)
    single = exposure_profile(model, v, 2048, N_STEPS, T=T, seed=3,
                              hazard_rate=0.02, recovery=0.4,
                              im_spread=0.003)
    netted = netting_set_profile(model, (v,), 2048, N_STEPS, T=T, seed=3,
                                 hazard_rate=0.02, recovery=0.4,
                                 im_spread=0.003)
    np.testing.assert_allclose(np.asarray(netted["epe"]),
                               np.asarray(single["epe"]), rtol=1e-10)
    np.testing.assert_allclose(float(netted["cva"]), float(single["cva"]),
                               rtol=1e-10)
    np.testing.assert_allclose(float(netted["cva_no_netting"]),
                               float(netted["cva"]), rtol=1e-10)
    # Netted delta-normal IM/MVA degenerate to the single-trade engine's
    # (both use the OU conditional std over the default 10d MPoR).
    np.testing.assert_allclose(np.asarray(netted["im"]),
                               np.asarray(single["im"]), rtol=1e-10)
    np.testing.assert_allclose(float(netted["mva"]), float(single["mva"]),
                               rtol=1e-10)
    assert float(netted["mva"]) > 0


def test_netting_im_nets_across_offsetting_trades():
    """IM is computed on the NETTED sensitivity: a book of (v, -v) has
    dV_net/dr == 0, so the netted IM vanishes while each standalone trade
    carries real IM — and a scaled single trade scales IM linearly."""
    from montecarlo.engine.exposure import netting_set_profile

    model = Vasicek.create(R0, KAPPA, THETA, SIG, T / N_STEPS,
                           dtype=jnp.float64)
    pay_times = np.arange(1, 5) * 0.5
    v = swap_value_fn(model, 0.035, pay_times, 0.5)
    flat = netting_set_profile(model, (v, lambda r, t: -1.0 * v(r, t)),
                               2048, N_STEPS, T=T, seed=3,
                               im_spread=0.003)
    np.testing.assert_allclose(np.asarray(flat["im"]), 0.0, atol=1e-12)
    assert float(flat["mva"]) == 0.0
    one = netting_set_profile(model, (v,), 2048, N_STEPS, T=T, seed=3,
                              im_spread=0.003)
    two = netting_set_profile(model, (v, v), 2048, N_STEPS, T=T, seed=3,
                              im_spread=0.003)
    np.testing.assert_allclose(np.asarray(two["im"]),
                               2.0 * np.asarray(one["im"]), rtol=1e-10)


def test_netting_csa_guards_and_mta():
    """Huge thresholds/MTA disable collateral (profile == uncollateralized);
    a sub-grid MPoR warns that the gap risk is invisible."""
    import pytest

    from montecarlo.engine.exposure import CSA, netting_set_profile

    model = Vasicek.create(R0, KAPPA, THETA, SIG, T / N_STEPS,
                           dtype=jnp.float64)
    pay_times = np.arange(1, 5) * 0.5
    trades = (swap_value_fn(model, 0.035, pay_times, 0.5),)
    huge = netting_set_profile(
        model, trades, 2048, N_STEPS, T=T, seed=3,
        csa=CSA(threshold=1e9, own_threshold=1e9, mta=0.0, mpor=0.0))
    np.testing.assert_array_equal(
        np.asarray(huge["epe"]), np.asarray(huge["epe_uncollateralized"]))
    big_mta = netting_set_profile(
        model, trades, 2048, N_STEPS, T=T, seed=3,
        csa=CSA(threshold=0.0, own_threshold=0.0, mta=1e9, mpor=0.0))
    np.testing.assert_array_equal(
        np.asarray(big_mta["epe"]),
        np.asarray(big_mta["epe_uncollateralized"]))
    with pytest.warns(UserWarning, match="margin period"):
        netting_set_profile(
            model, trades, 256, 8, T=T, seed=3,
            csa=CSA(threshold=0.0, own_threshold=0.0, mta=0.0,
                    mpor=0.25 * T / 8))


def test_cli_xva_portfolio(capsys):
    import json

    from montecarlo import cli

    rc = cli.main(["xva", "--portfolio", "--paths", "2048", "--steps",
                   "50", "--threshold", "0.005", "--mta", "0.001"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n_trades"] == 3 and out["csa"] is True
    assert out["peak_epe"] <= out["peak_epe_uncollateralized"]
    assert 0.0 <= out["cva"] <= out["cva_no_netting"]

    rc = cli.main(["xva", "--portfolio", "--underlying", "equity",
                   "--no-csa", "--paths", "2048", "--steps", "32"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["underlying"] == "equity" and out["csa"] is False
    assert out["cva"] <= out["cva_no_netting"]


# ---------------------------------------------------------------------------
# Wrong-way risk
# ---------------------------------------------------------------------------

def _wwr_book(n_paths=1 << 13, steps=N_STEPS, receiver=False):
    model = Vasicek.create(R0, KAPPA, THETA, SIG, T / steps,
                           dtype=jnp.float64)
    pay_times = np.arange(1, 5) * 0.5
    vfn = swap_value_fn(model, 0.035, pay_times, 0.5)
    sign = -1.0 if receiver else 1.0
    return model, (lambda r, t: sign * vfn(r, t),), n_paths


def test_wwr_beta_zero_reduces_to_flat():
    """beta = 0 makes the pathwise default increments deterministic, so
    cva_wwr collapses to the flat-hazard cva (same sum, different fp
    association), and the calibrated survival curve IS the flat curve."""
    from montecarlo.engine.exposure import netting_set_profile

    model, trades, n = _wwr_book()
    prof = netting_set_profile(model, trades, n, N_STEPS, T=T, seed=11,
                               hazard_rate=0.02, recovery=0.4,
                               wwr_beta=0.0)
    cva, cva_wwr = float(prof["cva"]), float(prof["cva_wwr"])
    assert abs(cva_wwr - cva) < 1e-12 * max(abs(cva), 1e-30), (cva, cva_wwr)
    times = np.asarray(prof["times"])
    np.testing.assert_allclose(np.asarray(prof["survival_wwr"]),
                               np.exp(-0.02 * times), rtol=1e-12)


def test_wwr_survival_calibrated_for_any_beta():
    """The Newton calibration pins the UNCONDITIONAL survival curve to the
    flat-hazard curve regardless of beta — the CDS curve is an input, not
    a model output.  Checked at a deliberately aggressive loading."""
    from montecarlo.engine.exposure import netting_set_profile

    model, trades, n = _wwr_book()
    prof = netting_set_profile(model, trades, n, N_STEPS, T=T, seed=11,
                               hazard_rate=0.03, wwr_beta=2.0)
    times = np.asarray(prof["times"])
    np.testing.assert_allclose(np.asarray(prof["survival_wwr"]),
                               np.exp(-0.03 * times), rtol=1e-10)
    # ... and the tilt actually moved the CVA.
    assert abs(float(prof["cva_wwr"]) - float(prof["cva"])) > 1e-6


def test_wwr_sign():
    """Payer swap: exposure increases in r.  beta > 0 concentrates default
    where r (and the exposure) is high -> cva_wwr > cva; beta < 0 is
    right-way.  The receiver side mirrors both inequalities."""
    from montecarlo.engine.exposure import netting_set_profile

    for receiver in (False, True):
        model, trades, n = _wwr_book(receiver=receiver)
        out = {}
        for beta in (1.0, -1.0):
            prof = netting_set_profile(model, trades, n, N_STEPS, T=T,
                                       seed=13, hazard_rate=0.02,
                                       wwr_beta=beta)
            out[beta] = (float(prof["cva_wwr"]), float(prof["cva"]))
        wrong = 1.0 if not receiver else -1.0
        cva_w, cva = out[wrong]
        assert cva_w > cva * 1.02, (receiver, out)
        cva_r, cva = out[-wrong]
        assert cva_r < cva * 0.98, (receiver, out)


def test_wwr_numpy_oracle():
    """Independent NumPy re-implementation of the WWR tilt — same paths
    (GBM forward book, flat discounting), same definition: per-date
    standardization, Newton-calibrated survival, pathwise
    (1-R) sum E[D V+ dPD].  Guards the JAX scan/fori machinery."""
    from montecarlo.engine.exposure import netting_set_profile
    from montecarlo.engine.simulate import simulate

    s0, r, sig, t_end, steps, n = 100.0, 0.03, 0.25, 1.0, 32, 4096
    beta, lam, rec, seed = 0.8, 0.02, 0.4, 17
    dt = t_end / steps
    model = GBM.create(s0, r, sig, dt, dtype=jnp.float64)
    k = s0 * np.exp(r * t_end)
    trades = (lambda s, t: s - k * jnp.exp(-r * (t_end - t)),)
    prof = netting_set_profile(model, trades, n, steps, T=t_end, seed=seed,
                               hazard_rate=lam, recovery=rec,
                               wwr_beta=beta, flat_rate=r)

    paths = np.asarray(simulate(model, n, steps, seed=seed, mode="paths",
                                dtype=jnp.float64))          # (T+1, N)
    times = np.arange(steps + 1) * dt
    disc = np.exp(-r * times)[:, None] * np.ones((1, n))
    v = paths - k * np.exp(-r * (t_end - times))[:, None]
    pos = np.maximum(v, 0.0)
    mean_k = paths.mean(axis=1, keepdims=True)
    std_k = paths.std(axis=1, keepdims=True)
    z = np.where(std_k > 0, (paths - mean_k) / np.where(std_k > 0, std_k,
                                                        1.0), 0.0)
    w = np.exp(beta * z)
    s_prev = np.ones(n)
    cva_np = 0.0
    for j in range(1, steps + 1):
        target = np.exp(-lam * times[j])
        c = lam
        for _ in range(12):
            f = np.mean(s_prev * np.exp(-c * w[j - 1] * dt))
            fp = dt * np.mean(s_prev * w[j - 1] * np.exp(-c * w[j - 1] * dt))
            c = c + (f - target) / fp
        s_new = s_prev * np.exp(-c * w[j - 1] * dt)
        cva_np += np.mean(disc[j] * pos[j] * (s_prev - s_new))
        s_prev = s_new
    cva_np *= (1.0 - rec)
    assert abs(float(prof["cva_wwr"]) - cva_np) < 1e-12 * cva_np + 1e-15


def test_cli_xva_portfolio_wwr(capsys):
    import json

    from montecarlo import cli

    rc = cli.main(["xva", "--portfolio", "--no-csa", "--paths", "2048",
                   "--steps", "50", "--wwr-beta", "1.0"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["wwr_beta"] == 1.0
    # Demo book is net long the payer swap -> exposure increases in r ->
    # beta > 0 is wrong-way.
    assert out["cva_wwr"] > out["cva"]


def test_kva_deterministic_exposure_closed_form():
    """A constant-value trade under flat-rate discounting makes every
    factor of the KVA integral deterministic (EEPE = c, P(0,t) = e^{-rt}),
    so MC must reproduce the closed-form capital integral exactly."""
    from montecarlo.engine.exposure import netting_set_profile

    c, r, lam_c, lam_o = 3.0, 0.03, 0.02, 0.01
    cost, ratio = 0.10, 0.112
    steps, t_end = 16, 2.0
    dt = t_end / steps
    model = GBM.create(100.0, r, 0.2, dt, dtype=jnp.float64)
    trades = (lambda s, t: jnp.full_like(s, c),)
    prof = netting_set_profile(model, trades, 256, steps, T=t_end, seed=1,
                               hazard_rate=lam_c, own_hazard_rate=lam_o,
                               kva_cost=cost, kva_capital_ratio=ratio,
                               flat_rate=r, dtype=jnp.float64)
    times = dt * np.arange(steps + 1)
    trap = np.full(steps + 1, dt)
    trap[0] = trap[-1] = 0.5 * dt
    alive = np.exp(-(lam_c + lam_o) * times)
    want = cost * np.sum(ratio * c * np.exp(-r * times) * alive * trap)
    np.testing.assert_allclose(float(prof["kva"]), want, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(prof["eepe"]), c, rtol=1e-12)


def test_kva_off_by_default_and_collateral_limits():
    """kva_cost defaults to 0 (term off); KVA is charged on the
    COLLATERALIZED EEPE, so the pinned instant-collateral limit (H=0,
    MTA=0, MPoR=0 — collateral tracks the netted value exactly) kills the
    capital charge entirely while the uncollateralized book pays it.
    (A lagged CSA need NOT reduce KVA on a mostly-negative book: our own
    posted collateral against the MPoR-old mark creates gap exposure —
    that direction is deliberately not asserted.)"""
    from montecarlo.engine.exposure import CSA, netting_set_profile

    model = Vasicek.create(R0, KAPPA, THETA, SIG, T / N_STEPS,
                           dtype=jnp.float64)
    pay_times = np.arange(1, 5) * 0.5
    v = swap_value_fn(model, 0.035, pay_times, 0.5)
    off = netting_set_profile(model, (v,), 2048, N_STEPS, T=T, seed=3,
                              hazard_rate=0.02)
    assert float(off["kva"]) == 0.0
    bare = netting_set_profile(model, (v,), 2048, N_STEPS, T=T, seed=3,
                               hazard_rate=0.02, kva_cost=0.10)
    assert float(bare["kva"]) > 0.0
    instant = netting_set_profile(
        model, (v,), 2048, N_STEPS, T=T, seed=3, hazard_rate=0.02,
        kva_cost=0.10,
        csa=CSA(threshold=0.0, own_threshold=0.0, mta=0.0, mpor=0.0))
    assert float(instant["kva"]) == 0.0


def test_cli_xva_portfolio_kva(capsys):
    import json

    from montecarlo import cli

    rc = cli.main(["xva", "--portfolio", "--no-csa", "--paths", "2048",
                   "--steps", "50", "--kva-cost", "0.1"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["kva"] > 0.0
