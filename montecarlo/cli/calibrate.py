"""`calibrate` — fit Heston/SABR/VG/NIG/Merton/Kou to an implied-vol
surface (Adam on exact gradients through the differentiable pricers)."""

from __future__ import annotations

import json
import sys


def add_parsers(sub):
    _add_calibrate(sub)


def _add_calibrate(sub):
    p = sub.add_parser("calibrate",
                       help="fit Heston/SABR/VG/NIG/Merton/Kou to an "
                            "implied-vol surface")
    p.add_argument("--model", default="heston",
                   choices=["heston", "sabr", "vg", "nig", "merton",
                            "kou", "vasicek", "lmm"])
    p.add_argument("--surface", default=None,
                   help="CSV with header strike,maturity,iv (long form); "
                        "vasicek: header expiry,pay_dt,strike,periods,"
                        "price (payer-swaption quotes); omit for --demo "
                        "behavior")
    p.add_argument("--s0", type=float, default=100.0,
                   help="spot (heston) / forward (sabr)")
    p.add_argument("--rate", type=float, default=0.03)
    p.add_argument("--beta", type=float, default=0.7,
                   help="SABR beta (fixed by convention)")
    p.add_argument("--maturity", type=float, default=1.0,
                   help="SABR smile maturity (single-expiry fit)")
    p.add_argument("--iters", type=int, default=800)


def cmd_calibrate(args) -> int:
    import numpy as np

    if args.model == "lmm":
        # Two-stage market-model calibration: cap strip -> per-tenor
        # vols (exact Black inversion), then European swaptions -> the
        # forward-correlation decay (Rebonato map).  Demo: generate the
        # quotes from a known humped vol curve + beta and recover both.
        from montecarlo.engine.rates_calibration import (
            bootstrap_lmm_vols, calibrate_lmm_corr_to_swaptions)
        from montecarlo.processes.lmm import (LMM, lmm_par_strike,
                                                  lmm_swaption_rebonato)

        if args.surface:
            raise SystemExit("--model lmm is demo-only in the CLI "
                             "(cap-strip + swaption file formats vary by "
                             "desk); call engine.rates_calibration."
                             "bootstrap_lmm_vols / "
                             "calibrate_lmm_corr_to_swaptions directly")
        delta, k_fwd, beta_true = 0.25, 16, 0.35
        t = delta * np.arange(k_fwd)
        sig_true = 0.12 + 0.25 * (0.3 + t) * np.exp(-0.8 * t)  # humped
        f0 = np.full(k_fwd, args.rate)
        m_true = LMM.create(f0, sig_true, delta, corr_beta=beta_true)
        # Co-terminal ATM-forward cap strip: sum of exact Black caplets.
        p = np.cumprod(1.0 / (1.0 + delta * f0))
        from scipy.stats import norm

        def black(f, k_, sd):
            d1 = (np.log(f / k_) + 0.5 * sd * sd) / sd
            return f * norm.cdf(d1) - k_ * norm.cdf(d1 - sd)

        caplets = np.array([delta * p[k] * black(
            f0[k], args.rate, sig_true[k] * np.sqrt(k * delta))
            for k in range(1, k_fwd)])
        caps = np.cumsum(caplets)
        sig_fit = bootstrap_lmm_vols(f0, delta, args.rate, caps)
        quotes = []
        for s, e in ((2, 8), (4, 16), (8, 16)):
            k_par = lmm_par_strike(m_true, s, e)
            quotes.append((s, e, k_par,
                           lmm_swaption_rebonato(m_true, s, e, k_par)))
        fit = calibrate_lmm_corr_to_swaptions(f0, sig_fit, delta, quotes)
        out = {"corr_beta": round(fit["corr_beta"], 6),
               "rmse_rel": round(fit["rmse_rel"], 9),
               "vol_max_abs_err": round(
                   float(np.abs(sig_fit[1:] - sig_true[1:]).max()), 9),
               "demo_truth": {"corr_beta": beta_true,
                              "vols": "humped, recovered exactly"}}
        print(json.dumps(out))
        return 0

    if args.model == "vasicek":
        # Rates asset class: fit (kappa, theta, sigma) to payer-swaption
        # premia through the traced-Newton Jamshidian pricer.
        from montecarlo.engine.rates_calibration import (
            calibrate_vasicek_to_swaptions, vasicek_swaption_prices)

        demo = None
        if args.surface:
            rows = np.genfromtxt(args.surface, delimiter=",", names=True)
            exp_, pdt, ks, nper, px = (
                np.atleast_1d(rows[c]).astype(np.float64)
                for c in ("expiry", "pay_dt", "strike", "periods",
                          "price"))
            nper = nper.astype(int)
        else:
            demo = dict(kappa=0.8, theta=0.05, sigma=0.015)
            exp_, pdt, ks, nper = [], [], [], []
            for t0 in (1.0, 2.0, 3.0):
                for m in (4, 8):
                    for k_ in (0.036, 0.045, 0.054):
                        exp_.append(t0)
                        pdt.append(0.5)
                        ks.append(k_)
                        nper.append(m)
            px = np.asarray(vasicek_swaption_prices(
                args.rate, demo["kappa"], demo["theta"], demo["sigma"],
                exp_, pdt, ks, nper))
        fit = calibrate_vasicek_to_swaptions(
            exp_, pdt, ks, nper, px, r0=args.rate,
            n_iters=max(args.iters, 1500))
        out = {k: round(float(v), 6) for k, v in fit.items()}
        if demo is not None:
            out["demo_truth"] = demo
        print(json.dumps(out))
        return 0

    if args.surface:
        rows = np.genfromtxt(args.surface, delimiter=",", names=True)
        strikes = np.atleast_1d(rows["strike"]).astype(np.float64)
        mats = np.atleast_1d(rows["maturity"]).astype(np.float64)
        ivs = np.atleast_1d(rows["iv"]).astype(np.float64)
        demo = None
    else:
        # Demo: generate a surface from known parameters and recover them.
        import jax.numpy as jnp

        if args.model == "heston":
            from montecarlo.engine.heston_analytic import (HestonParams,
                                                               heston_call_cf)
            from montecarlo.engine.implied_vol import implied_vol_call

            demo = dict(v0=0.04, kappa=2.0, theta=0.04, xi=0.5, rho=-0.7)
            ks = np.array([80., 90., 100., 110., 120.] * 3)
            mats = np.repeat([0.25, 0.5, 1.0], 5)
            prices = heston_call_cf(
                args.s0, jnp.asarray(ks), jnp.asarray(mats), args.rate,
                HestonParams(**{k: jnp.asarray(v)
                                for k, v in demo.items()}))
            ivs = np.asarray(implied_vol_call(
                prices, args.s0, jnp.asarray(ks), args.rate,
                jnp.asarray(mats)))
            strikes = ks
        elif args.model in ("vg", "nig", "merton", "kou"):
            from montecarlo.engine.cf_pricing import (cf_call_price,
                                                          kou_log_cf,
                                                          merton_log_cf,
                                                          nig_log_cf,
                                                          vg_log_cf)
            from montecarlo.engine.implied_vol import implied_vol_call

            strikes = np.array([80., 90., 100., 110., 120.] * 3)
            mats = np.repeat([0.25, 0.5, 1.0], 5)
            demo_cfg = {
                "vg": (vg_log_cf, dict(sigma=0.18, theta=-0.12, nu=0.25)),
                "nig": (nig_log_cf, dict(alpha=12.0, beta=-4.0,
                                         delta=0.4)),
                "merton": (merton_log_cf, dict(sigma=0.15, lam=0.8,
                                               jump_mean=-0.08,
                                               jump_std=0.12)),
                "kou": (kou_log_cf, dict(sigma=0.15, lam=1.0, p_up=0.35,
                                         eta1=9.0, eta2=4.0)),
            }
            cf_fn, demo = demo_cfg[args.model]
            phi = cf_fn(args.s0, args.rate, *demo.values(),
                        jnp.asarray(mats))
            prices = cf_call_price(phi, args.s0, jnp.asarray(strikes),
                                   jnp.asarray(mats), args.rate)
            ivs = np.asarray(implied_vol_call(
                prices, args.s0, jnp.asarray(strikes), args.rate,
                jnp.asarray(mats)))
        else:
            from montecarlo.processes import sabr_hagan_iv

            # alpha in CEV units: 20%% lognormal ATM vol at f0.
            demo = dict(alpha=0.2 * args.s0 ** (1.0 - args.beta),
                        nu=0.35, rho=-0.4)
            strikes = np.linspace(0.8, 1.25, 10) * args.s0
            mats = np.full(10, args.maturity)
            ivs = np.asarray(sabr_hagan_iv(
                args.s0, jnp.asarray(strikes), args.maturity,
                demo["alpha"], args.beta, demo["nu"], demo["rho"]))

    if args.model == "heston":
        from montecarlo.engine.heston_analytic import (
            calibrate_heston_to_ivs)

        est = calibrate_heston_to_ivs(strikes, mats, ivs, s0=args.s0,
                                      r=args.rate, n_iters=args.iters)
        out = {k: round(float(v), 6) for k, v in est._asdict().items()}
    elif args.model in ("vg", "nig", "merton", "kou"):
        from montecarlo.engine.levy_calibration import (
            calibrate_levy_to_ivs)

        fit = calibrate_levy_to_ivs(args.model, strikes, mats, ivs,
                                    s0=args.s0, r=args.rate,
                                    n_iters=max(args.iters, 1500))
        out = {k: round(float(v), 6) for k, v in fit.items()}
    else:
        if not np.allclose(mats, mats[0]):
            raise SystemExit("SABR fits one expiry at a time; the surface "
                             "has mixed maturities")
        from montecarlo.processes import calibrate_sabr

        fit = calibrate_sabr(strikes, ivs, f0=args.s0, T=float(mats[0]),
                             beta=args.beta, n_iters=max(args.iters, 2000))
        out = {k: round(float(v), 6) for k, v in fit.items()}
    if demo is not None:
        out["demo_truth"] = demo
    print(json.dumps(out))
    return 0

