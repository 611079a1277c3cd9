"""`bond` — short-rate bond / bond-option pricing (Vasicek, CIR,
Hull-White) with affine closed-form oracles and autodiff duration/convexity."""

from __future__ import annotations

import json
import sys


def add_parsers(sub):
    _add_bond(sub)


def _add_bond(sub):
    p = sub.add_parser("bond", help="short-rate bond / bond-option pricing")
    p.add_argument("--model", default="vasicek",
                   choices=["vasicek", "cir", "hullwhite", "g2pp", "lmm"])
    p.add_argument("--r0", type=float, default=0.03)
    p.add_argument("--kappa", type=float, default=0.8,
                   help="mean-reversion speed (a for hullwhite)")
    p.add_argument("--theta", type=float, default=0.05,
                   help="long-run level (vasicek/cir)")
    p.add_argument("--sigma", type=float, default=0.015)
    p.add_argument("--maturity", type=float, default=2.0, help="years")
    p.add_argument("--paths", type=int, default=1 << 16)
    p.add_argument("--steps", type=int, default=128)
    p.add_argument("--option", action="store_true",
                   help="European call on a bond: expiry --t1, bond "
                        "maturity --maturity (vasicek only)")
    p.add_argument("--t1", type=float, default=1.0)
    p.add_argument("--option-strike", type=float, default=None,
                   help="default: ATM forward bond price")
    p.add_argument("--fwd-slope", type=float, default=0.005,
                   help="hullwhite: slope of the synthetic forward curve")
    p.add_argument("--g2pp-b", type=float, default=0.1,
                   help="g2pp: second-factor mean reversion b")
    p.add_argument("--g2pp-eta", type=float, default=0.01,
                   help="g2pp: second-factor volatility eta")
    p.add_argument("--g2pp-rho", type=float, default=-0.7,
                   help="g2pp: factor correlation rho")
    p.add_argument("--cap", action="store_true",
                   help="price a cap on the simple rate (strip of "
                        "zero-bond puts, closed form; --floor for the "
                        "floor; --cap-strike defaults to r0) with an MC "
                        "cross-check; requires --model vasicek")
    p.add_argument("--floor", action="store_true",
                   help="with --cap: price the floor instead")
    p.add_argument("--cap-strike", type=float, default=None)
    p.add_argument("--cap-resets", type=int, default=4,
                   help="number of caplets (quarterly from 0.25y)")
    p.add_argument("--swaption", action="store_true",
                   help="Bermudan payer swaption by pathwise-discounted "
                        "LSM (vasicek; n_exercise=1 prints the Jamshidian "
                        "European closed form too); with --model lmm: "
                        "European payer swaption, MC vs the Rebonato "
                        "frozen-weight approximation")
    p.add_argument("--caplet", action="store_true",
                   help="lmm: MC caplet vs its EXACT Black closed form "
                        "(struck at the forward; reset at --t1 snapped to "
                        "the tenor grid)")
    p.add_argument("--lmm-sigma", type=float, default=0.2,
                   help="lmm: flat lognormal forward vol")
    p.add_argument("--lmm-shift", type=float, default=0.0,
                   help="lmm: displaced-diffusion shift (skew / negative "
                        "rates; caplet oracle shifts with it)")
    p.add_argument("--corr-beta", type=float, default=0.1,
                   help="lmm: forward-correlation decay "
                        "exp(-beta |T_j - T_k|)")
    p.add_argument("--tenor", type=float, default=0.25,
                   help="lmm: forward tenor delta (the simulation grid)")
    p.add_argument("--swap-strike", type=float, default=None,
                   help="fixed rate (default: ~par)")
    p.add_argument("--periods", type=int, default=8,
                   help="swaption: quarterly payment count")
    p.add_argument("--n-exercise", type=int, default=4,
                   help="swaption: number of Bermudan exercise dates")
    p.add_argument("--seed", type=int, default=0)


def cmd_bond(args) -> int:
    import numpy as np

    from montecarlo.engine.rates import (
        bond_option_mc, cir_zcb, vasicek_bond_option, vasicek_zcb,
        zcb_price_mc)
    from montecarlo.processes import CIR, HullWhite, Vasicek

    if args.model == "lmm":
        return _cmd_bond_lmm(args)
    T, n_steps = args.maturity, args.steps
    dt = T / n_steps
    if args.model == "vasicek":
        proc = Vasicek.create(args.r0, args.kappa, args.theta, args.sigma,
                              dt)
        cf = vasicek_zcb(args.r0, args.kappa, args.theta, args.sigma, T)
    elif args.model == "cir":
        proc = CIR.create(args.r0, args.kappa, args.theta, args.sigma, dt)
        cf = cir_zcb(args.r0, args.kappa, args.theta, args.sigma, T)
    elif args.model == "g2pp":
        from montecarlo.processes.g2pp import G2PP, g2pp_zcb

        proc = G2PP.create(args.r0, args.kappa, args.sigma, args.g2pp_b,
                           args.g2pp_eta, args.g2pp_rho, dt)
        cf = float(g2pp_zcb(proc, T))
    else:
        t_grid = np.arange(n_steps + 1) * dt
        fwd = args.r0 + args.fwd_slope * t_grid
        proc = HullWhite.from_forward_curve(fwd, a=args.kappa,
                                            sigma=args.sigma, dt=dt)
        cf = float(np.exp(-np.trapezoid(fwd, t_grid)))

    if args.cap:
        import jax.numpy as jnp

        from montecarlo.engine.rates import (vasicek_bond_from_rate,
                                                 vasicek_cap_price)
        from montecarlo.engine.pricing import mc_estimate
        from montecarlo.engine.simulate import simulate

        if args.model != "vasicek":
            raise SystemExit("--cap requires --model vasicek")
        delta = 0.25
        resets = delta * np.arange(1, args.cap_resets + 1)
        k_cap = args.cap_strike if args.cap_strike is not None else args.r0
        cf_cap = float(vasicek_cap_price(
            args.r0, args.kappa, args.theta, args.sigma, k_cap, resets,
            delta, floor=args.floor))
        # MC cross-check: simulate to the last reset, read each caplet's
        # simple rate off the reset-date bond, discount pathwise to the
        # payment date via D(0, T_i) * P(T_i, T_i + delta).
        t_last = float(resets[-1])
        n_mc = min(n_steps, 256)
        mc_dt = t_last / n_mc
        proc_mc = Vasicek.create(args.r0, args.kappa, args.theta,
                                 args.sigma, mc_dt)
        paths = simulate(proc_mc, args.paths, n_mc, seed=args.seed,
                         mode="paths")
        mid = 0.5 * (paths[:-1] + paths[1:]) * mc_dt
        cum = jnp.concatenate(
            [jnp.zeros((1, args.paths), paths.dtype),
             jnp.cumsum(mid, axis=0)], axis=0)
        total = 0.0
        for t_i in resets:
            k_i = int(round(float(t_i) / mc_dt))
            p_i = vasicek_bond_from_rate(paths[k_i], args.kappa,
                                         args.theta, args.sigma, delta)
            lib = (1.0 / p_i - 1.0) / delta
            pay = (jnp.maximum(k_cap - lib, 0.0) if args.floor
                   else jnp.maximum(lib - k_cap, 0.0))
            total = total + jnp.exp(-cum[k_i]) * p_i * delta * pay
        est = mc_estimate(total)
        print(json.dumps({
            "instrument": "floor" if args.floor else "cap",
            "strike": k_cap, "resets": args.cap_resets,
            "closed_form": round(cf_cap, 8),
            "mc_price": round(float(est["price"]), 8),
            "mc_std_err": round(float(est["std_err"]), 8)}))
        return 0

    if args.swaption:
        import jax.numpy as jnp

        from montecarlo.engine.bermudan import (
            bermudan_swaption_lsm, vasicek_swaption_jamshidian)
        from montecarlo.engine.rates import vasicek_zcb as _zcb

        if args.model == "g2pp":
            # European payer swaption under G2++: the Brigo-Mercurio
            # (4.31) quadrature closed form (no LSM needed).
            from montecarlo.processes.g2pp import (G2PP, g2pp_swaption,
                                                       g2pp_zcb)

            delta = 0.25
            t0 = delta
            pays = [t0 + (i + 1) * delta for i in range(args.periods - 1)]
            proc = G2PP.create(args.r0, args.kappa, args.sigma,
                               args.g2pp_b, args.g2pp_eta, args.g2pp_rho,
                               delta / 16)
            if args.swap_strike is None:
                ps = [float(g2pp_zcb(proc, t)) for t in pays]
                strike = ((float(g2pp_zcb(proc, t0)) - ps[-1])
                          / (delta * sum(ps)))
            else:
                strike = args.swap_strike
            px = float(g2pp_swaption(proc, strike, t0, pays, delta,
                                     payer=True))
            print(json.dumps({"g2pp_european_swaption": round(px, 8),
                              "strike": round(float(strike), 8),
                              "expiry": t0, "periods": args.periods}))
            return 0
        if args.model != "vasicek":
            raise SystemExit("--swaption requires --model vasicek or g2pp")
        delta, spp = 0.25, 16
        if args.swap_strike is None:
            # Forward par rate of the swap entered at the first reset t=delta
            # with payments at 2*delta..periods*delta:
            # K = (P(delta) - P(n*delta)) / (delta * sum P(i*delta), i>=2).
            # The annuity excludes P(delta) but the FLOAT leg starts there —
            # using P(2*delta) in the numerator understated K ~0.5pp.
            ps = [_zcb(args.r0, args.kappa, args.theta, args.sigma,
                       i * delta) for i in range(2, args.periods + 1)]
            p_start = _zcb(args.r0, args.kappa, args.theta, args.sigma,
                           delta)
            strike = (p_start - ps[-1]) / (delta * sum(ps)) if ps \
                else args.theta
        else:
            strike = args.swap_strike
        proc = Vasicek.create(args.r0, args.kappa, args.theta, args.sigma,
                              delta / spp, dtype=jnp.float64)
        res = bermudan_swaption_lsm(
            proc, strike, n_paths=args.paths, steps_per_period=spp,
            n_periods=args.periods, n_exercise=args.n_exercise,
            seed=args.seed)
        out = {"bermudan_swaption": float(res["price"]),
               "std_err": float(res["std_err"]),
               "strike": float(strike),
               "n_exercise": args.n_exercise}
        if args.n_exercise == 1:
            out["jamshidian_european"] = vasicek_swaption_jamshidian(
                (args.kappa, args.theta, args.sigma), strike, t0=delta,
                delta=delta, n_periods=args.periods - 1, r0=args.r0)
        print(json.dumps(out))
        return 0

    if args.option:
        if args.model != "vasicek":
            raise SystemExit("--option requires --model vasicek (affine "
                             "closed-form bond at expiry)")
        t1 = args.t1
        strike = args.option_strike or (
            vasicek_zcb(args.r0, args.kappa, args.theta, args.sigma, T)
            / vasicek_zcb(args.r0, args.kappa, args.theta, args.sigma, t1))
        proc = Vasicek.create(args.r0, args.kappa, args.theta, args.sigma,
                              t1 / n_steps)
        est = bond_option_mc(proc, t1, T, strike, n_steps, args.paths,
                             seed=args.seed)
        out = {"bond_option_price": float(est["price"]),
               "std_err": float(est["std_err"]),
               "strike": strike,
               "jamshidian": vasicek_bond_option(
                   args.r0, args.kappa, args.theta, args.sigma, t1, T,
                   strike)}
    else:
        est = zcb_price_mc(proc, T, n_steps, args.paths, seed=args.seed)
        out = {"zcb_price": float(est["price"]),
               "std_err": float(est["std_err"]),
               "closed_form": cf}
    print(json.dumps(out))
    return 0


def _cmd_bond_lmm(args) -> int:
    """`bond --model lmm`: forward-curve instruments with their oracles —
    ZCB by the bank-account martingale E[1/B(T)] = P(0,T) (exact up to
    the predictor-corrector drift), `--caplet` vs its EXACT Black closed
    form, `--swaption` vs the Rebonato frozen-weight approximation."""
    import numpy as np
    import jax.numpy as jnp

    from montecarlo.engine.simulate import simulate
    from montecarlo.processes.lmm import (LMM, lmm_caplet_mc,
                                              lmm_par_strike,
                                              lmm_swaption_mc, lmm_zcb0)

    delta = args.tenor
    k_fwd = max(int(round(args.maturity / delta)), 2)
    m = LMM.create([args.r0] * k_fwd, [args.lmm_sigma] * k_fwd, delta,
                   corr_beta=args.corr_beta, shift=args.lmm_shift,
                   dtype=jnp.float32)
    if args.caplet:
        k_idx = min(max(int(round(args.t1 / delta)), 1), k_fwd - 1)
        strike = (args.option_strike if args.option_strike is not None
                  else args.r0)
        est = lmm_caplet_mc(m, k_idx, strike, args.paths, seed=args.seed,
                            dtype=jnp.float32)
        print(json.dumps({
            "instrument": "caplet", "reset": k_idx * delta,
            "strike": strike,
            "mc_price": round(est["price"], 8),
            "mc_std_err": round(est["std_err"], 8),
            "black_exact": round(est["black"], 8)}))
        return 0
    if args.swaption:
        s = max(k_fwd // 4, 1)
        strike = (args.swap_strike if args.swap_strike is not None
                  else lmm_par_strike(m, s, k_fwd))
        est = lmm_swaption_mc(m, s, k_fwd, strike, args.paths,
                              seed=args.seed, dtype=jnp.float32)
        out = {"instrument": "lmm_european_swaption",
               "expiry": s * delta, "strike": round(float(strike), 8),
               "periods": k_fwd - s,
               "mc_price": round(est["price"], 8),
               "mc_std_err": round(est["std_err"], 8),
               "rebonato": round(est["rebonato"], 8)}
        if args.n_exercise > 1:
            from montecarlo.engine.bermudan import (
                lmm_bermudan_swaption_lsm)

            berm = lmm_bermudan_swaption_lsm(
                m, float(strike), s, k_fwd,
                n_exercise=min(args.n_exercise, k_fwd - s),
                n_paths=args.paths, seed=args.seed, dtype=jnp.float32)
            out["instrument"] = "lmm_bermudan_swaption"
            out["bermudan_price"] = round(float(berm["price"]), 8)
            out["n_exercise"] = min(args.n_exercise, k_fwd - s)
        print(json.dumps(out))
        return 0
    obs = simulate(m, args.paths, k_fwd, seed=args.seed, mode="terminal",
                   dtype=jnp.float32,
                   observe=lambda p, s_: p.exposure_obs(s_))
    d = np.asarray(jnp.exp(-obs[:, -1]), np.float64)
    print(json.dumps({
        "zcb_price": round(float(d.mean()), 8),
        "std_err": round(float(d.std(ddof=1) / np.sqrt(args.paths)), 8),
        "closed_form": round(lmm_zcb0(m, k_fwd), 8),
        "forwards": k_fwd, "tenor": delta}))
    return 0

