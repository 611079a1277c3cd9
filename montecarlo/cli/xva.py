"""`xva` — counterparty exposure profiles (EPE/ENE/PFE) and the xVA set
for a Vasicek swap or GBM equity forward; `--portfolio` nets a multi-trade
book against one counterparty with CSA variation margin."""

from __future__ import annotations

import json


def add_parsers(sub):
    _add_xva(sub)


def _add_xva(sub):
    p = sub.add_parser("xva", help="counterparty exposure profiles "
                                   "(EPE/ENE/PFE) and CVA/DVA/FVA/MVA for "
                                   "an interest-rate swap (Vasicek) or an "
                                   "equity forward (GBM)")
    p.add_argument("--underlying", default="rates",
                   choices=["rates", "equity", "g2pp", "hybrid", "lmm",
                            "heston"],
                   help="rates: Vasicek payer swap, pathwise discounting; "
                        "equity: GBM forward, flat discounting (CVA has a "
                        "Black-Scholes closed form, tested); g2pp: "
                        "two-factor Gaussian rates (--portfolio only — "
                        "two-tenor swap book, honest curve-risk netting); "
                        "hybrid: equity x Vasicek (--portfolio only — "
                        "cross-asset netting set: swap + equity forwards "
                        "on ONE exact joint simulation, exact pathwise "
                        "discounting); lmm: the full forward-curve Libor "
                        "Market Model (--portfolio only — a K-forward "
                        "curve book, one state per tenor, EXACT discrete "
                        "bank-account discounting; the grid is the reset "
                        "calendar: delta = maturity/steps); heston: "
                        "equity + VOLATILITY netting (--portfolio only — "
                        "equity forward + variance swaps marked off one "
                        "stochastic-vol simulation; affine closed-form "
                        "variance-swap marks, WWR loads on the variance)")
    p.add_argument("--xi", type=float, default=0.5,
                   help="heston: vol-of-variance (kappa/theta are the "
                        "variance mean reversion and long-run VARIANCE; "
                        "v0 = theta; --factor-rho the spot-vol "
                        "correlation)")
    p.add_argument("--g2pp-b", type=float, default=0.08,
                   help="g2pp: second-factor mean reversion")
    p.add_argument("--g2pp-eta", type=float, default=0.012,
                   help="g2pp: second-factor volatility")
    p.add_argument("--factor-rho", type=float, default=-0.7,
                   help="g2pp: factor correlation; hybrid: equity-rate "
                        "correlation")
    p.add_argument("--lmm-sigma", type=float, default=0.2,
                   help="lmm: flat lognormal forward vol")
    p.add_argument("--lmm-shift", type=float, default=0.0,
                   help="lmm: displaced-diffusion shift")
    p.add_argument("--corr-beta", type=float, default=0.1,
                   help="lmm: exponential forward-correlation decay "
                        "exp(-beta |T_j - T_k|)")
    p.add_argument("--s0", type=float, default=100.0,
                   help="equity: spot")
    p.add_argument("--fwd-strike", type=float, default=None,
                   help="equity: forward strike (default: the par forward "
                        "s0*e^{rT})")
    p.add_argument("--equity-sigma", type=float, default=0.25,
                   help="equity: GBM volatility")
    p.add_argument("--r0", type=float, default=0.03)
    p.add_argument("--kappa", type=float, default=0.8)
    p.add_argument("--theta", type=float, default=0.05)
    p.add_argument("--sigma", type=float, default=0.015)
    p.add_argument("--maturity", type=float, default=5.0,
                   help="swap maturity, years")
    p.add_argument("--periods", type=int, default=10,
                   help="number of swap payments (semiannual default)")
    p.add_argument("--swap-strike", type=float, default=None,
                   help="fixed rate (default: the par-ish model yield)")
    p.add_argument("--paths", type=int, default=1 << 15)
    p.add_argument("--steps", type=int, default=100,
                   help="exposure grid resolution")
    p.add_argument("--hazard", type=float, default=0.02,
                   help="counterparty flat hazard rate (CVA)")
    p.add_argument("--recovery", type=float, default=0.4)
    p.add_argument("--own-hazard", type=float, default=0.01,
                   help="own flat hazard rate (DVA; 0 = unilateral)")
    p.add_argument("--own-recovery", type=float, default=0.4)
    p.add_argument("--funding-spread", type=float, default=0.005,
                   help="flat funding spread (FVA; 0 disables)")
    p.add_argument("--im-spread", type=float, default=0.0,
                   help="initial-margin funding spread (MVA; 0 disables)")
    p.add_argument("--mpor", type=float, default=10.0 / 252.0,
                   help="margin period of risk in years (MVA)")
    p.add_argument("--quantile", type=float, default=0.95,
                   help="PFE quantile")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--portfolio", action="store_true",
                   help="netting-set mode: a demo book of offsetting "
                        "trades (swaps on rates, forwards on equity) "
                        "netted against one counterparty, with CSA "
                        "variation margin (threshold/MTA/MPoR); reports "
                        "collateralized xVA plus the no-netting baseline")
    p.add_argument("--threshold", type=float, default=0.0,
                   help="portfolio: counterparty CSA threshold")
    p.add_argument("--own-threshold", type=float, default=0.0,
                   help="portfolio: own CSA threshold")
    p.add_argument("--mta", type=float, default=0.0,
                   help="portfolio: minimum transfer amount")
    p.add_argument("--no-csa", action="store_true",
                   help="portfolio: no collateral (netting only)")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="portfolio: shard the simulation + marking over an "
                        "N-device paths mesh (sharded_netting_profile — "
                        "bitwise mesh-shape-invariant profiles incl. "
                        "IM/MVA, WWR, and Bermudan AMC legs; PFE via the "
                        "integer-psum sketch, grid error reported)")
    p.add_argument("--swaption-leg", action="store_true",
                   help="portfolio (rates/g2pp/lmm): add a 0.5x "
                        "physically-settled payer swaption (expiry at "
                        "half maturity into the back calendar). rates: "
                        "Jamshidian-marked (engine.exposure."
                        "swaption_value_fn); g2pp/lmm: AMC "
                        "regression-marked on the curve state (engine."
                        "amc.bermudan_swaption_amc_trade_g2pp/_lmm — "
                        "even the European leg, no closed form off a "
                        "multi-factor state)")
    p.add_argument("--swaption-exercise", type=int, default=1,
                   metavar="N",
                   help="with --swaption-leg: number of Bermudan exercise "
                        "dates (1 = European, Jamshidian-marked; >1 = "
                        "American-Monte-Carlo regression marks, "
                        "engine.amc.bermudan_swaption_amc_trade; with "
                        "--mesh the fit runs distributed on gathered "
                        "fixed-block Gram sums; with --checkpoint it "
                        "streams as extra fit sweeps over the chunks)")
    p.add_argument("--counterparties", type=int, default=1,
                   choices=[1, 2],
                   help="portfolio: 2 splits the demo book across two "
                        "counterparties (second at 1.5x the hazard) and "
                        "runs the multi-netting-set portfolio engine on "
                        "ONE simulation (engine.exposure.portfolio_xva; "
                        "with --mesh N: parallel.sharded_portfolio_xva; "
                        "incompatible with --greeks)")
    p.add_argument("--checkpoint", default=None, metavar="PATH.npz",
                   help="portfolio: stream the netting profile in chunks "
                        "with checkpoint/resume "
                        "(engine.streaming.streaming_netting_profile — "
                        "resume is bitwise the uninterrupted run; "
                        "IM/MVA included; excludes WWR and AMC legs "
                        "(global fits need a second pass over every "
                        "chunk), and --mesh itself)")
    p.add_argument("--chunk-paths", type=int, default=0,
                   help="portfolio streaming: paths per chunk (default "
                        "paths/4; blocks per chunk must be a power of "
                        "two)")
    p.add_argument("--var-horizon", type=float, default=0.0, metavar="H",
                   help="portfolio: also report desk market-risk VaR/CVaR "
                        "of the netted book — FULL revaluation at horizon "
                        "H years (engine.exposure.book_var; exact-sort "
                        "quantiles with order-statistic error bars; "
                        "incompatible with Bermudan AMC legs)")
    p.add_argument("--var-steps", type=int, default=10,
                   help="portfolio: simulation sub-steps to the VaR "
                        "horizon (pathwise discounting accuracy)")
    p.add_argument("--greeks", action="store_true",
                   help="portfolio: pathwise-AD xVA sensitivities "
                        "(d{cva,dva,bcva,fva,mva}/d{r0|s0, sigma, "
                        "hazard_rate} via engine.exposure.xva_greeks; "
                        "with --mesh N: parallel.sharded_xva_greeks — "
                        "values AND greeks bitwise mesh-invariant; with "
                        "--mta > 0 the deadband boundary is ignored and a "
                        "warning is raised)")
    p.add_argument("--allocate", action="store_true",
                   help="portfolio: Euler (marginal) allocation of the "
                        "netted CVA/DVA/FVA to each trade "
                        "(engine.exposure.xva_trade_allocations — one "
                        "forward tangent per trade under common random "
                        "numbers; allocations sum to the totals exactly "
                        "when collateral is homogeneous, i.e. no-CSA or "
                        "zero threshold/MTA; otherwise the gap is "
                        "reported; runs unsharded)")
    p.add_argument("--kva-cost", type=float, default=0.0,
                   help="portfolio: cost-of-capital hurdle rate (KVA; 0 "
                        "disables). Capital is modeled as "
                        "kva-capital-ratio x collateralized EEPE")
    p.add_argument("--kva-capital-ratio", type=float, default=0.112,
                   help="portfolio: capital per unit EEPE (the Basel "
                        "alpha x RW x 8%% chain collapsed; default "
                        "1.4 x 1.0 x 0.08)")
    p.add_argument("--rqmc", type=int, default=0, metavar="R",
                   help="portfolio: price the netting set under "
                        "randomized QMC — R independently scrambled Sobol "
                        "replicates (engine.exposure"
                        ".netting_set_profile_rqmc); every xVA scalar "
                        "gains an honest replicate-spread std error "
                        "(measured ~16x tighter than plain MC on the demo "
                        "CVA at equal paths); runs unsharded — "
                        "incompatible with --mesh/--checkpoint/--greeks/"
                        "--allocate/--counterparties; 0 = plain MC")
    p.add_argument("--wwr-beta", type=float, default=0.0,
                   help="portfolio: wrong-way risk — counterparty default "
                        "intensity log-loading per sigma of the underlying "
                        "state (survival curve stays calibrated to "
                        "--hazard; reports cva_wwr alongside the "
                        "independent cva; >0 wrong-way, <0 right-way)")


def cmd_xva(args) -> int:
    import numpy as np

    from montecarlo.engine.exposure import (exposure_profile,
                                                swap_value_fn)
    from montecarlo.engine.rates import vasicek_zcb
    from montecarlo.processes import Vasicek

    import jax.numpy as jnp

    if args.underlying in ("g2pp", "hybrid", "lmm", "heston") \
            and not args.portfolio:
        raise SystemExit(f"--underlying {args.underlying} is a multi-state "
                         "exposure underlying — it marks through the "
                         "netting engine; add --portfolio")
    if args.portfolio:
        return _cmd_xva_portfolio(args)
    if args.allocate:
        raise SystemExit("--allocate decomposes a netted book; it "
                         "requires --portfolio")

    if args.underlying == "equity":
        from montecarlo.processes import GBM

        gbm = GBM.create(args.s0, args.r0, args.equity_sigma,
                         args.maturity / args.steps)
        k_fwd = args.fwd_strike or args.s0 * float(
            np.exp(args.r0 * args.maturity))
        t_mat = args.maturity
        vfn_eq = lambda s, t: s - k_fwd * jnp.exp(-args.r0 * (t_mat - t))
        prof = exposure_profile(
            gbm, vfn_eq, args.paths, args.steps, T=args.maturity,
            seed=args.seed, quantile=args.quantile,
            hazard_rate=args.hazard, recovery=args.recovery,
            own_hazard_rate=args.own_hazard,
            own_recovery=args.own_recovery,
            funding_spread=args.funding_spread, im_spread=args.im_spread,
            mpor=args.mpor, flat_rate=args.r0, dtype=jnp.float32)
        epe = np.asarray(prof["epe"])
        out = {"underlying": "equity", "fwd_strike": round(k_fwd, 4),
               "peak_epe": round(float(epe.max()), 6),
               "peak_pfe": round(float(np.asarray(prof["pfe"]).max()), 6),
               "peak_im": round(float(np.asarray(prof["im"]).max()), 6)}
        for k in ("cva", "dva", "bcva", "fca", "fba", "fva", "mva"):
            out[k] = round(float(prof[k]), 6)
        print(json.dumps(out))
        return 0

    pay_dt = args.maturity / args.periods
    payment_times = pay_dt * np.arange(1, args.periods + 1)
    model = Vasicek.create(args.r0, args.kappa, args.theta, args.sigma,
                           args.maturity / args.steps)
    if args.swap_strike is None:
        # Par rate of the spot-starting swap: (1 - P(T)) / (dt * sum P(ti)).
        ps = [vasicek_zcb(args.r0, args.kappa, args.theta, args.sigma, t)
              for t in payment_times]
        strike = (1.0 - ps[-1]) / (pay_dt * sum(ps))
    else:
        strike = args.swap_strike
    # f32 here: the engine defaults to f64 for the x64 test environment,
    # but the CLI runs without x64 — request f32 explicitly rather than
    # let JAX truncate with a warning per call site.
    value_fn = swap_value_fn(model, strike, payment_times, pay_dt,
                             dtype=jnp.float32)
    prof = exposure_profile(
        model, value_fn, args.paths, args.steps, T=args.maturity,
        seed=args.seed, quantile=args.quantile, hazard_rate=args.hazard,
        recovery=args.recovery, own_hazard_rate=args.own_hazard,
        own_recovery=args.own_recovery,
        funding_spread=args.funding_spread, im_spread=args.im_spread,
        mpor=args.mpor,
        fixing_times=payment_times - pay_dt, dtype=jnp.float32)
    epe = np.asarray(prof["epe"])
    out = {"strike": round(float(strike), 6),
           "peak_epe": round(float(epe.max()), 6),
           "peak_epe_time": round(float(np.asarray(prof["times"])
                                        [int(epe.argmax())]), 4),
           "peak_pfe": round(float(np.asarray(prof["pfe"]).max()), 6),
           "eepe": round(float(np.asarray(prof["eepe"])[-1]), 6)}
    out["peak_im"] = round(float(np.asarray(prof["im"]).max()), 6)
    for k in ("cva", "dva", "bcva", "fca", "fba", "fva", "mva"):
        out[k] = round(float(prof[k]), 6)
    print(json.dumps(out))
    return 0


def _cmd_xva_portfolio(args) -> int:
    """`xva --portfolio`: a netted, collateralized book on one simulation.

    Rates book (Vasicek): long payer par swap (full calendar), short 0.6x
    receiver-side on the front half, long 0.5x payer struck 10% over par.
    Equity book (GBM): long forward struck under par, short 0.6x over par,
    long 0.5x at par — same netting structure, flat discounting.
    """
    import numpy as np
    import jax.numpy as jnp

    from montecarlo.engine.exposure import (CSA, netting_set_profile,
                                                swap_value_fn)
    from montecarlo.engine.rates import vasicek_zcb
    from montecarlo.processes import GBM, Vasicek

    csa = None if args.no_csa else CSA(
        threshold=args.threshold, own_threshold=args.own_threshold,
        mta=args.mta, mpor=args.mpor)
    if args.swaption_leg and args.underlying not in ("rates", "g2pp",
                                                     "lmm"):
        raise SystemExit("--swaption-leg needs a rates underlying: "
                         "rates (Vasicek), g2pp, or lmm")
    if args.underlying == "lmm" and args.var_horizon > 0:
        # book_var rebuilds the model with dt = horizon/steps; the LMM's
        # grid IS the reset calendar (dt == delta validated at create), so
        # a horizon grid would silently compound the bank account at every
        # sub-step as if it were a reset.
        raise SystemExit("--var-horizon is not defined for --underlying "
                         "lmm (the simulation grid is the reset calendar); "
                         "use g2pp/rates for horizon VaR on rates books")
    if args.allocate and (getattr(args, "mesh", 0) or args.checkpoint):
        # Validate up front: failing only after the profile run would make
        # the user pay the whole simulation before the SystemExit.
        raise SystemExit("--allocate runs the unsharded netting body "
                         "(one forward tangent per trade); drop "
                         "--mesh/--checkpoint")
    if args.rqmc and (getattr(args, "mesh", 0) or args.checkpoint
                      or args.greeks or args.allocate
                      or args.counterparties > 1):
        raise SystemExit("--rqmc prices one netting set unsharded "
                         "(independent Sobol replicates); drop "
                         "--mesh/--checkpoint/--greeks/--allocate/"
                         "--counterparties")

    def scaled(fn, a):
        return lambda s, t: a * fn(s, t)

    # The book as a function of the differentiable scalars: strikes are
    # FIXED floats (computed once from the CLI inputs), so --greeks
    # reports sensitivities at constant contract terms; the trades are
    # rebuilt from the params so valuation sensitivity flows through the
    # swap closed forms, not just the simulation (see xva_greeks docs).
    dt = args.maturity / args.steps
    if args.underlying == "g2pp":
        # Two-tenor curve book on the two-factor model: the netting the
        # one-factor family cannot represent honestly (all forwards
        # comonotone) — long 4x short-tenor payer, short 1x full-tenor
        # payer, both at par.
        from montecarlo.processes.g2pp import (G2PP,
                                                   g2pp_swap_value_fn,
                                                   g2pp_zcb)

        pay_dt = args.maturity / args.periods
        times_full = pay_dt * np.arange(1, args.periods + 1)
        times_half = times_full[:max(args.periods // 2, 1)]
        # Strikes are FIXED floats computed once from the CLI inputs (the
        # --greeks convention above): a concrete model prices them; the
        # traced rebuild below only carries the differentiable leaves.
        m0 = G2PP.create(args.r0, args.kappa, args.sigma, args.g2pp_b,
                         args.g2pp_eta, args.factor_rho, dt,
                         dtype=jnp.float32)

        def par(times):
            ps = [float(g2pp_zcb(m0, t)) for t in times]
            return (1.0 - ps[-1]) / (pay_dt * sum(ps))

        k_half, k_full_g2 = par(times_half), par(times_full)

        def build(p):
            m = G2PP.create(p["r0"], args.kappa, p["sigma"], args.g2pp_b,
                            args.g2pp_eta, args.factor_rho, dt,
                            dtype=jnp.float32)
            v_s = g2pp_swap_value_fn(m, k_half, times_half,
                                     pay_dt, dtype=jnp.float32)
            v_l = g2pp_swap_value_fn(m, k_full_g2, times_full,
                                     pay_dt, dtype=jnp.float32)
            trades = (lambda c, t: 4.0 * v_s(c, t),
                      lambda c, t: -1.0 * v_l(c, t))
            if args.swaption_leg:
                from montecarlo.engine.amc import (
                    bermudan_swaption_amc_trade_g2pp)

                # Second-half payer swaption, AMC-marked (even the
                # European n_exercise=1 leg: no Jamshidian closed form
                # off a two-factor state).  notional INSIDE the trade so
                # the structured spec survives for the sharded fit.
                times_back = tuple(
                    float(t) for t in times_full
                    if t > pay_dt * (args.periods // 2) + 1e-9)
                trades += (bermudan_swaption_amc_trade_g2pp(
                    m, k_full_g2, times_back, pay_dt,
                    n_exercise=min(args.swaption_exercise,
                                   len(times_back)),
                    notional=0.5, dtype=jnp.float32),)
            return m, trades, None

        params = {"r0": args.r0, "sigma": args.sigma,
                  "hazard_rate": args.hazard}
        state_param = "r0"
    elif args.underlying == "lmm":
        # Full-curve book on the Libor Market Model: long 2x a front-curve
        # payer, short 1x a back-curve payer, both par — curve-twist
        # netting a short-rate model cannot see (every forward is a state;
        # --corr-beta sets the term structure of correlation).  The grid
        # IS the reset calendar: K = --steps forwards of tenor
        # maturity/steps; exact discrete bank-account discounting.
        from montecarlo.processes.lmm import (LMM, lmm_par_strike,
                                                  lmm_swap_value_fn)

        k_fwd = args.steps
        if k_fwd < 4:
            raise SystemExit("--underlying lmm needs --steps >= 4 "
                             "(forwards = steps)")
        front = (1, max(k_fwd // 3, 2))
        back = (k_fwd // 2, k_fwd)
        # Par strikes fixed once off the concrete initial curve (the
        # --greeks convention: contract terms never carry tracers).
        m0 = LMM.create([args.r0] * k_fwd, [args.lmm_sigma] * k_fwd, dt,
                        corr_beta=args.corr_beta, shift=args.lmm_shift,
                        dtype=jnp.float32)
        k_front = lmm_par_strike(m0, *front)
        k_back = lmm_par_strike(m0, *back)

        def build(p):
            # jnp.full (not a python list): under --greeks p["r0"] is a
            # differentiation tracer and the flat curve must carry it.
            m = LMM.create(jnp.full(k_fwd, p["r0"]),
                           [args.lmm_sigma] * k_fwd,
                           dt, corr_beta=args.corr_beta,
                           shift=args.lmm_shift, dtype=jnp.float32)
            v_f = lmm_swap_value_fn(m, k_front, *front,
                                    dtype=jnp.float32)
            v_b = lmm_swap_value_fn(m, k_back, *back,
                                    dtype=jnp.float32)
            trades = (lambda c, t: 2.0 * v_f(c, t),
                      lambda c, t: -1.0 * v_b(c, t))
            if args.swaption_leg:
                from montecarlo.engine.amc import (
                    bermudan_swaption_amc_trade_lmm)

                # Co-terminal Bermudan on the back-tenor swap (exercise
                # at its first resets), AMC-marked on the full curve.
                trades += (bermudan_swaption_amc_trade_lmm(
                    m, k_back, back[0], back[1],
                    n_exercise=min(args.swaption_exercise,
                                   back[1] - back[0]),
                    notional=0.5, dtype=jnp.float32),)
            return m, trades, None

        params = {"r0": args.r0, "hazard_rate": args.hazard}
        state_param = "r0"
    elif args.underlying == "hybrid":
        # Cross-asset netting set on ONE exact joint simulation: a payer
        # swap marked off the Vasicek rate component + equity forwards
        # marked off the spot with stochastic-rate bond discounting —
        # pathwise bank-account discounting is EXACT (the integral is a
        # state component).
        from montecarlo.engine.rates import (vasicek_bond_from_rate,
                                                 vasicek_zcb)
        from montecarlo.processes import EquityVasicekHybrid, Vasicek

        pay_dt = args.maturity / args.periods
        times_full = pay_dt * np.arange(1, args.periods + 1)
        ps = [vasicek_zcb(args.r0, args.kappa, args.theta, args.sigma, t)
              for t in times_full]
        k_swap = (1.0 - ps[-1]) / (pay_dt * sum(ps))
        k_fwd = args.s0 / ps[-1]              # par equity forward
        t_mat = args.maturity

        def build(p):
            m = EquityVasicekHybrid.create(
                p["s0"], p["r0"], args.kappa, args.theta, args.sigma,
                args.equity_sigma, args.factor_rho, dt, dtype=jnp.float32)
            vas = Vasicek.create(p["r0"], args.kappa, args.theta,
                                 args.sigma, dt, dtype=jnp.float32)
            sw = swap_value_fn(vas, k_swap, times_full, pay_dt,
                               dtype=jnp.float32)

            def fwd(k):
                return lambda c, t: c[0] - k * vasicek_bond_from_rate(
                    c[1], args.kappa, args.theta, args.sigma,
                    jnp.maximum(t_mat - t, 1e-9))

            trades = (lambda c, t: sw(c[1], t),
                      fwd(0.9 * k_fwd),
                      lambda c, t: -0.6 * fwd(1.05 * k_fwd)(c, t))
            return m, trades, None

        params = {"s0": args.s0, "r0": args.r0,
                  "hazard_rate": args.hazard}
        state_param = "s0"
    elif args.underlying == "heston":
        # Equity + VOLATILITY netting on ONE stochastic-vol simulation:
        # a par equity forward plus a PAR variance swap (affine
        # closed-form marks off (v, accrued variance)) — with rho < 0
        # the legs net exactly when they should (equity down <-> vol
        # up); WWR loads on the variance.
        from montecarlo.processes import (
            HestonExposure, heston_forward_value_fn,
            heston_varswap_expected_total, heston_varswap_value_fn)

        t_mat = args.maturity
        k_fwd_h = args.s0 * float(np.exp(args.r0 * t_mat))
        m0 = HestonExposure.create(args.s0, args.theta, args.r0,
                                   args.kappa, args.theta, args.xi,
                                   args.factor_rho, dt, dtype=jnp.float32)
        k_var = heston_varswap_expected_total(m0, t_mat) / t_mat
        vs_notional = 5.0 * args.s0

        def build(p):
            m = HestonExposure.create(p["s0"], p["v0"], args.r0,
                                      args.kappa, args.theta, args.xi,
                                      args.factor_rho, dt,
                                      dtype=jnp.float32)
            fwd = heston_forward_value_fn(m, k_fwd_h, t_mat,
                                          dtype=jnp.float32)
            vs = heston_varswap_value_fn(m, k_var, t_mat,
                                         notional=vs_notional,
                                         dtype=jnp.float32)
            trades = (lambda c, t: 0.2 * fwd(c, t), vs)
            return m, trades, args.r0            # flat discounting

        params = {"s0": args.s0, "v0": args.theta,
                  "hazard_rate": args.hazard}
        state_param = "s0"
    elif args.underlying == "equity":
        k_par = args.s0 * float(np.exp(args.r0 * args.maturity))
        t_mat, r0 = args.maturity, args.r0

        def build(p):
            model = GBM.create(p["s0"], r0, p["sigma"], dt,
                               dtype=jnp.float32)

            def fwd(k):
                return lambda s, t: s - k * jnp.exp(-r0 * (t_mat - t))

            trades = (fwd(0.9 * k_par), scaled(fwd(1.05 * k_par), -0.6),
                      scaled(fwd(k_par), 0.5))
            return model, trades, r0

        params = {"s0": args.s0, "sigma": args.equity_sigma,
                  "hazard_rate": args.hazard}
        state_param = "s0"
    else:
        pay_dt = args.maturity / args.periods
        times_full = pay_dt * np.arange(1, args.periods + 1)
        times_half = times_full[:max(args.periods // 2, 1)]

        def par(times):
            ps = [vasicek_zcb(args.r0, args.kappa, args.theta, args.sigma,
                              t) for t in times]
            return (1.0 - ps[-1]) / (pay_dt * sum(ps))

        k_full, k_half = par(times_full), par(times_half)
        # Snap the swaption expiry to the payment calendar (a mid-period
        # expiry would misalign the post-exercise float fixings —
        # swaption_value_fn validates and rejects that).
        t_exp = pay_dt * (args.periods // 2)
        times_back = tuple(float(t) for t in times_full
                           if t > t_exp + 1e-9)

        def build(p):
            from montecarlo.engine.exposure import (
                PathDependentTrade, swaption_value_fn)

            model = Vasicek.create(p["r0"], args.kappa, args.theta,
                                   p["sigma"], dt, dtype=jnp.float32)
            trades = (
                swap_value_fn(model, k_full, times_full, pay_dt,
                              dtype=jnp.float32),
                scaled(swap_value_fn(model, k_half, times_half, pay_dt,
                                     dtype=jnp.float32), -0.6),
                scaled(swap_value_fn(model, 1.1 * k_full, times_full,
                                     pay_dt, dtype=jnp.float32), 0.5),
            )
            if args.swaption_leg and args.swaption_exercise > 1:
                from montecarlo.engine.amc import (
                    bermudan_swaption_amc_trade)

                # notional=0.5 INSIDE the trade (not a wrapping lambda):
                # the structured spec must survive for the sharded
                # engines' distributed fit.
                trades += (bermudan_swaption_amc_trade(
                    model, k_full, times_back, pay_dt,
                    n_exercise=min(args.swaption_exercise,
                                   len(times_back)),
                    notional=0.5, dtype=jnp.float32),)
            elif args.swaption_leg:
                sw = swaption_value_fn(model, k_full, t_exp, times_back,
                                       pay_dt, payer=True, physical=True,
                                       dtype=jnp.float32)
                trades += (PathDependentTrade(
                    lambda r, t, *obs: 0.5 * sw.value_fn(r, t, *obs),
                    sw.obs_times),)
            return model, trades, None

        params = {"r0": args.r0, "sigma": args.sigma,
                  "hazard_rate": args.hazard}
        state_param = "r0"

    model, trades, flat_rate = build(params)

    if args.counterparties > 1:
        if args.greeks:
            raise SystemExit("--counterparties is incompatible with "
                             "--greeks (run per-set greeks via the "
                             "single-set engine)")
        if args.checkpoint or args.chunk_paths:
            raise SystemExit("--checkpoint/--chunk-paths stream the "
                             "SINGLE netting set only; drop "
                             "--counterparties or run without streaming")
        if args.allocate:
            raise SystemExit("--allocate decomposes ONE netting set; "
                             "drop --counterparties (allocations within "
                             "each set are the single-set runs)")
        use_mesh = getattr(args, "mesh", 0)
        per_set = dict(csa=csa, recovery=args.recovery,
                       kva_cost=args.kva_cost,
                       kva_capital_ratio=args.kva_capital_ratio,
                       im_spread=args.im_spread)
        sets = {"cpty_a": dict(trades=trades[:1],
                               hazard_rate=args.hazard, **per_set),
                "cpty_b": dict(trades=trades[1:],
                               hazard_rate=1.5 * args.hazard, **per_set)}
        kwp = dict(T=args.maturity, seed=args.seed,
                   quantile=args.quantile,
                   own_hazard_rate=args.own_hazard,
                   own_recovery=args.own_recovery,
                   funding_spread=args.funding_spread,
                   flat_rate=flat_rate, dtype=jnp.float32)
        if use_mesh:
            import jax

            from montecarlo.parallel import (DEFAULT_BLOCK, make_mesh,
                                                 sharded_portfolio_xva)

            n_dev = len(jax.devices())
            if args.mesh > n_dev:
                raise SystemExit(f"--mesh {args.mesh}: only {n_dev} "
                                 "device(s) available")
            block = min(DEFAULT_BLOCK, args.paths // args.mesh)
            res = sharded_portfolio_xva(
                model, sets, args.paths, args.steps,
                mesh=make_mesh(args.mesh), block_size=block, **kwp)
        else:
            from montecarlo.engine.exposure import portfolio_xva

            res = portfolio_xva(model, sets, args.paths, args.steps,
                                **kwp)
        out = {"underlying": args.underlying, "counterparties": 2,
               "csa": not args.no_csa}
        for name, p_ in res["sets"].items():
            out[f"cva_{name}"] = round(float(p_["cva"]), 6)
            out[f"peak_epe_{name}"] = round(
                float(np.max(np.asarray(p_["epe"]))), 6)
        tot = res["portfolio"]
        for k in ("cva", "dva", "bcva", "fva", "kva", "mva"):
            out[f"{k}_total"] = round(float(tot[k]), 6)
        out["peak_epe_total"] = round(float(tot["peak_epe"]), 6)
        if use_mesh:
            out["mesh"] = args.mesh
            out["peak_pfe_grid_err"] = round(max(
                float(np.asarray(p_["pfe_grid_err"]).max())
                for p_ in res["sets"].values()), 6)
        print(json.dumps(out))
        return 0

    common = dict(T=args.maturity, seed=args.seed, csa=csa,
                  quantile=args.quantile, hazard_rate=args.hazard,
                  recovery=args.recovery, own_hazard_rate=args.own_hazard,
                  own_recovery=args.own_recovery,
                  funding_spread=args.funding_spread,
                  im_spread=args.im_spread,
                  kva_cost=args.kva_cost,
                  kva_capital_ratio=args.kva_capital_ratio,
                  flat_rate=flat_rate, dtype=jnp.float32)
    if args.checkpoint:
        if getattr(args, "mesh", 0) or args.wwr_beta != 0.0 or args.greeks:
            raise SystemExit(
                "--checkpoint streams the single netting set unsharded "
                "(WWR's global Newton fit cannot stream); drop "
                "--mesh/--wwr-beta/--greeks")
        from montecarlo.engine.streaming import (
            streaming_netting_profile)
        from montecarlo.parallel import DEFAULT_BLOCK

        chunk = args.chunk_paths or max(args.paths // 4, DEFAULT_BLOCK)
        block = min(DEFAULT_BLOCK, chunk)
        prof = streaming_netting_profile(
            model, trades, args.paths, args.steps, chunk_paths=chunk,
            block_size=block, checkpoint_path=args.checkpoint,
            im_mpor=args.mpor, **common)
    elif getattr(args, "mesh", 0):
        import jax

        from montecarlo.parallel import (DEFAULT_BLOCK, make_mesh,
                                             sharded_netting_profile)

        n_dev = len(jax.devices())
        if args.mesh > n_dev:
            raise SystemExit(f"--mesh {args.mesh}: only {n_dev} device(s) "
                             "available")
        block = min(DEFAULT_BLOCK, args.paths // args.mesh)
        prof = sharded_netting_profile(
            model, trades, args.paths, args.steps,
            mesh=make_mesh(args.mesh), block_size=block,
            wwr_beta=args.wwr_beta, im_mpor=args.mpor, **common)
    elif args.rqmc:
        from montecarlo.engine.exposure import netting_set_profile_rqmc

        prof = netting_set_profile_rqmc(
            model, trades, args.paths, args.steps,
            n_replicates=args.rqmc, qmc_seed=args.seed,
            wwr_beta=args.wwr_beta, im_mpor=args.mpor, **common)
    else:
        prof = netting_set_profile(model, trades, args.paths, args.steps,
                                   wwr_beta=args.wwr_beta,
                                   im_mpor=args.mpor, **common)
    epe = np.asarray(prof["epe"])
    epe_u = np.asarray(prof["epe_uncollateralized"])
    out = {"underlying": args.underlying, "n_trades": len(trades),
           "csa": not args.no_csa,
           "peak_epe": round(float(epe.max()), 6),
           "peak_epe_uncollateralized": round(float(epe_u.max()), 6),
           "peak_pfe": round(float(np.asarray(prof["pfe"]).max()), 6)}
    for k in ("cva", "cva_no_netting", "dva", "bcva", "fca", "fba", "fva"):
        out[k] = round(float(prof[k]), 6)
    if args.rqmc:
        out["rqmc_replicates"] = args.rqmc
        for k in ("cva", "fva", "mva"):
            out[f"{k}_std_err"] = round(float(prof[f"{k}_std_err"]), 9)
    if args.kva_cost != 0.0:
        out["kva"] = round(float(prof["kva"]), 6)
    out["peak_im"] = round(float(np.asarray(prof["im"]).max()), 6)
    out["mva"] = round(float(prof["mva"]), 6)
    if getattr(args, "mesh", 0):
        out["mesh"] = args.mesh
        out["peak_pfe_grid_err"] = round(
            float(np.asarray(prof["pfe_grid_err"]).max()), 6)
    elif args.checkpoint:
        out["paths_done"] = int(prof["paths_done"])
        out["peak_pfe_grid_err"] = round(
            float(np.asarray(prof["pfe_grid_err"]).max()), 6)
        out["pfe_overflow_max"] = int(
            np.asarray(prof["pfe_overflow"]).max())
    if args.wwr_beta != 0.0:
        out["wwr_beta"] = args.wwr_beta
        out["cva_wwr"] = round(float(prof["cva_wwr"]), 6)
    if args.var_horizon > 0:
        if args.swaption_leg and (args.swaption_exercise > 1
                                  or args.underlying != "rates"):
            raise SystemExit("--var-horizon revalues closed-form books; "
                             "AMC swaption legs (Bermudan, or any "
                             "multi-state leg) are exposure-grid marks — "
                             "drop the leg or the horizon")
        from montecarlo.engine.exposure import book_var

        # The VaR simulation advances by the MODEL's dt: rebuild it on
        # the horizon grid (the valuation closures never read dt, so the
        # trades above are reused as-is — book_var validates this).
        var_steps = max(args.var_steps, 1)
        var_model = model._replace(
            dt=jnp.asarray(args.var_horizon / var_steps, jnp.float32))
        bv = book_var(var_model, trades, args.paths,
                      horizon=args.var_horizon,
                      n_steps=var_steps, seed=args.seed,
                      flat_rate=flat_rate, dtype=jnp.float32)
        for k in ("var_95", "cvar_95", "var_99", "cvar_99"):
            out[f"book_{k}"] = round(float(bv[k]), 6)
    if args.greeks:
        common_g = dict(T=args.maturity, seed=args.seed, csa=csa,
                        quantile=args.quantile, recovery=args.recovery,
                        own_hazard_rate=args.own_hazard,
                        own_recovery=args.own_recovery,
                        funding_spread=args.funding_spread,
                        kva_cost=args.kva_cost,
                        kva_capital_ratio=args.kva_capital_ratio,
                        dtype=jnp.float32)
        if getattr(args, "mesh", 0):
            from montecarlo.parallel import (DEFAULT_BLOCK, make_mesh,
                                                 sharded_xva_greeks)

            outs = ["cva", "dva", "bcva", "fva", "mva"]
            if args.kva_cost != 0.0:
                outs.append("kva")
            block = min(DEFAULT_BLOCK, args.paths // args.mesh)
            g = sharded_xva_greeks(build, params, args.paths, args.steps,
                                   mesh=make_mesh(args.mesh),
                                   block_size=block, outputs=tuple(outs),
                                   wwr_beta=args.wwr_beta,
                                   im_spread=args.im_spread,
                                   im_mpor=args.mpor, **common_g)
        else:
            from montecarlo.engine.exposure import xva_greeks

            outs = ["cva", "dva", "bcva", "fva", "mva"]
            if args.kva_cost != 0.0:
                outs.append("kva")
            g = xva_greeks(build, params, args.paths, args.steps,
                           outputs=tuple(outs), wwr_beta=args.wwr_beta,
                           im_spread=args.im_spread, im_mpor=args.mpor,
                           **common_g)
        out["greeks"] = {o: {k: round(float(v), 8) for k, v in gg.items()}
                         for o, gg in g["greeks"].items()}
        out["state_param"] = state_param
    if args.allocate:
        from montecarlo.engine.exposure import xva_trade_allocations

        alloc_outs = ["cva", "dva"]
        if args.funding_spread != 0.0:
            alloc_outs.append("fva")
        if args.kva_cost != 0.0:
            alloc_outs.append("kva")
        if args.im_spread != 0.0:
            alloc_outs.append("mva")
        if args.wwr_beta != 0.0:
            alloc_outs.append("cva_wwr")
        # `common` already carries im_spread — passing it again raised a
        # duplicate-keyword TypeError on every --allocate run (caught by
        # the round-5 multi-state enablement drive).
        al = xva_trade_allocations(
            model, trades, args.paths, args.steps,
            outputs=tuple(alloc_outs), wwr_beta=args.wwr_beta,
            im_mpor=args.mpor, **common)
        out["allocations"] = {
            k: [round(float(x), 6) for x in np.asarray(v)]
            for k, v in al["allocations"].items()}
        out["allocation_gap"] = {
            k: round(float(v), 8)
            for k, v in al["allocation_gap"].items()}
    print(json.dumps(out))
    return 0

