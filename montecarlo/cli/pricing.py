"""`price` — Monte Carlo option pricing on the path engines.

GBM/CEV/Heston/Bates/Merton/Kou/NIG/VG/SABR/rough-Bergomi/SLV/hybrid;
vanilla/Asian/lookback/barrier (incl. knock-in + Brownian-bridge
correction) / multi-asset max-call; American via LSM (+ Andersen-Broadie
bound); MLMC; plain/antithetic/Sobol samplers incl. device-native, with
honest RQMC error bars.  Model construction lives in
:mod:`montecarlo.cli.pricing_models`, dedicated run modes in
:mod:`montecarlo.cli.pricing_modes`.
"""

from __future__ import annotations

import json


def add_parsers(sub):
    _add_price(sub)


def _add_price(sub):
    p = sub.add_parser("price", help="Monte Carlo option pricing")
    p.add_argument("--process", default="gbm",
                   choices=["gbm", "cev", "heston", "heston-qe", "bates",
                            "bates-qe", "merton", "kou", "nig", "vg",
                            "sabr", "rbergomi", "slv", "hybrid"])
    p.add_argument("--s0", type=float, default=100.0)
    p.add_argument("--strike", type=float, default=105.0)
    p.add_argument("--rate", type=float, default=0.03)
    p.add_argument("--sigma", type=float, default=0.2)
    p.add_argument("--beta", type=float, default=0.7,
                   help="CEV elasticity (--process cev)")
    p.add_argument("--sigma-r", type=float, default=0.015,
                   help="hybrid: Vasicek rate vol (equity-rate corr via "
                        "--rho, mean reversion --kappa, level --theta)")
    p.add_argument("--skew", type=float, default=-0.1,
                   help="slv: demo-surface IV skew per unit log-moneyness "
                        "(iv = sigma + skew*log(K/S0))")
    p.add_argument("--maturity", type=float, default=1.0, help="years")
    p.add_argument("--paths", type=int, default=100_000)
    p.add_argument("--steps", type=int, default=252)
    p.add_argument("--sampler", default="plain",
                   choices=["plain", "antithetic", "sobol",
                            "sobol-device", "sobol-bridge"])
    p.add_argument("--payoff", default="call",
                   choices=["call", "put", "digital", "asian", "lookback",
                            "up-and-out", "up-and-in", "max-call"])
    # Multi-asset extras (--payoff max-call)
    p.add_argument("--n-assets", type=int, default=2,
                   help="max-call: number of (symmetric) assets")
    p.add_argument("--div", type=float, default=0.0,
                   help="max-call: continuous dividend yield (risk-neutral "
                        "drift = rate - div)")
    p.add_argument("--asset-corr", type=float, default=0.0,
                   help="max-call: common pairwise correlation")
    p.add_argument("--barrier", type=float, default=None,
                   help="barrier level for up-and-out (default 1.2*strike)")
    p.add_argument("--bridge", action="store_true",
                   help="up-and-out: Brownian-bridge continuous-barrier "
                        "correction (monitoring-frequency-unbiased; gbm)")
    p.add_argument("--american", action="store_true",
                   help="American exercise via Longstaff-Schwartz "
                        "(call/put payoffs)")
    p.add_argument("--american-bound", action="store_true",
                   help="with --american: also report the Andersen-Broadie "
                        "duality upper bound (brackets the true price)")
    p.add_argument("--mlmc", action="store_true",
                   help="multilevel Monte Carlo (Giles) over a geometric "
                        "step ladder — Euler-discretized gbm or heston, "
                        "European call/put; prices to --mlmc-rmse")
    p.add_argument("--mlmc-rmse", type=float, default=0.01,
                   help="total RMSE target for --mlmc (bias + statistical)")
    p.add_argument("--target-se", type=float, default=None,
                   help="price until the discounted std-err reaches this "
                        "target instead of a fixed --paths (on-device "
                        "adaptive loop; vanilla payoffs). --sampler plain "
                        "uses the iid chunked loop; sobol-device uses "
                        "replicated-randomization RQMC (typically ~10-30x "
                        "fewer paths)")
    p.add_argument("--seed", type=int, default=0)
    # Heston extras
    p.add_argument("--v0", type=float, default=0.04)
    p.add_argument("--kappa", type=float, default=2.0)
    p.add_argument("--theta", type=float, default=0.04)
    p.add_argument("--xi", type=float, default=0.5)
    p.add_argument("--rho", type=float, default=-0.7)
    # Merton/Kou extras
    p.add_argument("--jump-intensity", type=float, default=1.0)
    p.add_argument("--jump-mean", type=float, default=-0.05)
    p.add_argument("--jump-std", type=float, default=0.1)
    p.add_argument("--p-up", type=float, default=0.4,
                   help="Kou: probability a jump is upward")
    p.add_argument("--eta1", type=float, default=10.0,
                   help="Kou: up-jump decay (>1)")
    p.add_argument("--eta2", type=float, default=5.0,
                   help="Kou: down-jump decay")
    # NIG extras (pure-jump Levy; --sigma unused)
    p.add_argument("--nig-alpha", type=float, default=15.0,
                   help="NIG: tail heaviness (> |nig-beta + 1|)")
    p.add_argument("--nig-beta", type=float, default=-5.0,
                   help="NIG: skewness (< 0 skews the down-tail)")
    p.add_argument("--nig-delta", type=float, default=0.5,
                   help="NIG: scale per unit time")
    # Variance-gamma extras (--sigma is the subordinated BM scale)
    p.add_argument("--vg-theta", type=float, default=-0.14,
                   help="VG: subordinated drift (< 0 skews the down-tail)")
    p.add_argument("--vg-nu", type=float, default=0.2,
                   help="VG: subordinator variance rate (kurtosis; "
                        "needs dt <= nu)")
    # SABR extras (--sigma is alpha, --beta the CEV exponent, --rho the corr)
    p.add_argument("--nu", type=float, default=0.3,
                   help="SABR vol-of-vol")
    # rough Bergomi extras (--v0 is xi0, --rho the spot-vol corr)
    p.add_argument("--hurst", type=float, default=0.1,
                   help="rough Bergomi Hurst exponent (< 0.5 = rough)")
    p.add_argument("--eta", type=float, default=1.5,
                   help="rough Bergomi vol-of-vol")



def cmd_price(args) -> int:
    from montecarlo.cli import pricing_models as pm
    from montecarlo.cli import pricing_modes as modes
    from montecarlo.engine import discount_factor

    if args.target_se is not None and (
            args.american or args.mlmc
            or args.process in ("rbergomi", "hybrid")
            or args.payoff not in ("call", "put", "digital")):
        raise SystemExit(
            "--target-se applies to vanilla European payoffs "
            "(call/put/digital) without --american/--mlmc and outside the "
            "own-simulator processes (rbergomi/hybrid); for --mlmc the "
            "tolerance knob is --mlmc-rmse")
    dt = args.maturity / args.steps
    proc = pm.build_process(args, dt)
    if args.process == "hybrid":
        return modes.run_hybrid(args, dt)
    if args.process == "rbergomi":
        return modes.run_rbergomi(args)
    if args.mlmc:
        return modes.run_mlmc(args)
    sampler = pm.build_sampler(args, proc)
    disc = discount_factor(args.rate, args.maturity)
    if args.payoff == "max-call":
        return modes.run_max_call(args, dt, disc)
    if args.american:
        est = modes.run_american(args, proc, dt)
        if isinstance(est, int):
            return est
    elif args.payoff in ("asian", "lookback", "up-and-out", "up-and-in"):
        est = _estimate_functional(args, proc, sampler, disc, dt)
    else:
        est = _estimate_vanilla(args, proc, sampler, disc)

    out = {"price": float(est["price"]), "std_err": float(est["std_err"]),
           "n_paths": int(est["n_paths"])}
    if "upper_bound" in est:
        out["upper_bound"] = float(est["upper_bound"])
        out["upper_bound_std_err"] = float(est["upper_bound_std_err"])
    pm.append_oracles(out, args, disc)
    print(json.dumps(out))
    return 0


def _estimate_functional(args, proc, sampler, disc, dt):
    """Path-dependent European payoffs (Asian/lookback/barrier): running
    functionals folded into the simulation scan, RQMC replication for the
    Sobol samplers."""
    import jax.numpy as jnp

    from montecarlo.cli.pricing_models import sobol_replicate_factory
    from montecarlo.engine import european_call, mc_estimate

    from montecarlo.engine import (
        ARITH_MEAN,
        RUNNING_MAX,
        RUNNING_MIN,
        asian_call,
        lookback_call_floating,
        simulate_functionals,
        up_and_out_call,
    )

    # Only the functionals the payoff actually reads (extra running
    # reductions are per-step work in the hot loop).
    if args.payoff == "asian":
        functionals = {"avg": ARITH_MEAN}
    elif args.payoff == "lookback":
        functionals = {"min": RUNNING_MIN}
    elif args.bridge:
        functionals = {}
    else:
        functionals = {"max": RUNNING_MAX}
    barrier = args.barrier or 1.2 * args.strike
    if args.payoff in ("up-and-out", "up-and-in") and args.bridge:
        if args.process != "gbm":
            raise SystemExit("--bridge requires --process gbm "
                             "(constant vol for the bridge law)")
        from montecarlo.engine import barrier_survival_up

        functionals["surv"] = barrier_survival_up(barrier, args.sigma,
                                                  dt)
    if args.payoff == "asian":
        payoff_of = lambda o: asian_call(o["avg"], args.strike)
    elif args.payoff == "lookback":
        payoff_of = lambda o: lookback_call_floating(o["terminal"],
                                                     o["min"])
    elif args.bridge:
        # Knock-out and knock-in from the SAME survival probability
        # (in-out parity: KO + KI = vanilla, continuous barrier).
        def payoff_of(o):
            w = (o["surv"] if args.payoff == "up-and-out"
                 else 1.0 - o["surv"])
            return european_call(o["terminal"], args.strike) * w
    elif args.payoff == "up-and-in":
        payoff_of = lambda o: jnp.where(
            o["max"] >= barrier,
            european_call(o["terminal"], args.strike), 0.0)
    else:
        payoff_of = lambda o: up_and_out_call(
            o["terminal"], o["max"], args.strike, barrier)
    if args.sampler.startswith("sobol"):
        # Honest QMC error bars for path-dependent payoffs too: route
        # through replicated randomizations (the iid std_err the plain
        # path reports is meaningless for QMC — overstates ~30x).
        from montecarlo.engine import rqmc_estimate

        n_rep = 8
        paths = (args.paths // n_rep) * n_rep
        if paths < n_rep:
            raise SystemExit("QMC needs --paths >= 64 (8 replicated "
                             "randomizations)")
        est = rqmc_estimate(
            proc, payoff_of, paths, args.steps, seed=args.seed,
            sampler_factory=sobol_replicate_factory(args, proc,
                                                     paths // n_rep),
            n_replicates=n_rep, discount=disc, functionals=functionals)
    else:
        out_f = simulate_functionals(
            proc, args.paths, args.steps, seed=args.seed,
            sampler=sampler, functionals=functionals)
        est = mc_estimate(payoff_of(out_f), disc)
    return est


def _estimate_vanilla(args, proc, sampler, disc):
    """Vanilla terminal payoffs (call/put/digital): fixed-path estimate,
    on-device tolerance loops (--target-se), or RQMC replication."""
    import jax.numpy as jnp

    from montecarlo.cli.pricing_models import sobol_replicate_factory
    from montecarlo.engine import european_call, mc_estimate

    # Vanilla terminal payoffs: call / put / digital.
    if args.payoff == "call":
        payoff = lambda s: european_call(s, args.strike)
    elif args.payoff == "put":
        payoff = lambda s: jnp.maximum(args.strike - s, 0.0)
    else:  # digital: cash-or-nothing call, pays 1 when S_T > K
        payoff = lambda s: (s > args.strike).astype(jnp.float32)
    if args.target_se is not None:
        # Adaptive tolerance pricing: one jitted on-device while_loop,
        # one host round-trip.  Chunks are sized per platform: large on
        # the GPU (few loop iterations), small on the CPU.
        from montecarlo import device

        on_gpu = device.platform() == "gpu"
        if args.sampler == "plain":
            from montecarlo.engine import price_to_tolerance

            est = price_to_tolerance(
                proc, payoff, target_std_err=args.target_se,
                seed=args.seed, n_steps=args.steps, discount=float(disc),
                chunk_paths=(1 << 22) if on_gpu else (1 << 16))
        elif args.sampler == "sobol-device":
            from montecarlo.engine import price_to_tolerance_rqmc

            est = price_to_tolerance_rqmc(
                proc, payoff, target_std_err=args.target_se,
                seed=args.seed, n_steps=args.steps, discount=float(disc),
                chunk_paths=(1 << 18) if on_gpu else (1 << 12))
        else:
            raise SystemExit(
                "--target-se supports --sampler plain (iid chunked "
                "loop) or sobol-device (replicated-randomization RQMC "
                "loop)")
    elif args.sampler.startswith("sobol"):
        # Honest QMC error bars for EVERY Sobol variant: the iid
        # formula is meaningless for QMC (overstates ~30x); replicate
        # the randomization instead (rqmc_estimate).
        from montecarlo.engine import rqmc_estimate

        n_rep = 8
        paths = (args.paths // n_rep) * n_rep
        if paths < n_rep:
            raise SystemExit("QMC needs --paths >= 64 (8 replicated "
                             "randomizations)")
        factory = sobol_replicate_factory(args, proc, paths // n_rep)
        est = rqmc_estimate(
            proc, payoff, paths, args.steps, seed=args.seed,
            sampler_factory=factory, n_replicates=n_rep, discount=disc)
    else:
        from montecarlo.engine.dispatch import terminal_prices

        terminal = terminal_prices(proc, args.paths, args.steps,
                                   seed=args.seed, sampler=sampler)
        est = mc_estimate(payoff(terminal), disc)
    return est
