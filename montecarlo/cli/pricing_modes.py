"""Dedicated run modes of the `price` subcommand: the own-simulator
processes (hybrid, rough Bergomi), multilevel Monte Carlo, the multi-asset
max-call family, and American exercise — each prints-or-returns exactly as
the monolithic cmd_price did."""

from __future__ import annotations

import json


def run_hybrid(args, dt) -> int:
    import jax.numpy as jnp

    # Equity x Vasicek hybrid, EXACT joint transition (zero
    # discretization error) with pathwise discounting — the closed
    # form prints alongside (processes/hybrid.py).
    from montecarlo.processes import (EquityVasicekHybrid,
                                          hybrid_call_closed_form,
                                          hybrid_price_mc)

    if args.american or args.payoff not in ("call", "put"):
        raise SystemExit("--process hybrid prices European call/put")
    if args.sampler != "plain":
        raise SystemExit("--process hybrid uses plain draws; remove "
                         "--sampler")
    hyb = EquityVasicekHybrid.create(
        args.s0, args.rate, args.kappa, args.theta, args.sigma_r,
        args.sigma, args.rho, dt)
    pay = ((lambda s: jnp.maximum(s - args.strike, 0.0))
           if args.payoff == "call"
           else (lambda s: jnp.maximum(args.strike - s, 0.0)))
    est = hybrid_price_mc(hyb, pay, args.paths, args.steps,
                          seed=args.seed)
    out = {"price": float(est["price"]),
           "std_err": float(est["std_err"]),
           "n_paths": int(est["n_paths"])}
    if args.payoff == "call":
        out["closed_form"] = hybrid_call_closed_form(
            args.s0, args.strike, args.maturity, args.rate,
            args.kappa, args.theta, args.sigma_r, args.sigma,
            args.rho)
    print(json.dumps(out))
    return 0


def run_rbergomi(args) -> int:
    import jax.numpy as jnp
    from montecarlo.engine import (discount_factor, european_call,
                                       mc_estimate)

    from montecarlo.processes import RoughBergomi, rbergomi_simulate

    if args.american or args.payoff not in ("call", "put"):
        raise SystemExit("--process rbergomi prices European call/put")
    if args.sampler != "plain":
        raise SystemExit("--process rbergomi uses its own "
                         "exact-covariance sampler; --sampler has no "
                         "effect there (remove it)")
    # forward-measure dynamics (driftless); discount by --rate
    model = RoughBergomi.create(
        s0=args.s0, xi0=args.v0, eta=args.eta, rho=args.rho,
        h=args.hurst, n_steps=args.steps, T=args.maturity)
    s_t = rbergomi_simulate(model, args.paths, seed=args.seed)
    payoffs = (european_call(s_t, args.strike) if args.payoff == "call"
               else jnp.maximum(args.strike - s_t, 0.0))
    est = mc_estimate(payoffs, discount_factor(args.rate,
                                               args.maturity))
    print(json.dumps({"price": float(est["price"]),
                      "std_err": float(est["std_err"]),
                      "n_paths": int(est["n_paths"]),
                      "hurst": args.hurst}))
    return 0


def run_mlmc(args) -> int:
    import jax.numpy as jnp
    from montecarlo.engine import black_scholes_call, discount_factor
    from montecarlo.processes import Heston

    from montecarlo.engine.mlmc import mlmc_estimate
    from montecarlo.processes import EulerGBM

    if args.american or args.payoff not in ("call", "put"):
        raise SystemExit("--mlmc supports European call/put payoffs")
    if args.sampler != "plain":
        raise SystemExit("--mlmc uses its own coupled plain draws; "
                         "--sampler has no effect there (remove it)")
    if args.process == "gbm":
        def make(n):
            return EulerGBM.create(args.s0, args.rate, args.sigma,
                                   args.maturity / n)
    elif args.process == "heston":
        def make(n):
            return Heston.create(s0=args.s0, v0=args.v0, mu=args.rate,
                                 kappa=args.kappa, theta=args.theta,
                                 xi=args.xi, rho=args.rho,
                                 dt=args.maturity / n)
    else:
        raise SystemExit("--mlmc supports gbm (Euler scheme) and heston")
    payoff = ((lambda s: jnp.maximum(s - args.strike, 0.0))
              if args.payoff == "call"
              else (lambda s: jnp.maximum(args.strike - s, 0.0)))
    res = mlmc_estimate(make, payoff, target_rmse=args.mlmc_rmse,
                        seed=args.seed, n0_steps=4,
                        discount=float(discount_factor(args.rate,
                                                       args.maturity)))
    out = {"price": float(res["price"]),
           "std_err": float(res["std_err"]),
           "bias_est": float(res["bias_est"]),
           "rmse_est": float(res["rmse_est"]),
           "n_levels": res["n_levels"],
           "level_paths": [l.n_paths for l in res["levels"]],
           "cost_path_steps": res["cost_path_steps"],
           "vs_single_level_cost": res["single_level_cost_est"]
           / max(res["cost_path_steps"], 1.0)}
    if args.process == "gbm" and args.payoff == "call":
        out["black_scholes"] = float(black_scholes_call(
            args.s0, args.strike, args.rate, args.sigma, args.maturity))
    print(json.dumps(out))
    return 0


def run_max_call(args, dt, disc) -> int:
    from montecarlo.engine import mc_estimate

    # Best-of-A call (the Bermudan max-call benchmark family,
    # Andersen-Broadie 2004): symmetric assets, common correlation.
    import numpy as _np

    from montecarlo.engine import max_call, simulate
    from montecarlo.processes import MultiGBM

    if args.process != "gbm":
        raise SystemExit("--payoff max-call prices symmetric "
                         "multi-asset GBM (--process gbm)")
    if args.sampler != "plain":
        raise SystemExit("--payoff max-call uses plain Threefry "
                         "draws; --sampler has no effect there")
    a = args.n_assets
    corr = _np.full((a, a), args.asset_corr)
    _np.fill_diagonal(corr, 1.0)
    proc_m = MultiGBM.create(s0=[args.s0] * a,
                             mu=[args.rate - args.div] * a,
                             sigma=[args.sigma] * a, corr=corr, dt=dt)
    payoff_m = lambda p: max_call(p, args.strike)
    if args.american:
        from montecarlo.engine import (
            andersen_broadie_bound_multi, lsm_policy_multi)

        est, policy = lsm_policy_multi(
            proc_m, payoff_m, args.paths, args.steps, seed=args.seed,
            rate=args.rate, dt=dt, degree=3, value_degree=3,
            fit_value=args.american_bound)
        out = {"price": float(est["price"]),
               "std_err": float(est["std_err"]),
               "n_paths": int(est["n_paths"]), "n_assets": a}
        if args.american_bound:
            ab = andersen_broadie_bound_multi(
                proc_m, payoff_m, policy, min(args.paths, 4096), 256,
                args.steps, seed=args.seed + 1, rate=args.rate, dt=dt,
                degree=3, value_degree=3)
            out["upper_bound"] = float(ab["upper"])
            out["upper_bound_std_err"] = float(ab["std_err"])
    else:
        terminal = simulate(proc_m, args.paths, args.steps,
                            seed=args.seed)
        est = mc_estimate(payoff_m(terminal), disc)
        out = {"price": float(est["price"]),
               "std_err": float(est["std_err"]),
               "n_paths": int(est["n_paths"]), "n_assets": a}
    print(json.dumps(out))
    return 0


def run_american(args, proc, dt):
    """American exercise via LSM (spot-only, (S, v) joint for stochastic
    vol, or the path-dependent (spot, running-average) basis).  Returns an
    exit CODE when the branch printed its own result (the asian LSM), else
    the estimate dict for the shared output path."""
    import jax.numpy as jnp

    from montecarlo.engine.american import (
        andersen_broadie_bound, lsm_policy)

    if args.sampler != "plain":
        raise SystemExit("--american uses plain Threefry draws; "
                         "--sampler has no effect there (remove it)")
    if args.payoff == "asian":
        # American average-price option: LSM on the joint (spot,
        # running average) state (Longstaff-Schwartz 2001 sec. 5).
        from montecarlo.engine import (ARITH_MEAN,
                                           lsm_price_path_dependent)

        if args.american_bound:
            raise SystemExit("--american-bound covers call/put only")
        est = lsm_price_path_dependent(
            proc, lambda s, a: jnp.maximum(a - args.strike, 0.0),
            ARITH_MEAN, args.paths, args.steps, seed=args.seed,
            rate=args.rate, dt=dt, degree=2)
        out = {"price": float(est["price"]),
               "std_err": float(est["std_err"]),
               "n_paths": int(est["n_paths"])}
        print(json.dumps(out))
        return 0
    if args.payoff not in ("call", "put"):
        raise SystemExit(
            f"--american supports call/put exercise (or asian via the "
            f"path-dependent LSM), not {args.payoff!r}")
    payoff = ((lambda s: jnp.maximum(s - args.strike, 0.0))
              if args.payoff == "call"
              else (lambda s: jnp.maximum(args.strike - s, 0.0)))
    if args.process in ("heston", "heston-qe", "bates", "bates-qe",
                        "slv"):
        # Stochastic vol: regress the continuation on (S, v) jointly —
        # the spot-only policy cannot see the vol state and prices
        # strictly worse (engine/american.py::lsm_policy_sv).
        from montecarlo.engine.american import (
            andersen_broadie_bound_sv, lsm_policy_sv)

        est, policy = lsm_policy_sv(
            proc, payoff, args.paths, args.steps, seed=args.seed,
            rate=args.rate, dt=dt, degree=2, value_degree=5)
        if args.american_bound:
            ab = andersen_broadie_bound_sv(
                proc, payoff, policy, min(args.paths, 2048), 256,
                args.steps, seed=args.seed + 1, rate=args.rate, dt=dt,
                degree=2, value_degree=5)
            est = dict(est)
            est["upper_bound"] = ab["upper"]
            est["upper_bound_std_err"] = ab["std_err"]
    else:
        est, policy = lsm_policy(proc, payoff, args.paths, args.steps,
                                 seed=args.seed, rate=args.rate, dt=dt,
                                 degree=3)
        if args.american_bound:
            ab = andersen_broadie_bound(
                proc, payoff, policy, min(args.paths, 4096), 512,
                args.steps, seed=args.seed + 1, rate=args.rate, dt=dt,
                degree=3)
            est = dict(est)
            est["upper_bound"] = ab["upper"]
            est["upper_bound_std_err"] = ab["std_err"]
    return est
