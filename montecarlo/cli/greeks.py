"""`greeks` — option sensitivities: pathwise autodiff, likelihood-ratio,
second-order (smoothed double autodiff), American policy-freezing, and the
pod-scale sharded path (`--mesh N`)."""

from __future__ import annotations

import json
import sys


def add_parsers(sub):
    _add_greeks(sub)


def _add_greeks(sub):
    p = sub.add_parser("greeks", help="option sensitivities")
    p.add_argument("--process", default="gbm", choices=["gbm", "heston"])
    p.add_argument("--s0", type=float, default=100.0)
    p.add_argument("--strike", type=float, default=105.0)
    p.add_argument("--rate", type=float, default=0.03)
    p.add_argument("--sigma", type=float, default=0.2)
    p.add_argument("--maturity", type=float, default=1.0)
    p.add_argument("--paths", type=int, default=200_000)
    p.add_argument("--steps", type=int, default=252)
    p.add_argument("--payoff", default="call", choices=["call", "put",
                                                        "digital"])
    p.add_argument("--method", default="pathwise",
                   choices=["pathwise", "lr", "second-order"],
                   help="pathwise autodiff (Lipschitz payoffs), "
                        "likelihood-ratio (any payoff, GBM only), or "
                        "second-order (gamma/vanna/volga via double "
                        "autodiff of a kernel-smoothed payoff)")
    p.add_argument("--smooth-width", type=float, default=2.0,
                   help="payoff smoothing width for --method second-order "
                        "(price units; bias O(w^2), gamma noise O(1/w))")
    p.add_argument("--american", action="store_true",
                   help="American-exercise Greeks by policy freezing: LSM "
                        "fits the exercise rule, then pathwise-"
                        "differentiates the frozen stopped value "
                        "(envelope theorem; call/put, pathwise method)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="pod-scale pathwise Greeks: shard over an N-device "
                        "paths mesh (sharded_price_and_greeks — bitwise "
                        "mesh-shape-invariant price, grads, and error "
                        "bars); pathwise method only")
    # Heston extras
    p.add_argument("--v0", type=float, default=0.04)
    p.add_argument("--kappa", type=float, default=2.0)
    p.add_argument("--theta", type=float, default=0.04)
    p.add_argument("--xi", type=float, default=0.5)
    p.add_argument("--rho", type=float, default=-0.7)


def cmd_greeks(args) -> int:
    import numpy as np
    import jax
    import jax.numpy as jnp

    from montecarlo.engine.greeks import lr_greeks_gbm, price_and_greeks
    from montecarlo.processes import GBM, Heston

    if getattr(args, "mesh", 0) and (args.method != "pathwise"
                                     or args.american):
        # Reject rather than silently ignore (round-2 contract: flags that
        # would not apply must error).
        raise SystemExit("--mesh applies to the pathwise method only "
                         "(not --method lr/second-order, not --american)")

    dt = args.maturity / args.steps
    disc = float(np.exp(-args.rate * args.maturity))
    if args.payoff == "call":
        payoff = lambda s: jnp.maximum(s - args.strike, 0.0)
    elif args.payoff == "put":
        payoff = lambda s: jnp.maximum(args.strike - s, 0.0)
    else:
        payoff = lambda s: (s > args.strike).astype(jnp.float32)

    if args.process == "gbm":
        proc = GBM.create(s0=args.s0, mu=args.rate, sigma=args.sigma, dt=dt)
    else:
        proc = Heston.create(s0=args.s0, v0=args.v0, mu=args.rate,
                             kappa=args.kappa, theta=args.theta,
                             xi=args.xi, rho=args.rho, dt=dt)

    if args.american:
        from montecarlo.engine.american import (
            american_price_and_greeks, lsm_exercise_policy)

        if args.method != "pathwise" or args.payoff == "digital":
            raise SystemExit("--american greeks use the pathwise method "
                             "on call/put payoffs")
        policy = lsm_exercise_policy(
            proc, payoff, args.paths, args.steps, seed=args.seed,
            rate=args.rate, dt=dt, degree=3)
        price, g = american_price_and_greeks(
            proc, payoff, policy, args.paths, args.steps, seed=args.seed,
            rate=args.rate, dt=dt, degree=3)
        out = {"price": float(price), "delta": float(g.s0)}
        if args.process == "gbm":
            out["vega"] = float(g.sigma)
            out["drift_sens"] = float(g.mu)
        else:
            out["vega_v0"] = float(g.v0)
            out["xi_sens"] = float(g.xi)
        print(json.dumps(out))
        return 0

    if args.method == "lr":
        if args.process != "gbm":
            print("likelihood-ratio greeks support GBM only",
                  file=sys.stderr)
            return 2
        out = lr_greeks_gbm(proc, payoff, args.paths, args.steps,
                            seed=args.seed, discount=disc)
        print(json.dumps({k: float(v) for k, v in out.items()}))
        return 0

    if args.method == "second-order":
        from montecarlo.engine.greeks import (second_order_greeks,
                                                  smoothed_call)

        if args.payoff != "call":
            print("second-order greeks use the smoothed call payoff",
                  file=sys.stderr)
            return 2
        sfields = ("s0", "sigma") if args.process == "gbm" else ("s0", "v0")
        price, grad, hess = second_order_greeks(
            proc, smoothed_call(args.strike, args.smooth_width),
            args.paths, args.steps, seed=args.seed, fields=sfields,
            discount=disc)
        out = {"price": float(price),
               "delta": float(grad[0]),
               f"vega_{sfields[1]}": float(grad[1]),
               "gamma": float(hess[0, 0]),
               "vanna": float(hess[0, 1]),
               "volga": float(hess[1, 1])}
        print(json.dumps(out))
        return 0

    if args.payoff == "digital":
        print("note: pathwise gradients of a hard digital are ~0; use "
              "--method lr or a smoothed payoff", file=sys.stderr)
    if getattr(args, "mesh", 0):
        from montecarlo.parallel import (DEFAULT_BLOCK, make_mesh,
                                             sharded_price_and_greeks)

        n_dev = len(jax.devices())
        if args.mesh > n_dev:
            raise SystemExit(
                f"--mesh {args.mesh}: only {n_dev} device(s) available "
                "(multi-chip sharding is validated on virtual CPU meshes "
                "in the test suite)")
        unit = args.mesh * DEFAULT_BLOCK
        n_paths = -(-args.paths // unit) * unit
        if n_paths != args.paths:
            print(f"note: paths rounded up to {n_paths} "
                  f"(mesh x {DEFAULT_BLOCK}-path stat blocks)",
                  file=sys.stderr)
        res = sharded_price_and_greeks(
            proc, payoff, n_paths, args.steps, seed=args.seed,
            mesh=make_mesh(args.mesh), discount=disc)
        out = {"price": float(res["price"]),
               "std_err": float(res["std_err"]),
               "n_paths": int(res["n_paths"]), "mesh": args.mesh}
        out.update({f"d_{k}": float(v)
                    for k, v in res["grads"]._asdict().items()})
        out.update({f"d_{k}_std_err": float(v)
                    for k, v in res["grad_std_err"]._asdict().items()})
        print(json.dumps(out))
        return 0
    price, grads = price_and_greeks(proc, payoff, args.paths, args.steps,
                                    seed=args.seed, discount=disc)
    out = {"price": float(price)}
    out.update({f"d_{k}": float(v)
                for k, v in grads._asdict().items()})
    print(json.dumps(out))
    return 0

