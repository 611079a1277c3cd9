"""`var` and `stress` — portfolio risk at scale: streaming-sketch VaR/CVaR
(checkpointable) and scenario-grid / named-stress P&L under common random
numbers."""

from __future__ import annotations

import json
import sys


def add_parsers(sub):
    _add_var(sub)
    _add_stress(sub)


def _add_var(sub):
    p = sub.add_parser("var", help="portfolio VaR/CVaR at scale")
    p.add_argument("--paths", type=int, default=1 << 22)
    p.add_argument("--days", type=int, default=20)
    p.add_argument("--s0", type=float, default=100.0)
    p.add_argument("--mu", type=float, default=0.05)
    p.add_argument("--sigma", type=float, default=0.25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bins", type=int, default=8192)
    p.add_argument("--chunk", type=int, default=None)
    p.add_argument("--checkpoint", default=None,
                   help="npz path for resume-able runs")
    p.add_argument("--on-device", action="store_true",
                   help="single device program (fastest; no checkpointing)")
    p.add_argument("--ticker", default=None,
                   help="use a ticker's GARCH-bootstrap process instead of "
                        "parametric GBM")
    p.add_argument("--period", default="5y")
    p.add_argument("--provider", default=None)


def cmd_var(args) -> int:
    import numpy as np
    from montecarlo.api import portfolio_var
    from montecarlo.processes import GBM, GARCHBootstrap

    if args.ticker:
        from montecarlo.data import get_stock_data

        data = get_stock_data(args.ticker, args.period,
                              provider=args.provider)
        if data is None:
            print(f"no data for {args.ticker}", file=sys.stderr)
            return 1
        s0 = float(data["Close"][-1])
        returns = np.asarray(data["log_ret"])
        proc = GARCHBootstrap.create(
            returns[~np.isnan(returns)], s0=s0,
            var0=float(data["rvol_20"][-1]) ** 2 / 252.0)
    else:
        s0 = args.s0
        proc = GBM.create(s0=s0, mu=args.mu, sigma=args.sigma, dt=1 / 252)

    if args.on_device:
        from montecarlo.api import portfolio_var_on_device

        out = portfolio_var_on_device(
            proc, args.paths, args.days, s0, seed=args.seed,
            bins=args.bins,
            chunk_paths=args.chunk or min(args.paths, 1 << 20))
    else:
        out = portfolio_var(
            proc, args.paths, args.days, s0, seed=args.seed, bins=args.bins,
            chunk_paths=args.chunk or min(args.paths, 1 << 20),
            checkpoint_path=args.checkpoint,
            progress_callback=lambda done, total, se: print(
                f"  {done:,}/{total:,} paths, std-err {se:.2e}",
                file=sys.stderr))
    print(json.dumps(out, default=float))
    return 0



def _add_stress(sub):
    p = sub.add_parser("stress", help="scenario grid / named stress P&L")
    p.add_argument("--process", default="gbm", choices=["gbm", "heston"])
    p.add_argument("--s0", type=float, default=100.0)
    p.add_argument("--strike", type=float, default=105.0)
    p.add_argument("--rate", type=float, default=0.03)
    p.add_argument("--sigma", type=float, default=0.2)
    p.add_argument("--maturity", type=float, default=1.0)
    p.add_argument("--paths", type=int, default=65536)
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--payoff", default="call", choices=["call", "put"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--spot-range", type=float, default=0.2,
                   help="grid spans +-this relative spot bump")
    p.add_argument("--vol-range", type=float, default=0.5,
                   help="grid spans +-this relative vol bump")
    p.add_argument("--grid", type=int, default=5,
                   help="points per axis (0 = named scenarios only)")
    # Heston extras
    p.add_argument("--v0", type=float, default=0.04)
    p.add_argument("--kappa", type=float, default=2.0)
    p.add_argument("--theta", type=float, default=0.04)
    p.add_argument("--xi", type=float, default=0.5)
    p.add_argument("--rho", type=float, default=-0.7)


def cmd_stress(args) -> int:
    import numpy as np
    import jax.numpy as jnp

    from montecarlo.api.stress import ladder, stress_grid, stress_report
    from montecarlo.processes import GBM, Heston

    dt = args.maturity / args.steps
    disc = float(np.exp(-args.rate * args.maturity))
    payoff = ((lambda s: jnp.maximum(s - args.strike, 0.0))
              if args.payoff == "call"
              else (lambda s: jnp.maximum(args.strike - s, 0.0)))
    if args.process == "gbm":
        proc = GBM.create(s0=args.s0, mu=args.rate, sigma=args.sigma, dt=dt)
        fields = ("s0", "sigma")
    else:
        proc = Heston.create(s0=args.s0, v0=args.v0, mu=args.rate,
                             kappa=args.kappa, theta=args.theta,
                             xi=args.xi, rho=args.rho, dt=dt)
        fields = ("s0", "v0")

    out = stress_report(proc, payoff, args.paths, args.steps,
                        seed=args.seed, fields=fields, discount=disc)
    if args.grid > 0:
        ba = ladder(-args.spot_range, args.spot_range, args.grid)
        bb = ladder(-args.vol_range, args.vol_range, args.grid)
        g = stress_grid(proc, payoff, args.paths, args.steps,
                        bumps_a=ba, bumps_b=bb, seed=args.seed,
                        fields=fields, discount=disc)
        out["grid"] = {
            "spot_bumps": [float(v) for v in np.asarray(g["bumps_a"])],
            "vol_bumps": [float(v) for v in np.asarray(g["bumps_b"])],
            "prices": np.asarray(g["prices"]).round(6).tolist(),
            "pnl": np.asarray(g["pnl"]).round(6).tolist(),
        }
    print(json.dumps(out))
    return 0

