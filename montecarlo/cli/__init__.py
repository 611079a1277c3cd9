"""Command-line interface — flags mirror the reference's sidebar widgets.

Subcommands (one module each under :mod:`montecarlo.cli`):
  analyze  — single-ticker deep dive (reference 'Single Stock' mode,
             app.py:1182-1257: horizon 5-60 default 20, sims 500-5000
             default 1000, backtest toggle, cv-folds/estimators/retrain)
  scan     — multi-ticker scanner (reference 'Scanner' mode,
             app.py:1262-1532: universe, max stocks, horizon, min accuracy,
             fast/balanced/full reliability, workers)
  price    — Monte Carlo option pricing on the path engines (GBM/CEV/Heston/
             Bates/Merton/Kou/SABR/rough-Bergomi; vanilla/Asian/lookback/
             barrier incl. knock-in + Brownian-bridge correction; American
             via LSM; MLMC; plain/antithetic/Sobol incl. device-native)
  greeks   — pathwise (autodiff) or likelihood-ratio sensitivities; --mesh
             for pod-scale sharded pathwise Greeks
  var      — portfolio VaR/CVaR at scale (streaming sketch, checkpointable)
  stress   — scenario grids / named stress P&L (common random numbers)
  calibrate— fit Heston / SABR / VG / NIG / Merton / Kou to an implied-
             vol surface (Adam on exact gradients; omitting --surface
             generates and recovers a known surface)
  bond     — short-rate bond / bond-option pricing (Vasicek/CIR/Hull-White)
  xva      — exposure profiles (EPE/ENE/PFE) + CVA/DVA/FVA/MVA for a swap
             (Vasicek) or equity forward; --portfolio nets a multi-trade
             book with CSA collateral (threshold/MTA/MPoR)
  note     — structured notes: autocallables (worst-of capable), cliquets
  credit   — portfolio credit: Gaussian-copula CDO tranches and
             kth-to-default basket CDS (--mesh for the pod-scale twin)
  bench    — the headline GBM throughput benchmark

Usage: python -m montecarlo.cli <subcommand> [flags]
"""

from __future__ import annotations

import argparse


def _run_bench(args) -> int:
    import importlib.util
    import os

    bench_path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "bench.py")
    spec = importlib.util.spec_from_file_location("bench", bench_path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    bench.main()
    return 0


def main(argv=None) -> int:
    from montecarlo.cli import (bond, calibrate, credit, greeks, note,
                                    pricing, quant, risk, xva)

    parser = argparse.ArgumentParser(
        prog="montecarlo",
        description="GPU-accelerated quantitative Monte Carlo framework")
    parser.add_argument("--platform", default=None,
                        choices=[None, "gpu", "cpu"],
                        help="force a JAX platform (e.g. cpu for "
                             "host-latency-bound analyze/scan runs)")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for module in (quant, pricing, greeks, risk, calibrate, bond, xva,
                   note, credit):
        module.add_parsers(sub)
    sub.add_parser("bench", help="headline GBM throughput benchmark")
    args = parser.parse_args(argv)

    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)

    handlers = {
        "analyze": quant.cmd_analyze,
        "scan": quant.cmd_scan,
        "price": pricing.cmd_price,
        "greeks": greeks.cmd_greeks,
        "var": risk.cmd_var,
        "stress": risk.cmd_stress,
        "calibrate": calibrate.cmd_calibrate,
        "bond": bond.cmd_bond,
        "xva": xva.cmd_xva,
        "note": note.cmd_note,
        "credit": credit.cmd_credit,
        "bench": _run_bench,
    }
    return handlers[args.cmd](args)
