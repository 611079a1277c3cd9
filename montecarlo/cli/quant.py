"""`analyze` and `scan` — the reference app's two modes as subcommands.

analyze: single-ticker deep dive (reference 'Single Stock' mode,
app.py:1182-1257).  scan: multi-ticker scanner (reference 'Scanner' mode,
app.py:1262-1532).
"""

from __future__ import annotations

import json
import sys

from montecarlo.config import ModelConfig, RELIABILITY_MODES, TradingConfig


def add_parsers(sub):
    _add_analyze(sub)
    _add_scan(sub)


def _add_analyze(sub):
    p = sub.add_parser("analyze", help="single-ticker deep dive")
    p.add_argument("ticker", nargs="?", default="NVDA")
    p.add_argument("--horizon", type=int, default=20,
                   help="forecast horizon in days (5-60)")
    p.add_argument("--sims", type=int, default=1000,
                   help="Monte Carlo simulations (500-5000)")
    p.add_argument("--no-backtest", action="store_true")
    p.add_argument("--cv-folds", type=int, default=5)
    p.add_argument("--estimators", type=int, default=100)
    p.add_argument("--retrain-freq", type=int, default=60)
    p.add_argument("--period", default="5y")
    p.add_argument("--provider", default=None,
                   choices=[None, "yfinance", "synthetic", "csv"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fit-garch", action="store_true",
                   help="QMLE-fit GARCH omega/alpha/beta to the return "
                        "history instead of the reference's hardcoded "
                        "(1e-5, 0.10, 0.85)")
    p.add_argument("--json", action="store_true", help="JSON output")


def _add_scan(sub):
    p = sub.add_parser("scan", help="multi-ticker scanner")
    p.add_argument("--source", default="Popular Stocks",
                   help="universe: 'S&P 500', 'Nasdaq 100', "
                        "'Popular Stocks', 'Mega Caps Only', 'ETFs Only', "
                        "'All Combined'")
    p.add_argument("--tickers", default=None,
                   help="comma-separated custom list (overrides --source)")
    p.add_argument("--max-stocks", type=int, default=50)
    p.add_argument("--horizon", type=int, default=20)
    p.add_argument("--min-accuracy", type=float, default=52.0)
    p.add_argument("--mode", default="balanced",
                   choices=list(RELIABILITY_MODES))
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--timeout", type=float, default=120.0,
                   help="per-ticker deadline in seconds (reference: 120)")
    p.add_argument("--sequential", action="store_true")
    p.add_argument("--batched", action="store_true",
                   help="vmapped device batching over the ticker axis "
                        "(device fast path) instead of the thread pool")
    p.add_argument("--device-batch", type=int, default=50,
                   help="tickers per device program in --batched mode "
                        "(one compile reused across chunks; results are "
                        "chunking-invariant)")
    p.add_argument("--provider", default=None)
    p.add_argument("--json", action="store_true")



def cmd_analyze(args) -> int:
    from montecarlo.api import analyze_ticker
    from montecarlo import report

    cfg = ModelConfig(cv_folds=args.cv_folds, n_estimators=args.estimators)
    out = analyze_ticker(
        args.ticker, forecast_horizon=args.horizon, n_sims=args.sims,
        run_backtest=not args.no_backtest,
        retrain_frequency=args.retrain_freq, period=args.period,
        model_config=cfg, trading_config=TradingConfig(),
        provider=args.provider, seed=args.seed,
        fit_garch_params=args.fit_garch,
        progress_callback=lambda m: print(f"  {m}", file=sys.stderr))
    if out is None:
        print(f"Could not analyze {args.ticker}: insufficient data or "
              "training failed", file=sys.stderr)
        return 1
    if args.json:
        res = {k: v for k, v in out["results"].items()
               if k != "fold_predictions"}
        mc = {k: v for k, v in (out["mc_results"] or {}).items()
              if k not in ("paths", "final_prices", "path_percentiles")}
        bt = (out["backtest_results"] or {}).get("metrics")
        print(json.dumps({"ticker": out["ticker"], "results": res,
                          "mc": mc, "backtest": bt}, default=float))
    else:
        print(report.analysis_report(out))
    return 0


def cmd_scan(args) -> int:
    from montecarlo.api import scan_tickers
    from montecarlo.data import get_ticker_list
    from montecarlo import report

    if args.tickers:
        tickers = [t.strip().upper() for t in args.tickers.replace(
            "\n", ",").split(",") if t.strip()]
    else:
        tickers = get_ticker_list(args.source)
    tickers = tickers[:args.max_stocks]
    cfg, period = RELIABILITY_MODES[args.mode]

    def progress(done, total, out):
        print(f"  scanned {done}/{total} | ok {len(out.results)} "
              f"| failed {len(out.failed)}", file=sys.stderr)

    if args.batched:
        from montecarlo.api import scan_tickers_batched

        res = scan_tickers_batched(
            tickers, forecast_horizon=args.horizon, config=cfg,
            period=period, provider=args.provider,
            progress_callback=progress, device_batch=args.device_batch)
    else:
        res = scan_tickers(
            tickers, forecast_horizon=args.horizon, config=cfg,
            period=period, provider=args.provider,
            parallel=not args.sequential, n_workers=args.workers,
            timeout=args.timeout, progress_callback=progress)
    if args.json:
        print(json.dumps({"results": res.results,
                          "failed": res.failed,
                          "summary": res.summary(len(tickers),
                                                 args.min_accuracy)},
                         default=float))
    else:
        print(report.scan_report(res, len(tickers), args.min_accuracy))
    return 0
