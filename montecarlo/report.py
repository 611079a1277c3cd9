"""Text/markdown reports — the reference dashboard's content, UI-free.

The reference renders results with Streamlit/Plotly
(`create_analysis_dashboard`, reference app.py:901-1120; scanner tables
app.py:1447-1532).  This module renders the same numbers — header metrics,
edge banner, MC percentile table, backtest metric tiles, feature
importances, per-fold CV details, scan tables — as plain text/markdown so
the capability exists everywhere (CLI, logs, notebooks); the optional
Streamlit app (montecarlo/app.py) reuses these result dicts directly.
"""

from __future__ import annotations

from typing import Dict, List

#: Interpretation thresholds from the reference About page (app.py:1164-1169)
#: and edge banner (app.py:936-939, 1022-1027).  The edge threshold is the
#: single source in ml.model (percent here, fraction there) so the banner
#: text can never drift from the has_edge decision.
from montecarlo.ml.model import EDGE_THRESHOLD as _EDGE_FRACTION

EDGE_THRESHOLD = _EDGE_FRACTION * 100.0
SHARPE_GOOD, SHARPE_POOR = 1.0, 0.5
MAX_DD_GOOD, MAX_DD_POOR = 15.0, 30.0
WIN_RATE_GOOD, WIN_RATE_POOR = 55.0, 45.0


def _table(rows: List[List[str]], headers: List[str]) -> str:
    widths = [max(len(str(r[i])) for r in rows + [headers])
              for i in range(len(headers))]
    def fmt(row):
        return " | ".join(str(v).ljust(w) for v, w in zip(row, widths))
    sep = "-+-".join("-" * w for w in widths)
    return "\n".join([fmt(headers), sep] + [fmt(r) for r in rows])


def header_metrics(results: Dict) -> str:
    """The five header tiles (app.py:911-933)."""
    da = results["directional_accuracy"] * 100
    lines = [
        f"Direction Accuracy : {da:.1f}%  ({da - 50:+.1f}% vs random)",
        f"CV RMSE            : {results['rmse_mean']:.4f} "
        f"(±{results['rmse_std']:.4f})",
        f"Predicted Return   : {results['predicted_pct_return']:+.2f}%  "
        f"[{'LONG' if results['signal'] == 1 else 'SHORT' if results['signal'] == -1 else 'FLAT'}]",
        f"Annualized Vol     : {results['current_volatility'] * 100:.1f}%",
        f"Confidence         : {results['confidence'] * 100:.0f}%",
    ]
    banner = (f"MODEL HAS PREDICTIVE EDGE (>{EDGE_THRESHOLD:.0f}% "
              "directional accuracy)"
              if results["has_edge"]
              else f"No significant edge detected (<{EDGE_THRESHOLD:.0f}% "
              "accuracy)")
    return "\n".join(lines + ["", banner])


def mc_report(mc: Dict, current_price: float) -> str:
    """The MC tab (app.py:944-1000): stat tiles + percentile table."""
    tiles = [
        f"Expected Return : {mc['expected_return']:+.2f}%",
        f"Expected Vol    : {mc['expected_vol']:.2f}%",
        f"Prob. of Profit : {mc['prob_profit']:.1f}%",
        f"VaR 95%         : {mc['var_95']:.2f}%   CVaR 95%: {mc['cvar_95']:.2f}%",
    ]
    rows = []
    for q in (1, 5, 10, 25, 50, 75, 90, 95, 99):
        price = mc["percentiles"][f"p{q}"]
        rows.append([f"p{q}", f"{price:.2f}",
                     f"{(price / current_price - 1) * 100:+.2f}%"])
    return "\n".join(tiles) + "\n\n" + _table(
        rows, ["Percentile", "Price", "Return"])


def backtest_report(bt: Dict) -> str:
    """The backtest tab (app.py:1002-1070): 8 tiles + Sharpe interpretation."""
    m = bt["metrics"]
    rows = [
        ["Total Return", f"{m['total_return']:+.2f}%"],
        ["Annualized Return", f"{m['annualized_return']:+.2f}%"],
        ["Sharpe Ratio", f"{m['sharpe_ratio']:.2f}"],
        ["Sortino Ratio", f"{m['sortino_ratio']:.2f}"],
        ["Calmar Ratio", f"{m['calmar_ratio']:.2f}"],
        ["Max Drawdown", f"{m['max_drawdown']:.2f}%"],
        ["Win Rate", f"{m['win_rate']:.1f}%"],
        ["Profit Factor", f"{m['profit_factor']:.2f}"],
        ["Trades", str(m["num_trades"])],
        ["Trading Days", str(m["trading_days"])],
    ]
    sharpe = m["sharpe_ratio"]
    verdict = ("Excellent risk-adjusted returns" if sharpe > SHARPE_GOOD
               else "Acceptable risk-adjusted returns" if sharpe > SHARPE_POOR
               else "Poor risk-adjusted returns")
    return _table(rows, ["Metric", "Value"]) + f"\n\nSharpe: {verdict}"


def importance_report(feature_importance: Dict, top: int = 15) -> str:
    """The features tab (app.py:1072-1099)."""
    rows = [[f, f"{imp:.4f}"]
            for f, imp in zip(feature_importance["feature"][:top],
                              feature_importance["importance"][:top])]
    return _table(rows, ["Feature", "Importance"])


def cv_details_report(results: Dict, n_rows: int | None = None) -> str:
    """The details tab (app.py:1101-1120): per-fold RMSE / accuracy and the
    data span used for training."""
    rows = [[str(i + 1), f"{r:.4f}", f"{d * 100:.1f}%"]
            for i, (r, d) in enumerate(zip(results["rmse_scores"],
                                           results["da_scores"]))]
    out = _table(rows, ["Fold", "RMSE", "Dir. Accuracy"])
    if n_rows:
        out += f"\n\nData span: {n_rows} trading days (~{n_rows / 252:.1f} years)"
    return out


def analysis_report(analysis: Dict) -> str:
    """Full single-ticker report — the whole dashboard as text."""
    parts = [f"=== {analysis['ticker']} ===", "",
             header_metrics(analysis["results"])]
    if analysis.get("mc_results"):
        parts += ["", "--- Monte Carlo ---",
                  mc_report(analysis["mc_results"],
                            analysis["results"]["current_price"])]
    if analysis.get("backtest_results"):
        parts += ["", "--- Backtest ---",
                  backtest_report(analysis["backtest_results"])]
    fi = getattr(analysis.get("model"), "feature_importance", None)
    if fi:
        parts += ["", "--- Top Features ---", importance_report(fi)]
    n_rows = len(analysis["data"]["Close"]) if analysis.get("data") else None
    parts += ["", "--- CV Folds ---",
              cv_details_report(analysis["results"], n_rows)]
    return "\n".join(parts)


def scan_report(scan, n_attempted: int, min_accuracy: float = 52.0) -> str:
    """Scanner results (app.py:1447-1532): edge table, all results, summary,
    failure breakdown."""
    headers = ["Ticker", "Price", "Dir. Acc", "Pred. Ret", "Vol",
               "Signal", "Edge", "Conf"]

    def row(r):
        return [r["Ticker"], f"${r['Price']:.2f}",
                f"{r['Dir. Accuracy']:.1f}%", f"{r['Pred. Return']:+.2f}%",
                f"{r['Volatility']:.1f}%", r["Signal"],
                "YES" if r["Edge"] else "no", f"{r['Confidence']:.0f}%"]

    parts = []
    edge = scan.edge_stocks(min_accuracy)
    parts.append(f"Stocks with potential edge (>= {min_accuracy:.0f}%): "
                 f"{len(edge)}")
    if edge:
        parts.append(_table([row(r) for r in edge], headers))
    all_sorted = sorted(scan.results, key=lambda r: -r["Dir. Accuracy"])
    if all_sorted:
        parts += ["", "All scanned results:",
                  _table([row(r) for r in all_sorted], headers)]
    s = scan.summary(n_attempted, min_accuracy)
    parts += ["", (f"Scan complete — attempted {s['attempted']}, "
                   f"successful {s['successful']}, failed {s['failed']}, "
                   f"with edge {s['with_edge']}, "
                   f"avg accuracy {s['average_accuracy']:.1f}%"
                   + (f", best {s['best_ticker']} "
                      f"({s['best_accuracy']:.1f}%)"
                      if s["best_ticker"] else ""))]
    if scan.failed:
        parts += ["", f"Failed tickers ({len(scan.failed)}):"]
        parts.append(_table([[f["Ticker"], f["Reason"]] for f in scan.failed],
                            ["Ticker", "Reason"]))
        parts.append("Failure reasons: " + ", ".join(
            f"{k}: {v}" for k, v in s["failure_reasons"].items()))
    return "\n".join(parts)
