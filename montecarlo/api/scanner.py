"""Multi-ticker scanner — the reference's 'Scanner' mode (app.py:1262-1532).

Work structure mirrors the reference: per-ticker containment (any exception
becomes a failure record, app.py:1349-1388), a worker pool (app.py:1391-1418)
with per-ticker timeouts, live progress callbacks, and the same result-record
schema ('Ticker', 'Price', 'Dir. Accuracy', 'Pred. Return', 'Volatility',
'Signal', 'Edge', 'Confidence') plus the summary/failure taxonomy.

Device note: device work (CV fits) is serialized by JAX per process; threads
here overlap *host-side* work (fetching, featurize dispatch) exactly like
the reference's GIL-releasing XGBoost threads.  Compiled programs are shared
across tickers (same shapes -> same executable), so the scan amortizes one
compile over the whole universe.
"""

from __future__ import annotations

import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from montecarlo.config import ModelConfig
from montecarlo.data.fetch import get_stock_data
from montecarlo.ml.model import ForecastModel


def signal_label(signal: int) -> str:
    return ("LONG" if signal == 1 else "SHORT" if signal == -1 else "FLAT")


def scan_single_ticker(ticker: str, *, forecast_horizon: int,
                       config: ModelConfig, period: str,
                       provider: Optional[str] = None) -> Dict:
    """One ticker -> success record or failure record (app.py:1349-1388)."""
    try:
        data = get_stock_data(ticker, period, provider=provider)
        if data is None:
            return {"ticker": ticker, "success": False,
                    "error": "No data available"}
        n = len(data["Close"])
        if n < config.min_data_points:
            return {"ticker": ticker, "success": False,
                    "error": f"Insufficient data: {n}/{config.min_data_points} days"}
        model = ForecastModel(forecast_horizon=forecast_horizon,
                              config=config)
        cv = model.train(data)
        if cv is None:
            return {"ticker": ticker, "success": False,
                    "error": "Model training failed"}
        return {
            "success": True,
            "ticker": ticker,
            "data": {
                "Ticker": ticker,
                "Price": cv["current_price"],
                "Dir. Accuracy": cv["directional_accuracy"] * 100.0,
                "Pred. Return": cv["predicted_pct_return"],
                "Volatility": cv["current_volatility"] * 100.0,
                "Signal": signal_label(cv["signal"]),
                "Edge": bool(cv["has_edge"]),
                "Confidence": cv["confidence"] * 100.0,
            },
        }
    except Exception as e:  # per-ticker containment (app.py:1387-1388)
        return {"ticker": ticker, "success": False, "error": str(e)[:50]}


def classify_failure(reason: str) -> str:
    """The reference's failure-reason taxonomy (app.py:1521-1529)."""
    r = str(reason)
    if "Insufficient" in r or "data" in r.lower():
        if "No data" in r:
            return "No data"
        return "Insufficient data"
    if "Training" in r or "failed" in r:
        return "Training failed"
    return "Other"


@dataclass
class ScanResult:
    results: List[Dict] = field(default_factory=list)
    failed: List[Dict] = field(default_factory=list)

    def edge_stocks(self, min_accuracy: float) -> List[Dict]:
        """Results with >= min_accuracy directional accuracy, sorted
        descending (app.py:1451-1453)."""
        edge = [r for r in self.results
                if r["Dir. Accuracy"] >= min_accuracy]
        return sorted(edge, key=lambda r: -r["Dir. Accuracy"])

    def summary(self, n_attempted: int, min_accuracy: float) -> Dict:
        accs = [r["Dir. Accuracy"] for r in self.results]
        best = max(self.results, key=lambda r: r["Dir. Accuracy"],
                   default=None)
        edge = self.edge_stocks(min_accuracy)
        reasons: Dict[str, int] = {}
        for f in self.failed:
            key = classify_failure(f.get("Reason", ""))
            reasons[key] = reasons.get(key, 0) + 1
        return {
            "attempted": n_attempted,
            "successful": len(self.results),
            "failed": len(self.failed),
            "with_edge": len(edge),
            "long_signals": sum(r["Signal"] == "LONG" for r in edge),
            "short_signals": sum(r["Signal"] == "SHORT" for r in edge),
            "average_accuracy": (sum(accs) / len(accs)) if accs else 0.0,
            "best_ticker": best["Ticker"] if best else None,
            "best_accuracy": best["Dir. Accuracy"] if best else None,
            "failure_reasons": reasons,
        }


def scan_tickers(tickers: List[str], *, forecast_horizon: int = 20,
                 config: Optional[ModelConfig] = None, period: str = "5y",
                 provider: Optional[str] = None, parallel: bool = True,
                 n_workers: int = 4, timeout: float = 120.0,
                 progress_callback=None) -> ScanResult:
    """Scan a universe (app.py:1391-1439).

    ``timeout`` is per ticker, like the reference's 120 s future timeout.
    ``progress_callback(done, total, result)`` fires per completion.
    """
    config = config or ModelConfig()
    out = ScanResult()

    def handle(result: Dict):
        if result.get("success"):
            out.results.append(result["data"])
        else:
            out.failed.append({"Ticker": result["ticker"],
                               "Reason": result.get("error", "Unknown")})

    kw = dict(forecast_horizon=forecast_horizon, config=config,
              period=period, provider=provider)

    if parallel and len(tickers) > 1:
        # Per-ticker deadline (the reference's per-future 120 s timeout,
        # app.py:1399): each ticker's clock starts when its task starts
        # executing — a global stall window alone would never trip on a
        # slow-but-alive universe where *something* keeps completing.
        # Deadlines are keyed per submission (not per ticker string:
        # duplicate tickers must not share a clock).
        starts: Dict[int, float] = {}

        def timed(idx: int, ticker: str):
            starts[idx] = time.monotonic()
            return scan_single_ticker(ticker, **kw)

        pool = ThreadPoolExecutor(max_workers=n_workers)
        try:
            futures = {pool.submit(timed, i, t): (i, t)
                       for i, t in enumerate(tickers)}
            pending = set(futures)
            done_count = 0
            # Liveness guard: if every worker is wedged on an abandoned
            # task, queued tickers can neither start nor expire — a stall
            # window with no completion AND no new start for `timeout`
            # seconds times out everything left (the old global-stall
            # semantics, kept as the termination guarantee).
            last_progress = time.monotonic()
            started_seen = 0

            def finish(result):
                nonlocal done_count
                handle(result)
                done_count += 1
                if progress_callback:
                    progress_callback(done_count, len(tickers), out)

            while pending:
                done, pending = wait(pending, timeout=min(timeout, 1.0),
                                     return_when=FIRST_COMPLETED)
                now = time.monotonic()
                if done or len(starts) > started_seen:
                    started_seen = len(starts)
                    last_progress = now
                expired = {
                    fut for fut in pending
                    if starts.get(futures[fut][0]) is not None
                    and now - starts[futures[fut][0]] > timeout
                }
                if not done and not expired and now - last_progress > timeout:
                    expired = set(pending)  # wedged pool: drain everything
                for fut in expired:
                    # The worker thread can't be killed (same as the
                    # reference's TimeoutError path); record and abandon —
                    # its eventual result is ignored.
                    finish({"ticker": futures[fut][1],
                            "success": False, "error": "Timeout"})
                    fut.cancel()
                pending -= expired
                for fut in done:
                    try:
                        finish(fut.result())
                    except Exception as e:
                        finish({"ticker": futures[fut][1],
                                "success": False, "error": str(e)[:50]})
        finally:
            # Do not block on abandoned (timed-out) workers; they unwind in
            # the background and their results are dropped.
            pool.shutdown(wait=False, cancel_futures=True)
    else:
        for i, t in enumerate(tickers):
            handle(scan_single_ticker(t, **kw))
            if progress_callback:
                progress_callback(i + 1, len(tickers), out)
    return out
