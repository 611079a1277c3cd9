"""Streamlit dashboard — UI parity with the reference app.

Run with: ``streamlit run montecarlo/app.py``

Mirrors the reference's three modes (reference app.py:1125-1532): an About
page, a Single Stock deep dive (header metrics, MC fan chart with percentile
bands, backtest equity/drawdown, feature importances, CV details), and a
multi-ticker Scanner (universe picker, reliability modes, live progress,
edge tables, failure breakdown).  All analytics come from the JAX
pipeline; this file is presentation only.

streamlit and plotly are optional dependencies — every capability is also
available through the CLI / report module without them.
"""

from __future__ import annotations

import numpy as np

try:
    import streamlit as st
except ImportError as e:  # pragma: no cover - optional dependency
    raise ImportError(
        "The dashboard requires streamlit (`pip install streamlit plotly`); "
        "use `python -m montecarlo.cli` for the terminal interface."
    ) from e

try:
    import plotly.graph_objects as go
    from plotly.subplots import make_subplots
    HAS_PLOTLY = True
except ImportError:  # pragma: no cover
    HAS_PLOTLY = False

from montecarlo.api import analyze_ticker, scan_tickers
from montecarlo.config import RELIABILITY_MODES, ModelConfig, TradingConfig
from montecarlo.data import SOURCES, default_provider, get_ticker_list
from montecarlo import report

st.set_page_config(layout="wide",
                   page_title="Quantitative Trading System")


def _about_page():
    st.title("Quantitative Trading System")
    st.markdown("""
This is a JAX rebuild of a quantitative trading research system:

- **Feature engineering** — ~60 technical indicators computed in JAX
- **ML forecasting** — walk-forward cross-validated gradient-boosted trees
  (histogram GBT running entirely on the accelerator)
- **Monte Carlo** — GARCH(1,1)-bootstrap simulation with counter-based,
  reproducible RNG (a fused path kernel on the GPU)
- **Backtesting** — walk-forward with periodic retraining, slippage,
  commissions, and a full risk-metric suite
- **Scanner** — multi-ticker universe scans with reliability presets

| Mode | Estimators | CV folds | History |
|---|---|---|---|
| Fast | 50 | 3 | 2y |
| Balanced | 75 | 4 | 3y |
| Full | 100 | 5 | 5y |

**Interpretation guide** — directional accuracy: poor < 52% < good > 55%;
Sharpe: poor < 0.5 < good > 1.0; max drawdown: good < 15% < poor > 30%;
win rate: poor < 45% < good > 55%.

*Research tooling, not investment advice.*
""")


def _mc_chart(mc, results):
    if not HAS_PLOTLY:
        st.text(report.mc_report(mc, results["current_price"]))
        return
    pp = mc["path_percentiles"]
    days = np.arange(len(pp["p50"]))
    fig = go.Figure()
    for lo, hi, alpha in (("p5", "p95", 0.15), ("p25", "p75", 0.3)):
        fig.add_trace(go.Scatter(x=days, y=pp[hi], line=dict(width=0),
                                 showlegend=False))
        fig.add_trace(go.Scatter(
            x=days, y=pp[lo], fill="tonexty",
            fillcolor=f"rgba(0,100,200,{alpha})", line=dict(width=0),
            name=f"{lo}-{hi}"))
    fig.add_trace(go.Scatter(x=days, y=pp["p50"], name="median",
                             line=dict(color="royalblue", width=2)))
    target_day = len(days) - 1
    target = results["current_price"] * np.exp(
        results["predicted_log_return"])
    fig.add_trace(go.Scatter(x=[target_day], y=[target], mode="markers",
                             marker=dict(symbol="star", size=14,
                                         color="gold"),
                             name="ML target"))
    fig.update_layout(title="Monte Carlo price paths (percentile bands)",
                      xaxis_title="days", yaxis_title="price")
    st.plotly_chart(fig, use_container_width=True)


def _backtest_charts(bt):
    if not HAS_PLOTLY:
        st.text(report.backtest_report(bt))
        return
    fig = make_subplots(rows=2, cols=1, shared_xaxes=True,
                        row_heights=[0.7, 0.3],
                        subplot_titles=("Equity", "Drawdown"))
    x = np.arange(len(bt["equity"]))
    fig.add_trace(go.Scatter(x=x, y=bt["equity"], name="equity"), row=1,
                  col=1)
    fig.add_trace(go.Scatter(x=x, y=-100 * np.asarray(bt["drawdowns"]),
                             name="drawdown %", fill="tozeroy"), row=2,
                  col=1)
    st.plotly_chart(fig, use_container_width=True)


def _single_stock_page():
    st.sidebar.header("Analysis Settings")
    ticker = st.sidebar.text_input("Ticker", "NVDA").strip().upper()
    horizon = st.sidebar.slider("Forecast horizon (days)", 5, 60, 20)
    run_bt = st.sidebar.checkbox("Run backtest", True)
    n_sims = st.sidebar.slider("Monte Carlo simulations", 500, 5000, 1000,
                               step=500)
    with st.sidebar.expander("Advanced"):
        cv_folds = st.slider("CV folds", 3, 7, 5)
        n_estimators = st.slider("Trees", 50, 200, 100, step=25)
        retrain_freq = st.slider("Retrain frequency (days)", 20, 120, 60,
                                 step=20)

    if not st.sidebar.button("Analyze", type="primary"):
        st.info("Configure and press Analyze.")
        return

    status = st.empty()
    out = analyze_ticker(
        ticker, forecast_horizon=horizon, n_sims=n_sims,
        run_backtest=run_bt, retrain_frequency=retrain_freq,
        model_config=ModelConfig(cv_folds=cv_folds,
                                 n_estimators=n_estimators),
        trading_config=TradingConfig(),
        progress_callback=status.text)
    status.empty()
    if out is None:
        st.error(f"Could not analyze {ticker}: insufficient data or "
                 "training failed.")
        return

    r = out["results"]
    c1, c2, c3, c4, c5 = st.columns(5)
    da = r["directional_accuracy"] * 100
    c1.metric("Direction Accuracy", f"{da:.1f}%", f"{da - 50:+.1f}% vs random")
    c2.metric("CV RMSE", f"{r['rmse_mean']:.4f}", f"±{r['rmse_std']:.4f}")
    label = ("LONG" if r["signal"] == 1 else
             "SHORT" if r["signal"] == -1 else "FLAT")
    c3.metric("Predicted Return", f"{r['predicted_pct_return']:+.2f}%", label)
    c4.metric("Annualized Vol", f"{r['current_volatility'] * 100:.1f}%")
    c5.metric("Confidence", f"{r['confidence'] * 100:.0f}%")
    if r["has_edge"]:
        st.success("Model shows predictive edge (>52% directional accuracy)")
    else:
        st.warning("No significant edge detected (<52% accuracy)")

    tabs = st.tabs(["Monte Carlo", "Backtest", "Features", "Details"])
    with tabs[0]:
        if out["mc_results"]:
            mc = out["mc_results"]
            m1, m2, m3, m4 = st.columns(4)
            m1.metric("Expected Return", f"{mc['expected_return']:+.2f}%")
            m2.metric("Prob. of Profit", f"{mc['prob_profit']:.1f}%")
            m3.metric("VaR 95%", f"{mc['var_95']:.2f}%")
            m4.metric("CVaR 95%", f"{mc['cvar_95']:.2f}%")
            st.table({"percentile": list(mc["percentiles"]),
                      "price": [f"{v:.2f}"
                                for v in mc["percentiles"].values()]})
            _mc_chart(mc, r)
    with tabs[1]:
        if out["backtest_results"]:
            bt = out["backtest_results"]
            m = bt["metrics"]
            cols = st.columns(4)
            for col, (k, v) in zip(cols * 2, [
                    ("Total Return", f"{m['total_return']:+.2f}%"),
                    ("Sharpe", f"{m['sharpe_ratio']:.2f}"),
                    ("Max Drawdown", f"{m['max_drawdown']:.2f}%"),
                    ("Win Rate", f"{m['win_rate']:.1f}%"),
                    ("Sortino", f"{m['sortino_ratio']:.2f}"),
                    ("Calmar", f"{m['calmar_ratio']:.2f}"),
                    ("Profit Factor", f"{m['profit_factor']:.2f}"),
                    ("Trades", str(m["num_trades"]))]):
                col.metric(k, v)
            _backtest_charts(bt)
            with st.expander("Trade log"):
                st.dataframe(bt["trades"])
        else:
            st.info("Backtest disabled or insufficient data.")
    with tabs[2]:
        fi = out["model"].feature_importance
        st.dataframe({"feature": fi["feature"],
                      "importance": fi["importance"]})
    with tabs[3]:
        st.table({"fold": list(range(1, len(r["rmse_scores"]) + 1)),
                  "rmse": r["rmse_scores"], "dir_acc": r["da_scores"]})


def _scanner_page():
    st.sidebar.header("Scanner Settings")
    source = st.sidebar.selectbox("Universe", list(SOURCES) + ["Custom"])
    custom = ""
    if source == "Custom":
        custom = st.sidebar.text_area("Tickers (comma/newline separated)")
    max_stocks = st.sidebar.slider("Stocks to scan", 10, 300, 50, step=10)
    horizon = st.sidebar.slider("Forecast horizon", 10, 60, 20)
    min_acc = st.sidebar.slider("Min directional accuracy (%)", 50, 60, 52)
    mode = st.sidebar.select_slider("Reliability",
                                    options=["fast", "balanced", "full"],
                                    value="balanced")
    parallel = st.sidebar.checkbox("Parallel fetch", True)
    workers = st.sidebar.slider("Workers", 2, 8, 4)

    if not st.sidebar.button("Start Scan", type="primary"):
        st.info("Configure and press Start Scan.")
        return

    if source == "Custom":
        tickers = [t.strip().upper()
                   for t in (custom or "").replace("\n", ",").split(",")
                   if t.strip()]
        if not tickers:
            st.error("Custom universe selected but no tickers entered.")
            return
    elif custom:
        tickers = [t.strip().upper()
                   for t in custom.replace("\n", ",").split(",")
                   if t.strip()]
    else:
        tickers = get_ticker_list(source)
    tickers = tickers[:max_stocks]
    cfg, period = RELIABILITY_MODES[mode]
    st.info(f"Scanning {len(tickers)} stocks from {source} in {mode} mode "
            f"({default_provider()} data)...")

    bar = st.progress(0)
    status = st.empty()
    live = st.empty()

    def progress(done, total, out):
        bar.progress(done / total)
        status.text(f"Scanned {done}/{total} | ok {len(out.results)} "
                    f"| failed {len(out.failed)}")
        if out.results and done % 3 == 0:
            top = sorted(out.results,
                         key=lambda x: -x["Dir. Accuracy"])[:10]
            live.dataframe(top)

    res = scan_tickers(tickers, forecast_horizon=horizon, config=cfg,
                       period=period, parallel=parallel, n_workers=workers,
                       progress_callback=progress)
    bar.empty(); status.empty(); live.empty()

    edge = res.edge_stocks(min_acc)
    st.subheader(f"Stocks with potential edge (>= {min_acc}%)")
    if edge:
        st.dataframe(edge)
        c1, c2, c3 = st.columns(3)
        c1.metric("Long Signals",
                  sum(r["Signal"] == "LONG" for r in edge))
        c2.metric("Short Signals",
                  sum(r["Signal"] == "SHORT" for r in edge))
        c3.metric("Avg Accuracy", f"{np.mean([r['Dir. Accuracy'] for r in edge]):.1f}%")
    else:
        st.warning(f"No stocks found with >= {min_acc}% accuracy")

    st.subheader("All scanned results")
    st.dataframe(sorted(res.results, key=lambda x: -x["Dir. Accuracy"]))
    s = res.summary(len(tickers), min_acc)
    st.success(f"Scan complete — attempted {s['attempted']}, successful "
               f"{s['successful']}, failed {s['failed']}, with edge "
               f"{s['with_edge']}, avg accuracy "
               f"{s['average_accuracy']:.1f}%")
    if res.failed:
        with st.expander(f"Failed tickers ({len(res.failed)})"):
            st.dataframe(res.failed)
            for reason, count in s["failure_reasons"].items():
                st.write(f"- {reason}: {count} tickers")


def _derivatives_page():
    """Pricing lab over the derivatives engine (beyond the reference app:
    process families, exotics, Greeks, and fixed income, all on the fused
    path kernel where eligible)."""
    import jax.numpy as jnp

    st.sidebar.header("Pricing Settings")
    process = st.sidebar.selectbox(
        "Process", ["GBM", "Heston", "Bates", "Merton", "Kou", "NIG", "VG",
                    "SABR", "SLV"])
    payoff = st.sidebar.selectbox(
        "Payoff", ["European call", "European put", "Asian call",
                   "Lookback", "Up-and-out call"])
    s0 = st.sidebar.slider("Spot", 50.0, 200.0, 100.0)
    strike = st.sidebar.slider("Strike", 50.0, 200.0, 105.0)
    rate = st.sidebar.slider("Rate (%)", 0.0, 10.0, 3.0) / 100.0
    sigma = st.sidebar.slider("Volatility (%)", 5.0, 80.0, 20.0) / 100.0
    maturity = st.sidebar.slider("Maturity (years)", 0.25, 3.0, 1.0)
    log2_paths = st.sidebar.slider("log2(paths)", 14, 20, 16)
    if not st.sidebar.button("Price", type="primary"):
        st.info("Configure the instrument and press Price.")
        return

    from montecarlo.engine import (
        ARITH_MEAN, RUNNING_MAX, RUNNING_MIN, asian_call,
        black_scholes_call, black_scholes_put, discount_factor,
        european_call, european_put, lookback_call_floating, mc_estimate,
        price_and_greeks, simulate_functionals, up_and_out_call)
    from montecarlo.processes import GBM, Heston, Kou, Merton, SABR

    n_paths, n_steps = 1 << log2_paths, 128
    dt = maturity / n_steps
    if process == "GBM":
        proc = GBM.create(s0=s0, mu=rate, sigma=sigma, dt=dt)
    elif process == "Heston":
        proc = Heston.create(s0=s0, v0=sigma**2, mu=rate, kappa=2.0,
                             theta=sigma**2, xi=0.5, rho=-0.7, dt=dt)
    elif process == "Bates":
        from montecarlo.processes import Bates

        proc = Bates.create(s0=s0, v0=sigma**2, mu=rate, kappa=2.0,
                            theta=sigma**2, xi=0.5, rho=-0.7, lam=1.0,
                            jump_mean=-0.05, jump_std=0.1, dt=dt)
    elif process == "Merton":
        proc = Merton.create(s0=s0, mu=rate, sigma=sigma, lam=1.0,
                             jump_mean=-0.05, jump_std=0.1, dt=dt)
    elif process == "Kou":
        proc = Kou.create(s0=s0, mu=rate, sigma=sigma, lam=1.0, p_up=0.4,
                          eta1=10.0, eta2=5.0, dt=dt)
    elif process == "VG":
        from montecarlo.processes import VarianceGamma

        # --sigma is the subordinated-BM scale, so the slider's annualized
        # vol carries straight through (classic MCC-1998 skew/kurtosis).
        proc = VarianceGamma.create(s0=s0, mu=rate, sigma=sigma,
                                    theta=-0.14, nu=0.2, dt=dt)
    elif process == "NIG":
        from montecarlo.processes import NIG

        # Map the vol slider onto the NIG scale: log-return variance per
        # unit time is delta*alpha^2/gamma^3, so delta = sigma^2*gamma^3/
        # alpha^2 reproduces the slider's annualized vol (skew beta=-5).
        alpha, beta = 15.0, -5.0
        gamma = float((alpha**2 - beta**2) ** 0.5)
        proc = NIG.create(s0=s0, mu=rate, alpha=alpha, beta=beta,
                          delta=sigma**2 * gamma**3 / alpha**2, dt=dt)
    elif process == "SLV":
        # Heston-SLV: leverage particle-calibrated to a demo surface with
        # ATM vol = the slider and a -0.1 skew per unit log-moneyness
        # (processes/slv.py) — vanillas reprice the surface, exotics see
        # the Heston smile dynamics.
        import numpy as _np

        from montecarlo.processes import LocalVolGBM, calibrate_slv
        from montecarlo.processes.dupire import local_vol_fn_from_ivs

        ks = _np.linspace(0.7, 1.4, 15) * s0
        mats = _np.array([0.5, 1.0]) * maturity
        ivs = (sigma - 0.1 * _np.log(ks / s0))[None, :].repeat(2, 0)
        vol_fn = local_vol_fn_from_ivs(ks, mats, ivs, s0=s0, rate=rate)
        lv = LocalVolGBM.create(s0, rate, dt, n_steps, vol_fn,
                                x_min=-0.9, x_max=0.9)
        proc = calibrate_slv(lv, v0=sigma**2, kappa=2.0, theta=sigma**2,
                             xi=0.8, rho=-0.6, n_steps=n_steps,
                             n_particles=min(n_paths, 1 << 16), seed=0)
    else:
        # SABR dynamics are driftless (forward measure): simulate the
        # T-forward of the spot, f0 = s0*e^{rT}, so the discounted price is
        # consistent with the risk-neutral spot models alongside it (a bare
        # f0 = s0 would silently drop the forward growth).
        import numpy as _np

        f0 = s0 * float(_np.exp(rate * maturity))
        proc = SABR.create(f0=f0, alpha=sigma * f0 ** 0.3, beta=0.7,
                           nu=0.3, rho=-0.3, dt=dt)

    disc = float(discount_factor(rate, maturity))
    if payoff in ("European call", "European put"):
        from montecarlo.engine.dispatch import terminal_prices

        # terminal_prices: fused Pallas kernel when eligible (same draws).
        terminal = terminal_prices(proc, n_paths, n_steps, seed=0)
        pay = (european_call(terminal, strike) if "call" in payoff
               else european_put(terminal, strike))
        est = mc_estimate(pay, disc)
    else:
        out = simulate_functionals(
            proc, n_paths, n_steps, seed=0,
            functionals={"avg": ARITH_MEAN, "mx": RUNNING_MAX,
                         "mn": RUNNING_MIN})
        if payoff == "Asian call":
            pay = asian_call(out["avg"], strike)
        elif payoff == "Lookback":
            pay = lookback_call_floating(out["terminal"], out["mn"])
        else:
            pay = up_and_out_call(out["terminal"], out["mx"], strike,
                                  1.2 * strike)
        est = mc_estimate(pay, disc)

    cols = st.columns(4)
    cols[0].metric("Price", f"{float(est['price']):.4f}")
    cols[1].metric("Std err", f"{float(est['std_err']):.2e}")
    cols[2].metric("Paths", f"{n_paths:,}")
    if process == "GBM" and payoff.startswith("European"):
        bs = (black_scholes_call if "call" in payoff
              else black_scholes_put)(s0, strike, rate, sigma, maturity)
        cols[3].metric("Black-Scholes", f"{float(bs):.4f}")
        price, greeks = price_and_greeks(
            proc, lambda s: european_call(s, strike)
            if "call" in payoff else european_put(s, strike),
            n_paths, n_steps, seed=0, discount=disc)
        g1, g2, _, _ = st.columns(4)
        g1.metric("Delta (pathwise)", f"{float(greeks.s0):.4f}")
        g2.metric("Vega (pathwise)", f"{float(greeks.sigma):.4f}")
    st.success(f"{process} {payoff}: {float(est['price']):.4f} "
               f"± {float(est['std_err']):.4f}")

    with st.expander("Stress scenarios (common random numbers)"):
        from montecarlo.api.stress import stress_report

        # Bump fields the process actually carries (Bates/SLV have v0, not
        # a flat sigma; bumping a missing field would KeyError).
        fields = (("s0", "v0") if process in ("Heston", "Bates", "SLV")
                  else ("f0", "alpha") if process == "SABR"
                  else ("s0", "delta") if process == "NIG"
                  else ("s0", "sigma"))
        rep = stress_report(
            proc, (lambda s: jnp.maximum(s - strike, 0.0)),
            min(n_paths, 1 << 14), n_steps, seed=0, fields=fields,
            discount=disc)
        st.dataframe([{"Scenario": k, **v}
                      for k, v in rep["scenarios"].items()])

    with st.expander("Model smile (implied vols from one simulation)"):
        from montecarlo.engine.surface import mc_implied_vol_surface

        surf = mc_implied_vol_surface(
            proc, strikes=[0.8 * s0, 0.9 * s0, s0, 1.1 * s0, 1.2 * s0],
            step_grid=[n_steps // 2, n_steps], dt=maturity / n_steps,
            rate=rate, n_paths=min(n_paths, 1 << 16), seed=0, s0=s0)
        st.dataframe({"strike": surf["strikes"],
                      f"iv @ {surf['maturities'][0]:.2f}y":
                      surf["ivs"][0].round(4),
                      f"iv @ {surf['maturities'][1]:.2f}y":
                      surf["ivs"][1].round(4)})

    if process != "SABR":
        with st.expander("American exercise (LSM lower bound)"):
            # Vol-aware (S, v) regression for the SV processes, spot-only
            # polynomial LSM otherwise (engine/american.py).
            am_paths = min(n_paths, 1 << 15)
            am_payoff = lambda s: jnp.maximum(strike - s, 0.0)
            if process in ("Heston", "Bates", "SLV"):
                from montecarlo.engine import lsm_price_sv

                am = lsm_price_sv(proc, am_payoff, am_paths, n_steps,
                                  seed=0, rate=rate, dt=dt, degree=2)
            else:
                from montecarlo.engine import lsm_price

                am = lsm_price(proc, am_payoff, am_paths, n_steps, seed=0,
                               rate=rate, dt=dt, degree=3)
            st.metric("American put (LSM)",
                      f"{float(am['price']):.4f} "
                      f"± {float(am['std_err']):.4f}")

    with st.expander("Counterparty xVA (Vasicek payer swap)"):
        import numpy as _np

        from montecarlo.engine.exposure import (exposure_profile,
                                                    swap_value_fn)
        from montecarlo.engine.rates import vasicek_zcb
        from montecarlo.processes import Vasicek as _Vas

        kap, th, sg = 0.8, rate + 0.01, 0.015
        periods = 8
        pay_dt = maturity / periods
        pts = pay_dt * _np.arange(1, periods + 1)
        vas = _Vas.create(rate, kap, th, sg, maturity / 50)
        ps = [vasicek_zcb(rate, kap, th, sg, t) for t in pts]
        par = (1.0 - ps[-1]) / (pay_dt * sum(ps))
        vfn = swap_value_fn(vas, par, pts, pay_dt, dtype=jnp.float32)
        prof = exposure_profile(
            vas, vfn, 1 << 12, 50, T=maturity, seed=0, hazard_rate=0.02,
            own_hazard_rate=0.01, funding_spread=0.005,
            fixing_times=pts - pay_dt, dtype=jnp.float32)
        x1, x2, x3 = st.columns(3)
        x1.metric("CVA", f"{float(prof['cva']) * 1e4:.2f} bp")
        x2.metric("DVA", f"{float(prof['dva']) * 1e4:.2f} bp")
        x3.metric("FVA", f"{float(prof['fva']) * 1e4:.2f} bp")
        st.dataframe({
            "t (y)": _np.asarray(prof["times"]).round(3),
            "EPE": _np.asarray(prof["epe"]).round(6),
            "ENE": _np.asarray(prof["ene"]).round(6),
            "PFE 95%": _np.asarray(prof["pfe"]).round(6)})

        st.caption("Netting set: par swap + 0.5x physical swaption under "
                   "CSA variation margin; KVA on the collateralized EEPE; "
                   "pathwise CVA greeks by forward-mode AD")
        from montecarlo.engine.exposure import (CSA, PathDependentTrade,
                                                    netting_set_profile,
                                                    swaption_value_fn,
                                                    xva_greeks)

        t_exp = float(pts[periods // 2] - pay_dt)
        back = tuple(float(t) for t in pts if t > t_exp + 1e-9)
        sw = swaption_value_fn(vas, par, t_exp, back, pay_dt,
                               dtype=jnp.float32)
        book = (vfn, PathDependentTrade(
            lambda r, t, *o: 0.5 * sw.value_fn(r, t, *o), sw.obs_times))
        nb = netting_set_profile(
            vas, book, 1 << 12, 50, T=maturity, seed=0,
            csa=CSA(threshold=0.002, mpor=4 * maturity / 50),
            hazard_rate=0.02, kva_cost=0.10, dtype=jnp.float32)
        y1, y2, y3 = st.columns(3)
        y1.metric("Netted CVA", f"{float(nb['cva']) * 1e4:.2f} bp")
        y2.metric("No-netting CVA",
                  f"{float(nb['cva_no_netting']) * 1e4:.2f} bp")
        y3.metric("KVA", f"{float(nb['kva']) * 1e4:.2f} bp")

        def _xva_build(p):
            v = _Vas.create(p["r0"], kap, th, p["sigma"], maturity / 50)
            return v, (swap_value_fn(v, par, pts, pay_dt,
                                     dtype=jnp.float32),), None

        g = xva_greeks(_xva_build,
                       {"r0": rate, "sigma": sg, "hazard_rate": 0.02},
                       1 << 11, 50, T=maturity, seed=0,
                       outputs=("cva",), dtype=jnp.float32)
        st.write("CVA greeks (swap book):",
                 {k: round(float(v), 6)
                  for k, v in g["greeks"]["cva"].items()})

        st.caption("Full forward-curve book (Libor Market Model): long "
                   "the front of the curve vs short the back — netting "
                   "quality is set by the correlation decay across "
                   "tenors, a knob no short-rate model has")
        from montecarlo.processes.lmm import (LMM as _LMM,
                                                  lmm_par_strike,
                                                  lmm_swap_value_fn)

        k_fwd = 8
        lmm = _LMM.create([rate] * k_fwd, [0.2] * k_fwd, 0.25,
                          corr_beta=0.3, dtype=jnp.float32)
        vf = lmm_swap_value_fn(lmm, lmm_par_strike(lmm, 1, 4), 1, 4,
                               dtype=jnp.float32)
        vb = lmm_swap_value_fn(lmm, lmm_par_strike(lmm, 4, 8), 4, 8,
                               dtype=jnp.float32)
        lb = netting_set_profile(
            lmm, (lambda c, t: 2.0 * vf(c, t),
                  lambda c, t: -1.0 * vb(c, t)),
            1 << 11, k_fwd, T=k_fwd * 0.25, seed=0, hazard_rate=0.02,
            dtype=jnp.float32)
        z1, z2 = st.columns(2)
        z1.metric("LMM curve-book CVA", f"{float(lb['cva']) * 1e4:.2f} bp")
        z2.metric("Net / gross",
                  f"{float(lb['cva']) / max(float(lb['cva_no_netting']), 1e-12):.2f}")

        st.caption("Equity + volatility netting (Heston): a long-equity "
                   "forward hedged with a PAR variance swap — the "
                   "spot-vol correlation is what nets them (equity down "
                   "<-> vol up), a cross no constant-vol model can mark")
        from montecarlo.processes import (
            HestonExposure as _HX, heston_forward_value_fn,
            heston_varswap_expected_total, heston_varswap_value_fn)

        t_h = 1.0
        hx = _HX.create(100.0, 0.04, rate, 1.5, 0.05, 0.5, -0.7,
                        t_h / 16, dtype=jnp.float32)
        k_var = heston_varswap_expected_total(hx, t_h) / t_h
        fwd_h = heston_forward_value_fn(
            hx, 100.0 * float(_np.exp(rate * t_h)), t_h,
            dtype=jnp.float32)
        vs_h = heston_varswap_value_fn(hx, k_var, t_h, notional=500.0,
                                       dtype=jnp.float32)
        hb = netting_set_profile(
            hx, (lambda c, t: 0.2 * fwd_h(c, t), vs_h), 1 << 11, 16,
            T=t_h, seed=0, hazard_rate=0.02, flat_rate=rate,
            dtype=jnp.float32)
        h1, h2 = st.columns(2)
        h1.metric("Heston equity+vol CVA", f"{float(hb['cva']):.4f}")
        h2.metric("Net / gross",
                  f"{float(hb['cva']) / max(float(hb['cva_no_netting']), 1e-12):.2f}")

    with st.expander("Portfolio credit (Gaussian copula)"):
        import numpy as _np

        from montecarlo.engine.credit import (base_correlation,
                                                  cdo_tranche,
                                                  tranche_spread_exact)

        cc1, cc2, cc3 = st.columns(3)
        cr_rho = cc1.slider("Copula correlation", 0.05, 0.9, 0.3, 0.05)
        cr_att = cc2.selectbox("Tranche", ["0-3%", "3-7%", "7-15%"],
                               index=1)
        cr_haz = cc3.slider("Hazard (bp/y)", 50, 500, 200, 25) / 1e4
        a, b = {"0-3%": (0.0, 0.03), "3-7%": (0.03, 0.07),
                "7-15%": (0.07, 0.15)}[cr_att]
        tr = cdo_tranche([cr_haz] * 100, cr_rho, attach=a, detach=b,
                         T=5.0, n_steps=20, n_paths=1 << 14, seed=0,
                         rate=rate, dtype=jnp.float32)
        ex = tranche_spread_exact(cr_haz, cr_rho, n_names=100, attach=a,
                                  detach=b, T=5.0, n_steps=20, rate=rate,
                                  dtype=jnp.float32)
        d1, d2, d3 = st.columns(3)
        d1.metric("Par spread (MC)",
                  f"{float(tr['par_spread']) * 1e4:.1f} bp",
                  f"± {float(tr['par_spread_std_err']) * 1e4:.1f}")
        d2.metric("Par spread (exact)",
                  f"{float(ex['par_spread']) * 1e4:.1f} bp")
        d3.metric("Hazard delta", f"{float(ex['hazard_delta']):.3f}")
        st.line_chart({"expected tranche loss":
                       _np.asarray(tr["expected_loss"])})
        bc = base_correlation(
            float(tranche_spread_exact(cr_haz, cr_rho, n_names=100,
                                       attach=0.0, detach=0.03, T=5.0,
                                       n_steps=20, rate=rate,
                                       dtype=jnp.float32)["par_spread"]),
            n_names=100, detach=0.03, hazard=cr_haz, T=5.0, n_steps=20,
            rate=rate, dtype=jnp.float32)
        st.caption(f"Base correlation round-trip on the 0-3% tranche: "
                   f"{float(bc):.4f} (generated at {cr_rho:.2f})")

    with st.expander("Fixed income (Vasicek)"):
        from montecarlo.engine import vasicek_zcb, zcb_price_mc
        from montecarlo.processes import Vasicek

        vas = Vasicek.create(rate, 0.8, rate + 0.01, 0.015, maturity / 128)
        zcb = zcb_price_mc(vas, maturity, 128, 1 << 14, seed=0)
        st.metric("Zero-coupon bond (MC)", f"{float(zcb['price']):.6f}")
        st.write(f"Affine closed form: "
                 f"{vasicek_zcb(rate, 0.8, rate + 0.01, 0.015, maturity):.6f}")


def main():
    mode = st.sidebar.radio("Mode", ["About", "Single Stock", "Scanner",
                                     "Derivatives Lab"], index=1)
    if mode == "About":
        _about_page()
    elif mode == "Single Stock":
        _single_stock_page()
    elif mode == "Scanner":
        _scanner_page()
    else:
        _derivatives_page()


if __name__ == "__main__":
    main()
