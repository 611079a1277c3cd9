"""Smoke tests for the Streamlit dashboard (montecarlo/app.py).

streamlit/plotly are absent from this image, so a recording fake module
(tests/fake_streamlit.py) stands in: every page executes its REAL pipeline
(analyze/scan over the synthetic provider) and the test asserts the result
keys the page consumes — any drift between the API contracts and the UI
fails here instead of shipping broken (reference parity surface:
app.py:901-1120, 1182-1532).
"""

import importlib

import pytest

from tests import fake_streamlit


@pytest.fixture
def app_with(request):
    """Import app.py against a fresh fake streamlit with given overrides."""
    made = []

    def factory(overrides=None):
        calls, _ = fake_streamlit.install(overrides)
        import montecarlo.app as app
        app = importlib.reload(app)
        made.append(app)
        return app, calls

    yield factory
    fake_streamlit.uninstall()


def _methods(calls):
    return [m for m, _ in calls]


def test_about_page(app_with):
    app, calls = app_with({"Mode": "About"})
    app.main()
    assert "title" in _methods(calls)
    md = [label for m, label in calls if m == "markdown"]
    assert any("Interpretation guide" in str(s) for s in md)


def test_single_stock_page_runs_pipeline(app_with):
    app, calls = app_with({
        "Mode": "Single Stock",
        "Ticker": "SYN",
        "Monte Carlo simulations": 512,
        "CV folds": 3,
        "Trees": 25,
    })
    app.main()
    methods = _methods(calls)
    # Pipeline ran: header metrics, edge banner, 4 tabs, MC table, charts.
    assert methods.count("metric") >= 9  # 5 header + >=4 MC tiles
    assert "tabs" in methods
    assert ("success" in methods) or ("warning" in methods)
    assert "plotly_chart" in methods      # MC fan chart through the stub
    assert "dataframe" in methods         # trade log / feature importances


def test_single_stock_page_not_pressed(app_with):
    app, calls = app_with({"Mode": "Single Stock", "Analyze": False})
    app.main()
    # No pipeline work — just the configure hint.
    assert "info" in _methods(calls)
    assert "metric" not in _methods(calls)


def test_single_stock_page_bad_ticker_graceful(app_with):
    # Ticker with too little history -> analyze returns None -> st.error.
    app, calls = app_with({
        "Mode": "Single Stock", "Ticker": "SYN", "_period_override": None})
    import montecarlo.api as api

    real = api.analyze_ticker
    app.analyze_ticker = lambda *a, **kw: None
    try:
        app.main()
    finally:
        app.analyze_ticker = real
    assert "error" in _methods(calls)


def test_scanner_page_custom_universe(app_with):
    app, calls = app_with({
        "Mode": "Scanner",
        "Universe": "Custom",
        "Tickers (comma/newline separated)": "SYNA, SYNB\nSYNC",
        "Stocks to scan": 10,
        "Reliability": "fast",
        "Workers": 2,
    })
    app.main()
    methods = _methods(calls)
    assert "progress" in methods
    assert "dataframe" in methods  # results tables
    assert "success" in methods    # summary banner
    banners = [label for m, label in calls if m == "success"]
    assert any("Scan complete" in str(b) for b in banners)
    # Custom ticker parsing: 3 tickers attempted.
    assert any("Scanning 3 stocks" in str(label)
               for m, label in calls if m == "info")


def test_derivatives_lab_gbm_call(app_with):
    app, calls = app_with({"Mode": "Derivatives Lab", "log2(paths)": 14})
    app.main()
    methods = _methods(calls)
    # price tiles + BS reference + pathwise greeks + fixed-income expander
    assert methods.count("metric") >= 7
    assert "expander" in methods
    assert "success" in methods


def test_derivatives_lab_exotic_heston(app_with):
    app, calls = app_with({"Mode": "Derivatives Lab", "Process": "Heston",
                           "Payoff": "Asian call", "log2(paths)": 14})
    app.main()
    methods = _methods(calls)
    assert methods.count("metric") >= 4
    assert "success" in methods


def test_derivatives_lab_not_pressed(app_with):
    app, calls = app_with({"Mode": "Derivatives Lab", "Price": False})
    app.main()
    assert "info" in _methods(calls)


def test_derivatives_lab_slv(app_with):
    """SLV in the Lab: particle calibration + pricing + the American and
    xVA expanders all execute."""
    app, calls = app_with({"Mode": "Derivatives Lab", "Process": "SLV",
                           "log2(paths)": 14})
    app.main()
    methods = _methods(calls)
    assert "success" in methods
    # price tiles + American LSM + CVA/DVA/FVA + fixed income
    assert methods.count("metric") >= 7
    labels = [str(label) for m, label in calls if m == "metric"]
    assert any("American put" in s for s in labels)
    assert any("CVA" in s for s in labels)
    # Netting-set block: collateralized vs no-netting CVA, KVA, greeks.
    assert any("Netted CVA" in s for s in labels)
    assert any("KVA" in s for s in labels)
    writes = [str(label) for m, label in calls if m == "write"]
    assert any("CVA greeks" in s for s in writes)


def test_derivatives_lab_bates_stress(app_with):
    """Regression: the stress expander used to bump a 'sigma' field Bates
    does not carry (its vol state is v0) — the Lab must price Bates with
    the stress scenarios intact."""
    app, calls = app_with({"Mode": "Derivatives Lab", "Process": "Bates",
                           "log2(paths)": 14})
    app.main()
    methods = _methods(calls)
    assert "success" in methods
    assert "dataframe" in methods  # stress table rendered
