"""Report rendering and CLI plumbing."""

import json

import numpy as np
import pytest

from montecarlo import report
from montecarlo.api import analyze_ticker, scan_tickers
from montecarlo.config import ModelConfig


@pytest.fixture(scope="module")
def analysis():
    out = analyze_ticker("AAPL", forecast_horizon=20, n_sims=500,
                         run_backtest=True, period="3y",
                         model_config=ModelConfig.fast(),
                         provider="synthetic")
    assert out is not None
    return out


def test_analysis_report_contains_all_sections(analysis):
    text = report.analysis_report(analysis)
    for token in ("Direction Accuracy", "Monte Carlo", "Expected Return",
                  "VaR 95%", "p50", "Backtest", "Sharpe Ratio",
                  "Top Features", "CV Folds"):
        assert token in text, token


def test_report_edge_banner(analysis):
    text = report.header_metrics(analysis["results"])
    assert ("PREDICTIVE EDGE" in text) == analysis["results"]["has_edge"]


def test_scan_report_sections():
    scan = scan_tickers(["AAPL", "MSFT"], forecast_horizon=20,
                        config=ModelConfig.fast(), period="3y",
                        provider="synthetic", parallel=False)
    text = report.scan_report(scan, 2, min_accuracy=50.0)
    assert "Scan complete" in text
    assert "attempted 2" in text


def test_cli_price_json(capsys):
    from montecarlo import cli

    rc = cli.main(["price", "--paths", "16384", "--steps", "16",
                   "--sampler", "antithetic"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert abs(out["price"] - out["black_scholes"]) < 5 * out["std_err"] + 0.02
    assert out["n_paths"] == 16384


def test_cli_analyze_json(capsys):
    from montecarlo import cli

    rc = cli.main(["analyze", "GOOGL", "--json", "--provider", "synthetic",
                   "--period", "3y", "--cv-folds", "3", "--estimators",
                   "50", "--sims", "500", "--no-backtest"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["ticker"] == "GOOGL"
    assert "directional_accuracy" in out["results"]
    assert "var_95" in out["mc"]


def test_cli_scan_json(capsys):
    from montecarlo import cli

    rc = cli.main(["scan", "--tickers", "AAPL,MSFT", "--mode", "fast",
                   "--provider", "synthetic", "--json", "--sequential"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["summary"]["attempted"] == 2


def test_cli_analyze_failure_exit_code():
    from montecarlo import cli

    rc = cli.main(["analyze", "SHORT", "--provider", "synthetic",
                   "--period", "1y"])
    assert rc == 1


def test_dispatch_falls_back_on_cpu():
    """On the CPU test platform the dispatcher must use the scan engine."""
    from montecarlo.engine import simulate, terminal_prices
    from montecarlo.processes import GBM

    proc = GBM.create(s0=100.0, mu=0.03, sigma=0.2, dt=1 / 252)
    a = np.asarray(terminal_prices(proc, 2048, 8, seed=3))
    b = np.asarray(simulate(proc, 2048, 8, seed=3))
    np.testing.assert_array_equal(a, b)


def test_analysis_report_without_mc_or_backtest(analysis):
    partial = dict(analysis)
    partial["mc_results"] = None
    partial["backtest_results"] = None
    text = report.analysis_report(partial)
    assert "Monte Carlo" not in text and "Backtest" not in text
    assert "Direction Accuracy" in text and "CV Folds" in text


def test_cli_greeks_pathwise_and_lr(capsys):
    from montecarlo import cli

    rc = cli.main(["greeks", "--paths", "32768", "--steps", "32",
                   "--maturity", "0.127"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert 0.0 < out["d_s0"] < 1.0  # call delta

    rc = cli.main(["greeks", "--method", "lr", "--payoff", "digital",
                   "--paths", "32768", "--steps", "32",
                   "--maturity", "0.127"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["delta"] > 0


def test_cli_calibrate_surface_csv(tmp_path, capsys):
    """calibrate --surface reads a long-form CSV and fits SABR."""
    import json

    import numpy as np

    from montecarlo.cli import main
    from montecarlo.processes import sabr_hagan_iv

    ks = np.linspace(85.0, 120.0, 8)
    ivs = np.asarray(sabr_hagan_iv(100.0, ks, 1.0, 0.2 * 100.0 ** 0.3,
                                   0.7, 0.3, -0.35))
    p = tmp_path / "surf.csv"
    p.write_text("strike,maturity,iv\n" + "\n".join(
        f"{k},1.0,{v}" for k, v in zip(ks, ivs)))
    rc = main(["--platform", "cpu", "calibrate", "--model", "sabr",
               "--surface", str(p)])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert abs(out["nu"] - 0.3) < 0.02
    assert abs(out["rho"] + 0.35) < 0.03
    assert out["rmse_vol"] < 1e-3


def test_cli_sabr_forward_compounds_rate(capsys):
    """CLI SABR must simulate the T-forward f0 = s0*e^{rT} (like app.py's
    Derivatives Lab) so its discounted price matches the risk-neutral gbm
    branch at matching vols — a bare f0 = s0 priced systematically low."""
    from montecarlo import cli

    common = ["--paths", "16384", "--steps", "16", "--s0", "100",
              "--strike", "100", "--rate", "0.05", "--sigma", "0.2",
              "--maturity", "1.0"]
    rc = cli.main(["price", "--process", "sabr", "--nu", "1e-5",
                   "--beta", "1.0", "--rho", "0.0"] + common)
    assert rc == 0
    sabr = json.loads(capsys.readouterr().out)
    rc = cli.main(["price", "--process", "gbm"] + common)
    assert rc == 0
    gbm = json.loads(capsys.readouterr().out)
    # nu~0, beta=1 SABR == lognormal forward == Black-Scholes.
    tol = 5 * (sabr["std_err"] + gbm["std_err"]) + 0.02
    assert abs(sabr["price"] - gbm["black_scholes"]) < tol
    assert abs(sabr["price"] - gbm["price"]) < tol


def test_cli_path_dependent_sobol_reports_replicated_se(capsys):
    """Asian + sobol-device must route through replicated randomizations:
    n_paths rounds to a multiple of 8 replicates and the spread-based
    std_err is materially tighter than the plain-MC iid bar."""
    from montecarlo import cli

    args = ["price", "--payoff", "asian", "--paths", "8194", "--steps",
            "16", "--seed", "3"]
    rc = cli.main(args + ["--sampler", "sobol-device"])
    assert rc == 0
    qmc = json.loads(capsys.readouterr().out)
    assert qmc["n_paths"] == 8192  # rounded to 8 replicates
    rc = cli.main(args + ["--sampler", "plain"])
    assert rc == 0
    plain = json.loads(capsys.readouterr().out)
    assert abs(qmc["price"] - plain["price"]) < 6 * (qmc["std_err"]
                                                     + plain["std_err"])
    assert qmc["std_err"] < 0.5 * plain["std_err"]


def test_cli_target_se_modes(capsys):
    """--target-se prices adaptively; RQMC mode needs far fewer paths."""
    from montecarlo import cli

    base = ["price", "--steps", "16", "--seed", "1", "--target-se"]
    rc = cli.main(base + ["0.02", "--sampler", "sobol-device"])
    assert rc == 0
    qmc = json.loads(capsys.readouterr().out)
    assert qmc["std_err"] <= 0.02
    assert abs(qmc["price"] - qmc["black_scholes"]) < 8 * qmc["std_err"]
    rc = cli.main(base + ["0.05", "--sampler", "plain"])
    assert rc == 0
    plain = json.loads(capsys.readouterr().out)
    assert plain["std_err"] <= 0.05
    import pytest

    with pytest.raises(SystemExit):
        cli.main(base + ["0.05", "--sampler", "antithetic"])
    with pytest.raises(SystemExit):
        cli.main(base + ["0.05", "--payoff", "asian"])


def test_cli_nig_matches_cf_oracle(capsys):
    """price --process nig reports a cf_price and agrees with it; Sobol
    samplers are rejected (NIG consumes IG accept uniforms)."""
    import pytest

    from montecarlo import cli

    args = ["price", "--process", "nig", "--paths", "65536", "--steps",
            "32", "--seed", "2"]
    rc = cli.main(args)
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert abs(out["price"] - out["cf_price"]) < 5 * out["std_err"] + 5e-3
    with pytest.raises(SystemExit):
        cli.main(args + ["--sampler", "sobol-device"])


def test_cli_vg_matches_cf_oracle(capsys):
    """price --process vg reports a cf_price and agrees with it; Sobol
    samplers are rejected (VG consumes gamma-inversion uniforms)."""
    import pytest

    from montecarlo import cli

    args = ["price", "--process", "vg", "--paths", "65536", "--steps",
            "32", "--seed", "2"]
    rc = cli.main(args)
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert abs(out["price"] - out["cf_price"]) < 5 * out["std_err"] + 5e-3
    with pytest.raises(SystemExit):
        cli.main(args + ["--sampler", "sobol-device"])
