#!/usr/bin/env python
"""Smoke run of the Monte Carlo engine's main path on one GPU.

    python chip_smoke.py                # every one-card phase
    python chip_smoke.py --four-cards   # only the cross-card phase, 4 cards

Drives the system through the entry points a user calls — the ``price``
CLI, ``garch_monte_carlo``, ``portfolio_var_on_device``, ``lsm_price``,
``terminal_prices`` — at full size, in one process, and compares every
result with an independent reference at a stated tolerance.  Every line
before the last is one JSON check: the value, its reference, the tolerance
and the reason for it, the compile seconds (first call minus second call)
and the device's ``peak_bytes_in_use``.  A failed check stops the run with
a non-zero exit and no result.

The last line is ``{"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": N}}``.  The script needs a GPU: anywhere else it exits non-zero
before printing a result.
"""

from __future__ import annotations

import json
import math
import sys
import time
from typing import NamedTuple

import numpy as np

# --------------------------------------------------------------------------
# Reporting


class CheckFailed(AssertionError):
    """A phase's result left its tolerance."""


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def check(phase: str, name: str, value, reference, tol, reason: str,
          *, compile_s=None, run_s=None, passed=None, **extra) -> dict:
    """Print one check line; raise CheckFailed when it fails.  ``passed``
    overrides the default ``|value - reference| <= tol`` test (for
    bitwise and one-sided checks)."""
    if passed is None:
        passed = bool(abs(float(value) - float(reference)) <= float(tol))
    line = {"phase": phase, "check": name, "value": value,
            "reference": reference, "tolerance": tol, "reason": reason,
            "ok": bool(passed), "compile_s": compile_s, "run_s": run_s,
            "peak_bytes_in_use": _peak_bytes(), **extra}
    print(json.dumps(line, default=float), flush=True)
    if not passed:
        raise CheckFailed(f"{phase}/{name}: {value} vs {reference} "
                          f"(tolerance {tol})")
    return line


def timed_twice(fn):
    """(result, compile_s, run_s): the first call compiles and runs, the
    second only runs; both are fenced with block_until_ready."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    run = time.perf_counter() - t0
    return out, max(first - run, 0.0), run


def black_scholes_call(s0, k, r, sigma, t) -> float:
    """Closed form in f64, independent of the library's own."""
    d1 = (math.log(s0 / k) + (r + 0.5 * sigma ** 2) * t) / (sigma
                                                            * math.sqrt(t))
    d2 = d1 - sigma * math.sqrt(t)
    cdf = lambda x: 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))
    return s0 * cdf(d1) - k * math.exp(-r * t) * cdf(d2)


def numpy_garch_oracle(returns, s0, var0, n_sims, n_days, rng):
    """The reference app's bootstrap-GARCH recurrence in f64 NumPy (the
    oracle `tests/test_reference_parity.py` holds)."""
    import os

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from test_reference_parity import numpy_garch_oracle as oracle

    return oracle(returns, s0, var0, n_sims, n_days, rng)


# --------------------------------------------------------------------------
# Phases (each takes its sizes; the defaults are the full sizes)


def phase_price(n_paths=1 << 20, n_steps=252, target_se=1e-3):
    """The ``price`` CLI's --target-se loop (plain and sobol-device) and a
    fixed-path European call through ``terminal_prices``, each against
    Black-Scholes."""
    import contextlib
    import io

    from montecarlo.cli import main as cli_main
    from montecarlo.engine import european_call, mc_estimate
    from montecarlo.engine.dispatch import terminal_prices
    from montecarlo.processes import GBM

    s0, k, r, sigma, t = 100.0, 105.0, 0.03, 0.2, 1.0
    bs = black_scholes_call(s0, k, r, sigma, t)
    for sampler in ("plain", "sobol-device"):
        argv = ["price", "--process", "gbm", "--s0", str(s0), "--strike",
                str(k), "--rate", str(r), "--sigma", str(sigma),
                "--maturity", str(t), "--steps", str(n_steps),
                "--sampler", sampler, "--target-se", str(target_se)]

        def run():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli_main(argv)
            if rc != 0:
                raise CheckFailed(f"price CLI exited {rc}")
            return json.loads(buf.getvalue().strip().splitlines()[-1])

        out, compile_s, run_s = timed_twice(run)
        check("price", f"cli --target-se {target_se} --sampler {sampler}",
              out["price"], bs, 5 * out["std_err"],
              "5 reported std-errs of the MC estimate; log-Euler GBM has no "
              "discretization bias", compile_s=compile_s, run_s=run_s,
              std_err=out["std_err"], n_paths=out["n_paths"])
        check("price", f"cli --sampler {sampler} std_err <= target",
              out["std_err"], target_se, 0.0, "the loop's stopping rule",
              passed=out["std_err"] <= target_se)

    proc = GBM.create(s0=s0, mu=r, sigma=sigma, dt=t / n_steps)
    disc = math.exp(-r * t)
    est, compile_s, run_s = timed_twice(lambda: mc_estimate(european_call(
        terminal_prices(proc, n_paths, n_steps, seed=11), k), disc))
    check("price", f"terminal_prices {n_paths}x{n_steps} European call",
          float(est["price"]), bs, 5 * float(est["std_err"]),
          "5 std-errs of the MC estimate", compile_s=compile_s, run_s=run_s,
          std_err=float(est["std_err"]))


def _synthetic_history(period: str):
    from montecarlo.data import get_stock_data

    data = get_stock_data("SYN", period, provider="synthetic")
    if data is None:
        raise CheckFailed(f"synthetic provider returned no {period} history")
    return data


def phase_garch(n_sims=1 << 20, n_days=20, ui_sims=5000, ui_days=60,
                n_oracle_reps=20):
    """``garch_monte_carlo`` on the synthetic 5y history — terminal mode at
    full size and the reference UI's maximum in paths mode — against the
    f64 NumPy oracle of the reference recurrence."""
    from montecarlo.api import garch_monte_carlo

    data = _synthetic_history("5y")
    s0 = float(data["Close"][-1])
    returns = np.asarray(data["log_ret"], np.float64)
    returns = returns[~np.isnan(returns)]
    var0 = float(data["rvol_20"][-1]) ** 2 / 252.0
    for sims, days, keep_paths in ((n_sims, n_days, False),
                                   (ui_sims, ui_days, True)):
        ours, compile_s, run_s = timed_twice(lambda: garch_monte_carlo(
            data, sims, days, s0, seed=4, keep_paths=keep_paths))
        rng = np.random.default_rng(0)
        reps = [numpy_garch_oracle(returns, s0, var0, sims, days, rng)
                for _ in range(n_oracle_reps)]
        mode = "paths" if keep_paths else "terminal"
        for key in ("expected_return", "expected_vol", "prob_profit",
                    "var_95", "cvar_95"):
            vals = [rep[key] for rep in reps]
            se = max(float(np.std(vals, ddof=1)), 1e-6)
            check("garch", f"{mode} {sims}x{days} {key}", ours[key],
                  float(np.mean(vals)), 5 * se,
                  f"5 std-devs of the oracle over {n_oracle_reps} "
                  "independent replications (the estimator's std-err at "
                  "this path count)",
                  compile_s=compile_s, run_s=run_s)
            compile_s = run_s = None
        finite = bool(np.isfinite(ours["final_prices"]).all())
        check("garch", f"{mode} final prices finite, shape", finite, True, 0,
              "every path finite", passed=finite
              and ours["final_prices"].shape == (sims,))


def fusable_catalogue(n_curve_steps: int = 64):
    """One instance of every process the fused kernel runs."""
    import jax.numpy as jnp

    from montecarlo.processes import (CIR, G2PP, GBM, NIG, SABR, Bates,
                                      BatesQE, BasketGBM, CCCGarch,
                                      DCCGarch, EulerGBM, GARCHBootstrap,
                                      Heston, HestonQE, HullWhite, Kou,
                                      LocalVolGBM, Merton, TermBasketGBM,
                                      TermStructureGBM, VarianceGamma,
                                      Vasicek, slv_to_kernel)
    from montecarlo.processes.slv import calibrate_slv

    dt, n = 1 / 252, n_curve_steps
    corr = np.array([[1.0, 0.5, 0.2], [0.5, 1.0, 0.4], [0.2, 0.4, 1.0]])
    s3, w3 = [100.0, 50.0, 75.0], [0.5, 0.3, 0.2]
    heston = dict(s0=100.0, v0=0.04, kappa=2.0, theta=0.04, xi=0.5,
                  rho=-0.7)
    jumps = dict(lam=0.5, jump_mean=-0.1, jump_std=0.15)
    rng = np.random.default_rng(0)
    lv = LocalVolGBM.create(
        100.0, 0.03, 1 / n, n,
        lambda t, s: 0.2 - 0.1 * np.log(np.maximum(s, 1e-9) / 100.0),
        x_min=-0.9, x_max=0.9)
    slv = calibrate_slv(lv, v0=0.04, kappa=2.0, theta=0.04, xi=0.8,
                        rho=-0.6, n_steps=n, n_particles=1 << 14, seed=3)
    return {
        "gbm": GBM.create(s0=100.0, mu=0.03, sigma=0.2, dt=dt),
        "garch": GARCHBootstrap.create(rng.normal(0, 0.02, 504), s0=100.0,
                                       var0=4e-4),
        "heston": Heston.create(mu=0.03, dt=dt, **heston),
        "heston_qe": HestonQE.create(mu=0.03, dt=dt, **heston),
        "bates": Bates.create(mu=0.03, dt=dt, **heston, **jumps),
        "bates_qe": BatesQE.create(mu=0.03, dt=dt, **heston, **jumps),
        "merton": Merton.create(s0=100.0, mu=0.03, sigma=0.2, dt=dt,
                                **jumps),
        "kou": Kou.create(s0=100.0, mu=0.03, sigma=0.2, lam=1.0, p_up=0.4,
                          eta1=10.0, eta2=5.0, dt=dt),
        "nig": NIG.create(s0=100.0, mu=0.03, alpha=15.0, beta=-3.0,
                          delta=0.5, dt=dt),
        "vg": VarianceGamma.create(s0=100.0, mu=0.03, sigma=0.2,
                                   theta=-0.1, nu=0.2, dt=dt),
        "sabr": SABR.create(f0=100.0, alpha=0.2 * 100 ** 0.3, beta=0.7,
                            nu=0.4, rho=-0.3, dt=dt),
        "euler_gbm": EulerGBM.create(s0=100.0, mu=0.03, sigma=0.2, dt=dt),
        "basket": BasketGBM.create(s0=s3, mu=[0.03, 0.02, 0.04],
                                   sigma=[0.2, 0.3, 0.25], corr=corr,
                                   dt=dt, weights=w3),
        "ccc_garch": CCCGarch.create(
            s0=s3, var0=[2e-4, 4e-4, 3e-4], omega=[1e-5] * 3,
            alpha=[0.1] * 3, beta=[0.85] * 3, corr=corr, weights=w3),
        "dcc_garch": DCCGarch.create(
            s0=s3, var0=[2e-4, 4e-4, 3e-4], omega=[1e-5] * 3,
            alpha=[0.1] * 3, beta=[0.85] * 3, qbar=corr, weights=w3,
            a_dcc=0.05, b_dcc=0.9),
        "local_vol": lv,
        "slv": slv,
        "slv_knots": slv_to_kernel(slv, n_time_knots=8),
        "term_gbm": TermStructureGBM.from_curves(
            100.0, rng.uniform(0.0, 0.05, n), rng.uniform(0.1, 0.3, n), dt),
        "term_basket": TermBasketGBM.create(
            s3, np.tile(np.array([[0.03], [0.02], [0.04]]), (1, n)),
            np.tile(np.array([[0.2], [0.3], [0.25]]), (1, n)), corr, w3,
            dt),
        "vasicek": Vasicek.create(r0=0.03, kappa=0.5, theta=0.04,
                                  sigma=0.01, dt=dt),
        "cir": CIR.create(r0=0.03, kappa=0.5, theta=0.04, sigma=0.05,
                          dt=dt),
        "hull_white": HullWhite.create(0.03, 0.1, 0.01,
                                       np.full(n, 0.004), dt),
        "g2pp": G2PP.create(0.03, 0.8, 0.01, 0.08, 0.012, -0.7, 1 / 64,
                            dtype=jnp.float32),
    }


#: Processes whose kernel and scan terminals may differ by FMA contraction
#: (their step offers mul->add contraction sites that the two compilations
#: resolve differently); every other process is bitwise.
ULP_TIGHT = {"heston_qe", "bates_qe", "nig"}
ULP_RTOL = 2e-6


def phase_kernel(n_paths=1 << 20, n_steps=1024, big=("gbm", "garch",
                                                      "heston"),
                 n_small=1 << 16, small_steps=64, processes=None,
                 target_se=1e-3, ptt_chunk=1 << 22, rqmc_chunk=1 << 18,
                 interpret=False):
    """The fused path kernel against the scan engine: every fusable process
    at (n_small x small_steps) for parity, the three headline processes at
    (n_paths x n_steps) timed against the scan engine, and wall-clock to
    std-err ``target_se`` through price_to_tolerance(_rqmc) with the kernel
    and with the scan engine."""
    import jax
    import jax.numpy as jnp

    from montecarlo.engine import price_to_tolerance, price_to_tolerance_rqmc
    from montecarlo.engine.simulate import simulate
    from montecarlo.ops.fused_engine import fused_terminal_pallas

    cat = fusable_catalogue()
    names = processes or tuple(cat)

    def compare(name, n, t, label):
        proc = cat[name]
        ker_fn = jax.jit(lambda p: fused_terminal_pallas(
            p, n, t, seed=5, interpret=interpret))
        scan_fn = jax.jit(lambda p: simulate(p, n, t, seed=5))
        ker, k_compile, k_run = timed_twice(lambda: ker_fn(proc))
        ref, s_compile, s_run = timed_twice(lambda: scan_fn(proc))
        ker, ref = np.asarray(ker), np.asarray(ref)
        rel = float(np.max(np.abs(ker - ref)
                           / np.maximum(np.abs(ref), 1e-30)))
        if name in ULP_TIGHT:
            tol, reason = ULP_RTOL, ("FMA contraction differs between the "
                                     "two compilations (max relative diff)")
        else:
            tol, reason = 0.0, "bitwise: same draws, same step arithmetic"
        check("kernel", f"{label} {name} {n}x{t} kernel vs scan", rel, 0.0,
              tol, reason, compile_s=k_compile, run_s=k_run,
              scan_compile_s=s_compile, scan_run_s=s_run,
              kernel_path_steps_per_s=n * t / k_run,
              scan_path_steps_per_s=n * t / s_run,
              bitwise=bool(np.array_equal(ker, ref)),
              passed=bool(np.isfinite(ker).all()) and rel <= tol)

    for name in names:
        compare(name, n_small, small_steps, "parity")
    for name in big:
        compare(name, n_paths, n_steps, "timed")

    gbm = cat["gbm"]
    disc = math.exp(-0.03)
    bs = black_scholes_call(100.0, 100.0, 0.03, 0.2, 1.0)
    pay = lambda s: jnp.maximum(s - 100.0, 0.0)
    for label, fn, chunk in (("price_to_tolerance", price_to_tolerance,
                              ptt_chunk),
                             ("price_to_tolerance_rqmc",
                              price_to_tolerance_rqmc, rqmc_chunk)):
        runs = {}
        for use_fused in (True, False):
            runs[use_fused] = timed_twice(lambda: fn(
                gbm, pay, target_std_err=target_se, seed=1, n_steps=252,
                discount=disc, chunk_paths=chunk, use_fused=use_fused))
        (est, k_compile, k_run), (_, _, s_run) = runs[True], runs[False]
        check("kernel", f"{label} GBM 1y ATM call to std-err {target_se}",
              float(est["price"]), bs, 5 * float(est["std_err"]),
              "5 reported std-errs; wall-clock with the kernel (run_s) and "
              "with the scan engine (scan_run_s)", compile_s=k_compile,
              run_s=k_run, scan_run_s=s_run, n_paths=float(est["n_paths"]))


def phase_var(n_paths=1 << 28, n_days=20, exact_paths=1 << 24,
              chunk_paths=1 << 24):
    """``portfolio_var_on_device`` for GARCH: the histogram-sketch VaR/CVaR
    against an exact sort of an ``exact_paths`` run."""
    from montecarlo.api.var import portfolio_var_on_device
    from montecarlo.engine.dispatch import terminal_prices
    from montecarlo.processes import GARCHBootstrap

    data = _synthetic_history("5y")
    returns = np.asarray(data["log_ret"], np.float64)
    returns = returns[~np.isnan(returns)]
    s0 = float(data["Close"][-1])
    proc = GARCHBootstrap.create(
        returns, s0=s0, var0=float(data["rvol_20"][-1]) ** 2 / 252.0)
    sk, compile_s, run_s = timed_twice(lambda: portfolio_var_on_device(
        proc, n_paths, n_days, s0, seed=3, chunk_paths=chunk_paths))
    term = np.sort(np.asarray(terminal_prices(proc, exact_paths, n_days,
                                              seed=3), np.float64))
    p5 = float(np.percentile(term, 5))
    tail = term[term <= p5]
    exact_var = (s0 - p5) / s0 * 100.0
    exact_cvar = (s0 - tail.mean()) / s0 * 100.0
    # Sampling std-err of the exact run's 5% quantile: order-statistic
    # spread over +-sqrt(n p (1-p)) ranks.
    m = int(math.sqrt(exact_paths * 0.05 * 0.95))
    k = int(0.05 * exact_paths)
    q_se = (term[k + m] - term[k - m]) / 2.0 / s0 * 100.0
    cvar_se = float(tail.std() / math.sqrt(tail.size)) / s0 * 100.0
    check("var", f"VaR95 sketch {n_paths} vs exact sort {exact_paths}",
          sk["var_95"], exact_var,
          sk["var_95_grid_err"] + 4 * math.hypot(q_se, sk["var_95_std_err"]),
          "one bin width (grid error) + 4 sampling std-errs",
          compile_s=compile_s, run_s=run_s,
          path_steps_per_s=n_paths * n_days / run_s)
    check("var", f"CVaR95 sketch {n_paths} vs exact sort {exact_paths}",
          sk["cvar_95"], exact_cvar,
          sk["cvar_95_grid_err"] + 4 * math.hypot(q_se, cvar_se),
          "1.5 bin widths (grid error) + 4 sampling std-errs")


class F32Normals(NamedTuple("F32NormalsFields", [])):
    """Sampler: the process's own f32 draws, cast to the run's dtype — an
    f64 reference run then walks the same normals as the f32 run."""

    def draws(self, process, seed, stream, path_ids, t, dtype=None):
        import jax.numpy as jnp

        return tuple(e.astype(dtype) for e in process.draws(
            seed, stream, path_ids, t, jnp.float32))


def phase_precision(lsm_paths=1 << 18, lsm_steps=50, n_assets=50,
                    basket_paths=1 << 15, basket_steps=50):
    """f32 contractions at full precision: the LSM American put against the
    CRR tree, and a 50-asset basket call on the device against the f64 scan
    on the host CPU at a matched seed."""
    import jax
    import jax.numpy as jnp

    from montecarlo.engine.american import binomial_american_put, lsm_price
    from montecarlo.engine.simulate import simulate
    from montecarlo.processes import GBM, MultiGBM

    r, sigma, t, s0, k = 0.06, 0.2, 1.0, 36.0, 40.0
    proc = GBM.create(s0=s0, mu=r, sigma=sigma, dt=t / lsm_steps)
    out, compile_s, run_s = timed_twice(lambda: lsm_price(
        proc, lambda s: jnp.maximum(k - s, 0.0), lsm_paths, lsm_steps,
        seed=11, rate=r, dt=t / lsm_steps, degree=3))
    tree = binomial_american_put(s0, k, r, sigma, t, n_steps=2000)
    check("precision", f"LSM put {lsm_paths}x{lsm_steps} vs CRR",
          float(out["price"]), tree, 4 * float(out["std_err"]) + 0.05,
          f"4 std-errs + 0.05 for LSM's low bias at {lsm_steps} exercise dates",
          compile_s=compile_s, run_s=run_s, std_err=float(out["std_err"]))

    rng = np.random.default_rng(1)
    a = rng.normal(size=(n_assets, n_assets))
    cov = a @ a.T + n_assets * np.eye(n_assets)
    d = np.sqrt(np.diag(cov))
    corr = cov / np.outer(d, d)
    kw = dict(s0=np.full(n_assets, 100.0), mu=np.full(n_assets, 0.03),
              sigma=rng.uniform(0.15, 0.35, n_assets), corr=corr,
              dt=1.0 / basket_steps)

    def basket_values(dtype):
        proc = MultiGBM.create(dtype=dtype, **kw)
        return jnp.mean(simulate(proc, basket_paths, basket_steps, seed=5,
                                 dtype=dtype, sampler=F32Normals()), axis=1)

    dev, compile_s, run_s = timed_twice(lambda: basket_values(jnp.float32))
    dev = np.asarray(dev, np.float64)
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        host = np.asarray(basket_values(jnp.float64))
    rel = float(np.max(np.abs(dev - host) / host))
    check("precision", f"{n_assets}-asset basket {basket_paths}x"
          f"{basket_steps} device f32 vs host f64 (max rel, per path)",
          rel, 0.0, 2e-5,
          "same f32 normals; f32 rounding of the log-price over the steps "
          "(~1e-6) — a TF32 correlation matmul would show ~1e-4",
          compile_s=compile_s,
          run_s=run_s, passed=rel <= 2e-5)
    pay = lambda v: np.maximum(v - 100.0, 0.0)
    price_dev, price_host = pay(dev).mean(), pay(host).mean()
    check("precision", f"{n_assets}-asset basket call price, device vs host",
          price_dev, price_host, 1e-4 * max(price_host, 1.0),
          "same paths to 2e-5 per path, so 1e-4 relative on the mean")


def phase_four_cards(n_cards=4, mc_paths=1 << 24, mc_steps=252,
                     sketch_paths=1 << 24, sketch_days=20,
                     lsm_paths=1 << 18, lsm_steps=50, xva_paths=1 << 16,
                     xva_steps=64, block=4096, xva_block=1024):
    """The sharded estimators on an ``n_cards`` mesh against the one-card
    mesh: bitwise equality is the mesh-invariance contract."""
    import jax
    import jax.numpy as jnp

    from montecarlo.engine.exposure import CSA, swap_value_fn
    from montecarlo.parallel import (make_mesh, sharded_lsm_price,
                                     sharded_mc_estimate,
                                     sharded_netting_profile,
                                     sharded_terminal_sketch)
    from montecarlo.processes import GBM, GARCHBootstrap, Vasicek

    devices = jax.devices()
    if len(devices) < n_cards:
        raise CheckFailed(f"{n_cards} cards needed, {len(devices)} found")
    meshes = {n_cards: make_mesh(n_cards, devices=devices[:n_cards]),
              1: make_mesh(1, devices=devices[:1])}
    gbm = GBM.create(s0=100.0, mu=0.03, sigma=0.2, dt=1.0 / mc_steps)
    garch = GARCHBootstrap.create(
        np.random.default_rng(0).normal(0, 0.02, 1260), s0=100.0,
        var0=4e-4)
    put_gbm = GBM.create(s0=36.0, mu=0.06, sigma=0.2, dt=1.0 / lsm_steps)
    vas = Vasicek.create(0.03, 0.6, 0.04, 0.012, 2.0 / xva_steps)
    pay_times = np.arange(1, 5) * 0.5
    v1 = swap_value_fn(vas, 0.035, pay_times, 0.5)
    v2 = swap_value_fn(vas, 0.04, pay_times[:2], 0.5)
    trades = (v1, lambda r, t: -0.5 * v2(r, t))
    runs = {
        "sharded_mc_estimate": lambda mesh: sharded_mc_estimate(
            gbm, lambda s: jnp.maximum(s - 105.0, 0.0), mc_paths, mc_steps,
            seed=7, mesh=mesh, block_size=block),
        "sharded_terminal_sketch": lambda mesh: sharded_terminal_sketch(
            garch, sketch_paths, sketch_days, seed=7, mesh=mesh, lo=50.0,
            hi=150.0, block_size=block),
        "sharded_lsm_price": lambda mesh: sharded_lsm_price(
            put_gbm, lambda s: jnp.maximum(40.0 - s, 0.0), lsm_paths,
            lsm_steps, seed=7, rate=0.06, dt=1.0 / lsm_steps, mesh=mesh,
            degree=3, block_size=block),
        "sharded_netting_profile": lambda mesh: sharded_netting_profile(
            vas, trades, xva_paths, xva_steps, T=2.0, seed=7, mesh=mesh,
            hazard_rate=0.02, funding_spread=0.004,
            csa=CSA(threshold=0.002, mta=0.0005, mpor=4 * 2.0 / xva_steps),
            block_size=xva_block, dtype=jnp.float32),
    }
    for name, run in runs.items():
        one, _, one_s = timed_twice(lambda: run(meshes[1]))
        many, compile_s, run_s = timed_twice(lambda: run(meshes[n_cards]))
        a = [np.asarray(x) for x in jax.tree.leaves(one)]
        b = [np.asarray(x) for x in jax.tree.leaves(many)]
        same = len(a) == len(b) and all(
            x.shape == y.shape and np.array_equal(x, y)
            for x, y in zip(a, b))
        diff = max((float(np.max(np.abs(x.astype(np.float64)
                                        - y.astype(np.float64))))
                    for x, y in zip(a, b) if x.size), default=0.0)
        check("four_cards", f"{name} mesh({n_cards}) vs mesh(1)", diff, 0.0,
              0.0, "bitwise: the mesh-invariance contract", passed=same,
              compile_s=compile_s, run_s=run_s, one_card_run_s=one_s,
              n_leaves=len(a))


ONE_CARD_PHASES = (phase_price, phase_garch, phase_kernel, phase_var,
                   phase_precision)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"chip_smoke.py: needs a GPU, JAX's first device is "
              f"{platform!r}", file=sys.stderr)
        return 2
    from montecarlo import device
    from montecarlo.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    if "--four-cards" in argv:
        phase_four_cards()
    else:
        for phase in ONE_CARD_PHASES:
            phase()
    print(f"card: {device.card_name_and_power_limit()}", flush=True)
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
