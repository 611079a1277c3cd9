"""Short-rate models and fixed-income pricing vs the affine closed forms."""

import math

import jax.numpy as jnp
import numpy as np

from montecarlo.engine import simulate
from montecarlo.engine.rates import (
    bond_option_mc,
    cir_zcb,
    vasicek_bond_option,
    vasicek_zcb,
    zcb_price_mc,
)
from montecarlo.processes import CIR, HullWhite, Vasicek

R0, KAPPA, THETA, SIGMA = 0.03, 0.8, 0.05, 0.015
T = 2.0
N_STEPS = 128
DT = T / N_STEPS


def _vasicek(dtype=jnp.float64):
    return Vasicek.create(R0, KAPPA, THETA, SIGMA, DT, dtype=dtype)


def test_vasicek_exact_transition_moments():
    """The step is the exact OU transition: terminal mean/var must match the
    closed form to MC error, at ANY step count (no discretization bias)."""
    n = 1 << 16
    for steps, dt in ((4, T / 4), (N_STEPS, DT)):
        proc = Vasicek.create(R0, KAPPA, THETA, SIGMA, dt, dtype=jnp.float64)
        r_t = np.asarray(simulate(proc, n, steps, seed=2, dtype=jnp.float64))
        mean_cf = THETA + (R0 - THETA) * math.exp(-KAPPA * T)
        var_cf = SIGMA**2 / (2 * KAPPA) * (1 - math.exp(-2 * KAPPA * T))
        assert abs(r_t.mean() - mean_cf) < 4 * r_t.std() / math.sqrt(n)
        assert abs(r_t.var() - var_cf) < 0.05 * var_cf


def test_vasicek_zcb_mc_vs_closed_form():
    est = zcb_price_mc(_vasicek(), T, N_STEPS, 1 << 16, seed=3,
                       dtype=jnp.float64)
    cf = vasicek_zcb(R0, KAPPA, THETA, SIGMA, T)
    # exact transition + trapezoid integral: bias O(dt^2), tiny at 128 steps
    assert abs(float(est["price"]) - cf) < 4 * float(est["std_err"]) + 5e-5


def test_cir_zcb_mc_vs_closed_form():
    proc = CIR.create(R0, KAPPA, THETA, SIGMA, DT, dtype=jnp.float64)
    est = zcb_price_mc(proc, T, N_STEPS, 1 << 16, seed=5, dtype=jnp.float64)
    cf = cir_zcb(R0, KAPPA, THETA, SIGMA, T)
    assert abs(float(est["price"]) - cf) < 4 * float(est["std_err"]) + 3e-4


def test_cir_stays_finite_and_positive_mean():
    """Full truncation: no NaNs even with a vol violating Feller."""
    proc = CIR.create(0.02, 0.5, 0.03, 0.25, DT, dtype=jnp.float64)  # 2kθ<σ²
    r_t = np.asarray(simulate(proc, 1 << 14, N_STEPS, seed=7,
                              dtype=jnp.float64))
    assert np.isfinite(r_t).all()
    assert r_t.mean() > 0


def test_vasicek_bond_option_mc_vs_jamshidian():
    t1, t2 = 1.0, 3.0
    strike = vasicek_zcb(R0, KAPPA, THETA, SIGMA, t2) / vasicek_zcb(
        R0, KAPPA, THETA, SIGMA, t1)  # near-ATM forward
    est = bond_option_mc(_vasicek(), t1, t2, strike, 64, 1 << 16, seed=11,
                         dtype=jnp.float64)
    cf = vasicek_bond_option(R0, KAPPA, THETA, SIGMA, t1, t2, strike)
    assert abs(float(est["price"]) - cf) < 4 * float(est["std_err"]) + 5e-5


def test_hull_white_reprices_input_curve():
    """from_forward_curve: the model must reproduce the market discount
    curve P(0,T) = exp(-int f) it was fit to (up to MC + O(dt^2))."""
    n_steps = 128
    t_grid = np.arange(n_steps + 1) * DT
    fwd = 0.02 + 0.015 * (1.0 - np.exp(-t_grid)) + 0.005 * t_grid  # sloped
    hw = HullWhite.from_forward_curve(fwd, a=0.6, sigma=0.012, dt=DT,
                                      dtype=jnp.float64)
    est = zcb_price_mc(hw, T, n_steps, 1 << 16, seed=13, dtype=jnp.float64)
    # market price by (trapezoid) integration of the input forwards
    p_mkt = math.exp(-np.trapezoid(fwd, t_grid))
    assert abs(float(est["price"]) - p_mkt) < 4 * float(est["std_err"]) + 2e-4


def test_hull_white_flat_curve_reduces_to_vasicek():
    """Flat forwards + matching OU params: HW terminal distribution must
    match the Vasicek with theta chosen by the no-arbitrage drift."""
    n_steps = 64
    a, sig = 0.6, 0.012
    fwd = np.full(n_steps + 1, 0.03)
    hw = HullWhite.from_forward_curve(fwd, a=a, sigma=sig, dt=T / n_steps,
                                      dtype=jnp.float64)
    r_hw = np.asarray(simulate(hw, 1 << 15, n_steps, seed=17,
                               dtype=jnp.float64))
    # identical seed + identical transition law modulo theta(t): compare
    # moments against the exact HW mean (flat f: E r_T = f + sigma-convexity)
    assert abs(r_hw.std()
               - sig * math.sqrt((1 - math.exp(-2 * a * T)) / (2 * a))) \
        < 0.03 * r_hw.std()


def test_rate_paths_deterministic_and_shardable():
    a = np.asarray(simulate(_vasicek(), 4096, 32, seed=23,
                            dtype=jnp.float64))
    b = np.asarray(simulate(_vasicek(), 4096, 32, seed=23,
                            dtype=jnp.float64))
    off = np.asarray(simulate(_vasicek(), 2048, 32, seed=23,
                              dtype=jnp.float64, path_offset=2048))
    off2 = np.asarray(simulate(_vasicek(), 2048, 32, seed=23,
                               dtype=jnp.float64, path_offset=2048))
    assert (a == b).all()          # identical program: bitwise
    assert (off == off2).all()
    # Different shapes compile different XLA programs whose elementwise
    # fusion may differ by 1 ULP — the bitwise contract lives in the
    # fixed-block sharded estimators, not across scan-program shapes.
    np.testing.assert_allclose(a[2048:], off, rtol=1e-14)


def test_vasicek_cap_floor_parity_and_mc():
    """Cap - floor = the swap-let strip sum_i [P(0,T_i) - (1+K d)
    P(0,T_i+d)] (model-free parity, exact in the closed forms); the cap
    itself is MC-cross-checked with pathwise discounting."""
    import numpy as np
    import jax.numpy as jnp

    from montecarlo.engine.pricing import mc_estimate
    from montecarlo.engine.rates import (vasicek_bond_from_rate,
                                             vasicek_cap_price,
                                             vasicek_zcb)
    from montecarlo.engine.simulate import simulate
    from montecarlo.processes import Vasicek

    r0, kap, th, sg, k_cap, delta = 0.03, 0.8, 0.05, 0.015, 0.035, 0.25
    resets = delta * np.arange(1, 5)
    cap = float(vasicek_cap_price(r0, kap, th, sg, k_cap, resets, delta))
    floor = float(vasicek_cap_price(r0, kap, th, sg, k_cap, resets, delta,
                                    floor=True))
    parity = sum(vasicek_zcb(r0, kap, th, sg, t)
                 - (1.0 + k_cap * delta)
                 * vasicek_zcb(r0, kap, th, sg, t + delta)
                 for t in resets)
    np.testing.assert_allclose(cap - floor, parity, rtol=1e-9)

    n, n_mc = 1 << 15, 128
    mc_dt = float(resets[-1]) / n_mc
    model = Vasicek.create(r0, kap, th, sg, mc_dt, dtype=jnp.float64)
    paths = simulate(model, n, n_mc, seed=11, mode="paths",
                     dtype=jnp.float64)
    mid = 0.5 * (paths[:-1] + paths[1:]) * mc_dt
    cum = jnp.concatenate([jnp.zeros((1, n), jnp.float64),
                           jnp.cumsum(mid, axis=0)], axis=0)
    total = 0.0
    for t_i in resets:
        k_i = int(round(float(t_i) / mc_dt))
        p_i = vasicek_bond_from_rate(paths[k_i], kap, th, sg, delta)
        lib = (1.0 / p_i - 1.0) / delta
        total = total + (jnp.exp(-cum[k_i]) * p_i * delta
                         * jnp.maximum(lib - k_cap, 0.0))
    est = mc_estimate(total)
    assert abs(float(est["price"]) - cap) < 4 * float(est["std_err"])


def test_cli_bond_cap(capsys):
    import json

    from montecarlo import cli

    rc = cli.main(["bond", "--cap", "--paths", "8192"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert abs(out["mc_price"] - out["closed_form"]) \
        < 5 * out["mc_std_err"] + 1e-6
