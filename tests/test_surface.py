"""Implied-vol surfaces from one MC run: GBM flatness, snapshot
correctness, and Heston smile shape."""

import jax.numpy as jnp
import numpy as np

from montecarlo.engine.surface import mc_implied_vol_surface
from montecarlo.processes import GBM, Heston

S0, R, SIGMA = 100.0, 0.03, 0.2


def test_gbm_surface_is_flat_at_sigma():
    """Every (K, T) cell of a GBM surface must invert back to sigma."""
    dt = 1 / 64
    proc = GBM.create(s0=S0, mu=R, sigma=SIGMA, dt=dt, dtype=jnp.float64)
    surf = mc_implied_vol_surface(
        proc, strikes=[90.0, 100.0, 110.0], step_grid=[16, 32, 64], dt=dt,
        rate=R, n_paths=1 << 16, seed=3, dtype=jnp.float64)
    assert surf["ivs"].shape == (3, 3)
    np.testing.assert_allclose(surf["ivs"], SIGMA, atol=0.01)
    np.testing.assert_allclose(surf["maturities"], [0.25, 0.5, 1.0])


def test_snapshot_matches_shorter_run():
    """The step-s snapshot of a long run equals the terminal of a run
    stopped at s (identical counter-based draws)."""
    from montecarlo.engine import simulate
    from montecarlo.engine.functionals import simulate_functionals
    from montecarlo.engine.surface import price_snapshot

    dt = 1 / 32
    proc = GBM.create(s0=S0, mu=R, sigma=SIGMA, dt=dt, dtype=jnp.float64)
    out = simulate_functionals(proc, 2048, 32, seed=5, dtype=jnp.float64,
                               functionals={"snap": price_snapshot(16)})
    short = simulate(proc, 2048, 16, seed=5, dtype=jnp.float64)
    np.testing.assert_array_equal(np.asarray(out["snap"]),
                                  np.asarray(short))


def test_heston_surface_smiles():
    """Negative spot-vol correlation must produce a downward skew (OTM
    puts richer than OTM calls)."""
    dt = 1 / 64
    proc = Heston.create(s0=S0, v0=0.04, mu=R, kappa=2.0, theta=0.04,
                         xi=0.6, rho=-0.8, dt=dt, dtype=jnp.float64)
    surf = mc_implied_vol_surface(
        proc, strikes=[80.0, 100.0, 120.0], step_grid=[64], dt=dt,
        rate=R, n_paths=1 << 16, seed=7, dtype=jnp.float64)
    ivs = surf["ivs"][0]
    assert np.isfinite(ivs).all()
    assert ivs[0] > ivs[1] > ivs[2]  # skew from rho < 0


def test_forward_start_option_via_snapshot():
    """Forward-start call max(S_T - k*S_t1, 0): priced from one run with a
    price snapshot at t1, validated against the Rubinstein closed form
    price = S0 * C_BS(spot=1, strike=k, r, sigma, T - t1)."""
    from montecarlo.engine import (black_scholes_call, mc_estimate,
                                      simulate_functionals)
    from montecarlo.engine.surface import price_snapshot

    n_steps, t1_step = 64, 32
    dt = 1.0 / n_steps
    k = 1.05
    proc = GBM.create(s0=S0, mu=R, sigma=SIGMA, dt=dt, dtype=jnp.float64)
    out = simulate_functionals(proc, 1 << 16, n_steps, seed=21,
                               dtype=jnp.float64,
                               functionals={"s1": price_snapshot(t1_step)})
    pay = jnp.maximum(out["terminal"] - k * out["s1"], 0.0)
    est = mc_estimate(pay, float(np.exp(-R * 1.0)))
    cf = S0 * float(black_scholes_call(1.0, k, R, SIGMA,
                                       (n_steps - t1_step) * dt))
    assert abs(float(est["price"]) - cf) < 4 * float(est["std_err"]), (
        float(est["price"]), cf)
