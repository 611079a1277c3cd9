"""Multilevel Monte Carlo: coupling exactness, variance decay, accuracy,
determinism, and the cost advantage that justifies the method."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from montecarlo.engine import black_scholes_call, european_call
from montecarlo.engine.mlmc import mlmc_estimate, mlmc_level_moments
from montecarlo.processes import GBM, EulerGBM, GARCHBootstrap, Heston
from montecarlo.stats.welford import variance

S0, R, SIGMA, T, STRIKE = 100.0, 0.05, 0.2, 1.0, 100.0


def _euler(n_steps):
    return EulerGBM.create(s0=S0, mu=R, sigma=SIGMA, dt=T / n_steps,
                           dtype=jnp.float64)


def _exact(n_steps):
    return GBM.create(s0=S0, mu=R, sigma=SIGMA, dt=T / n_steps,
                      dtype=jnp.float64)


def _payoff(s):
    return european_call(s, STRIKE)


def test_coupling_exact_for_exact_scheme():
    """Log-Euler GBM is exact: fine and coarse coupled paths hit the *same*
    terminal (the coarse increment is the sum of the fine ones), so Y_l must
    vanish to float tolerance.  This pins the coupling convention itself —
    any draw-schedule or 1/sqrt(M) error would show up as O(1) variance."""
    st_y, st_p = mlmc_level_moments(_exact, _payoff, level=3, n_paths=4096,
                                    seed=11, n0_steps=4, dtype=jnp.float64)
    assert abs(float(st_y.mean)) < 1e-9
    assert float(variance(st_y)) < 1e-18
    assert float(st_p.mean) > 0  # the fine payoff itself is real


def test_variance_decay_euler():
    """Giles beta: V_l for Euler GBM decays ~O(dt_l) — each level's coupling
    variance should drop by clearly more than half per level."""
    vs = []
    for level in range(1, 5):
        st_y, _ = mlmc_level_moments(_euler, _payoff, level, n_paths=1 << 15,
                                     seed=5, n0_steps=4, dtype=jnp.float64)
        vs.append(float(variance(st_y, ddof=1)))
    for v_prev, v_next in zip(vs, vs[1:]):
        assert v_next < 0.7 * v_prev, vs


def test_mean_decay_euler():
    """Giles alpha: |E[Y_l]| decays with the level (weak error O(dt))."""
    ms = []
    for level in range(1, 5):
        st_y, _ = mlmc_level_moments(_euler, _payoff, level, n_paths=1 << 16,
                                     seed=9, n0_steps=4, dtype=jnp.float64)
        ms.append(abs(float(st_y.mean)))
    assert ms[-1] < ms[0]


def test_mlmc_prices_euler_call_to_tolerance():
    eps = 0.05
    res = mlmc_estimate(_euler, _payoff, target_rmse=eps, seed=3,
                        n0_steps=4, discount=math.exp(-R * T),
                        dtype=jnp.float64)
    bs = black_scholes_call(S0, STRIKE, R, SIGMA, T)
    # RMSE-eps estimator: allow 4 eps (catches real bias/coupling bugs while
    # keeping the statistical false-failure rate negligible).
    assert abs(res["price"] - bs) < 4 * eps, (res["price"], bs)
    assert res["std_err"] <= eps
    assert res["n_levels"] >= 3
    # Work concentrates on the coarse grids.
    assert res["levels"][0].n_paths > res["levels"][-1].n_paths


def test_mlmc_cost_advantage():
    """The point of MLMC: total work far below single-level MC at the finest
    grid for the same RMSE target."""
    res = mlmc_estimate(_euler, _payoff, target_rmse=0.02, seed=7,
                        n0_steps=4, dtype=jnp.float64)
    assert res["cost_path_steps"] < 0.5 * res["single_level_cost_est"], res


def test_mlmc_deterministic():
    a = mlmc_estimate(_euler, _payoff, target_rmse=0.05, seed=42, n0_steps=4,
                      dtype=jnp.float64)
    b = mlmc_estimate(_euler, _payoff, target_rmse=0.05, seed=42, n0_steps=4,
                      dtype=jnp.float64)
    assert a["price"] == b["price"]
    assert a["std_err"] == b["std_err"]
    assert [l.n_paths for l in a["levels"]] == [l.n_paths for l in b["levels"]]


def test_mlmc_heston_couples():
    """Heston (2 correlated draws/step) couples too: variance must decay."""
    def make(n_steps):
        return Heston.create(s0=S0, v0=0.04, kappa=1.5, theta=0.04, xi=0.4,
                             rho=-0.6, mu=R, dt=T / n_steps,
                             dtype=jnp.float64)

    vs = []
    for level in (1, 3):
        st_y, _ = mlmc_level_moments(make, _payoff, level, n_paths=1 << 14,
                                     seed=13, n0_steps=8, dtype=jnp.float64)
        vs.append(float(variance(st_y, ddof=1)))
    assert vs[1] < 0.5 * vs[0], vs


def test_mlmc_asian_variance_decay_exact_scheme():
    """payoff_on='mean': with the exact GBM scheme the only level difference
    is the monitoring grid itself, so Y_l variance decays fast (beta ~ 2)."""
    vs = []
    for level in (1, 2, 3):
        st_y, _ = mlmc_level_moments(
            _exact, lambda a: jnp.maximum(a - STRIKE, 0.0), level,
            n_paths=1 << 14, seed=21, n0_steps=4, dtype=jnp.float64,
            payoff_on="mean")
        vs.append(float(variance(st_y, ddof=1)))
    assert vs[1] < 0.5 * vs[0], vs
    assert vs[2] < 0.5 * vs[1], vs


def test_mlmc_asian_price_matches_fine_grid_oracle():
    """MLMC Asian telescopes to the fine-monitoring price: compare against
    a direct fixed-grid MC at the (dense) finest grid."""
    from montecarlo.engine.functionals import (
        ARITH_MEAN, simulate_functionals)

    payoff = lambda a: jnp.maximum(a - STRIKE, 0.0)
    res = mlmc_estimate(_exact, payoff, target_rmse=0.02, seed=5,
                        n0_steps=4, payoff_on="mean", dtype=jnp.float64,
                        discount=math.exp(-R * T))
    # dense-grid oracle (256 monitoring steps, well past the MLMC ladder)
    out = simulate_functionals(_exact(256), 1 << 17, 256, seed=99,
                               dtype=jnp.float64,
                               functionals={"avg": ARITH_MEAN})
    pay = np.maximum(np.asarray(out["avg"]) - STRIKE, 0.0)
    oracle = math.exp(-R * T) * pay.mean()
    oracle_se = math.exp(-R * T) * pay.std() / math.sqrt(pay.size)
    assert abs(res["price"] - oracle) < 4 * (0.02 + oracle_se), (
        res["price"], oracle)


def test_mlmc_sharded_level_mesh_invariant():
    """Sharded level moments are bitwise identical across mesh shapes."""
    from montecarlo.parallel import make_mesh

    outs = []
    for n_dev in (1, 2, 4):
        mesh = make_mesh(n_dev)
        st_y, st_p = mlmc_level_moments(
            _euler, _payoff, level=2, n_paths=1 << 15, seed=31, n0_steps=4,
            dtype=jnp.float64, mesh=mesh)
        outs.append((float(st_y.mean), float(variance(st_y, ddof=1)),
                     float(st_p.mean)))
    assert outs[0] == outs[1] == outs[2], outs


def test_mlmc_estimate_sharded_runs():
    from montecarlo.parallel import make_mesh

    res = mlmc_estimate(_euler, _payoff, target_rmse=0.05, seed=17,
                        n0_steps=4, dtype=jnp.float64,
                        discount=math.exp(-R * T), mesh=make_mesh(4))
    bs = black_scholes_call(S0, STRIKE, R, SIGMA, T)
    assert abs(res["price"] - bs) < 4 * 0.05, (res["price"], bs)
    assert res["std_err"] <= 0.05


def test_mlmc_rejects_bootstrap_draws():
    rng = np.random.default_rng(0)
    rets = rng.normal(0, 0.01, size=300)

    def make(n_steps):
        return GARCHBootstrap.create(returns=rets, s0=S0, var0=1e-4)

    with pytest.raises(TypeError):
        mlmc_level_moments(make, _payoff, level=1, n_paths=128, seed=1)


def test_mlmc_sharded_accepts_unaligned_chunk():
    """chunk_paths that is not a multiple of n_shards*4096 must round up to
    the shard quantum instead of crashing mid-run (review finding r2)."""
    from montecarlo.parallel import make_mesh

    res = mlmc_estimate(_euler, _payoff, target_rmse=0.08, seed=23,
                        n0_steps=4, dtype=jnp.float64,
                        chunk_paths=100_000,  # 100000 % (4*4096) != 0
                        discount=math.exp(-R * T), mesh=make_mesh(4))
    bs = black_scholes_call(S0, STRIKE, R, SIGMA, T)
    assert abs(res["price"] - bs) < 4 * 0.08
    # Every level's sampled count sits on the 4*4096 shard quantum.
    for lvl in res["levels"]:
        assert lvl.n_paths % (4 * 4096) == 0
