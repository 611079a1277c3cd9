"""Variance-reduction correctness (BASELINE.json config 2).

Antithetic and Sobol QMC must *reduce the standard error* of the European
call estimator vs. plain MC at equal path counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from montecarlo.engine import european_call, simulate
from montecarlo.processes import GBM
from montecarlo.samplers import AntitheticSampler, PlainSampler, SobolSampler

S0, R, SIGMA, STRIKE = 100.0, 0.03, 0.2, 100.0
N_STEPS = 16
DT = (1.0 / 252.0)


def _gbm():
    return GBM.create(s0=S0, mu=R, sigma=SIGMA, dt=DT)


def _estimator_std(sampler_factory, n_paths, n_reps):
    """Std of the estimator across independent replications (by stream)."""
    ests = []
    for rep in range(n_reps):
        sampler = sampler_factory(rep)
        s_t = simulate(_gbm(), n_paths, N_STEPS, seed=100, stream=rep,
                       sampler=sampler)
        ests.append(float(np.mean(np.asarray(european_call(s_t, STRIKE)))))
    return np.std(ests), np.mean(ests)


def test_antithetic_reduces_standard_error():
    n, reps = 4096, 24
    plain_std, plain_mean = _estimator_std(lambda r: PlainSampler(), n, reps)
    anti_std, anti_mean = _estimator_std(lambda r: AntitheticSampler(), n, reps)
    assert anti_std < plain_std, (anti_std, plain_std)
    # Same target: means agree within joint uncertainty.
    assert abs(plain_mean - anti_mean) < 5 * (plain_std + anti_std)


def test_antithetic_pairs_are_mirrored():
    """Path 2k+1 must be the exact mirror of path 2k for GBM (z -> -z)."""
    n = 1024
    s_t = np.asarray(simulate(_gbm(), n, 8, seed=4,
                              sampler=AntitheticSampler()))
    log_ret = np.log(s_t / S0)
    drift = (R - 0.5 * SIGMA**2) * DT * 8
    even, odd = log_ret[0::2], log_ret[1::2]
    np.testing.assert_allclose(even - drift, -(odd - drift), atol=1e-5)


def test_sobol_beats_plain_mc():
    n = 2048
    sob = SobolSampler.create(n, N_STEPS, n_draws=1, seed=0)
    # Sobol is deterministic given the scramble seed; replicate by scramble.
    sob_ests = []
    for rep in range(12):
        s = SobolSampler.create(n, N_STEPS, n_draws=1, seed=rep)
        s_t = simulate(_gbm(), n, N_STEPS, seed=0, sampler=s)
        sob_ests.append(float(np.mean(np.asarray(european_call(s_t, STRIKE)))))
    plain_std, plain_mean = _estimator_std(lambda r: PlainSampler(), n, 12)
    sob_std = np.std(sob_ests)
    assert sob_std < plain_std, (sob_std, plain_std)
    assert abs(np.mean(sob_ests) - plain_mean) < 5 * (plain_std + sob_std)
    assert sob.z.shape == (n, N_STEPS, 1)


def test_antithetic_stream_shard_invariant():
    from montecarlo.parallel import make_mesh, sharded_terminal

    n = 8192
    full = np.asarray(simulate(_gbm(), n, 8, seed=2,
                               sampler=AntitheticSampler()))
    mesh = make_mesh(4)
    shard = np.asarray(sharded_terminal(_gbm(), n, 8, seed=2, mesh=mesh,
                                        sampler=AntitheticSampler()))
    np.testing.assert_array_equal(full, shard)


def test_device_sobol_bits_match_scipy():
    """On-device Gray-code construction == scipy's Sobol points, bitwise."""
    import jax.numpy as jnp
    from scipy.stats import qmc

    from montecarlo.rng.sobol import BITS, direction_numbers, sobol_bits

    dims, n = 5, 64
    sv = direction_numbers(dims)
    ref = qmc.Sobol(d=dims, scramble=False, bits=BITS).random(n)
    ids = jnp.arange(n, dtype=jnp.uint32)
    for d in range(dims):
        x = np.asarray(sobol_bits(jnp.asarray(sv[d]), ids))
        np.testing.assert_allclose(x / 2.0**BITS, ref[:, d], atol=2**-BITS)


def test_device_sobol_sampler_variance_reduction():
    from montecarlo.rng.sobol import SobolDeviceSampler

    n, steps = 2048, N_STEPS
    sob_ests = []
    for rep in range(10):
        sampler = SobolDeviceSampler.create(steps, 1)
        s_t = simulate(_gbm(), n, steps, seed=100, stream=rep,
                       sampler=sampler)
        sob_ests.append(float(np.mean(np.asarray(european_call(s_t,
                                                               STRIKE)))))
    plain_std, plain_mean = _estimator_std(lambda r: PlainSampler(), n, 10)
    assert np.std(sob_ests) < plain_std
    assert abs(np.mean(sob_ests) - plain_mean) < 5 * (plain_std + 1e-9) + 0.05


def test_device_sobol_shard_invariant():
    from montecarlo.rng.sobol import SobolDeviceSampler

    sampler = SobolDeviceSampler.create(8, 1)
    n = 4096
    full = np.asarray(simulate(_gbm(), n, 8, seed=2, sampler=sampler))
    parts = [np.asarray(simulate(_gbm(), n // 2, 8, seed=2, sampler=sampler,
                                 path_offset=o)) for o in (0, n // 2)]
    np.testing.assert_array_equal(full, np.concatenate(parts))


def test_control_variate_reduces_std_err():
    """Terminal price as the control for a European call (corr ~ 0.9+)."""
    from montecarlo.engine.control_variate import cv_estimate
    from montecarlo.engine import mc_estimate

    n, steps = 1 << 15, N_STEPS
    T = steps * DT
    terminal = simulate(_gbm(), n, steps, seed=42)
    payoff = european_call(terminal, STRIKE)
    disc = float(np.exp(-R * T))
    plain = mc_estimate(payoff, disc)
    cv = cv_estimate(payoff, terminal, control_mean=S0 * np.exp(R * T),
                     discount=disc)
    assert float(cv["std_err"]) < 0.7 * float(plain["std_err"])
    assert float(cv["variance_ratio"]) < 0.5
    # Unbiasedness: both estimates agree within joint tolerance.
    assert abs(float(cv["price"]) - float(plain["price"])) < \
        4 * float(plain["std_err"])


def test_brownian_bridge_increments_are_standard_normal():
    from montecarlo.samplers import _brownian_bridge_increments

    rng = np.random.default_rng(0)
    z = rng.normal(size=(20000, 16))
    inc = _brownian_bridge_increments(z)
    assert inc.shape == z.shape
    # Marginals ~ N(0,1), increments uncorrelated (BM property preserved).
    assert np.abs(inc.mean(axis=0)).max() < 0.05
    assert np.abs(inc.std(axis=0) - 1).max() < 0.05
    cov = np.corrcoef(inc.T)
    off = cov - np.eye(16)
    assert np.abs(off).max() < 0.05


def test_bridge_sobol_unbiased_and_effective_for_asian():
    """Bridge-ordered Sobol prices the Asian call correctly and beats
    plain MC variance at equal path counts."""
    from montecarlo.engine.functionals import (
        ARITH_MEAN, asian_call, simulate_functionals)

    n, steps = 2048, 16
    ests_bridge, ests_mc = [], []
    for rep in range(10):
        sob = SobolSampler.create(n, steps, 1, seed=rep, bridge=True)
        out = simulate_functionals(_gbm(), n, steps, seed=0, sampler=sob,
                                   functionals={"avg": ARITH_MEAN})
        ests_bridge.append(float(np.mean(np.asarray(
            asian_call(out["avg"], STRIKE)))))
        out = simulate_functionals(_gbm(), n, steps, seed=0, stream=rep + 1,
                                   functionals={"avg": ARITH_MEAN})
        ests_mc.append(float(np.mean(np.asarray(
            asian_call(out["avg"], STRIKE)))))
    assert np.std(ests_bridge) < np.std(ests_mc)
    assert abs(np.mean(ests_bridge) - np.mean(ests_mc)) < \
        5 * (np.std(ests_mc) + np.std(ests_bridge)) + 1e-3


def test_importance_sampling_otm_variance_reduction():
    """OTM call (~2.6 sigma): IS matches Black-Scholes with a fraction of
    the plain-MC error."""
    from montecarlo.engine import black_scholes_call, mc_estimate
    from montecarlo.engine.importance import (
        importance_sampled_estimate,
        shift_to_strike,
    )

    strike, steps = 130.0, 64
    T = steps / 252.0
    proc = GBM.create(s0=S0, mu=R, sigma=SIGMA, dt=1 / 252)
    disc = float(np.exp(-R * T))
    bs = float(black_scholes_call(S0, strike, R, SIGMA, T))
    n = 1 << 16

    plain_t = simulate(proc, n, steps, seed=3)
    plain = mc_estimate(european_call(plain_t, strike), disc)

    shift = float(shift_to_strike(proc, strike, steps))
    is_est = importance_sampled_estimate(
        proc, lambda s: european_call(s, strike), n, steps, seed=3,
        shift=shift, discount=disc)
    assert float(is_est["std_err"]) < 0.3 * float(plain["std_err"])
    assert abs(float(is_est["price"]) - bs) < 5 * float(is_est["std_err"])


def test_importance_sampling_extreme_tail():
    """5.9-sigma OTM (K=1.8*S0): plain MC sees ZERO payoffs at 65k paths;
    IS prices it within MC tolerance of Black-Scholes (~1e-8)."""
    from montecarlo.engine import black_scholes_call
    from montecarlo.engine.importance import (
        importance_sampled_estimate,
        shift_to_strike,
    )

    strike, steps = 180.0, 64
    proc = GBM.create(s0=S0, mu=R, sigma=SIGMA, dt=1 / 252)
    disc = float(np.exp(-R * steps / 252))
    plain_t = np.asarray(simulate(proc, 1 << 16, steps, seed=3))
    assert np.max(plain_t) < strike  # plain MC is hopeless here
    shift = float(shift_to_strike(proc, strike, steps))
    out = importance_sampled_estimate(
        proc, lambda s: european_call(s, strike), 1 << 16, steps, seed=3,
        shift=shift, discount=disc)
    bs = float(black_scholes_call(S0, strike, R, SIGMA, steps / 252))
    assert abs(float(out["price"]) - bs) < 5 * float(out["std_err"])
    assert float(out["std_err"]) < 0.1 * bs


def test_importance_sampling_unbiased_atm():
    """Zero shift reduces to the plain estimator exactly."""
    from montecarlo.engine import mc_estimate
    from montecarlo.engine.importance import importance_sampled_estimate

    proc = GBM.create(s0=S0, mu=R, sigma=SIGMA, dt=1 / 252)
    n, steps = 1 << 14, 16
    plain_t = simulate(proc, n, steps, seed=5)
    plain = mc_estimate(european_call(plain_t, STRIKE))
    is0 = importance_sampled_estimate(
        proc, lambda s: european_call(s, STRIKE), n, steps, seed=5,
        shift=0.0)
    np.testing.assert_allclose(float(is0["price"]), float(plain["price"]),
                               rtol=1e-5)


def test_stratified_terminal_estimate():
    """Stratified terminal sampling: unbiased and far tighter than plain MC."""
    from montecarlo.engine import black_scholes_call, mc_estimate
    from montecarlo.engine.importance import stratified_terminal_estimate

    steps = 64
    T = steps / 252.0
    proc = GBM.create(s0=S0, mu=R, sigma=SIGMA, dt=1 / 252)
    disc = float(np.exp(-R * T))
    n = 1 << 14
    strat = stratified_terminal_estimate(
        proc, lambda s: european_call(s, STRIKE), n, seed=3, t_years=T,
        discount=disc)
    bs = float(black_scholes_call(S0, STRIKE, R, SIGMA, T))
    assert abs(float(strat["price"]) - bs) < 5 * float(strat["std_err"]) + 1e-4
    plain_t = simulate(proc, n, steps, seed=3)
    plain = mc_estimate(european_call(plain_t, STRIKE), disc)
    assert float(strat["std_err"]) < 0.1 * float(plain["std_err"])


def test_brownian_bridge_matrix_matches_host_construction():
    """B @ z must equal the host bridge's increments for arbitrary z, and
    rows must be orthonormal (increments stay i.i.d. N(0,1))."""
    from montecarlo.rng.sobol import brownian_bridge_matrix
    from montecarlo.samplers import _brownian_bridge_increments

    for T in (4, 7, 16, 63):
        b = brownian_bridge_matrix(T)
        rng = np.random.default_rng(T)
        z = rng.normal(size=(5, T))
        np.testing.assert_allclose(z @ b.T,
                                   _brownian_bridge_increments(z),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(b @ b.T, np.eye(T), atol=1e-12)


def test_device_bridge_sampler_increment_distribution():
    """Marginals of the device bridged draws are standard normal (mean/var)
    and each step's increment has unit variance — the combination weights
    and dimension bookkeeping are easy to get silently wrong."""
    from montecarlo.rng.sobol import SobolBridgeDeviceSampler
    from montecarlo.processes import GBM

    T, n = 16, 4096
    proc = GBM.create(s0=100.0, mu=0.0, sigma=0.2, dt=1.0 / T)
    sampler = SobolBridgeDeviceSampler.create(T)
    ids = jnp.arange(n, dtype=jnp.uint32)
    for t in (0, 7, 15):
        (eps,) = sampler.draws(proc, 3, 0, ids, t)
        e = np.asarray(eps, np.float64)
        assert abs(e.mean()) < 0.05, (t, e.mean())
        assert abs(e.std() - 1.0) < 0.05, (t, e.std())


def test_device_bridge_variance_reduction_matches_host_bridge():
    """The device-native bridged Sobol must beat plain MC on the European
    call like the host-precomputed bridge does (VERDICT item 9's 'done'
    criterion): RMSE over seeds within 2x of the host bridge and well
    under plain MC."""
    from montecarlo.engine.simulate import simulate
    from montecarlo.engine.payoffs import black_scholes_call
    from montecarlo.rng.sobol import SobolBridgeDeviceSampler
    from montecarlo.processes import GBM

    T, n = 32, 2048
    proc = GBM.create(s0=100.0, mu=0.03, sigma=0.2, dt=1.0 / T)
    strike, disc = 105.0, float(np.exp(-0.03))
    bs = float(black_scholes_call(100.0, 105.0, 0.03, 0.2, 1.0))

    def price(sampler, seed):
        term = simulate(proc, n, T, seed=seed, sampler=sampler)
        return disc * float(jnp.mean(jnp.maximum(term - strike, 0.0)))

    seeds = range(8)
    # Fresh LMS scramble + digital shift per replication (like the host's
    # per-seed Owen scrambling).
    err_dev = [price(SobolBridgeDeviceSampler.create(T, scramble_seed=s), s)
               - bs for s in seeds]
    err_host = [price(SobolSampler.create(n, T, 1, seed=s, bridge=True), s)
                - bs for s in seeds]
    err_plain = [price(PlainSampler(), s) - bs for s in seeds]

    rmse = lambda e: float(np.sqrt(np.mean(np.square(e))))
    assert rmse(err_dev) < 0.5 * rmse(err_plain), (
        rmse(err_dev), rmse(err_plain))
    assert rmse(err_dev) < 2.0 * rmse(err_host), (
        rmse(err_dev), rmse(err_host))


def test_garch_antithetic_unbiased_and_reduces_variance():
    """Antithetic GARCH mirrors the UNIFORM before the table gather: with a
    skewed (non-demeaned) shock table, negating gathered shocks was biased;
    u -> 1-u keeps both pair halves exact bootstrap draws."""
    from montecarlo.processes.garch import GARCHBootstrap

    rng = np.random.default_rng(0)
    rets = np.exp(rng.normal(-0.5, 0.6, size=600)) * 0.02 - 0.015  # skewed
    proc = GARCHBootstrap.create(rets, s0=100.0, var0=4e-4)
    n, steps = 1 << 13, 32

    plain = [float(np.mean(np.asarray(simulate(
        proc, n, steps, seed=s)))) for s in range(16)]
    anti = [float(np.mean(np.asarray(simulate(
        proc, n, steps, seed=s, sampler=AntitheticSampler()))))
        for s in range(16)]
    # Unbiased: the two estimator families agree within joint noise.
    se = (np.std(plain, ddof=1) + np.std(anti, ddof=1)) / np.sqrt(16)
    assert abs(np.mean(plain) - np.mean(anti)) < 5 * se + 1e-3
    # Variance-reducing: the sorted table makes u -> 1-u value-negative.
    assert np.std(anti, ddof=1) < np.std(plain, ddof=1)


def test_garch_antithetic_halves_are_bootstrap_draws():
    """Every simulated shock (both pair halves) must be a table entry."""
    from montecarlo.processes.garch import GARCHBootstrap

    rng = np.random.default_rng(1)
    rets = rng.normal(0, 0.02, size=300)
    proc = GARCHBootstrap.create(rets, s0=100.0, var0=4e-4)
    table = np.asarray(proc.table)[:int(proc.n_table)]
    paths = np.asarray(simulate(proc, 512, 4, seed=2,
                                sampler=AntitheticSampler(), mode="paths"))
    log_ret = np.diff(np.log(paths), axis=0)  # (T, N) = shock * vol
    # Reconstruct shocks from the recurrence's vol sequence is involved;
    # instead check step-1 (vol known exactly = sqrt(var0)).
    shocks1 = log_ret[0] / np.sqrt(4e-4)
    dists = np.min(np.abs(shocks1[:, None] - table[None, :]), axis=1)
    assert dists.max() < 1e-4  # every shock is (numerically) a table entry


def test_rqmc_estimate_honest_error_bar():
    """Replicated-randomization QMC: the error bar must (a) cover the true
    value and (b) be far tighter than plain MC's at the same path count."""
    from montecarlo.engine import (black_scholes_call, mc_estimate,
                                       rqmc_estimate)

    n, steps = 1 << 13, N_STEPS
    T = steps * DT
    disc = float(np.exp(-R * T))
    bs = float(black_scholes_call(S0, STRIKE, R, SIGMA, T))

    est = rqmc_estimate(_gbm(), lambda s: european_call(s, STRIKE), n,
                        steps, seed=3, n_replicates=8, discount=disc)
    se = float(est["std_err"])
    assert abs(float(est["price"]) - bs) < 6 * se + 1e-3
    plain = mc_estimate(european_call(simulate(_gbm(), n, steps, seed=3),
                                      STRIKE), disc)
    assert se < 0.3 * float(plain["std_err"])  # QMC beats MC decisively


def test_rqmc_bridge_error_bar_covers_truth():
    """Bridge-ordered RQMC with per-replicate scrambles: the replicate
    spread must cover the BS truth (digital shifts alone understated the
    error ~8x; fresh LMS scrambles fix the shift-invariant component)."""
    from montecarlo.engine import black_scholes_call, rqmc_estimate
    from montecarlo.rng.sobol import SobolBridgeDeviceSampler

    n, steps = 1 << 13, N_STEPS
    T = steps * DT
    disc = float(np.exp(-R * T))
    bs = float(black_scholes_call(S0, STRIKE, R, SIGMA, T))
    zs = []
    for seed in (1, 2, 3):
        est = rqmc_estimate(
            _gbm(), lambda s: european_call(s, STRIKE), n, steps,
            seed=seed, n_replicates=8, discount=disc,
            sampler_factory=lambda r, seed=seed:
                SobolBridgeDeviceSampler.create(steps,
                                                scramble_seed=seed + r))
        zs.append((float(est["price"]) - bs) / float(est["std_err"]))
    # Each |z| within 6 (noisy 8-rep se), and not ALL huge (systematic).
    assert all(abs(z) < 6 for z in zs), zs
    assert np.mean(np.square(zs)) < 9, zs


def test_sobol_rejected_for_non_normal_processes():
    """Sobol samplers substitute NORMALS for every draw — feeding one into
    a jump-count/bootstrap-index slot silently corrupted the distribution
    (Bates priced 0.06 vs 7.43; review r2). All engines must reject."""
    import pytest

    from montecarlo.processes import Bates, GARCHBootstrap
    from montecarlo.rng.sobol import SobolDeviceSampler
    from montecarlo.samplers import SobolSampler

    bates = Bates.create(s0=100.0, v0=0.04, mu=0.03, kappa=2.0, theta=0.04,
                         xi=0.5, rho=-0.7, lam=0.5, jump_mean=-0.08,
                         jump_std=0.15, dt=1 / 64)
    garch = GARCHBootstrap.create(
        np.random.default_rng(0).normal(0, 0.02, 300), s0=100.0, var0=4e-4)
    for proc in (bates, garch):
        with pytest.raises(ValueError, match="normals"):
            simulate(proc, 256, 8, seed=0,
                     sampler=SobolDeviceSampler.create(8, proc.n_draws))
    with pytest.raises(ValueError, match="normals"):
        simulate(garch, 256, 8, seed=0,
                 sampler=SobolSampler.create(256, 8, 1, seed=0))


def test_rqmc_one_program_matches_sequential_dispatch():
    """The scanned one-program RQMC must reproduce the replicate means of
    running each replicate as its own dispatch, bitwise (same samplers,
    same shift seeds, same mean reduction)."""
    from montecarlo.engine import rqmc_estimate, terminal_prices
    from montecarlo.rng.sobol import SobolDeviceSampler

    n, steps, n_rep = 1 << 12, N_STEPS, 4
    seed = 11
    payoff = lambda s: european_call(s, STRIKE)
    est = rqmc_estimate(_gbm(), payoff, n, steps, seed=seed,
                        n_replicates=n_rep)
    # Manual sequential replicates (the pre-round-3 code path).
    means = []
    for r in range(n_rep):
        rep_seed = (seed + 0x9E3779B9 * (r + 1)) & 0x7FFFFFFF
        smp = SobolDeviceSampler.create(steps, 1, scramble_seed=seed + r)
        t = terminal_prices(_gbm(), n // n_rep, steps, seed=rep_seed,
                            sampler=smp)
        means.append(jnp.mean(payoff(t)))
    m = jnp.stack(means)
    price = jnp.mean(m)
    se = jnp.std(m, ddof=1) / jnp.sqrt(jnp.asarray(float(n_rep), m.dtype))
    assert float(est["price"]) == float(price)
    assert float(est["std_err"]) == float(se)


def test_rqmc_functionals_honest_error_bar():
    """Path-dependent payoffs (Asian) through replicated randomizations:
    the spread-based error bar must cover an independent plain-MC price
    and beat plain MC's std-err at equal path counts."""
    from montecarlo.engine import (ARITH_MEAN, asian_call, mc_estimate,
                                       rqmc_estimate, simulate_functionals)

    n, steps = 1 << 13, N_STEPS
    proc = _gbm()
    payoff = lambda out: asian_call(out["avg"], STRIKE)
    est = rqmc_estimate(proc, payoff, n, steps, seed=5, n_replicates=8,
                        functionals={"avg": ARITH_MEAN})
    # Plain-MC oracle at 4x the paths for a tight reference price.
    out = simulate_functionals(proc, 4 * n, steps, seed=77,
                               functionals={"avg": ARITH_MEAN})
    plain_big = mc_estimate(asian_call(out["avg"], STRIKE))
    se = float(est["std_err"])
    ref = float(plain_big["price"])
    tol = 6.0 * np.hypot(se, float(plain_big["std_err"]))
    assert abs(float(est["price"]) - ref) < tol
    out_eq = simulate_functionals(proc, n, steps, seed=78,
                                  functionals={"avg": ARITH_MEAN})
    plain_eq = mc_estimate(asian_call(out_eq["avg"], STRIKE))
    assert se < 0.5 * float(plain_eq["std_err"])  # QMC decisively tighter


def test_price_to_tolerance_rqmc_coverage_and_path_savings():
    """The on-device RQMC tolerance loop: (a) reported std_err reaches the
    target, (b) the price covers Black-Scholes across seeds, (c) it needs
    far fewer paths than the plain-MC tolerance loop at the same target."""
    from montecarlo.engine import (black_scholes_call,
                                       price_to_tolerance,
                                       price_to_tolerance_rqmc)

    proc = _gbm()
    T = N_STEPS * DT
    disc = float(np.exp(-R * T))
    bs = float(black_scholes_call(S0, STRIKE, R, SIGMA, T))
    target = 0.004
    payoff = lambda s: european_call(s, STRIKE)

    zs, rqmc_paths = [], None
    for seed in (1, 2, 3):
        out = price_to_tolerance_rqmc(
            proc, payoff, target_std_err=target, seed=seed,
            n_replicates=8, chunk_paths=1 << 11, n_steps=N_STEPS,
            discount=disc, max_chunks=256)
        se = float(out["std_err"])
        assert se <= target
        assert float(out["n_paths"]) == (float(out["n_chunks"])
                                         * 8 * (1 << 11))
        zs.append((float(out["price"]) - bs) / max(se, 1e-9))
        rqmc_paths = float(out["n_paths"])
    # 8-replicate spread bars are noisy (7 dof): each |z| bounded, and the
    # three runs must not be systematically biased together.
    assert all(abs(z) < 8 for z in zs), zs
    assert np.mean(np.square(zs)) < 16, zs

    plain = price_to_tolerance(
        proc, payoff, target_std_err=target, seed=1,
        chunk_paths=1 << 13, n_steps=N_STEPS, discount=disc,
        max_chunks=4096)
    assert float(plain["std_err"]) <= target
    assert rqmc_paths < 0.25 * float(plain["n_paths"]), (
        rqmc_paths, float(plain["n_paths"]))
