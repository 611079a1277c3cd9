"""Sharding tests on the virtual 8-device CPU mesh.

The headline guarantee: estimates are **bitwise identical across mesh
shapes** (1, 2, 4, 8 devices) at a fixed seed — the property the reference
app cannot have (unseeded global RNG, app.py:620).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from montecarlo.engine import european_call, simulate
from montecarlo.parallel import (
    make_mesh,
    sharded_mc_estimate,
    sharded_terminal,
    sharded_terminal_sketch,
)
from montecarlo.processes import GBM
from montecarlo.stats import sketch_quantile

N_PATHS = 1 << 15
N_STEPS = 32
BLOCK = 1024
S0, STRIKE = 100.0, 105.0


def _gbm():
    return GBM.create(s0=S0, mu=0.03, sigma=0.2, dt=1 / 252)


def _payoff(s):
    return european_call(s, STRIKE)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_terminal_matches_unsharded():
    mesh = make_mesh(8)
    sharded = np.asarray(sharded_terminal(_gbm(), N_PATHS, N_STEPS, seed=3,
                                          mesh=mesh))
    local = np.asarray(simulate(_gbm(), N_PATHS, N_STEPS, seed=3))
    np.testing.assert_array_equal(sharded, local)


@pytest.fixture(scope="module")
def _mesh1_reference():
    mesh = make_mesh(1)
    return sharded_mc_estimate(_gbm(), _payoff, N_PATHS, N_STEPS, seed=11,
                               mesh=mesh, block_size=BLOCK)


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_estimate_bitwise_invariant_across_mesh_shapes(ndev,
                                                       _mesh1_reference):
    # (ndev=1 vs itself would be vacuous; the reference IS the 1-mesh run,
    # computed once per module instead of per parametrization.)
    mesh = make_mesh(ndev)
    est = sharded_mc_estimate(_gbm(), _payoff, N_PATHS, N_STEPS, seed=11,
                              mesh=mesh, block_size=BLOCK)
    ref = _mesh1_reference
    assert float(est["price"]) == float(ref["price"])  # bitwise
    assert float(est["std_err"]) == float(ref["std_err"])
    assert int(est["n_paths"]) == N_PATHS


def test_sharded_estimate_statistically_correct():
    from montecarlo.engine import black_scholes_call, discount_factor

    mesh = make_mesh(8)
    est = sharded_mc_estimate(
        _gbm(), _payoff, 1 << 17, 64, seed=5, mesh=mesh, block_size=BLOCK,
        discount=float(discount_factor(0.03, 64 / 252)),
    )
    bs = float(black_scholes_call(S0, STRIKE, 0.03, 0.2, 64 / 252))
    assert abs(float(est["price"]) - bs) < 4 * float(est["std_err"])


def test_sketch_quantiles_close_to_exact():
    mesh = make_mesh(8)
    sketch, moments = sharded_terminal_sketch(
        _gbm(), N_PATHS, N_STEPS, seed=7, mesh=mesh, lo=40.0, hi=250.0,
        bins=4096, block_size=BLOCK,
    )
    terminal = np.asarray(simulate(_gbm(), N_PATHS, N_STEPS, seed=7))
    for q in (5.0, 50.0, 95.0):
        exact = np.percentile(terminal, q)
        approx = float(sketch_quantile(sketch, q))
        bin_w = (250.0 - 40.0) / 4096
        assert abs(approx - exact) < 3 * bin_w, (q, approx, exact)
    # Moments agree with the sample exactly (same blocks, same tree).
    assert abs(float(moments.mean) - terminal.mean()) < 1e-3
    assert int(moments.count) == N_PATHS


def test_sketch_bitwise_invariant_across_mesh_shapes():
    results = []
    for ndev in (1, 2, 8):
        sketch, moments = sharded_terminal_sketch(
            _gbm(), N_PATHS, N_STEPS, seed=7, mesh=make_mesh(ndev),
            lo=40.0, hi=250.0, bins=512, block_size=BLOCK,
        )
        results.append((np.asarray(sketch.counts), float(moments.mean)))
    for counts, mean in results[1:]:
        np.testing.assert_array_equal(counts, results[0][0])
        assert mean == results[0][1]


def test_two_axis_mesh_paths_sharding():
    """A 2-D (paths x assets) mesh: estimates still bitwise-match 1-D."""
    mesh2d = make_mesh(n_path_shards=4, n_asset_shards=2)
    assert mesh2d.shape == {"paths": 4, "assets": 2}
    est = sharded_mc_estimate(_gbm(), _payoff, N_PATHS, N_STEPS, seed=11,
                              mesh=mesh2d, block_size=BLOCK)
    ref = sharded_mc_estimate(_gbm(), _payoff, N_PATHS, N_STEPS, seed=11,
                              mesh=make_mesh(1), block_size=BLOCK)
    assert float(est["price"]) == float(ref["price"])
    assert float(est["std_err"]) == float(ref["std_err"])


def test_asset_axis_sharded_basket():
    """2-D (paths x assets) basket sharding: correlated draws regenerate
    locally (no collectives in the loop); matches the unsharded engine."""
    from montecarlo.engine import simulate
    from montecarlo.parallel import sharded_basket_estimate
    from montecarlo.processes import BasketGBM

    corr = np.eye(4) * 0.6 + 0.4
    basket = BasketGBM.create(
        s0=[100.0, 50.0, 75.0, 120.0], mu=[0.03] * 4,
        sigma=[0.2, 0.3, 0.25, 0.15], corr=corr,
        weights=[0.25] * 4, dt=1 / 252)
    n, steps = 1 << 13, 16
    payoff = lambda v: jnp.maximum(v - 85.0, 0.0)

    mesh2 = make_mesh(n_path_shards=4, n_asset_shards=2)
    est = sharded_basket_estimate(basket, payoff, n, steps, seed=9,
                                  mesh=mesh2, block_size=512)
    # Reference: unsharded scan engine on the same basket.
    vals = np.asarray(payoff(simulate(basket, n, steps, seed=9)))
    assert abs(float(est["price"]) - vals.mean()) < 1e-3
    assert int(est["n_paths"]) == n

    # Bitwise invariance across PATH shardings at fixed asset sharding.
    mesh1 = make_mesh(n_path_shards=2, n_asset_shards=2)
    est2 = sharded_basket_estimate(basket, payoff, n, steps, seed=9,
                                   mesh=mesh1, block_size=512)
    assert float(est["price"]) == float(est2["price"])


def test_asset_axis_sharded_large_basket():
    """16 assets over 4 asset shards x 2 path shards — the ASSETS_AXIS path
    beyond the small 4-asset case (each shard owns 4 Cholesky rows)."""
    from montecarlo.engine import simulate
    from montecarlo.parallel import sharded_basket_estimate
    from montecarlo.processes import BasketGBM

    rng = np.random.default_rng(3)
    a_n = 16
    q = rng.normal(size=(a_n, a_n))
    corr = q @ q.T
    d = np.sqrt(np.diag(corr))
    basket = BasketGBM.create(
        s0=rng.uniform(50, 150, a_n), mu=[0.03] * a_n,
        sigma=rng.uniform(0.1, 0.4, a_n), corr=corr / np.outer(d, d),
        weights=np.full(a_n, 1.0 / a_n), dt=1 / 252)
    n, steps = 1 << 13, 8
    payoff = lambda v: jnp.maximum(v - 90.0, 0.0)

    mesh = make_mesh(n_path_shards=2, n_asset_shards=4)
    est = sharded_basket_estimate(basket, payoff, n, steps, seed=21,
                                  mesh=mesh, block_size=512)
    vals = np.asarray(payoff(simulate(basket, n, steps, seed=21)))
    se = vals.std(ddof=1) / np.sqrt(n)
    assert abs(float(est["price"]) - vals.mean()) < max(5e-3, 0.1 * se)
    assert int(est["n_paths"]) == n

    # Invariance across asset-shard counts (1 vs 4) at fixed path sharding.
    est1 = sharded_basket_estimate(basket, payoff, n, steps, seed=21,
                                   mesh=make_mesh(n_path_shards=2,
                                                  n_asset_shards=1),
                                   block_size=512)
    assert abs(float(est["price"]) - float(est1["price"])) < 1e-5


def test_weak_scaling_structure():
    """Weak-scaling structure: fixed per-device path count, growing mesh —
    per-shard programs are identical (same local shapes), only the
    all_gather width grows.  Estimates across mesh sizes must agree within
    MC error and report the right global path counts; the 8-device case is
    the virtual stand-in for the pod-scale claim (BASELINE.md row 3)."""
    from montecarlo.parallel import sharded_mc_estimate

    local_n = 4096
    prices = {}
    for n_dev in (1, 2, 4, 8):
        est = sharded_mc_estimate(
            _gbm(), _payoff, local_n * n_dev, N_STEPS, seed=13,
            mesh=make_mesh(n_dev), block_size=BLOCK)
        assert int(est["n_paths"]) == local_n * n_dev
        prices[n_dev] = (float(est["price"]), float(est["std_err"]))
    # All estimates consistent within joint MC error.
    for n_dev, (p, se) in prices.items():
        p1, se1 = prices[1]
        assert abs(p - p1) < 5 * (se + se1), (n_dev, prices)
    # More devices -> more paths -> tighter estimate.
    assert prices[8][1] < prices[1][1]


def test_sharded_estimate_path_offset_chunking():
    """path_offset chunks compose: two disjoint half-runs merge to the
    full-run estimate (the pod-scale chunking hook)."""
    from montecarlo.parallel import sharded_mc_estimate
    from montecarlo.stats.welford import (MomentState, moments_merge,
                                              std_error)

    mesh = make_mesh(4)
    full = sharded_mc_estimate(_gbm(), _payoff, N_PATHS, N_STEPS, seed=17,
                               mesh=mesh, block_size=BLOCK)
    a = sharded_mc_estimate(_gbm(), _payoff, N_PATHS // 2, N_STEPS, seed=17,
                            mesh=mesh, block_size=BLOCK)
    b = sharded_mc_estimate(_gbm(), _payoff, N_PATHS // 2, N_STEPS, seed=17,
                            mesh=mesh, block_size=BLOCK,
                            path_offset=N_PATHS // 2)
    # Chunk MOMENT STATES merge to the full-run estimate — price AND
    # std_err through the Welford merge law (not just averaged means).
    n = N_PATHS // 2
    sa = MomentState(count=jnp.float32(n), mean=jnp.float32(a["price"]),
                     m2=jnp.square(jnp.float32(a["std_err"]))
                     * n * (n - 1))
    sb = MomentState(count=jnp.float32(n), mean=jnp.float32(b["price"]),
                     m2=jnp.square(jnp.float32(b["std_err"]))
                     * n * (n - 1))
    merged = moments_merge(sa, sb)
    assert abs(float(merged.mean) - float(full["price"])) < 1e-5
    assert abs(float(std_error(merged))
               - float(full["std_err"])) < 2e-3 * float(full["std_err"])


def test_multi_slice_mesh_bitwise_invariant():
    """("slices", "paths") meshes — the multi-slice DCN layout with the
    two-level merge (intra-slice block gather + per-slice tree + inter-
    slice gather of one state per slice) — must match the flat mesh AND
    the 1-device run bitwise (the tree decomposes exactly when blocks per
    slice is a power of two)."""
    ref = sharded_mc_estimate(_gbm(), _payoff, N_PATHS, N_STEPS, seed=11,
                              mesh=make_mesh(1), block_size=BLOCK)
    for n_slices, n_paths_shards in ((2, 4), (4, 2), (2, 2), (8, 1)):
        mesh = make_mesh(n_path_shards=n_paths_shards, n_slices=n_slices)
        assert mesh.shape == {"slices": n_slices, "paths": n_paths_shards}
        est = sharded_mc_estimate(_gbm(), _payoff, N_PATHS, N_STEPS,
                                  seed=11, mesh=mesh, block_size=BLOCK)
        assert float(est["price"]) == float(ref["price"]), (n_slices,
                                                            n_paths_shards)
        assert float(est["std_err"]) == float(ref["std_err"])
        assert int(est["n_paths"]) == N_PATHS


def test_multi_slice_terminal_and_sketch_match_flat():
    """Terminal layout is slice-major (== unsharded order) and the sketch's
    hierarchical psum equals the flat psum bitwise (integer adds)."""
    mesh = make_mesh(n_path_shards=4, n_slices=2)
    sharded = np.asarray(sharded_terminal(_gbm(), N_PATHS, N_STEPS, seed=3,
                                          mesh=mesh))
    local = np.asarray(simulate(_gbm(), N_PATHS, N_STEPS, seed=3))
    np.testing.assert_array_equal(sharded, local)

    sk2, mo2 = sharded_terminal_sketch(
        _gbm(), N_PATHS, N_STEPS, seed=7, mesh=mesh, lo=40.0, hi=250.0,
        bins=512, block_size=BLOCK)
    sk1, mo1 = sharded_terminal_sketch(
        _gbm(), N_PATHS, N_STEPS, seed=7, mesh=make_mesh(1), lo=40.0,
        hi=250.0, bins=512, block_size=BLOCK)
    np.testing.assert_array_equal(np.asarray(sk2.counts),
                                  np.asarray(sk1.counts))
    assert float(mo2.mean) == float(mo1.mean)
    assert float(sk2.vmin) == float(sk1.vmin)
    assert float(sk2.vmax) == float(sk1.vmax)


def test_multi_slice_guards():
    """Non-power-of-two blocks per slice must be rejected (the two-level
    tree would pair blocks across a slice boundary and silently break the
    bitwise contract), as must slices x assets meshes."""
    mesh = make_mesh(n_path_shards=2, n_slices=2)
    with pytest.raises(ValueError, match="power-of-two"):
        # 24 blocks over 2 slices -> 12 per slice: not a power of two.
        sharded_mc_estimate(_gbm(), _payoff, 24 * BLOCK, N_STEPS, seed=1,
                            mesh=mesh, block_size=BLOCK)
    with pytest.raises(ValueError, match="slices x assets"):
        make_mesh(n_path_shards=2, n_asset_shards=2, n_slices=2)


# ---------------------------------------------------------------------------
# Sharded pathwise Greeks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def _greeks_mesh1():
    from montecarlo.parallel import sharded_price_and_greeks

    disc = float(np.exp(-0.03 * 64 / 252))
    return sharded_price_and_greeks(_gbm(), _payoff, 1 << 16, 64, seed=11,
                                    mesh=make_mesh(1), discount=disc,
                                    block_size=BLOCK)


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_sharded_greeks_bitwise_invariant(ndev, _greeks_mesh1):
    """Price AND every gradient leaf (and their error bars) bitwise
    identical across mesh shapes — the per-block vmap(value_and_grad) +
    fixed-tree merge contract."""
    from montecarlo.parallel import sharded_price_and_greeks

    disc = float(np.exp(-0.03 * 64 / 252))
    r = sharded_price_and_greeks(_gbm(), _payoff, 1 << 16, 64, seed=11,
                                 mesh=make_mesh(ndev), discount=disc,
                                 block_size=BLOCK)
    ref = _greeks_mesh1
    assert float(r["price"]) == float(ref["price"])
    assert float(r["std_err"]) == float(ref["std_err"])
    for leaf, leaf_ref in zip(jax.tree.leaves(r["grads"]),
                              jax.tree.leaves(ref["grads"])):
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(leaf_ref))
    for leaf, leaf_ref in zip(jax.tree.leaves(r["grad_std_err"]),
                              jax.tree.leaves(ref["grad_std_err"])):
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(leaf_ref))


def test_sharded_greeks_match_black_scholes(_greeks_mesh1):
    """Delta (grads.s0) and vega (grads.sigma) agree with the closed forms
    within their own blockwise-CLT error bars."""
    from montecarlo.engine.greeks import (black_scholes_delta,
                                              black_scholes_vega)

    T = 64 / 252
    r = _greeks_mesh1
    delta_bs = float(black_scholes_delta(S0, STRIKE, 0.03, 0.2, T))
    vega_bs = float(black_scholes_vega(S0, STRIKE, 0.03, 0.2, T))
    d, dse = float(r["grads"].s0), float(r["grad_std_err"].s0)
    v, vse = float(r["grads"].sigma), float(r["grad_std_err"].sigma)
    assert abs(d - delta_bs) < 4 * dse + 1e-4, (d, delta_bs, dse)
    assert abs(v - vega_bs) < 4 * vse + 1e-3, (v, vega_bs, vse)
    assert int(r["n_paths"]) == 1 << 16


def test_sharded_greeks_multislice_and_int_leaves():
    """Multi-slice mesh stays bitwise-equal to the flat mesh, and integer
    process leaves (GARCH's n_table) come back as zero gradients instead
    of float0 (the gather/merge needs uniform float arithmetic)."""
    from montecarlo.parallel import sharded_price_and_greeks
    from montecarlo.processes.garch import GARCHBootstrap

    flat = sharded_price_and_greeks(_gbm(), _payoff, 1 << 15, 16, seed=4,
                                    mesh=make_mesh(8), block_size=BLOCK)
    two_level = sharded_price_and_greeks(
        _gbm(), _payoff, 1 << 15, 16, seed=4,
        mesh=make_mesh(n_path_shards=4, n_slices=2), block_size=BLOCK)
    assert float(flat["price"]) == float(two_level["price"])
    assert float(flat["grads"].s0) == float(two_level["grads"].s0)

    rng = np.random.default_rng(0)
    garch = GARCHBootstrap.create(rng.normal(0, 0.02, size=300),
                                  s0=S0, var0=1e-4)
    r = sharded_price_and_greeks(garch, _payoff, 1 << 14, 16, seed=4,
                                 mesh=make_mesh(4), block_size=BLOCK)
    assert np.all(np.asarray(r["grads"].n_table) == 0.0)
    assert np.isfinite(float(r["grads"].s0))
    assert float(r["grads"].s0) > 0.0  # a call's delta
