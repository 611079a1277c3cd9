"""Pod-scale American pricing (`parallel/sharded.py::sharded_lsm_price`):
bitwise mesh-shape invariance, statistical parity with the single-chip LSM
on the SAME paths, and the binomial-oracle accuracy gate."""

import numpy as np
import jax.numpy as jnp
import pytest

from montecarlo.engine import binomial_american_put, lsm_price
from montecarlo.parallel import make_mesh, sharded_lsm_price
from montecarlo.processes import GBM

S0, K, R, SIG, T = 36.0, 40.0, 0.06, 0.2, 1.0
STEPS = 50
DT = T / STEPS
N_PATHS = 1 << 16
BLOCK = 2048


def _put(s):
    return jnp.maximum(K - s, 0.0)


def _proc():
    return GBM.create(s0=S0, mu=R, sigma=SIG, dt=DT)


def _price(n_dev):
    mesh = make_mesh(n_dev)
    res = sharded_lsm_price(_proc(), _put, N_PATHS, STEPS, seed=7, rate=R,
                            dt=DT, mesh=mesh, degree=3, block_size=BLOCK)
    return float(res["price"]), float(res["std_err"])


def test_bitwise_mesh_shape_invariance():
    """1/2/4/8-device meshes produce the identical price bit for bit —
    the same contract as sharded_mc_estimate."""
    p1, se1 = _price(1)
    for n in (2, 4, 8):
        pn, sen = _price(n)
        assert pn == p1 and sen == se1, (n, pn, p1)


def test_matches_single_chip_lsm():
    """Same seed -> same global paths; only the regression arithmetic
    differs (block-ordered one-pass sums), so the two engines' prices
    agree far inside the MC error."""
    p8, _ = _price(8)
    single = lsm_price(_proc(), _put, N_PATHS, STEPS, seed=7, rate=R,
                       dt=DT, degree=3)
    assert abs(p8 - float(single["price"])) < \
        0.5 * float(single["std_err"]), (p8, single)


def test_accuracy_vs_binomial():
    oracle = binomial_american_put(S0, K, R, SIG, T, n_steps=1000)
    p, se = _price(8)
    assert abs(p - oracle) < 4 * se + 0.05, (p, oracle)


def test_multislice_two_level_matches_flat():
    """(2 slices x 4 shards) == (8 flat shards), bitwise — the DCN-aware
    gather must not change the block order the fixed reduction sees."""
    p8, se8 = _price(8)
    mesh2 = make_mesh(n_path_shards=4, n_slices=2)
    res = sharded_lsm_price(_proc(), _put, N_PATHS, STEPS, seed=7, rate=R,
                            dt=DT, mesh=mesh2, degree=3, block_size=BLOCK)
    assert float(res["price"]) == p8
    assert float(res["std_err"]) == se8


def test_indivisible_rejected():
    with pytest.raises(ValueError):
        sharded_lsm_price(_proc(), _put, 1000, STEPS, seed=7, rate=R,
                          dt=DT, mesh=make_mesh(8), block_size=BLOCK)


# --- sharded path-dependent pricing ---------------------------------------


def test_sharded_functional_mesh_invariance():
    """Asian call through `sharded_functional_estimate`: bitwise across
    1/2/4/8-device and 2x4 multi-slice meshes."""
    from montecarlo.engine import ARITH_MEAN, asian_call
    from montecarlo.parallel import sharded_functional_estimate

    proc = GBM.create(s0=100.0, mu=0.03, sigma=0.2, dt=1.0 / 64)
    fns = {"avg": ARITH_MEAN}
    payoff_of = lambda o: asian_call(o["avg"], 100.0)

    def run(mesh):
        res = sharded_functional_estimate(
            proc, fns, payoff_of, 1 << 15, 64, seed=3, mesh=mesh,
            discount=float(np.exp(-0.03)), block_size=BLOCK)
        return float(res["price"]), float(res["std_err"])

    ref = run(make_mesh(1))
    assert ref[0] > 0
    for n in (2, 4, 8):
        assert run(make_mesh(n)) == ref, n
    assert run(make_mesh(n_path_shards=4, n_slices=2)) == ref


def test_sharded_functional_worst_of_note():
    """Multi-asset worst-of autocallable at pod layout == mesh-1, and both
    match the unsharded run to estimator noise."""
    from montecarlo.engine import (mc_estimate, simulate_functionals,
                                       worst_of_autocallable)
    from montecarlo.parallel import sharded_functional_estimate
    from montecarlo.processes import MultiGBM

    corr = np.full((3, 3), 0.5)
    np.fill_diagonal(corr, 1.0)
    proc = MultiGBM.create(s0=[100.0] * 3, mu=[0.03] * 3,
                           sigma=[0.25] * 3, corr=corr, dt=1.0 / 64)
    fn = worst_of_autocallable(16, 1.0, 0.02, 0.03 / 64, 0.7, [100.0] * 3)
    payoff_of = lambda o: o["ac"]

    def run(mesh):
        res = sharded_functional_estimate(
            proc, {"ac": fn}, payoff_of, 1 << 14, 64, seed=13, mesh=mesh,
            block_size=BLOCK)
        return float(res["price"]), float(res["std_err"])

    p1 = run(make_mesh(1))
    p8 = run(make_mesh(8))
    assert p1 == p8
    flat = simulate_functionals(proc, 1 << 14, 64, seed=13,
                                functionals={"ac": fn})
    ref = mc_estimate(flat["ac"], 1.0)
    np.testing.assert_allclose(p8[0], float(ref["price"]), rtol=2e-6)


def test_sharded_slv_mesh_invariance():
    """The exact-rows SLV shards like everything else (its leverage table
    is a KernelTable only inside the fused kernel; the CPU mesh runs the
    scan path): bitwise across mesh shapes."""
    import jax.numpy as jnp

    from montecarlo.parallel import sharded_mc_estimate
    from montecarlo.processes.slv import SLV

    steps = 16
    rows = jnp.asarray(
        0.2 + 0.05 * np.sin(np.linspace(0, 3, steps))[:, None]
        + 0.02 * np.cos(np.linspace(0, 2, 128))[None, :], jnp.float32)
    f32 = lambda v: jnp.asarray(v, jnp.float32)
    proc = SLV(s0=f32(100.0), rate=f32(0.03), v0=f32(0.04), kappa=f32(2.0),
               theta=f32(0.04), xi=f32(0.8), rho=f32(-0.6),
               dt=f32(1.0 / steps), x0=f32(-0.9), dx=f32(1.8 / 127),
               lev_rows=rows)

    def run(n_dev):
        est = sharded_mc_estimate(
            proc, lambda s: jnp.maximum(s - 100.0, 0.0), 1 << 14, steps,
            seed=3, mesh=make_mesh(n_dev), block_size=BLOCK)
        return float(est["price"]), float(est["std_err"])

    ref = run(1)
    assert ref[0] > 0
    for n in (2, 8):
        assert run(n) == ref, n


# --- sharded Andersen-Broadie dual ------------------------------------------


@pytest.fixture(scope="module")
def _dual_setup():
    from montecarlo.engine.american import lsm_policy

    _, policy = lsm_policy(_proc(), _put, N_PATHS, STEPS, seed=7, rate=R,
                           dt=DT, degree=3)
    return policy


def _dual(n_dev_or_mesh, policy):
    from montecarlo.parallel import sharded_andersen_broadie_bound

    mesh = (n_dev_or_mesh if not isinstance(n_dev_or_mesh, int)
            else make_mesh(n_dev_or_mesh))
    res = sharded_andersen_broadie_bound(
        _proc(), _put, policy, 1 << 13, 16, STEPS, seed=7, rate=R, dt=DT,
        mesh=mesh, degree=3, block_size=1024)
    return float(res["upper"]), float(res["std_err"])


def test_sharded_dual_bitwise_mesh_invariance(_dual_setup):
    """Upper bound and std-err bitwise identical on 1/2/4/8-device and
    2x4 multi-slice meshes — the pod-scale American price now brackets
    from BOTH sides under the same invariance contract."""
    ref = _dual(1, _dual_setup)
    for n in (2, 4, 8):
        assert _dual(n, _dual_setup) == ref, n
    assert _dual(make_mesh(n_path_shards=4, n_slices=2), _dual_setup) == ref


def test_sharded_dual_brackets_binomial(_dual_setup):
    """LSM lower (its known small low bias) <= binomial oracle <= dual
    upper, within error bars: the full distributed bracket."""
    from montecarlo.engine.american import andersen_broadie_bound

    oracle = binomial_american_put(S0, K, R, SIG, T, n_steps=1000)
    lo, lo_se = _price(8)
    up, up_se = _dual(8, _dual_setup)
    assert lo - 4 * lo_se - 0.05 <= oracle <= up + 4 * up_se, \
        (lo, oracle, up)
    # Same per-path maxima as the unsharded dual (identical global ids and
    # streams); only the mean's reduction tree differs.
    un = andersen_broadie_bound(_proc(), _put, _dual_setup, 1 << 13, 16,
                                STEPS, seed=7, rate=R, dt=DT, degree=3)
    assert abs(up - float(un["upper"])) < 1e-4, (up, un)
