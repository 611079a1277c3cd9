"""CCC-GARCH portfolio process."""

import numpy as np
import jax.numpy as jnp

from montecarlo.engine import simulate
from montecarlo.ops.fused_engine import fused_terminal_pallas
from montecarlo.processes import CCCGarch, GARCHBootstrap

CORR = np.array([[1.0, 0.5, 0.2], [0.5, 1.0, 0.4], [0.2, 0.4, 1.0]])


def _ccc():
    return CCCGarch.create(
        s0=[100.0, 50.0, 75.0], var0=[2e-4, 4e-4, 3e-4],
        omega=[1e-5] * 3, alpha=[0.1] * 3, beta=[0.85] * 3,
        corr=CORR, weights=[0.5, 0.3, 0.2])


def test_portfolio_value_and_stationarity():
    n = 1 << 14
    v_t = np.asarray(simulate(_ccc(), n, 20, seed=3))
    v0 = 0.5 * 100 + 0.3 * 50 + 0.2 * 75
    assert np.all(v_t > 0)
    assert abs(np.median(v_t) / v0 - 1.0) < 0.05


def test_correlation_recovered_in_returns():
    # Single-asset weights expose each asset's path for correlation checks.
    n = 1 << 14
    rets = []
    for a in range(3):
        w = [0.0] * 3
        w[a] = 1.0
        proc = CCCGarch.create(
            s0=[100.0, 100.0, 100.0], var0=[2e-4] * 3, omega=[1e-5] * 3,
            alpha=[0.1] * 3, beta=[0.85] * 3, corr=CORR, weights=w)
        paths = np.asarray(simulate(proc, n, 32, seed=7, mode="paths"))
        rets.append(np.diff(np.log(paths), axis=0).ravel())
    est = np.corrcoef(np.stack(rets))
    np.testing.assert_allclose(est, CORR, atol=0.03)


def test_reduces_to_single_garch_shape():
    """One asset, weight 1: same variance dynamics family as GARCHBootstrap
    (normal innovations instead of bootstrap — compare spreads loosely)."""
    n = 1 << 14
    ccc = CCCGarch.create(s0=[100.0], var0=[4e-4], omega=[1e-5],
                          alpha=[0.1], beta=[0.85], corr=[[1.0]],
                          weights=[1.0])
    s_ccc = np.asarray(simulate(ccc, n, 20, seed=5))
    rng = np.random.default_rng(0)
    boot = GARCHBootstrap.create(rng.normal(0, 0.02, 1260), s0=100.0,
                                 var0=4e-4)
    s_boot = np.asarray(simulate(boot, n, 20, seed=5))
    spread_ratio = np.log(s_ccc / 100).std() / np.log(s_boot / 100).std()
    assert 0.7 < spread_ratio < 1.4


def test_fused_kernel_parity():
    n = 128 * 64
    ref = np.asarray(simulate(_ccc(), n, 9, seed=5))
    ker = np.asarray(fused_terminal_pallas(_ccc(), n, 9, seed=5,
                                           block=128, interpret=True))
    np.testing.assert_array_equal(ker, ref)
