"""Term-structure GBM: curve semantics, dividend drift, fused parity."""

import numpy as np
import jax.numpy as jnp

from montecarlo.engine import simulate
from montecarlo.ops.fused_engine import fused_terminal_pallas
from montecarlo.processes import GBM, TermStructureGBM


def test_flat_curves_reduce_to_gbm():
    steps = 32
    flat = TermStructureGBM.from_curves(
        100.0, np.full(steps, 0.03), np.full(steps, 0.2), 1 / 252)
    plain = GBM.create(s0=100.0, mu=0.03, sigma=0.2, dt=1 / 252)
    a = np.asarray(simulate(flat, 4096, steps, seed=5))
    b = np.asarray(simulate(plain, 4096, steps, seed=5))
    np.testing.assert_allclose(a, b, rtol=1e-6)


def test_dividend_yield_lowers_forward():
    steps = 252
    n = 1 << 15
    no_div = TermStructureGBM.with_dividend(100.0, 0.05, 0.0, 0.2, 1 / 252,
                                            steps)
    with_div = TermStructureGBM.with_dividend(100.0, 0.05, 0.02, 0.2,
                                              1 / 252, steps)
    f0 = np.asarray(simulate(no_div, n, steps, seed=3)).mean()
    f1 = np.asarray(simulate(with_div, n, steps, seed=3)).mean()
    np.testing.assert_allclose(f0, 100 * np.exp(0.05), rtol=5e-3)
    np.testing.assert_allclose(f1, 100 * np.exp(0.03), rtol=5e-3)


def test_time_varying_vol_realized():
    """First half sigma=0.1, second half sigma=0.4: realized vol of each
    half matches its curve."""
    steps = 64
    sig = np.concatenate([np.full(32, 0.1), np.full(32, 0.4)])
    proc = TermStructureGBM.from_curves(100.0, np.zeros(steps), sig, 1 / 252)
    paths = np.asarray(simulate(proc, 1 << 14, steps, seed=7, mode="paths"))
    rets = np.diff(np.log(paths), axis=0)
    vol1 = rets[:32].std() * np.sqrt(252)
    vol2 = rets[32:].std() * np.sqrt(252)
    assert abs(vol1 - 0.1) < 0.01
    assert abs(vol2 - 0.4) < 0.02


def test_fused_kernel_parity_interpret():
    steps = 17
    rng = np.random.default_rng(0)
    proc = TermStructureGBM.from_curves(
        100.0, rng.uniform(0.0, 0.05, steps), rng.uniform(0.1, 0.3, steps),
        1 / 252)
    n = 128 * 64
    ref = np.asarray(simulate(proc, n, steps, seed=5))
    ker = np.asarray(fused_terminal_pallas(proc, n, steps, seed=5,
                                           block=128, interpret=True))
    np.testing.assert_array_equal(ker, ref)
