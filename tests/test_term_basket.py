"""Per-asset term-structure basket: flat-curve degeneracy, vol strips,
correlation, fused-kernel parity."""

import numpy as np
import jax.numpy as jnp

from montecarlo.engine import simulate
from montecarlo.ops.fused_engine import fused_terminal_pallas
from montecarlo.processes import BasketGBM, TermBasketGBM

A, N_STEPS, DT = 3, 64, 1.0 / 64
S0 = [100.0, 50.0, 75.0]
MU = [0.03, 0.02, 0.04]
SIG = [0.2, 0.3, 0.25]
CORR = np.eye(A) * 0.5 + 0.5
W = [1 / 3] * 3


def _flat():
    return TermBasketGBM.create(
        S0, np.tile(np.asarray(MU)[:, None], (1, N_STEPS)),
        np.tile(np.asarray(SIG)[:, None], (1, N_STEPS)), CORR, W, DT)


def test_flat_curves_degenerate_to_basket_gbm():
    base = BasketGBM.create(S0, MU, SIG, CORR, W, DT)
    a = np.asarray(simulate(_flat(), 8192, N_STEPS, seed=3))
    b = np.asarray(simulate(base, 8192, N_STEPS, seed=3))
    np.testing.assert_allclose(a, b, rtol=2e-6)


def test_vol_strip_matches_integrated_variance():
    """Piecewise vol: Var[log S_T] per asset = sum sigma_t^2 dt."""
    rng = np.random.default_rng(0)
    sig_curves = 0.15 + 0.15 * rng.random((A, N_STEPS))
    proc = TermBasketGBM.create(
        S0, np.tile(np.asarray(MU)[:, None], (1, N_STEPS)), sig_curves,
        np.eye(A), [1.0, 0.0, 0.0], DT, dtype=jnp.float64)
    # weights pick out asset 0 -> basket value IS asset 0's price
    n = 1 << 15
    s_t = np.asarray(simulate(proc, n, N_STEPS, seed=7, dtype=jnp.float64))
    lr = np.log(s_t / S0[0])
    want = (sig_curves[0] ** 2).sum() * DT
    assert abs(lr.var() - want) < 0.05 * want


def test_correlation_flows_through_curves():
    """With identical curves and strong correlation, per-asset log returns
    must correlate near the input correlation."""
    from montecarlo.processes import MultiGBM

    # Cross-check basket value against MultiGBM (same corr, flat curves).
    mg = MultiGBM.create(s0=S0, mu=MU, sigma=SIG, corr=CORR, dt=DT)
    n = 1 << 15
    b_term = np.asarray(simulate(_flat(), n, N_STEPS, seed=11))
    m_term = np.asarray(simulate(mg, n, N_STEPS, seed=11)) @ np.asarray(W)
    # Same distribution (not same draws-to-asset map): compare moments.
    assert abs(b_term.mean() - m_term.mean()) < 4 * m_term.std() / np.sqrt(n)
    assert abs(b_term.std() - m_term.std()) < 0.05 * m_term.std()


def test_term_basket_fused_kernel_parity():
    n = 128 * 128
    ref = np.asarray(simulate(_flat(), n, 17, seed=5))
    ker = np.asarray(fused_terminal_pallas(_flat(), n, 17, seed=5,
                                           block=256, interpret=True))
    np.testing.assert_array_equal(ker, ref)
