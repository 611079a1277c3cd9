"""DCC-GARCH: CCC-degenerate equivalence, numpy oracle parity, dynamics."""

import jax.numpy as jnp
import numpy as np

from montecarlo.engine import simulate
from montecarlo.ops.fused_engine import fused_terminal_pallas
from montecarlo.processes import CCCGarch, DCCGarch

QBAR = np.array([[1.0, 0.5, 0.2], [0.5, 1.0, 0.4], [0.2, 0.4, 1.0]])
S0 = [100.0, 50.0, 75.0]
VAR0 = [2e-4, 4e-4, 3e-4]
W = [0.5, 0.3, 0.2]


def _dcc(a=0.05, b=0.9):
    return DCCGarch.create(
        s0=S0, var0=VAR0, omega=[1e-5] * 3, alpha=[0.1] * 3,
        beta=[0.85] * 3, qbar=QBAR, weights=W, a_dcc=a, b_dcc=b)


def test_degenerates_to_ccc_when_static():
    """a_dcc = b_dcc = 0 freezes Q at Qbar — identical draws, identical
    dynamics to CCC-GARCH with the same correlation."""
    dcc = _dcc(a=0.0, b=0.0)
    ccc = CCCGarch.create(
        s0=S0, var0=VAR0, omega=[1e-5] * 3, alpha=[0.1] * 3,
        beta=[0.85] * 3, corr=QBAR, weights=W)
    n, steps = 4096, 24
    a = np.asarray(simulate(dcc, n, steps, seed=7))
    b = np.asarray(simulate(ccc, n, steps, seed=7))
    np.testing.assert_allclose(a, b, rtol=2e-5)


def test_numpy_oracle_parity():
    """Full-path parity against an independent NumPy port of the Engle
    recursion, fed the *same* standard-normal draws (from the framework's
    RNG) — exercises the per-path Cholesky and the Q update exactly."""
    proc = _dcc(a=0.05, b=0.9)
    n, steps = 512, 12
    ids = jnp.arange(n, dtype=jnp.uint32)
    eps_all = []  # (steps, 3, n) raw draws, same as the engine consumes
    for t in range(steps):
        eps_all.append([np.asarray(e, np.float64)
                        for e in proc.draws(0, 0, ids, t, jnp.float32)])

    a_n = 3
    log_s = np.log(np.asarray(S0))[:, None] * np.ones((a_n, n))
    var = np.asarray(VAR0, np.float64)[:, None] * np.ones((a_n, n))
    q = np.broadcast_to(QBAR[:, :, None], (a_n, a_n, n)).copy()
    omega, alpha, beta = 1e-5, 0.1, 0.85
    a_d, b_d = 0.05, 0.9
    for t in range(steps):
        eps = np.stack(eps_all[t])  # (3, n)
        d = 1.0 / np.sqrt(np.einsum("iik->ik", q))
        r = q * d[:, None, :] * d[None, :, :]
        eta = np.empty_like(eps)
        for p in range(n):
            chol = np.linalg.cholesky(r[:, :, p])
            eta[:, p] = chol @ eps[:, p]
        ret = np.sqrt(var) * eta
        log_s = log_s + ret
        var = omega + alpha * ret ** 2 + beta * var
        q = ((1 - a_d - b_d) * QBAR[:, :, None]
             + a_d * eta[:, None, :] * eta[None, :, :] + b_d * q)

    expected = (np.asarray(W)[:, None] * np.exp(log_s)).sum(axis=0)
    got = np.asarray(simulate(proc, n, steps, seed=0))
    np.testing.assert_allclose(got, expected, rtol=5e-4)


def test_correlation_clustering_dynamics():
    """With a_dcc > 0, the conditional correlation moves with shocks: the
    dispersion of pairwise Q across paths grows from zero (all paths start
    at Qbar) — absent in the CCC degenerate case."""
    proc = _dcc(a=0.2, b=0.7)
    n, steps = 4096, 30
    ids = jnp.arange(n, dtype=jnp.uint32)
    state = proc.init_state(ids)
    for t in range(steps):
        eps = proc.draws(0, 0, ids, t, jnp.float32)
        state = proc.step(state, eps, t)
    _, _, qtuple = state
    # Entry (1,0) of the lower triangle is index 1.
    q10 = np.asarray(qtuple[1])
    assert q10.std() > 0.02, q10.std()
    assert abs(np.median(q10) - 0.5) < 0.15  # mean-reverts around qbar


def test_fused_kernel_bitwise_parity():
    proc = _dcc(a=0.05, b=0.9)
    a = fused_terminal_pallas(proc, 8192, 9, seed=3, interpret=True,
                              block=128)
    b = simulate(proc, 8192, 9, seed=3)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_create_validation():
    import pytest

    with pytest.raises(ValueError):
        _dcc(a=0.5, b=0.6)  # a + b >= 1
    with pytest.raises(ValueError):
        DCCGarch.create(s0=S0, var0=VAR0, omega=[1e-5] * 3,
                        alpha=[0.1] * 3, beta=[0.85] * 3,
                        qbar=QBAR * 2.0, weights=W)  # not a correlation


def test_create_accepts_corrcoef_diagonal():
    """np.corrcoef diagonals carry 1 +/- 1ulp; create must tolerate them
    (exact float equality used to reject valid inputs)."""
    rng = np.random.default_rng(7)
    q = np.corrcoef(rng.normal(size=(3, 500)))
    q[0, 0] = np.nextafter(1.0, 0.0)  # force the 1-ulp case
    q[0, 1] = q[1, 0] = q[0, 1]  # keep symmetry
    proc = DCCGarch.create(s0=[100.0] * 3, var0=[2e-4] * 3,
                           omega=[1e-5] * 3, alpha=[0.1] * 3,
                           beta=[0.85] * 3, qbar=q, weights=[1 / 3] * 3)
    qb = np.asarray(proc.qbar_flat).reshape(3, 3)
    np.testing.assert_array_equal(np.diag(qb), 1.0)
