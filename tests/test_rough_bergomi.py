"""Rough Bergomi: exact Volterra covariances, martingale property,
deterministic-vol limit vs Black-Scholes, and the rough short-dated skew."""

import numpy as np
import jax.numpy as jnp

from montecarlo.engine import black_scholes_call
from montecarlo.engine.implied_vol import implied_vol_call
from montecarlo.processes.rough_bergomi import (
    RoughBergomi,
    rbergomi_simulate,
    volterra_joint_chol,
)

S0, XI0, ETA, RHO, H, T = 100.0, 0.04, 1.5, -0.7, 0.1, 0.5
N_STEPS = 64


def _model(**kw):
    args = dict(s0=S0, xi0=XI0, eta=ETA, rho=RHO, h=H, n_steps=N_STEPS, T=T)
    args.update(kw)
    return RoughBergomi.create(**args)


def test_joint_cholesky_reproduces_covariances():
    """Sample moments of the joint Gaussian vs the analytic covariances."""
    rng = np.random.default_rng(0)
    chol = volterra_joint_chol(16, 1.0, 0.3)
    z = rng.normal(size=(200_000, 32))
    x = z @ chol.T
    t = (np.arange(1, 17)) / 16.0
    emp_var = x[:, :16].var(axis=0)
    np.testing.assert_allclose(emp_var, t ** 0.6, rtol=0.03)
    # increments: iid with variance dt, independent of PAST W~ values
    emp_dw_var = x[:, 16:].var(axis=0)
    np.testing.assert_allclose(emp_dw_var, 1.0 / 16, rtol=0.03)
    c = np.corrcoef(x[:, 5], x[:, 16 + 10])[0, 1]  # W~_{t6} vs dW_11
    assert abs(c) < 0.01


def test_forward_variance_is_unbiased():
    """E[v_t] = xi0 for every t (lognormal drift correction exact)."""
    v, _ = rbergomi_simulate(_model(), 1 << 16, seed=3, mode="paths")
    v = np.asarray(v)
    se = v.std(axis=0) / np.sqrt(v.shape[0])
    assert np.all(np.abs(v.mean(axis=0) - XI0) < 5 * se + 1e-5)


def test_price_is_martingale():
    s_t = np.asarray(rbergomi_simulate(_model(), 1 << 17, seed=5))
    se = s_t.std() / np.sqrt(s_t.size)
    assert abs(s_t.mean() - S0) < 5 * se


def test_zero_vol_of_vol_is_black_scholes():
    """eta=0: v == xi0 deterministic, so the call price must be BS with
    sigma = sqrt(xi0) (validates the dW handling end to end)."""
    s_t = np.asarray(rbergomi_simulate(_model(eta=0.0, rho=0.0), 1 << 17,
                                       seed=7))
    pay = np.maximum(s_t - 100.0, 0.0)
    se = pay.std() / np.sqrt(pay.size)
    bs = float(black_scholes_call(S0, 100.0, 0.0, np.sqrt(XI0), T))
    assert abs(pay.mean() - bs) < 4 * se + 0.02, (pay.mean(), bs)


def test_short_dated_skew_is_rough():
    """ATM skew ~ T^{H-1/2}: at short maturity the H=0.1 surface must be
    much steeper than H=0.45 (same eta/rho)."""
    def atm_skew(h):
        m = _model(h=h, T=0.1, n_steps=32, eta=1.9, rho=-0.9)
        s_t = np.asarray(rbergomi_simulate(m, 1 << 18, seed=11))
        ivs = []
        for k in (97.0, 103.0):
            price = np.maximum(s_t - k, 0.0).mean()
            ivs.append(float(implied_vol_call(price, S0, k, 0.0, 0.1)))
        return (ivs[1] - ivs[0]) / 6.0

    sk_rough, sk_smooth = atm_skew(0.1), atm_skew(0.45)
    assert sk_rough < 0 and sk_smooth < 0
    assert sk_rough < 1.5 * sk_smooth, (sk_rough, sk_smooth)


def test_deterministic_and_offset_consistent():
    a = np.asarray(rbergomi_simulate(_model(), 4096, seed=13))
    b = np.asarray(rbergomi_simulate(_model(), 4096, seed=13))
    assert (a == b).all()
    off = np.asarray(rbergomi_simulate(_model(), 2048, seed=13,
                                       path_offset=2048))
    np.testing.assert_allclose(a[2048:], off, rtol=2e-5)


def _rbergomi_f64_reference(model, n_paths, seed):
    """The same sampler in f64 NumPy from the same f32 normals: joint
    Gaussian by the Cholesky factor, v_t at the grid, left-point log-price
    sum."""
    from montecarlo.engine.simulate import path_ids_for
    from montecarlo.rng.normal import normal_draw

    T_ = model.n_steps
    ids = path_ids_for(n_paths, 0)
    cols = jnp.arange(3 * T_, dtype=jnp.uint32)
    z = np.asarray(normal_draw(seed, 0, ids[None, :], cols[:, None],
                               jnp.float32), np.float64)
    chol = np.asarray(model.chol, np.float64)
    joint = chol @ z[:2 * T_]
    t = np.asarray(model.t_grid, np.float64)
    xi0, eta, rho = (float(model.xi0), float(model.eta), float(model.rho))
    h, dt, s0 = float(model.h), float(model.dt), float(model.s0)
    v = xi0 * np.exp(eta * joint[:T_] - 0.5 * eta ** 2 * t[:, None] ** (2 * h))
    v_left = np.concatenate([np.full((1, n_paths), xi0), v[:-1]], axis=0)
    dws = rho * joint[T_:] + np.sqrt(1 - rho ** 2) * z[2 * T_:] * np.sqrt(dt)
    log_s = np.log(s0) + np.sum(np.sqrt(v_left) * dws - 0.5 * v_left * dt,
                                axis=0)
    return np.exp(log_s)


def test_xla_path_matches_f64_reference():
    """The plain-XLA sampler (f32, HIGHEST-precision factor matmul) agrees
    path by path with an f64 NumPy implementation fed the same normals."""
    model = _model(n_steps=16)
    got = np.asarray(rbergomi_simulate(model, 4096, seed=11))
    ref = _rbergomi_f64_reference(model, 4096, 11)
    np.testing.assert_allclose(got, ref, rtol=2e-5)


def test_xla_path_price_matches_f64_reference():
    """The call price over those paths agrees to f32 accuracy."""
    model = _model(n_steps=32)
    got = np.asarray(rbergomi_simulate(model, 8192, seed=2))
    ref = _rbergomi_f64_reference(model, 8192, 2)
    pay = lambda s: np.maximum(s - 100.0, 0.0).mean()
    assert abs(pay(got) - pay(ref)) < 1e-4 * pay(ref)
