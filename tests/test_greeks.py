"""Pathwise Greeks via autodiff vs Black-Scholes closed forms."""

import numpy as np
import jax.numpy as jnp

from montecarlo.engine.greeks import (
    black_scholes_delta,
    black_scholes_vega,
    price_and_greeks,
)
from montecarlo.engine import black_scholes_call, european_call
from montecarlo.processes import GBM, Heston

S0, R, SIGMA, STRIKE = 100.0, 0.03, 0.2, 105.0
N_STEPS = 64
T = N_STEPS / 252.0


def test_gbm_delta_vega_match_black_scholes():
    proc = GBM.create(s0=S0, mu=R, sigma=SIGMA, dt=1 / 252)
    n = 1 << 17
    price, grads = price_and_greeks(
        proc, lambda s: european_call(s, STRIKE), n, N_STEPS, seed=3,
        discount=float(np.exp(-R * T)))
    bs = float(black_scholes_call(S0, STRIKE, R, SIGMA, T))
    assert abs(float(price) - bs) < 0.05
    delta = float(grads.s0)
    vega = float(grads.sigma)
    bs_delta = float(black_scholes_delta(S0, STRIKE, R, SIGMA, T))
    bs_vega = float(black_scholes_vega(S0, STRIKE, R, SIGMA, T))
    assert abs(delta - bs_delta) < 0.01, (delta, bs_delta)
    assert abs(vega - bs_vega) / bs_vega < 0.03, (vega, bs_vega)


def test_greeks_use_common_random_numbers():
    """Same seed -> the gradient is the derivative of THIS price estimate:
    a tiny parameter bump reprices consistently (CRN pathwise property)."""
    n, eps = 1 << 15, 1e-2
    mk = lambda s0: GBM.create(s0=s0, mu=R, sigma=SIGMA, dt=1 / 252)
    p0, grads = price_and_greeks(mk(S0), lambda s: european_call(s, STRIKE),
                                 n, N_STEPS, seed=7)
    p_up, _ = price_and_greeks(mk(S0 + eps),
                               lambda s: european_call(s, STRIKE),
                               n, N_STEPS, seed=7)
    fd_delta = (float(p_up) - float(p0)) / eps
    assert abs(fd_delta - float(grads.s0)) < 2e-3


def test_heston_greeks_finite():
    proc = Heston.create(s0=S0, v0=0.04, mu=R, kappa=2.0, theta=0.04,
                         xi=0.5, rho=-0.7, dt=1 / 252)
    price, grads = price_and_greeks(
        proc, lambda s: european_call(s, STRIKE), 1 << 14, N_STEPS, seed=5)
    assert float(price) > 0
    # Delta in (0, 1) for a call; vega-like sensitivities finite.
    assert 0.0 < float(grads.s0) < 1.0
    for leaf in [grads.v0, grads.kappa, grads.theta, grads.xi, grads.rho]:
        assert np.isfinite(float(leaf))


def test_lr_greeks_digital_call():
    """LR delta/vega for a digital payoff vs closed forms (pathwise would
    give zero gradients almost everywhere here)."""
    from jax.scipy.stats import norm as jnorm

    from montecarlo.engine.greeks import lr_greeks_gbm

    proc = GBM.create(s0=S0, mu=R, sigma=SIGMA, dt=1 / 252)
    n = 1 << 18
    disc = float(np.exp(-R * T))
    out = lr_greeks_gbm(proc, lambda s: (s > STRIKE).astype(jnp.float32),
                        n, N_STEPS, seed=9, discount=disc)
    d2 = ((np.log(S0 / STRIKE) + (R - 0.5 * SIGMA**2) * T)
          / (SIGMA * np.sqrt(T)))
    from scipy.stats import norm
    price_cf = disc * norm.cdf(d2)
    delta_cf = disc * norm.pdf(d2) / (S0 * SIGMA * np.sqrt(T))
    assert abs(float(out["price"]) - price_cf) < 0.01
    assert abs(float(out["delta"]) - delta_cf) < \
        4 * float(out["delta_std_err"]) + 1e-4, (float(out["delta"]), delta_cf)
    # Vega via central finite difference of the closed form.
    eps = 1e-4
    def digital_price(sig):
        d2_ = ((np.log(S0 / STRIKE) + (R - 0.5 * sig**2) * T)
               / (sig * np.sqrt(T)))
        return disc * norm.cdf(d2_)
    vega_cf = (digital_price(SIGMA + eps) - digital_price(SIGMA - eps)) / (2 * eps)
    assert abs(float(out["vega"]) - vega_cf) < \
        4 * float(out["vega_std_err"]) + 1e-3, (float(out["vega"]), vega_cf)


def test_remat_greeks_match_plain():
    """jax.checkpoint'ed scan gives identical gradients with O(paths)
    residual memory (draws recompute from counters)."""
    from montecarlo.engine.greeks import price_and_greeks

    proc = GBM.create(s0=S0, mu=R, sigma=SIGMA, dt=1 / 252)
    n = 1 << 12
    p0, g0 = price_and_greeks(proc, lambda s: european_call(s, STRIKE),
                              n, 32, seed=3)
    p1, g1 = price_and_greeks(proc, lambda s: european_call(s, STRIKE),
                              n, 32, seed=3, remat=True)
    assert float(p0) == float(p1)
    np.testing.assert_allclose(float(g0.s0), float(g1.s0), rtol=1e-6)
    np.testing.assert_allclose(float(g0.sigma), float(g1.sigma), rtol=1e-6)


def test_smoothed_digital_delta_close_to_lr():
    """Smoothed-payoff pathwise delta agrees with the LR estimator (and the
    closed form) for a digital call — the process-agnostic fallback."""
    from scipy.stats import norm

    from montecarlo.engine.greeks import smoothed_digital

    proc = GBM.create(s0=S0, mu=R, sigma=SIGMA, dt=1 / 252)
    disc = float(np.exp(-R * T))
    n = 1 << 17
    price, grads = price_and_greeks(proc, smoothed_digital(STRIKE, 0.8),
                                    n, N_STEPS, seed=9, discount=disc)
    d2 = ((np.log(S0 / STRIKE) + (R - 0.5 * SIGMA**2) * T)
          / (SIGMA * np.sqrt(T)))
    delta_cf = disc * norm.pdf(d2) / (S0 * SIGMA * np.sqrt(T))
    assert abs(float(grads.s0) - delta_cf) < 0.2 * delta_cf + 5e-4


def test_second_order_greeks_match_black_scholes():
    """Gamma / vanna / volga from one forward-over-reverse pass through the
    simulator with the kernel-smoothed call vs the BS closed forms."""
    from scipy.stats import norm

    from montecarlo.engine.greeks import (second_order_greeks,
                                              smoothed_call)

    proc = GBM.create(s0=S0, mu=R, sigma=SIGMA, dt=T / N_STEPS,
                      dtype=jnp.float64)
    n = 1 << 17
    disc = float(np.exp(-R * T))
    price, grad, hess = second_order_greeks(
        proc, smoothed_call(STRIKE, 1.5), n, N_STEPS, seed=11,
        fields=("s0", "sigma"), discount=disc, dtype=jnp.float64)

    sqt = np.sqrt(T)
    d1 = (np.log(S0 / STRIKE) + (R + SIGMA**2 / 2) * T) / (SIGMA * sqt)
    d2 = d1 - SIGMA * sqt
    bs_gamma = norm.pdf(d1) / (S0 * SIGMA * sqt)
    bs_vanna = -norm.pdf(d1) * d2 / SIGMA
    bs_volga = S0 * norm.pdf(d1) * sqt * d1 * d2 / SIGMA

    assert abs(float(price) - float(black_scholes_call(
        S0, STRIKE, R, SIGMA, T))) < 0.05
    assert abs(float(grad[0])
               - float(black_scholes_delta(S0, STRIKE, R, SIGMA, T))) < 0.02
    assert abs(float(hess[0, 0]) - bs_gamma) < 0.15 * abs(bs_gamma), (
        float(hess[0, 0]), bs_gamma)
    assert abs(float(hess[0, 1]) - bs_vanna) < (
        0.25 * abs(bs_vanna) + 0.05), (float(hess[0, 1]), bs_vanna)
    assert abs(float(hess[1, 1]) - bs_volga) < (
        0.25 * abs(bs_volga) + 0.5), (float(hess[1, 1]), bs_volga)
    # Hessian symmetry (same program computes both off-diagonals).
    np.testing.assert_allclose(float(hess[0, 1]), float(hess[1, 0]),
                               rtol=1e-8)


def test_pathwise_greeks_work_for_garch_bootstrap():
    """Integer leaves (n_table) must not break autodiff (allow_int)."""
    from montecarlo.processes import GARCHBootstrap

    rets = np.random.default_rng(0).normal(0, 0.02, 300)
    proc = GARCHBootstrap.create(rets, s0=100.0, var0=4e-4)
    price, grads = price_and_greeks(
        proc, lambda s: european_call(s, 100.0), 1 << 12, 16, seed=1)
    assert np.isfinite(float(price))
    assert 0.3 < float(grads.s0) < 1.0  # ITM-ish call delta


def test_cli_greeks_mesh(capsys):
    """`greeks --mesh N` rides sharded_price_and_greeks: grads plus their
    blockwise error bars, paths rounded up to the block contract; --mesh
    composes with the pathwise method only."""
    import json

    import pytest

    from montecarlo import cli

    rc = cli.main(["greeks", "--mesh", "2", "--paths", "9000",
                   "--steps", "16"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mesh"] == 2
    assert out["n_paths"] == 16384  # 9000 rounded up to 2 * 4096 * 2
    assert 0.0 < out["d_s0"] < 1.0
    assert out["d_s0_std_err"] > 0.0
    assert out["d_sigma"] > 0.0
    with pytest.raises(SystemExit, match="pathwise"):
        cli.main(["greeks", "--mesh", "2", "--method", "lr"])
    with pytest.raises(SystemExit, match="pathwise"):
        cli.main(["greeks", "--mesh", "2", "--american"])
