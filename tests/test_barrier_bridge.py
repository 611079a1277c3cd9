"""Brownian-bridge barrier correction: monitoring-frequency invariance,
discrete-barrier convergence, and degenerate limits.  Plus gamma by
double-autodiff and a basket-Asian composition check."""

import numpy as np
import jax
import jax.numpy as jnp

from montecarlo.engine import (
    RUNNING_MAX,
    black_scholes_call,
    european_call,
    mc_estimate,
    simulate_functionals,
    up_and_out_call,
)
from montecarlo.engine.functionals import ARITH_MEAN, barrier_survival_up
from montecarlo.processes import GBM, BasketGBM

S0, R, SIGMA, T, STRIKE, BARRIER = 100.0, 0.03, 0.2, 1.0, 100.0, 125.0


def _bridged_price(n_steps, seed, n=1 << 16):
    proc = GBM.create(S0, R, SIGMA, T / n_steps, dtype=jnp.float64)
    out = simulate_functionals(
        proc, n, n_steps, seed=seed, dtype=jnp.float64,
        functionals={"surv": barrier_survival_up(BARRIER, SIGMA,
                                                 T / n_steps)})
    pay = european_call(out["terminal"], STRIKE) * out["surv"]
    return mc_estimate(pay, np.exp(-R * T))


def _naive_price(n_steps, seed, n=1 << 16):
    proc = GBM.create(S0, R, SIGMA, T / n_steps, dtype=jnp.float64)
    out = simulate_functionals(proc, n, n_steps, seed=seed,
                               dtype=jnp.float64,
                               functionals={"mx": RUNNING_MAX})
    pay = up_and_out_call(out["terminal"], out["mx"], STRIKE, BARRIER)
    return mc_estimate(pay, np.exp(-R * T))


def test_bridge_price_is_monitoring_invariant():
    a = _bridged_price(32, seed=3)
    b = _bridged_price(256, seed=5)
    se = float(a["std_err"]) + float(b["std_err"])
    assert abs(float(a["price"]) - float(b["price"])) < 4 * se, (a, b)


def test_naive_discrete_converges_to_bridge_from_above():
    bridge = float(_bridged_price(256, seed=7)["price"])
    naive_coarse = float(_naive_price(32, seed=7)["price"])
    naive_fine = float(_naive_price(512, seed=7)["price"])
    # discrete monitoring misses crossings -> fewer knockouts -> higher price
    assert naive_coarse > bridge + 0.05
    assert naive_fine > bridge
    assert naive_fine < naive_coarse  # monotone convergence in frequency
    assert abs(naive_fine - bridge) < abs(naive_coarse - bridge)


def test_barrier_at_infinity_is_vanilla():
    n_steps = 64
    proc = GBM.create(S0, R, SIGMA, T / n_steps, dtype=jnp.float64)
    out = simulate_functionals(
        proc, 1 << 16, n_steps, seed=9, dtype=jnp.float64,
        functionals={"surv": barrier_survival_up(1e6, SIGMA, T / n_steps)})
    pay = european_call(out["terminal"], STRIKE) * out["surv"]
    est = mc_estimate(pay, np.exp(-R * T))
    bs = float(black_scholes_call(S0, STRIKE, R, SIGMA, T))
    assert abs(float(est["price"]) - bs) < 4 * float(est["std_err"])
    assert float(jnp.min(out["surv"])) > 0.99999


def test_gamma_by_double_autodiff():
    """Second derivative of the MC price w.r.t. spot matches BS gamma
    (pathwise delta is exact; one more grad gives distributional gamma of
    the smoothed estimator — validated against the closed form)."""
    from scipy.stats import norm

    from montecarlo.engine import simulate

    n, n_steps = 1 << 15, 64

    def norm_cdf(x):
        return 0.5 * (1.0 + jax.scipy.special.erf(x / np.sqrt(2.0)))

    def norm_pdf(x):
        return jnp.exp(-0.5 * x * x) / np.sqrt(2.0 * np.pi)

    def price(s0):
        proc = GBM.create(s0, R, SIGMA, T / n_steps, dtype=jnp.float64)
        term = simulate(proc, n, n_steps, seed=11)
        # smooth the kink so the second derivative exists pathwise
        x = (term - STRIKE) / 2.0
        payoff = 2.0 * (x * norm_cdf(x) + norm_pdf(x))
        return jnp.mean(payoff) * np.exp(-R * T)

    gamma = float(jax.grad(jax.grad(price))(jnp.float64(S0)))
    d1 = (np.log(S0 / STRIKE) + (R + SIGMA**2 / 2) * T) / (SIGMA * np.sqrt(T))
    bs_gamma = norm.pdf(d1) / (S0 * SIGMA * np.sqrt(T))
    # smoothing width 2.0 biases gamma slightly; MC noise dominates
    assert abs(gamma - bs_gamma) < 0.35 * bs_gamma, (gamma, bs_gamma)


def test_basket_asian_composition():
    """Functionals compose with baskets: Asian on the basket *value*."""
    corr = np.eye(3) * 0.4 + 0.6
    proc = BasketGBM.create([100.0, 50.0, 75.0], [0.03] * 3,
                            [0.2, 0.3, 0.25], corr, [1 / 3] * 3, 1 / 64,
                            dtype=jnp.float64)
    out = simulate_functionals(proc, 1 << 14, 64, seed=13,
                               dtype=jnp.float64,
                               functionals={"avg": ARITH_MEAN})
    est = mc_estimate(jnp.maximum(out["avg"] - 75.0, 0.0), np.exp(-0.03))
    # sanity: positive, below the undiscounted deep-ITM cap
    assert 0.0 < float(est["price"]) < 75.0
    # Asian <= European on the same basket (Jensen, near-zero drift)
    eur = mc_estimate(jnp.maximum(out["terminal"] - 75.0, 0.0),
                      np.exp(-0.03))
    assert float(est["price"]) < float(eur["price"])


def test_in_out_parity_exact_from_one_run():
    """KO + KI computed from the same survival probability reproduce the
    vanilla price exactly (pathwise identity, not just in expectation)."""
    n_steps, n = 64, 1 << 14
    proc = GBM.create(S0, R, SIGMA, T / n_steps, dtype=jnp.float64)
    out = simulate_functionals(
        proc, n, n_steps, seed=17, dtype=jnp.float64,
        functionals={"surv": barrier_survival_up(BARRIER, SIGMA,
                                                 T / n_steps)})
    pay = european_call(out["terminal"], STRIKE)
    ko = pay * out["surv"]
    ki = pay * (1.0 - out["surv"])
    np.testing.assert_allclose(np.asarray(ko + ki), np.asarray(pay),
                               rtol=1e-12)
