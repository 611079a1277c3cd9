"""Rates sensitivities by autodiff through the bond simulator.

Because the short-rate processes are pytrees and the engine is pure,
`jax.grad` of the MC bond price w.r.t. r0 gives pathwise dollar duration
(and the second derivative convexity) with common random numbers — matched
here against the affine closed form's exact derivatives."""

import math

import jax
import jax.numpy as jnp

from montecarlo.engine.functionals import (
    simulate_functionals,
    trapezoid_integral,
)
from montecarlo.engine.rates import vasicek_zcb
from montecarlo.processes import Vasicek

R0, KAPPA, THETA, SIGMA, T = 0.03, 0.8, 0.05, 0.015, 2.0
N_STEPS = 64


def _price(r0):
    proc = Vasicek.create(r0, KAPPA, THETA, SIGMA, T / N_STEPS,
                          dtype=jnp.float64)
    out = simulate_functionals(
        proc, 1 << 14, N_STEPS, seed=5, dtype=jnp.float64,
        functionals={"I": trapezoid_integral(T / N_STEPS)})
    return jnp.mean(jnp.exp(-out["I"]))


def test_duration_and_convexity_match_affine_derivatives():
    # Closed form: P(r0) = A e^{-B r0}  =>  dP/dr0 = -B P, d2P/dr02 = B^2 P.
    k = KAPPA
    b = (1.0 - math.exp(-k * T)) / k
    p_cf = vasicek_zcb(R0, KAPPA, THETA, SIGMA, T)

    dp = jax.grad(_price)(jnp.float64(R0))
    d2p = jax.grad(jax.grad(_price))(jnp.float64(R0))
    assert abs(float(dp) - (-b * p_cf)) < 2e-3 * p_cf
    assert abs(float(d2p) - b * b * p_cf) < 2e-2 * p_cf
