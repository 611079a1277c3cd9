"""SABR stochastic-volatility model (Hagan et al. 2002).

    dF     = sigma_t F^beta dW1        (forward, Euler with absorption guard)
    dsigma = nu sigma_t dW2            (lognormal vol leg, stepped *exactly*)
    d<W1, W2> = rho dt

The desk-standard smile model for rates/FX forwards.  The vol leg is a GBM
so it is stepped by its exact lognormal solution; only the forward leg is
Euler-discretized (full truncation at F=0, the absorbing boundary for
beta < 1).  Two correlated draws per step, tuple state of 2-D arrays —
exactly the Heston layout, so the process is fused-Pallas-kernel eligible.

Validated against the Hagan lognormal implied-vol expansion
(:func:`sabr_hagan_iv`), the industry quoting convention.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from montecarlo.rng.normal import exp32, log32

from montecarlo.processes.base import NormalDrawsMixin


class SABRState(NamedTuple):
    f: jnp.ndarray      # forward
    sigma: jnp.ndarray  # instantaneous vol


class SABR(NormalDrawsMixin, NamedTuple("SABRFields", [
        ("f0", jnp.ndarray),
        ("alpha", jnp.ndarray),  # initial vol sigma_0
        ("beta", jnp.ndarray),   # CEV exponent in [0, 1]
        ("nu", jnp.ndarray),     # vol-of-vol
        ("rho", jnp.ndarray),    # corr(forward, vol)
        ("dt", jnp.ndarray),
])):
    """SABR under the forward measure (the forward is driftless)."""

    n_draws = 2

    @classmethod
    def create(cls, f0, alpha, beta, nu, rho, dt, dtype=jnp.float32):
        as_ = lambda v: jnp.asarray(v, dtype)
        return cls(f0=as_(f0), alpha=as_(alpha), beta=as_(beta), nu=as_(nu),
                   rho=as_(rho), dt=as_(dt))

    def init_state(self, path_ids, dtype=jnp.float32) -> SABRState:
        shape = path_ids.shape
        return SABRState(
            f=jnp.full(shape, jnp.asarray(self.f0, dtype), dtype),
            sigma=jnp.full(shape, jnp.asarray(self.alpha, dtype), dtype))

    def step(self, state: SABRState, eps, t) -> SABRState:
        z1, z2 = eps
        dtype = state.f.dtype
        rho = self.rho.astype(dtype)
        w2 = rho * z1 + jnp.sqrt(1.0 - jnp.square(rho)) * z2
        sqdt = jnp.sqrt(self.dt).astype(dtype)
        nu = self.nu.astype(dtype)
        # Forward leg: Euler, absorbed at zero (beta < 1 boundary).
        f_plus = jnp.maximum(state.f, 0.0)
        df = state.sigma * jnp.power(f_plus, self.beta.astype(dtype)) \
            * sqdt * z1
        f_new = jnp.maximum(f_plus + df, 0.0)
        # Vol leg: exact lognormal transition.
        sig_new = state.sigma * exp32(
            nu * sqdt * w2 - 0.5 * jnp.square(nu) * self.dt.astype(dtype))
        return SABRState(f=f_new, sigma=sig_new)

    def prices(self, state: SABRState):
        return state.f


def sabr_hagan_iv(f0, strike, T, alpha, beta, nu, rho):
    """Hagan et al. (2002) lognormal (Black) implied-vol expansion.

    The standard quoting approximation, accurate to O(nu^2 T) for moderate
    parameters — the validation oracle for the MC process (tests price the
    smile both ways and compare), and the model function smile calibration
    fits (:func:`calibrate_sabr`).  Pure jnp: jits, vmaps over strike
    arrays, and differentiates w.r.t. (alpha, nu, rho).
    """
    f0, k = jnp.asarray(f0), jnp.asarray(strike)
    alpha, nu, rho = jnp.asarray(alpha), jnp.asarray(nu), jnp.asarray(rho)
    one_m_b = 1.0 - beta
    fk_mid = (f0 * k) ** (one_m_b / 2.0)
    log_fk = jnp.log(f0 / k)
    z = (nu / alpha) * fk_mid * log_fk
    # Guard the removable singularity at z -> 0 (ATM): evaluate x at a z
    # bounded away from 0, then select the series limit there instead.
    near0 = jnp.abs(z) < 1e-6
    z_safe = jnp.where(near0, 1.0, z)
    x = jnp.log((jnp.sqrt(1.0 - 2.0 * rho * z_safe + z_safe * z_safe)
                 + z_safe - rho) / (1.0 - rho))
    z_over_x = jnp.where(near0, 1.0 - rho * z / 2.0, z_safe / x)
    denom = fk_mid * (1.0 + one_m_b**2 / 24.0 * log_fk**2
                      + one_m_b**4 / 1920.0 * log_fk**4)
    correction = (1.0 + (one_m_b**2 / 24.0 * alpha**2 / fk_mid**2
                         + 0.25 * rho * beta * nu * alpha / fk_mid
                         + (2.0 - 3.0 * rho**2) / 24.0 * nu**2) * T)
    return alpha / denom * z_over_x * correction


def _constrain_sabr(raw):
    import jax

    return (jax.nn.softplus(raw[0]) * 0.5,   # alpha (CEV units)
            jax.nn.softplus(raw[1]) * 0.5,   # nu
            jnp.tanh(raw[2]))                # rho


def calibrate_sabr(strikes, ivs, *, f0, T, beta: float = 0.7,
                   n_iters: int = 3000, lr: float = 0.05):
    """Fit (alpha, nu, rho) to a market smile of Black implied vols by Adam
    on the exact gradient of the Hagan expansion (beta fixed by convention).

    Returns ``{"alpha", "nu", "rho", "rmse_vol"}`` — the same
    gradient-descent-on-device pattern as
    :func:`montecarlo.engine.heston_analytic.calibrate_heston`.
    """
    import jax
    import optax

    strikes = jnp.asarray(strikes, jnp.float32)
    ivs = jnp.asarray(ivs, jnp.float32)

    def loss_fn(raw):
        alpha, nu, rho = _constrain_sabr(raw)
        model = sabr_hagan_iv(f0, strikes, T, alpha, beta, nu, rho)
        return jnp.mean(jnp.square(model - ivs))

    opt = optax.adam(lr)
    grad_fn = jax.value_and_grad(loss_fn)

    @jax.jit
    def run(raw0):
        def step(carry, _):
            raw, opt_state = carry
            loss, g = grad_fn(raw)
            updates, opt_state = opt.update(g, opt_state)
            return (optax.apply_updates(raw, updates), opt_state), loss
        (raw, _), losses = jax.lax.scan(step, (raw0, opt.init(raw0)), None,
                                        length=n_iters)
        return raw, losses

    raw0 = jnp.asarray([1.0, 0.5, 0.0], jnp.float32)
    raw, losses = run(raw0)
    alpha, nu, rho = (float(v) for v in _constrain_sabr(raw))
    return {"alpha": alpha, "nu": nu, "rho": rho,
            "rmse_vol": float(jnp.sqrt(losses[-1]))}
