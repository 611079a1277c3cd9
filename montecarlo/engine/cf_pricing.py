"""Generic characteristic-function option pricing (Gil-Pelaez / Heston form).

One jittable Gauss-Legendre pricer for ANY model whose log-price
characteristic function is known in closed form:

    C = S0 * P1 - K e^{-rT} * P2
    P2 = 1/2 + 1/pi int Re[ e^{-iu ln K} phi(u)   / (iu)          ] du
    P1 = 1/2 + 1/pi int Re[ e^{-iu ln K} phi(u-i) / (iu phi(-i))  ] du

(the same machinery as :mod:`montecarlo.engine.heston_analytic`, here
factored over a caller-supplied phi).  Shipped CFs: Merton lognormal jumps
and Kou double-exponential jumps — the semi-analytic validation oracles for
the corresponding Monte Carlo processes, and cross-checks of each other
(the Merton CF price must reproduce the Merton 1976 series).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


# One Gauss-Legendre grid shared with the Heston pricer — the two CF
# pricers must integrate on identical nodes or they drift apart.
from montecarlo.engine.heston_analytic import _quad_nodes  # noqa: E402


@partial(jax.jit, static_argnames=("phi", "n_quad"))
def cf_call_price(phi, s0, strike, T, r, *, n_quad: int = 256,
                  u_max: float = 200.0):
    """European call from a log-price characteristic function.

    ``phi(u)`` must be the risk-neutral CF of ln S_T evaluated at complex
    ``u`` (vectorized over a 1-D array).  Scalar or broadcast batches of
    strike/T follow the Heston pricer's convention.
    """
    return cf_call_price_impl(phi, s0, strike, T, r, n_quad=n_quad,
                              u_max=u_max)


def cf_call_price_impl(phi, s0, strike, T, r, *, n_quad: int = 256,
                       u_max: float = 200.0):
    """Unjitted body of :func:`cf_call_price` — call this when ``phi``
    closes over *traced* values (e.g. calibration parameters inside an
    optimizer scan), where a static-argname jit would leak tracers."""
    u, w = _quad_nodes(n_quad, u_max)
    s0 = jnp.asarray(s0)
    strike = jnp.asarray(strike)
    lnk = jnp.log(strike)
    disc = jnp.exp(-r * T)

    phi_m_i = phi(jnp.asarray(-1j))  # = E[S_T] (forward)

    def p_term(us, denom_phi):
        def integrand(ui):
            return jnp.real(jnp.exp(-1j * ui * lnk) * phi(us(ui))
                            / (1j * ui * denom_phi))
        vals = jax.vmap(integrand)(u)
        return 0.5 + jnp.tensordot(w, vals, axes=1) / jnp.pi

    p1 = p_term(lambda ui: ui - 1j, phi_m_i)
    p2 = p_term(lambda ui: ui, 1.0)
    # C = S0 P1 - K e^{-rT} P2 with the *passed* spot (for a risk-neutral
    # phi, disc * phi(-i) == s0, but taking the spot implicitly from the CF
    # silently ignored the s0 argument — e.g. under a spot bump).
    return s0 * p1 - disc * strike * p2


def merton_log_cf(s0, r, sigma, lam, jump_mean, jump_std, T):
    """Risk-neutral CF of ln S_T under Merton jump-diffusion."""
    m = jnp.exp(jump_mean + 0.5 * jump_std**2) - 1.0
    drift = jnp.log(s0) + (r - lam * m - 0.5 * sigma**2) * T

    def phi(us):
        iu = 1j * us
        jump_cf = jnp.exp(iu * jump_mean - 0.5 * jump_std**2 * us * us)
        return jnp.exp(iu * drift - 0.5 * sigma**2 * us * us * T
                       + lam * T * (jump_cf - 1.0))
    return phi


def kou_log_cf(s0, r, sigma, lam, p_up, eta1, eta2, T):
    """Risk-neutral CF of ln S_T under Kou double-exponential jumps."""
    m = p_up * eta1 / (eta1 - 1.0) + (1.0 - p_up) * eta2 / (eta2 + 1.0) - 1.0
    drift = jnp.log(s0) + (r - lam * m - 0.5 * sigma**2) * T

    def phi(us):
        iu = 1j * us
        jump_cf = (p_up * eta1 / (eta1 - iu)
                   + (1.0 - p_up) * eta2 / (eta2 + iu))
        return jnp.exp(iu * drift - 0.5 * sigma**2 * us * us * T
                       + lam * T * (jump_cf - 1.0))
    return phi


def nig_log_cf(s0, r, alpha, beta, delta, T):
    """Risk-neutral CF of ln S_T under the normal-inverse-Gaussian process.

    The Levy symbol is ``delta*(gamma - sqrt(alpha^2 - (beta+iu)^2))`` with
    ``gamma = sqrt(alpha^2 - beta^2)``; the drift carries the martingale
    correction ``omega = delta*(sqrt(alpha^2-(beta+1)^2) - gamma)`` exactly
    as :class:`montecarlo.processes.nig.NIG` applies it, so this CF is
    the exact law of the simulated terminal log-price (NIG increments have
    no time-discretization error)."""
    gamma = jnp.sqrt(alpha * alpha - beta * beta)
    omega = delta * (jnp.sqrt(alpha * alpha - (beta + 1.0) ** 2) - gamma)
    drift = jnp.log(s0) + (r + omega) * T

    def phi(us):
        iu = 1j * us
        root = jnp.sqrt(alpha * alpha - (beta + iu) ** 2)
        return jnp.exp(iu * drift + delta * T * (gamma - root))
    return phi


def vg_log_cf(s0, r, sigma, theta, nu, T):
    """Risk-neutral CF of ln S_T under the variance-gamma process.

    The VG Levy exponent gives ``phi_X(u) = (1 - iu*theta*nu +
    sigma^2*nu*u^2/2)^(-T/nu)``; the drift carries the martingale
    correction ``omega = log(1 - theta*nu - sigma^2*nu/2)/nu`` exactly as
    :class:`montecarlo.processes.vg.VarianceGamma` applies it, so this
    CF is the exact law of the simulated terminal log-price (VG increments
    have no time-discretization error).  The CF base ``1 + sigma^2*nu*u^2/2
    - iu*theta*nu`` has strictly positive real part for real u, so the
    principal complex log is continuous (no branch tracking needed)."""
    omega = jnp.log(1.0 - theta * nu - 0.5 * sigma * sigma * nu) / nu
    drift = jnp.log(s0) + (r + omega) * T

    def phi(us):
        iu = 1j * us
        base = 1.0 - iu * theta * nu + 0.5 * sigma * sigma * nu * us * us
        return jnp.exp(iu * drift - (T / nu) * jnp.log(base))
    return phi


__all__ = ["cf_call_price", "cf_call_price_impl", "merton_log_cf",
           "kou_log_cf", "nig_log_cf", "vg_log_cf"]
