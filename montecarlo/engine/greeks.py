"""Pathwise Greeks by differentiating straight through the simulator.

A capability the reference cannot express at all: because every process is a
pure JAX pytree and the engine is a pure function, `jax.grad` of the
discounted mean payoff **with respect to the process parameters themselves**
yields pathwise sensitivity estimators — delta/vega/rho/etc. in one reverse
pass, on device, with the exact same counter-based draws as the price (common
random numbers by construction).

Validity: the pathwise estimator requires an a.e.-differentiable payoff
(calls/puts/baskets qualify; digital payoffs do not — use finite differences
of the smoothed payoff or a likelihood-ratio estimator for those).

Uses the scan engine (the Pallas kernels define no VJP); gradients flow
through the SDE arithmetic only — the RNG's integer ops are constants with
respect to the parameters, which is precisely the fixed-draws pathwise
construction.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from montecarlo.engine.simulate import simulate


@partial(jax.jit, static_argnames=("payoff_fn", "n_paths", "n_steps",
                                   "seed", "stream", "dtype", "remat"))
def price_and_greeks(process, payoff_fn, n_paths: int, n_steps: int, *,
                     seed: int, discount=1.0, stream: int = 0,
                     dtype=jnp.float32, remat: bool = False):
    """Discounted price and its gradient w.r.t. every process parameter.

    Returns ``(price, grads)`` where ``grads`` is a pytree shaped like
    ``process`` — e.g. for GBM: ``grads.s0`` is delta, ``grads.sigma`` is
    vega (per unit of annualized vol), ``grads.mu`` is the drift
    sensitivity (rho for a risk-neutral drift).
    """
    d = jnp.asarray(discount, dtype)

    def price_fn(proc):
        terminal = simulate(proc, n_paths, n_steps, seed=seed,
                            stream=stream, dtype=dtype, remat=remat)
        return d * jnp.mean(payoff_fn(terminal))

    # allow_int: process pytrees may carry integer leaves (e.g. the GARCH
    # bootstrap's n_table) — their "gradients" come back as float0 and the
    # real parameter gradients are unaffected.
    price, grads = jax.value_and_grad(price_fn, allow_int=True)(process)
    return price, grads


@partial(jax.jit, static_argnames=("payoff_fn", "n_paths", "n_steps",
                                   "seed", "stream", "dtype"))
def lr_greeks_gbm(process, payoff_fn, n_paths: int, n_steps: int, *,
                  seed: int, discount=1.0, stream: int = 0,
                  dtype=jnp.float32):
    """Likelihood-ratio delta and vega for GBM — valid for *any* terminal
    payoff, including discontinuous ones (digitals, barriers at expiry)
    where the pathwise estimator fails.

    Under GBM, ln S_T ~ N(a, v) with a = ln S0 + (mu - sigma^2/2) T and
    v = sigma^2 T; the score functions are

        d ln p / d S0    = z / (S0 sigma sqrt(T))
        d ln p / d sigma = (z^2 - 1)/sigma - z sqrt(T),
        z = (ln S_T - a) / (sigma sqrt(T))

    and greek = E[payoff * score].  Higher variance than pathwise —
    prefer `price_and_greeks` for Lipschitz payoffs.
    """
    terminal = simulate(process, n_paths, n_steps, seed=seed, stream=stream,
                        dtype=dtype)
    d = jnp.asarray(discount, dtype)
    t_total = (process.dt * n_steps).astype(dtype)
    sqrt_t = jnp.sqrt(t_total)
    sigma = process.sigma.astype(dtype)
    a = (jnp.log(process.s0)
         + (process.mu - 0.5 * jnp.square(process.sigma))
         * process.dt * n_steps).astype(dtype)
    z = (jnp.log(terminal) - a) / (sigma * sqrt_t)
    f = payoff_fn(terminal)

    score_s0 = z / (process.s0.astype(dtype) * sigma * sqrt_t)
    score_sigma = (jnp.square(z) - 1.0) / sigma - z * sqrt_t
    return {
        "price": d * jnp.mean(f),
        "delta": d * jnp.mean(f * score_s0),
        "vega": d * jnp.mean(f * score_sigma),
        "delta_std_err": d * jnp.std(f * score_s0)
        / jnp.sqrt(jnp.asarray(n_paths, dtype)),
        "vega_std_err": d * jnp.std(f * score_sigma)
        / jnp.sqrt(jnp.asarray(n_paths, dtype)),
    }


def smoothed_call(strike, width=2.0):
    """Twice-differentiable surrogate for the call payoff max(S−K, 0).

    Normal-kernel smoothing: ``w·(x·Φ(x) + φ(x))`` with ``x=(S−K)/w`` — the
    exact convolution of the hinge with a N(0, w²) kernel, so it converges
    to the hinge as ``w→0`` and its *second* derivative (the thing gamma
    needs) is the smooth Gaussian density φ(x)/w instead of a delta.  Bias
    is O(w²·payoff curvature); MC noise grows like 1/w for gamma — width
    ≈ a few percent of spot balances the two at typical path counts.
    """
    inv_sqrt2 = 0.7071067811865476
    inv_sqrt2pi = 0.3989422804014327

    def payoff(s):
        x = (s - strike) / width
        cdf = 0.5 * (1.0 + jax.scipy.special.erf(x * inv_sqrt2))
        pdf = inv_sqrt2pi * jnp.exp(-0.5 * x * x)
        return width * (x * cdf + pdf)

    return payoff


@partial(jax.jit, static_argnames=("payoff_fn", "n_paths", "n_steps",
                                   "seed", "stream", "dtype", "fields"))
def second_order_greeks(process, payoff_fn, n_paths: int, n_steps: int, *,
                        seed: int, fields=("s0", "sigma"), discount=1.0,
                        stream: int = 0, dtype=jnp.float32):
    """Price, gradient, and Hessian w.r.t. named scalar process parameters.

    One forward-over-reverse pass through the simulator gives the full
    second-order ladder under common random numbers: with
    ``fields=("s0", "sigma")`` the Hessian is
    ``[[gamma, vanna], [vanna, volga]]``.

    The payoff must be *twice* a.e.-differentiable for the Hessian to be a
    consistent estimator — pass :func:`smoothed_call` (or any C² payoff)
    rather than the raw hinge, whose pathwise second derivative is a.e.
    zero.  Works for any process whose named fields are scalars (GBM,
    Heston, SABR, ...).

    Returns ``(price, grad, hessian)`` with ``grad[i] = d price / d
    fields[i]`` and ``hessian[i, j]`` the mixed second derivative.
    """
    d = jnp.asarray(discount, dtype)
    zeros = jnp.zeros(len(fields), dtype)

    def price_fn(bumps):
        repl = {f: getattr(process, f) + bumps[i].astype(
            jnp.asarray(getattr(process, f)).dtype)
            for i, f in enumerate(fields)}
        proc = process._replace(**repl)
        terminal = simulate(proc, n_paths, n_steps, seed=seed,
                            stream=stream, dtype=dtype)
        return d * jnp.mean(payoff_fn(terminal))

    # One primal forward+reverse pass (linearized), then one cheap
    # tangent pass per field for the Hessian columns — a separate
    # jacfwd(grad) would re-trace and re-run the whole simulation.
    (price, grad), lin = jax.linearize(
        jax.value_and_grad(price_fn), zeros)
    basis = jnp.eye(len(fields), dtype=dtype)
    hess = jnp.stack([lin(basis[i])[1] for i in range(len(fields))])
    return price, grad, hess


def smoothed_digital(strike, width=0.5):
    """A differentiable surrogate for the digital payoff 1{S_T > K}:
    sigmoid((S-K)/width).

    Makes `price_and_greeks` usable for digital-style payoffs under ANY
    process (the LR estimator covers GBM only); bias is O(width * density
    curvature) — shrink ``width`` with the path count.  Returns a payoff
    callable.
    """
    def payoff(s):
        return jax.nn.sigmoid((s - strike) / width)

    return payoff


def black_scholes_delta(s0, strike, r, sigma, T):
    """Closed-form call delta — the validation oracle."""
    from jax.scipy.stats import norm

    d1 = ((jnp.log(s0 / strike) + (r + 0.5 * sigma**2) * T)
          / (sigma * jnp.sqrt(T)))
    return norm.cdf(d1)


def black_scholes_vega(s0, strike, r, sigma, T):
    """Closed-form call vega — the validation oracle."""
    from jax.scipy.stats import norm

    d1 = ((jnp.log(s0 / strike) + (r + 0.5 * sigma**2) * T)
          / (sigma * jnp.sqrt(T)))
    return s0 * norm.pdf(d1) * jnp.sqrt(T)
