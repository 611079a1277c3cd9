"""Black-Scholes implied volatility — jittable, vmappable Newton solver."""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from montecarlo.engine.payoffs import black_scholes_call
from montecarlo.engine.greeks import black_scholes_vega


@partial(jax.jit, static_argnames=("n_iter",))
def implied_vol_call(price, s0, strike, r, T, *, init=0.2, n_iter: int = 32):
    """Implied vol of a European call by safeguarded Newton iteration.

    Vectorizes over any broadcastable batch of (price, s0, strike, r, T) —
    an entire vol surface inverts in one device program.  Returns NaN where
    the price is outside the no-arbitrage band.
    """
    price, s0, strike, r, T = map(jnp.asarray, (price, s0, strike, r, T))
    lower = jnp.maximum(s0 - strike * jnp.exp(-r * T), 0.0)
    valid = (price > lower + 1e-12) & (price < s0)

    def body(_, sigma):
        bs = black_scholes_call(s0, strike, r, sigma, T)
        vega = jnp.maximum(black_scholes_vega(s0, strike, r, sigma, T),
                           1e-8)
        step = (bs - price) / vega
        # Safeguard: cap the Newton step, keep sigma in (1e-4, 5).
        step = jnp.clip(step, -0.5, 0.5)
        return jnp.clip(sigma - step, 1e-4, 5.0)

    # Broadcast the start to the COMMON shape of all five inputs — seeding
    # at price.shape alone changes the fori_loop carry shape mid-loop (and
    # crashes) whenever strike/T carry the batch dimension.
    shape = jnp.broadcast_shapes(price.shape, s0.shape, strike.shape,
                                 jnp.shape(r), jnp.shape(T))
    sigma0 = jnp.broadcast_to(jnp.asarray(init, price.dtype), shape)
    sigma = jax.lax.fori_loop(0, n_iter, body, sigma0)
    return jnp.where(valid, sigma, jnp.nan)
