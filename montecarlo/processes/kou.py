"""Kou double-exponential jump-diffusion (Kou 2002).

    dS/S = (mu - lambda*m) dt + sigma dW + (e^J - 1) dN
    N ~ Poisson(lambda);  J ~ asymmetric Laplace:
        +Exp(eta1) with prob p   (up-jumps,  eta1 > 1)
        -Exp(eta2) with prob 1-p (down-jumps)
    m = E[e^J] - 1 = p*eta1/(eta1-1) + (1-p)*eta2/(eta2+1) - 1

Heavier-than-Gaussian jump tails with separate up/down decay — the standard
equity-desk refinement of Merton's lognormal jumps.  Per step (log-Euler,
exact for the diffusion; compound Poisson sampled exactly on a truncated
support like :mod:`montecarlo.processes.merton`):

    log S += (mu - lambda*m - sigma^2/2) dt + sigma sqrt(dt) z
             + sum_{k<=N} J_k,    J_k by inverse-CDF from one uniform each.

Draw layout per step: one normal (diffusion, main stream; consecutive draw
indices so both Box-Muller halves are consumed) and 1 + K_MAX uniforms
(count + jump sizes) on a separate key stream — a Box-Muller normal consumes
both halves of its cipher call, so uniforms never share ciphers with normals
(see DEVNOTES "RNG convention trap").

Scalar state + elementwise ops only: fused-Pallas-kernel eligible.
Validated against the characteristic-function price
(:mod:`montecarlo.engine.cf_pricing`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from montecarlo.processes.merton import (K_MAX, _JUMP_STREAM,
                                             check_jump_grid, poisson_count)
from montecarlo.rng.normal import (exp32, log32, normal_draw,
                                        uniform_draw)


class KouState(NamedTuple):
    log_s: jnp.ndarray


class Kou(NamedTuple("KouFields", [
        ("s0", jnp.ndarray),
        ("mu", jnp.ndarray),
        ("sigma", jnp.ndarray),
        ("lam", jnp.ndarray),    # jump intensity per unit time
        ("p_up", jnp.ndarray),   # probability a jump is upward
        ("eta1", jnp.ndarray),   # up-jump decay (> 1 for finite E[e^J])
        ("eta2", jnp.ndarray),   # down-jump decay (> 0)
        ("dt", jnp.ndarray),
])):
    """Kou double-exponential jump-diffusion with risk-drift compensation."""

    n_draws = 2 + K_MAX  # z, u_count, u_jump[0..K_MAX-1]
    draw_kinds = ("normal",) + ("uniform",) * (1 + K_MAX)

    @classmethod
    def create(cls, s0, mu, sigma, lam, p_up, eta1, eta2, dt,
               dtype=jnp.float32):
        if float(eta1) <= 1.0:
            raise ValueError("eta1 must exceed 1 (finite E[e^J])")
        check_jump_grid(lam, dt)
        as_ = lambda v: jnp.asarray(v, dtype)
        return cls(s0=as_(s0), mu=as_(mu), sigma=as_(sigma), lam=as_(lam),
                   p_up=as_(p_up), eta1=as_(eta1), eta2=as_(eta2),
                   dt=as_(dt))

    def init_state(self, path_ids, dtype=jnp.float32) -> KouState:
        return KouState(log_s=jnp.full(path_ids.shape,
                                       log32(self.s0).astype(dtype),
                                       dtype))

    def draws(self, seed, stream, path_ids, t, dtype=jnp.float32):
        tt = jnp.asarray(t).astype(jnp.uint32)
        z = normal_draw(seed, stream, path_ids, tt, dtype)
        base = tt * jnp.uint32(1 + K_MAX)
        us = tuple(
            uniform_draw(seed, stream ^ _JUMP_STREAM, path_ids,
                         base + jnp.uint32(k), dtype)
            for k in range(1 + K_MAX))
        return (z,) + us

    def draws_pair(self, seed, stream, path_ids, j, dtype=jnp.float32):
        """Two-step draws with EXPLICIT cipher sharing (fused kernel): the
        pair's two normals are the Box-Muller halves of counter j, and its
        ten jump uniforms are exactly the 2x5 halves of counters 5j..5j+4
        — 1 Box-Muller pair + 5 uniform ciphers instead of the 2 + 10 the
        per-step delegation paid.  Bitwise identical to two :meth:`draws`
        calls by construction."""
        from montecarlo.rng.normal import normal_pair, uniform_pair

        jj = jnp.asarray(j).astype(jnp.uint32)
        z0, z1 = normal_pair(seed, stream, path_ids, jj, dtype)
        base = jj * jnp.uint32(1 + K_MAX)
        halves = []
        for k in range(1 + K_MAX):
            halves.extend(uniform_pair(seed, stream ^ _JUMP_STREAM,
                                       path_ids, base + jnp.uint32(k),
                                       dtype))
        return ((z0,) + tuple(halves[:1 + K_MAX]),
                (z1,) + tuple(halves[1 + K_MAX:]))

    def antithetic(self, eps):
        z, u_count = eps[0], eps[1]
        # Mirror the normal, reflect every uniform (keeps them uniform and
        # anticorrelates count and jump directions/magnitudes).
        return (-z, 1.0 - u_count) + tuple(1.0 - u for u in eps[2:])

    def _poisson_count(self, u, dtype):
        return poisson_count(u, (self.lam * self.dt).astype(dtype), dtype)

    def _jump_size(self, u, dtype):
        """Inverse CDF of the asymmetric double exponential.

        F(x) = (1-p) e^{eta2 x} for x < 0;  1 - p e^{-eta1 x} for x >= 0.

        ONE log32 per uniform: both branches need log of a (0,1] ratio, so
        the ratio is selected FIRST and the (expensive — Newton-over-exp32)
        log evaluated once — bitwise identical to evaluating each branch's
        own log (same ops in the same order per lane), measured +21% on
        the fused kernel (this was 8 of the step's 9 transcendentals).
        """
        p = self.p_up.astype(dtype)
        eta1 = self.eta1.astype(dtype)
        eta2 = self.eta2.astype(dtype)
        q = 1.0 - p
        down = u <= q
        # u in (0,1) open interval (never 0/1), so the log is finite.
        ratio = jnp.where(down, u / q, (1.0 - u) / p)
        lg = log32(jnp.maximum(ratio, 1e-38))
        return jnp.where(down, lg / eta2, -lg / eta1)

    def mean_jump_factor(self):
        """m + 1 = E[e^J] (used for the compensator and in tests)."""
        return (self.p_up * self.eta1 / (self.eta1 - 1.0)
                + (1.0 - self.p_up) * self.eta2 / (self.eta2 + 1.0))

    def step(self, state: KouState, eps, t) -> KouState:
        dtype = state.log_s.dtype
        z, u_count = eps[0], eps[1]
        n = self._poisson_count(u_count, dtype)
        jump = jnp.zeros_like(state.log_s)
        for k in range(K_MAX):
            size = self._jump_size(eps[2 + k], dtype)
            jump = jump + jnp.where(n > float(k), size, 0.0)
        m = self.mean_jump_factor() - 1.0
        drift = ((self.mu - self.lam * m - 0.5 * jnp.square(self.sigma))
                 * self.dt).astype(dtype)
        scale = (self.sigma * jnp.sqrt(self.dt)).astype(dtype)
        # Increment grouped before the accumulator add (see GBM.step).
        return KouState(log_s=state.log_s + (drift + scale * z + jump))

    def prices(self, state: KouState):
        return exp32(state.log_s)

    def log_prices(self, state):
        """Native log prices — the functional engines fold log-space
        functionals on these directly (no per-step exp/log)."""
        return state.log_s
