"""Merton jump-diffusion: GBM plus compound-Poisson lognormal jumps.

    dS/S = (mu - lambda*m) dt + sigma dW + (e^J - 1) dN,
    N ~ Poisson(lambda), J ~ N(jump_mean, jump_std^2),
    m = E[e^J] - 1 = exp(jump_mean + jump_std^2/2) - 1

Per step (log-Euler, exact for the diffusion part):

    log S += (mu - lambda*m - sigma^2/2) dt + sigma sqrt(dt) z1
             + jump_mean*N + jump_std*sqrt(N) z2

The per-step jump count N is sampled exactly by inverse-CDF over a
truncated Poisson support (K_MAX=4; truncation error < (lambda*dt)^5/5!,
far below float32 resolution at daily steps) — a chain of where-selects, so
the process runs in the fused Pallas kernel like every other scalar-state
process.  Draw layout per step: z1 (diffusion), u (count), z2 (jump sizes),
normals at draw indices 2t/2t+1 of the main stream, the count uniform on
a separate key stream (a Box-Muller normal consumes both halves of its
cipher call, so uniforms must not share ciphers with normals) — all
counter-based and shard-invariant.

The European call has a semi-analytic series (Merton 1976), used as the
validation oracle in tests.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from montecarlo.rng.normal import (exp32, log32, normal_draw,
                                        normal_pair,
                                       uniform_draw, uniform_pair)

K_MAX = 4  # truncated Poisson support (error < (lam*dt)^5 / 5!)
_JUMP_STREAM = 0x6A09E667  # key-stream offset for the count uniforms


def check_jump_grid(lam, dt) -> None:
    """Reject per-step jump rates the K_MAX-truncated Poisson cannot carry
    (shared by Merton/Kou/Bates — one guard, one error message)."""
    rate = float(lam) * float(dt)
    if rate > 0.4:
        raise ValueError(
            f"lam*dt = {rate:.3f} too coarse for the K_MAX={K_MAX} "
            f"truncated Poisson (P(N>{K_MAX}) ~ {rate**5/120:.2e}); "
            "use more steps so lam*dt <= 0.4")


def poisson_count(u, rate, dtype):
    """Inverse-CDF Poisson(rate) on support {0..K_MAX} — THE shared count
    sampler of the jump processes."""
    pmf = exp32(-rate)
    cdf = pmf
    count = jnp.zeros_like(u)
    for k in range(1, K_MAX + 1):
        pmf = pmf * rate / k
        count = jnp.where(u > cdf, jnp.asarray(float(k), dtype), count)
        cdf = cdf + pmf
    return count


class MertonState(NamedTuple):
    log_s: jnp.ndarray


class Merton(NamedTuple("MertonFields", [
        ("s0", jnp.ndarray),
        ("mu", jnp.ndarray),
        ("sigma", jnp.ndarray),
        ("lam", jnp.ndarray),        # jump intensity per unit time
        ("jump_mean", jnp.ndarray),  # mean of log-jump J
        ("jump_std", jnp.ndarray),   # std of log-jump J
        ("dt", jnp.ndarray),
])):
    """Merton jump-diffusion with risk-drift compensation."""

    n_draws = 3
    draw_kinds = ("normal", "uniform", "normal")  # z1, u_count, z_jump

    @classmethod
    def create(cls, s0, mu, sigma, lam, jump_mean, jump_std, dt,
               dtype=jnp.float32):
        check_jump_grid(lam, dt)
        as_ = lambda v: jnp.asarray(v, dtype)
        return cls(s0=as_(s0), mu=as_(mu), sigma=as_(sigma), lam=as_(lam),
                   jump_mean=as_(jump_mean), jump_std=as_(jump_std),
                   dt=as_(dt))

    def init_state(self, path_ids, dtype=jnp.float32) -> MertonState:
        return MertonState(log_s=jnp.full(path_ids.shape,
                                          log32(self.s0).astype(dtype),
                                          dtype))

    def draws(self, seed, stream, path_ids, t, dtype=jnp.float32):
        # A Box-Muller normal consumes BOTH 32-bit halves of its cipher
        # call, so a raw-bits uniform must never share a cipher with a
        # normal (they would be dependent).  Normals take draw indices
        # 2t/2t+1 (one shared cipher, both halves used as the pair z0/z1);
        # the count uniform lives on a separate key stream entirely.
        m0 = jnp.asarray(t).astype(jnp.uint32) * jnp.uint32(2)
        z1 = normal_draw(seed, stream, path_ids, m0, dtype)
        z2 = normal_draw(seed, stream, path_ids, m0 + jnp.uint32(1), dtype)
        u = uniform_draw(seed, stream ^ _JUMP_STREAM, path_ids,
                         jnp.asarray(t).astype(jnp.uint32), dtype)
        return (z1, u, z2)

    def draws_pair(self, seed, stream, path_ids, j, dtype=jnp.float32):
        """Two-step draws with EXPLICIT cipher sharing (fused kernel):
        step t's normals are both components of pair counter t, and the
        two steps' count uniforms are the two halves of counter j — so a
        step pair costs 2 Box-Muller pairs + 1 uniform cipher instead of
        the 4 + 2 the per-step delegation paid (CSE across calls is
        unreliable in kernel bodies; worth ~1.3x on this kernel).
        Bitwise identical to two :meth:`draws` calls by construction."""
        jj = jnp.asarray(j).astype(jnp.uint32)
        z1a, z2a = normal_pair(seed, stream, path_ids,
                               jj * jnp.uint32(2), dtype)
        z1b, z2b = normal_pair(seed, stream, path_ids,
                               jj * jnp.uint32(2) + jnp.uint32(1), dtype)
        u0, u1 = uniform_pair(seed, stream ^ _JUMP_STREAM, path_ids, jj,
                              dtype)
        return (z1a, u0, z2a), (z1b, u1, z2b)

    def antithetic(self, eps):
        z1, u, z2 = eps
        # Mirror the normals; reflect the count uniform (u -> 1-u keeps it
        # uniform and anticorrelates the jump counts).
        return (-z1, 1.0 - u, -z2)

    def _poisson_count(self, u, dtype):
        return poisson_count(u, (self.lam * self.dt).astype(dtype), dtype)

    def step(self, state: MertonState, eps, t) -> MertonState:
        dtype = state.log_s.dtype
        z1, u, z2 = eps
        n = self._poisson_count(u, dtype)
        sigma = self.sigma.astype(dtype)
        dt = self.dt.astype(dtype)
        m = exp32(self.jump_mean + 0.5 * jnp.square(self.jump_std)) - 1.0
        drift = ((self.mu - self.lam * m - 0.5 * jnp.square(self.sigma))
                 * self.dt).astype(dtype)
        jump = (self.jump_mean.astype(dtype) * n
                + self.jump_std.astype(dtype) * jnp.sqrt(n) * z2)
        # Increment grouped before the accumulator add (see GBM.step).
        return MertonState(log_s=state.log_s
                           + (drift + sigma * jnp.sqrt(dt) * z1 + jump))

    def prices(self, state: MertonState):
        return exp32(state.log_s)

    def log_prices(self, state):
        """Native log prices — the functional engines fold log-space
        functionals on these directly (no per-step exp/log)."""
        return state.log_s


def merton_call_series(s0, strike, r, sigma, lam, jump_mean, jump_std, T,
                       n_terms: int = 30) -> float:
    """Merton (1976) semi-analytic European call — the validation oracle."""
    import numpy as np
    from scipy.stats import norm

    def bs(s0_, k_, r_, sig_, T_):
        d1 = (np.log(s0_ / k_) + (r_ + sig_**2 / 2) * T_) / (sig_ * np.sqrt(T_))
        d2 = d1 - sig_ * np.sqrt(T_)
        return s0_ * norm.cdf(d1) - k_ * np.exp(-r_ * T_) * norm.cdf(d2)

    m = np.exp(jump_mean + 0.5 * jump_std**2) - 1.0
    lam_p = lam * (1.0 + m)
    total = 0.0
    log_fact = 0.0
    for k in range(n_terms):
        if k > 0:
            log_fact += np.log(k)
        weight = np.exp(-lam_p * T + k * np.log(lam_p * T) - log_fact)
        sig_k = np.sqrt(sigma**2 + k * jump_std**2 / T)
        r_k = r - lam * m + k * (jump_mean + 0.5 * jump_std**2) / T
        total += weight * bs(s0, strike, r_k, sig_k, T)
    return float(total)
