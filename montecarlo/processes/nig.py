"""Normal-inverse-Gaussian (NIG) Levy process (Barndorff-Nielsen 1997).

    ln S_{t+dt} - ln S_t = (mu + omega) dt + beta * I + sqrt(I) * Z,
    I ~ InverseGaussian(delta*dt, gamma),   gamma = sqrt(alpha^2 - beta^2),
    omega = delta * (sqrt(alpha^2 - (beta+1)^2) - gamma)

A pure-jump Levy model with semi-heavy tails — the standard step up from
Merton/Kou when the *whole* return distribution (not just rare jumps) is
non-Gaussian.  Because NIG is closed under convolution, the per-step
increment is **exactly** NIG-distributed: there is no time-discretization
error at any step count (unlike the Euler schemes), and the martingale
correction ``omega`` makes ``E[S_t] = s0 * exp(mu*t)`` exact.

Sampling is exact and branch-free, so the process runs in the fused Pallas
kernel like every other scalar-state process: the IG subordinator increment
uses the Michael-Schucany-Haas (1976) transform — one standard normal
``z_ig`` plus one accept uniform ``u`` — with the smaller root computed in
the rationalized form

    x = m * z_ig^2,  s = sqrt(x * (x + 4*lam)),  y = 4*lam*m*x / (x + s)^2

(m = mean = delta*dt/gamma, lam = shape = (delta*dt)^2), which is
algebraically identical to the textbook ``m + m^2 nu/(2 lam) - ...`` form
but has **no cancellation**: every term is positive, so it is f32-safe at
the tiny per-step IG means daily grids produce.  Accept ``y`` when
``u * (m + y) <= m``, else take ``m^2 / y`` — a single where-select.

Draw layout per step (DEVNOTES "RNG convention trap": a Box-Muller normal
consumes both cipher halves, so uniforms never share ciphers with normals):
``z_ig``/``z`` at draw indices 2t/2t+1 of the main stream (one shared
cipher pair), the accept uniform at index t of a separate key stream.

Validation oracle: the NIG characteristic function is closed-form
(:func:`montecarlo.engine.cf_pricing.nig_log_cf` +
:func:`~montecarlo.engine.cf_pricing.cf_call_price`).  Beyond-reference
capability (the reference's only stochastic model is the GARCH bootstrap,
reference app.py:586-657); same process protocol as every other model here.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from montecarlo.rng.normal import (exp32, log32, normal_draw,
                                       normal_pair, uniform_draw,
                                       uniform_pair)

# Key-stream offset for the IG accept uniforms.  Distinct from Merton's
# 0x6A09E667 and int31-safe: the fused kernel traces `stream` as int32.
_IG_STREAM = 0x510E527F


class NIGState(NamedTuple):
    log_s: jnp.ndarray


class NIG(NamedTuple("NIGFields", [
        ("s0", jnp.ndarray),
        ("mu", jnp.ndarray),     # drift of E[S_t] per unit time (r - q)
        ("alpha", jnp.ndarray),  # tail heaviness (> |beta + 1|)
        ("beta", jnp.ndarray),   # skewness (< 0: heavier down-tail)
        ("delta", jnp.ndarray),  # scale per unit time (> 0)
        ("dt", jnp.ndarray),
])):
    """Normal-inverse-Gaussian log-returns with martingale correction."""

    n_draws = 3  # z_ig (IG transform), u (accept), z (conditional normal)
    draw_kinds = ("normal", "uniform", "normal")

    @classmethod
    def create(cls, s0, mu, alpha, beta, delta, dt, dtype=jnp.float32):
        if float(delta) <= 0.0:
            raise ValueError("delta must be positive")
        if float(alpha) <= abs(float(beta)):
            raise ValueError("need alpha > |beta| (gamma real)")
        if float(alpha) <= abs(float(beta) + 1.0):
            raise ValueError(
                "need alpha > |beta + 1| (finite E[S_t] for the "
                "martingale correction)")
        as_ = lambda v: jnp.asarray(v, dtype)
        return cls(s0=as_(s0), mu=as_(mu), alpha=as_(alpha), beta=as_(beta),
                   delta=as_(delta), dt=as_(dt))

    def init_state(self, path_ids, dtype=jnp.float32) -> NIGState:
        return NIGState(log_s=jnp.full(path_ids.shape,
                                       log32(self.s0).astype(dtype),
                                       dtype))

    def draws(self, seed, stream, path_ids, t, dtype=jnp.float32):
        m0 = jnp.asarray(t).astype(jnp.uint32) * jnp.uint32(2)
        z_ig = normal_draw(seed, stream, path_ids, m0, dtype)
        z = normal_draw(seed, stream, path_ids, m0 + jnp.uint32(1), dtype)
        u = uniform_draw(seed, stream ^ _IG_STREAM, path_ids,
                         jnp.asarray(t).astype(jnp.uint32), dtype)
        return (z_ig, u, z)

    def draws_pair(self, seed, stream, path_ids, j, dtype=jnp.float32):
        """Two-step draws with EXPLICIT cipher sharing (fused kernel): step
        t's two normals are the Box-Muller halves of pair counter t, and the
        two steps' accept uniforms are the two halves of counter j — same
        layout as Merton.  Bitwise identical to two :meth:`draws` calls."""
        jj = jnp.asarray(j).astype(jnp.uint32)
        za, zb = normal_pair(seed, stream, path_ids,
                             jj * jnp.uint32(2), dtype)
        zc, zd = normal_pair(seed, stream, path_ids,
                             jj * jnp.uint32(2) + jnp.uint32(1), dtype)
        u0, u1 = uniform_pair(seed, stream ^ _IG_STREAM, path_ids, jj,
                              dtype)
        return (za, u0, zb), (zc, u1, zd)

    def antithetic(self, eps):
        z_ig, u, z = eps
        # Mirror the conditional normal; reflect the accept uniform (keeps
        # it uniform, anticorrelates the root choice).  -z_ig is a no-op
        # (it enters as z^2) but keeps the mirrored tuple well-formed.
        return (-z_ig, 1.0 - u, -z)

    def _gamma(self, dtype):
        a = self.alpha.astype(dtype)
        b = self.beta.astype(dtype)
        return jnp.sqrt(jnp.square(a) - jnp.square(b))

    def _ig_increment(self, z_ig, u, dtype):
        """Exact IG(delta*dt, gamma) subordinator increment, branch-free."""
        gamma = self._gamma(dtype)
        a = (self.delta * self.dt).astype(dtype)  # IG "time" parameter
        m = a / gamma                             # mean
        lam = jnp.square(a)                       # shape
        # Floor nu so x + s never vanishes (z_ig == 0 is possible from
        # Box-Muller's sin leg); at nu = 1e-12 the stable form already
        # rounds to y = m, the correct nu -> 0 limit.
        nu = jnp.maximum(jnp.square(z_ig), jnp.asarray(1e-12, dtype))
        x = m * nu
        s = jnp.sqrt(x * (x + 4.0 * lam))
        y = 4.0 * lam * m * x / jnp.square(x + s)
        return jnp.where(u * (m + y) <= m, y, jnp.square(m) / y)

    def omega(self, dtype=jnp.float32):
        """Martingale correction per unit time: E[S_t] = s0 e^{mu t}."""
        a = self.alpha.astype(dtype)
        b = self.beta.astype(dtype)
        d = self.delta.astype(dtype)
        return d * (jnp.sqrt(jnp.square(a) - jnp.square(b + 1.0))
                    - self._gamma(dtype))

    def step(self, state: NIGState, eps, t) -> NIGState:
        dtype = state.log_s.dtype
        z_ig, u, z = eps
        inc_ig = self._ig_increment(z_ig, u, dtype)
        drift = ((self.mu.astype(dtype) + self.omega(dtype))
                 * self.dt.astype(dtype))
        beta = self.beta.astype(dtype)
        # Increment grouped before the accumulator add (see GBM.step).
        return NIGState(log_s=state.log_s
                        + (drift + beta * inc_ig
                           + jnp.sqrt(inc_ig) * z))

    def prices(self, state: NIGState):
        return exp32(state.log_s)

    def log_prices(self, state):
        """Native log prices — the functional engines fold log-space
        functionals on these directly (no per-step exp/log)."""
        return state.log_s
