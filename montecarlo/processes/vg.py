"""Variance-Gamma Levy process (Madan-Carr-Chang 1998).

    ln S_{t+dt} - ln S_t = (mu + omega) dt + theta * G + sigma * sqrt(G) * Z,
    G ~ Gamma(shape = dt/nu, scale = nu),
    omega = log(1 - theta*nu - sigma^2*nu/2) / nu

Brownian motion with drift ``theta`` time-changed by a gamma subordinator —
the other canonical pure-jump Levy model next to NIG (`processes/nig.py`),
with *polynomial* (rather than semi-heavy) tails and independent skew /
kurtosis control (theta / nu).  Like NIG, VG is closed under convolution:
the per-step increment is EXACTLY VG-distributed, so there is no
time-discretization error at any step count, and the CF oracle
(:func:`montecarlo.engine.cf_pricing.vg_log_cf`) must match at every
step count.

Sampling is exact and branch-free — unusual for gamma variates, whose
standard samplers are rejection loops: the subordinator increment uses the
boost identity ``Gamma(a) = Gamma(1+a) * U^(1/a)`` with the shape-(1+a)
part inverted through a trace-time residual quantile table (the shape is a
create-time constant — `rng/gamma.py::gamma_icdf_resid_table64`, cubic
Hermite over four table reads, quantile error ~1e-6 vs f64 scipy).  That
keeps the (seed, stream, path, t) counter contract (static draw count
per step) and lets VG ride the fused path kernel like every other
scalar-state process.

Draw layout per step (DEVNOTES "RNG convention trap"): the conditional
normal ``z`` at draw index t of the main stream (two steps share a
Box-Muller cipher), the two inversion uniforms ``(u_w, u_boost)`` as the
two halves of cipher t on a separate key stream.

Beyond-reference capability (the reference's only stochastic model is the
GARCH bootstrap, reference app.py:586-657); same process protocol as every
other model here (`processes/base.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from montecarlo.rng.gamma import (gamma_from_uniforms_table32,
                                      gamma_icdf_resid_table64)
from montecarlo.rng.normal import (exp32, log32, normal_draw,
                                       normal_pair, uniform_draw,
                                       uniform_pair)

# Key-stream offset for the gamma-inversion uniforms.  Distinct from
# Merton's 0x6A09E667 and NIG's 0x510E527F; int31-safe (the fused kernel
# traces `stream` as int32).
_VG_STREAM = 0x1F83D9AB


class VGState(NamedTuple):
    log_s: jnp.ndarray


class VarianceGamma(NamedTuple("VGFields", [
        ("s0", jnp.ndarray),
        ("mu", jnp.ndarray),     # drift of E[S_t] per unit time (r - q)
        ("sigma", jnp.ndarray),  # diffusion scale of the subordinated BM
        ("theta", jnp.ndarray),  # subordinated drift (< 0: down-skew)
        ("nu", jnp.ndarray),     # subordinator variance rate (kurtosis)
        ("dt", jnp.ndarray),
        ("gq_z0", jnp.ndarray),      # quantile-table first z knot
        ("gq_dz", jnp.ndarray),      # quantile-table z spacing
        ("gq_resid", jnp.ndarray),   # (512,) residual log-quantile
        ("gq_dresid", jnp.ndarray),  # (512,) its z-derivative
])):
    """Variance-Gamma log-returns with martingale correction.

    The gamma shape b = 1 + dt/nu is fixed at create time, so the shape-b
    quantile rides a precomputed residual table (`rng/gamma.py::
    gamma_icdf_resid_table64`) — cubic Hermite over GARCH-style lane
    gathers instead of the 4-step log-Newton, ~10x cheaper per step at the
    same ~1e-6 accuracy."""

    n_draws = 3  # u_w (shape-(1+a) inversion), u_boost, z
    draw_kinds = ("uniform", "uniform", "normal")

    @classmethod
    def create(cls, s0, mu, sigma, theta, nu, dt, dtype=jnp.float32):
        if float(sigma) <= 0.0:
            raise ValueError("sigma must be positive")
        if float(nu) <= 0.0:
            raise ValueError("nu must be positive")
        if float(dt) > float(nu):
            raise ValueError(
                "need dt <= nu (gamma shape dt/nu <= 1 for the boost-"
                "identity sampler in rng/gamma.py) — use more steps")
        if 1.0 - float(theta) * float(nu) \
                - 0.5 * float(sigma) ** 2 * float(nu) <= 0.0:
            raise ValueError(
                "need theta*nu + sigma^2*nu/2 < 1 (finite E[S_t] for the "
                "martingale correction)")
        z0, dz, resid, dresid = gamma_icdf_resid_table64(
            1.0 + float(dt) / float(nu))
        as_ = lambda v: jnp.asarray(v, dtype)
        f32 = lambda v: jnp.asarray(v, jnp.float32)
        return cls(s0=as_(s0), mu=as_(mu), sigma=as_(sigma),
                   theta=as_(theta), nu=as_(nu), dt=as_(dt),
                   gq_z0=f32(z0), gq_dz=f32(dz), gq_resid=f32(resid),
                   gq_dresid=f32(dresid))

    def init_state(self, path_ids, dtype=jnp.float32) -> VGState:
        return VGState(log_s=jnp.full(path_ids.shape,
                                      log32(self.s0).astype(dtype),
                                      dtype))

    def draws(self, seed, stream, path_ids, t, dtype=jnp.float32):
        tt = jnp.asarray(t).astype(jnp.uint32)
        u_w = uniform_draw(seed, stream ^ _VG_STREAM, path_ids,
                           tt * jnp.uint32(2), dtype)
        u_b = uniform_draw(seed, stream ^ _VG_STREAM, path_ids,
                           tt * jnp.uint32(2) + jnp.uint32(1), dtype)
        z = normal_draw(seed, stream, path_ids, tt, dtype)
        return (u_w, u_b, z)

    def draws_pair(self, seed, stream, path_ids, j, dtype=jnp.float32):
        """Two-step draws with EXPLICIT cipher sharing (fused kernel): the
        two steps' normals are the Box-Muller halves of pair counter j, and
        each step's (u_w, u_boost) are the two halves of its own uniform
        cipher.  Bitwise identical to two :meth:`draws` calls."""
        jj = jnp.asarray(j).astype(jnp.uint32)
        za, zb = normal_pair(seed, stream, path_ids, jj, dtype)
        ua_w, ua_b = uniform_pair(seed, stream ^ _VG_STREAM, path_ids,
                                  jj * jnp.uint32(2), dtype)
        ub_w, ub_b = uniform_pair(seed, stream ^ _VG_STREAM, path_ids,
                                  jj * jnp.uint32(2) + jnp.uint32(1), dtype)
        return (ua_w, ua_b, za), (ub_w, ub_b, zb)

    def antithetic(self, eps):
        u_w, u_b, z = eps
        # Reflect both inversion uniforms (the quantile and the boost power
        # are monotone in u, so G is anticorrelated) and mirror the normal.
        return (1.0 - u_w, 1.0 - u_b, -z)

    def omega(self, dtype=jnp.float32):
        """Martingale correction per unit time: E[S_t] = s0 e^{mu t}."""
        th = self.theta.astype(dtype)
        nu = self.nu.astype(dtype)
        sg = self.sigma.astype(dtype)
        return log32(1.0 - th * nu - 0.5 * jnp.square(sg) * nu) / nu

    def _gamma_increment(self, u_w, u_b, dtype):
        """Exact Gamma(dt/nu, scale=nu) subordinator increment via the
        shape-(1+a) residual quantile table (f32, Pallas-safe; quantile
        error ~1e-6, far below MC noise), cast to the state dtype."""
        a = (self.dt / self.nu).astype(jnp.float32)
        g = gamma_from_uniforms_table32(
            a, u_w.astype(jnp.float32), u_b.astype(jnp.float32),
            self.gq_z0, self.gq_dz, self.gq_resid, self.gq_dresid)
        return (self.nu.astype(dtype) * g.astype(dtype))

    def step(self, state: VGState, eps, t) -> VGState:
        dtype = state.log_s.dtype
        u_w, u_b, z = eps
        g = self._gamma_increment(u_w, u_b, dtype)
        drift = ((self.mu.astype(dtype) + self.omega(dtype))
                 * self.dt.astype(dtype))
        th = self.theta.astype(dtype)
        # Increment grouped before the accumulator add (see GBM.step).
        return VGState(log_s=state.log_s
                       + (drift + th * g
                          + self.sigma.astype(dtype) * jnp.sqrt(g) * z))

    def prices(self, state: VGState):
        return exp32(state.log_s)

    def log_prices(self, state):
        """Native log prices — the functional engines fold log-space
        functionals on these directly (no per-step exp/log)."""
        return state.log_s
