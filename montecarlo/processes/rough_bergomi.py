"""Rough Bergomi (Bayer–Friz–Gatheral 2016) via exact-covariance sampling.

    v_t = xi0 * exp(eta * W~_t - eta^2/2 * t^{2H})
    dS/S = sqrt(v_t) * (rho dW + sqrt(1-rho^2) dW_perp)

where ``W~`` is the Riemann–Liouville fractional process
``sqrt(2H) int_0^t (t-u)^{H-1/2} dW_u`` with Hurst H < 1/2 — the "rough
volatility" model whose short-maturity ATM skew blows up like T^{H-1/2},
matching equity smiles where Markovian models cannot.

``W~`` is **non-Markovian**, so it does not fit the per-step process
protocol.  Sampling is instead one matmul: the joint Gaussian
of (W~ at the T grid times, the T Brownian increments) is sampled *exactly*
by one (N, 2T) @ (2T, 2T) matmul against the host-precomputed Cholesky
factor of the joint covariance — no hybrid-scheme kernel, no convolution,
and the discretization of v_t is exact in distribution at the grid times
(the only bias is the Riemann product for the S integral, shared by every
rBergomi scheme).

Covariances (r = H + 1/2):
  Cov[W~_t, W~_s]   = 2H * int_0^{min} (t-u)^{H-1/2} (s-u)^{H-1/2} du
                      (Gauss–Legendre on the half-open kernel, host-side)
  Cov[W~_t, W_s]    = sqrt(2H)/r * (t^r - (t - min(s,t))^r)
  Cov[W_t, W_s]     = min(t, s)

Draws are counter-based Threefry normals keyed by (seed, global path id,
column) — the framework's shard/replay contract — and the price path is a
`lax.scan` over the sampled v/dW arrays.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from montecarlo.rng.normal import exp32, log32, normal_draw
from montecarlo.engine.simulate import path_ids_for


def volterra_joint_chol(n_steps: int, T: float, H: float) -> np.ndarray:
    """(2T, 2T) Cholesky factor of the joint (W~ grid values, dW) Gaussian.

    Columns 0..T-1: W~ at t_1..t_T; columns T..2T-1: Brownian increments.
    Host-side, float64, one-time per (n_steps, T, H).
    """
    dt = T / n_steps
    t = (np.arange(1, n_steps + 1)) * dt
    r = H + 0.5
    c2h = 2.0 * H

    # Volterra-Volterra block: 2H int_0^{min} ((t-u)(s-u))^{H-1/2} du.
    # The (min-u)^{H-1/2} factor is singular at u=min; substituting
    # u = min - w^2 turns the integrand into 2 (max-min+w^2)^{H-1/2} w^{2H}
    # — bounded and smooth, so Gauss-Legendre in w converges fast.
    x_gl, w_gl = np.polynomial.legendre.leggauss(64)
    tt = t[:, None]
    ss = t[None, :]
    mn = np.minimum(tt, ss)
    gap = np.abs(tt - ss)
    half = 0.5 * np.sqrt(mn)
    w_nodes = half[..., None] * (x_gl + 1.0)      # (T, T, 64) in [0, sqrt(mn)]
    weights = half[..., None] * w_gl
    integrand = (2.0 * (gap[..., None] + w_nodes**2) ** (H - 0.5)
                 * w_nodes ** c2h)
    cov_vv = c2h * np.sum(weights * integrand, axis=-1)
    # diagonal is exact: Var[W~_t] = t^{2H}
    np.fill_diagonal(cov_vv, t ** c2h)

    # Volterra-Brownian: Cov[W~_ti, W_s] = sqrt(2H)/r (ti^r - (ti - min)^r)
    def cov_vw_point(ti, s):
        mn = np.minimum(s, ti)
        return np.sqrt(c2h) / r * (ti ** r - (ti - mn) ** r)

    s_grid = t
    cvw_full = cov_vw_point(tt, s_grid[None, :])          # vs W_{s_j}
    cvw_prev = cov_vw_point(tt, (s_grid - dt)[None, :])   # vs W_{s_{j-1}}
    cov_vw = cvw_full - cvw_prev                          # vs increments

    cov_ww = np.eye(n_steps) * dt

    top = np.concatenate([cov_vv, cov_vw], axis=1)
    bot = np.concatenate([cov_vw.T, cov_ww], axis=1)
    cov = np.concatenate([top, bot], axis=0)
    # jitter for numerical PSD (cov_vv quadrature error ~1e-12)
    return np.linalg.cholesky(cov + 1e-12 * np.eye(2 * n_steps))


class RoughBergomi(NamedTuple("RoughBergomiFields", [
        ("s0", jnp.ndarray),
        ("xi0", jnp.ndarray),    # forward variance level
        ("eta", jnp.ndarray),    # vol-of-vol
        ("rho", jnp.ndarray),    # spot-vol correlation
        ("h", jnp.ndarray),      # Hurst exponent
        ("chol", jnp.ndarray),   # (2T, 2T) joint Cholesky (f32)
        ("t_grid", jnp.ndarray),  # (T,) grid times
        ("dt", jnp.ndarray),
])):
    """Rough Bergomi sampler (not a step process — see module docstring)."""

    @classmethod
    def create(cls, s0, xi0, eta, rho, h, n_steps: int, T: float,
               dtype=jnp.float32):
        chol = volterra_joint_chol(n_steps, T, float(h))
        dt = T / n_steps
        as_ = lambda v: jnp.asarray(v, dtype)
        return cls(s0=as_(s0), xi0=as_(xi0), eta=as_(eta), rho=as_(rho),
                   h=as_(h), chol=as_(chol),
                   t_grid=as_(np.arange(1, n_steps + 1) * dt), dt=as_(dt))

    @property
    def n_steps(self) -> int:
        return self.t_grid.shape[0]


@partial(jax.jit, static_argnames=("n_paths", "seed", "stream", "mode"))
def rbergomi_simulate(model: RoughBergomi, n_paths: int, *, seed: int,
                      stream: int = 0, path_offset=0,
                      mode: str = "terminal"):
    """Terminal prices (or (v paths, S terminals)) under rough Bergomi.

    One (3T, n_paths) standard-normal block (counter-based: entry (m, i)
    is draw index m of global path i) hits the Cholesky factor as
    ``chol @ Z`` — (dims, paths) layout end to end, no transposes; the
    price integral is a sum over the exact-in-distribution v/dW rows.
    XLA fuses the Threefry cipher and Box-Muller into the kernel that
    writes the draw matrix, and the elementwise tail plus the reduction
    over T into one more.
    """
    T = model.n_steps
    ids = path_ids_for(n_paths, path_offset)
    cols = jnp.arange(3 * T, dtype=jnp.uint32)
    z = normal_draw(seed, stream, ids[None, :], cols[:, None],
                    jnp.float32)                            # (3T, N)
    # HIGHEST precision: an f32 matmul may run in TF32 on the GPU (about
    # three decimal digits), which would distort the sampled Gaussians'
    # covariance.  The factor matmul is a small part of the run, so
    # exactness wins.
    joint = jnp.matmul(model.chol, z[:2 * T],
                       precision=jax.lax.Precision.HIGHEST)  # (2T, N)
    w_tilde = joint[:T]                               # W~ at grid times
    dw = joint[T:]                                    # Brownian increments
    z_perp = z[2 * T:]                                # dW_perp normals

    t = model.t_grid
    v = model.xi0 * exp32(model.eta * w_tilde
                            - 0.5 * jnp.square(model.eta)
                            * t[:, None] ** (2.0 * model.h))  # (T, N)

    # log S: left-point Riemann (v evaluated at interval start; v_0 = xi0).
    v_left = jnp.concatenate(
        [jnp.full((1, n_paths), model.xi0, v.dtype), v[:-1]], axis=0)
    sqrt_v = jnp.sqrt(v_left)
    rho = model.rho
    dws = rho * dw + jnp.sqrt(1.0 - jnp.square(rho)) * z_perp \
        * jnp.sqrt(model.dt)
    log_s = (log32(model.s0)
             + jnp.sum(sqrt_v * dws - 0.5 * v_left * model.dt, axis=0))
    s_t = exp32(log_s)
    if mode == "paths":
        return v.T, s_t
    return s_t


__all__ = ["RoughBergomi", "rbergomi_simulate", "volterra_joint_chol"]
