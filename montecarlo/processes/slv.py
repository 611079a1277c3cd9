"""Heston stochastic-local-volatility (SLV) with particle-calibrated leverage.

    d log S = (r - L(t,S)^2 v^+ / 2) dt + L(t,S) sqrt(v^+ dt) z_s
    dv      = kappa (theta - v^+) dt + xi sqrt(v^+ dt) z_v
    z_v     = rho z_s + sqrt(1 - rho^2) z_2          (full-truncation Euler,
                                                      as processes/heston.py)

The production equity-desk model: stochastic vol supplies realistic smile
*dynamics* (forward skew, vol-of-vol) while the leverage function L(t,S)
pins the model to today's vanilla surface.  Gyongy's lemma gives the
consistency condition

    L^2(t,S) * E[v_t | S_t = S] = sigma_LV^2(t,S)

where sigma_LV is the Dupire local vol of the target surface
(`processes/dupire.py`).  L is calibrated by the particle method (Guyon &
Henry-Labordere 2012): simulate N particles forward one step at a time; at
each step estimate E[v | S] on the 128-knot log-moneyness grid the
local-vol machinery already uses (`processes/local_vol.py`), set that
step's leverage row, and advance the particles with it.

Design:
- the whole calibration is ONE jitted `lax.scan` — no per-step host round
  trips; the binned conditional expectation is two `segment_sum`s over the
  128 knots (cloud-in-cell deposits: each particle splits its weight
  linearly between its two bracketing knots, so the estimator is exactly
  the piecewise-linear-hat Nadaraya-Watson), followed by a small
  triangular smoothing kernel and a shrink-to-mean regularizer for
  unvisited bins;
- particle draws use the NormalDrawsMixin counter convention, so pricing
  the calibrated SLV via `engine.simulate` with the calibration seed
  re-walks the *exact* calibration particles (bitwise) — the calibration
  is self-consistent by construction;
- the per-step leverage rows (n_steps, 128) are indexed by traced step id
  (a gather in the scan engine, indexed loads in the fused kernel).
  :func:`slv_to_kernel` resamples the leverage onto a few time knots
  (:class:`SLVKnots`, LocalVolGBM's time treatment) — a much smaller
  table; the reprice difference of the piecewise-linear-in-time leverage
  is tested to sit inside the MC noise.  The reference has no SLV at all
  (beyond-reference; its only vol models are constant and GARCH —
  reference app.py:586-657).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from montecarlo.processes.base import NormalDrawsMixin
from montecarlo.processes.local_vol import (DEFAULT_TIME_KNOTS,
                                                 KNOTS, LocalVolGBM,
                                                 interp_row_1d, surface_interp)
from montecarlo.rng.normal import exp32, log32
from montecarlo.rng.threefry import key_from_seed_dynamic


class SLVState(NamedTuple):
    log_s: jnp.ndarray  # (n_paths,)
    v: jnp.ndarray      # (n_paths,) — may go negative; truncated at use


# Canonical definition lives next to the grid machinery.
_interp_row = interp_row_1d


class SLV(NormalDrawsMixin, NamedTuple("SLVFields", [
        ("s0", jnp.ndarray),
        ("rate", jnp.ndarray),
        ("v0", jnp.ndarray),
        ("kappa", jnp.ndarray),
        ("theta", jnp.ndarray),
        ("xi", jnp.ndarray),
        ("rho", jnp.ndarray),
        ("dt", jnp.ndarray),
        ("x0", jnp.ndarray),        # first log-moneyness knot
        ("dx", jnp.ndarray),        # knot spacing
        ("lev_rows", jnp.ndarray),  # (n_steps, KNOTS) per-step leverage
])):
    """Heston dynamics with a per-step leverage surface (scan engine and
    fused kernel alike)."""

    n_draws = 2

    def init_state(self, path_ids, dtype=jnp.float32) -> SLVState:
        shape = path_ids.shape
        return SLVState(
            log_s=jnp.full(shape, log32(self.s0).astype(dtype), dtype),
            v=jnp.full(shape, self.v0.astype(dtype), dtype),
        )

    def leverage(self, log_s, t):
        """L(t, S) — the step-t leverage row interpolated at the paths'
        log-moneyness."""
        dtype = log_s.dtype
        rows = self.lev_rows.astype(dtype)
        k = jnp.clip(jnp.asarray(t).astype(jnp.int32), 0, rows.shape[0] - 1)
        x = log_s - log32(self.s0).astype(dtype)
        return _interp_row(rows[k], x, self.x0.astype(dtype),
                           self.dx.astype(dtype))

    def step(self, state: SLVState, eps, t) -> SLVState:
        dtype = state.log_s.dtype
        z1, z2 = eps[0], eps[1]
        rho = self.rho.astype(dtype)
        z_v = rho * z1 + jnp.sqrt(1.0 - jnp.square(rho)) * z2
        dt = self.dt.astype(dtype)
        v_plus = jnp.maximum(state.v, 0.0)
        # Double-where sqrt guard (pathwise-Greeks-safe; see Heston.step).
        positive = v_plus > 0
        v_safe = jnp.where(positive, v_plus, 1.0)
        sq_vdt = jnp.where(positive, jnp.sqrt(v_safe * dt), 0.0)
        lev = self.leverage(state.log_s, t)
        log_s = (state.log_s
                 + ((self.rate.astype(dtype)
                     - 0.5 * jnp.square(lev) * v_plus) * dt
                    + lev * sq_vdt * z1))
        v = (state.v
             + self.kappa.astype(dtype)
             * (self.theta.astype(dtype) - v_plus) * dt
             + self.xi.astype(dtype) * sq_vdt * z_v)
        return SLVState(log_s=log_s, v=v)

    def prices(self, state: SLVState):
        return exp32(state.log_s)

    def log_prices(self, state):
        """Native log prices for log-space functionals."""
        return state.log_s


class SLVKnots(NormalDrawsMixin, NamedTuple("SLVKnotsFields", [
        ("s0", jnp.ndarray),
        ("rate", jnp.ndarray),
        ("v0", jnp.ndarray),
        ("kappa", jnp.ndarray),
        ("theta", jnp.ndarray),
        ("xi", jnp.ndarray),
        ("rho", jnp.ndarray),
        ("dt", jnp.ndarray),
        ("x0", jnp.ndarray),
        ("dx", jnp.ndarray),
        ("dt_knot", jnp.ndarray),   # time-knot spacing (years)
        ("lev_flat", jnp.ndarray),  # (n_knots * 128,) row-major leverage
])):
    """Compact SLV: the leverage surface lives on a few time knots
    (LocalVolGBM's treatment) instead of :class:`SLV`'s exact per-step
    rows.  Leverage is piecewise-LINEAR in time between
    knots — vol surfaces are smooth in t, and the reprice difference vs
    the per-step process is tested to be inside the MC noise.  Everything
    else (full-truncation Heston dynamics, draw streams) matches
    :class:`SLV`; build one with :func:`slv_to_kernel`.
    """

    n_draws = 2

    @property
    def n_time_knots(self) -> int:
        return self.lev_flat.shape[0] // KNOTS

    def init_state(self, path_ids, dtype=jnp.float32) -> SLVState:
        shape = path_ids.shape
        return SLVState(
            log_s=jnp.full(shape, log32(self.s0).astype(dtype), dtype),
            v=jnp.full(shape, self.v0.astype(dtype), dtype),
        )

    def leverage(self, log_s, t):
        """L(t, S): bilinear read of the knot surface (see
        LocalVolGBM.local_vol)."""
        dtype = log_s.dtype
        u = (jnp.asarray(t).astype(dtype) * self.dt.astype(dtype)
             / self.dt_knot.astype(dtype))
        x = log_s - log32(self.s0).astype(dtype)
        return surface_interp(self.lev_flat.astype(dtype),
                              self.n_time_knots, u, x,
                              self.x0.astype(dtype), self.dx.astype(dtype))

    step = SLV.step
    prices = SLV.prices
    log_prices = SLV.log_prices


def slv_to_kernel(slv: SLV, n_time_knots: int = DEFAULT_TIME_KNOTS
                  ) -> SLVKnots:
    """Resample an :class:`SLV`'s per-step leverage rows onto linear
    time knots, yielding the fused-kernel-eligible :class:`SLVKnots`.

    Knot j sits at time j * horizon/(n_knots-1); its row is the linear
    blend of the two bracketing per-step rows (flat at the ends), so the
    knot surface interpolates the per-step surface exactly where steps and
    knots coincide."""
    import numpy as np

    rows = np.asarray(slv.lev_rows, np.float64)   # (n_steps, KNOTS)
    n_steps = rows.shape[0]
    if n_time_knots < 2:
        raise ValueError("need at least 2 time knots")
    dt = float(slv.dt)
    horizon = n_steps * dt
    dt_knot = horizon / (n_time_knots - 1)
    knot_rows = np.empty((n_time_knots, KNOTS))
    for j in range(n_time_knots):
        s = min(j * dt_knot / dt, n_steps - 1.0)
        k = int(min(int(s), n_steps - 2))
        f = s - k
        knot_rows[j] = (1.0 - f) * rows[k] + f * rows[k + 1]
    f32 = lambda v: jnp.asarray(v, jnp.float32)
    return SLVKnots(s0=slv.s0, rate=slv.rate, v0=slv.v0, kappa=slv.kappa,
                    theta=slv.theta, xi=slv.xi, rho=slv.rho, dt=slv.dt,
                    x0=slv.x0, dx=slv.dx, dt_knot=f32(dt_knot),
                    lev_flat=f32(knot_rows.reshape(-1)))


@partial(jax.jit, static_argnames=("n_particles", "n_steps", "smooth_bins",
                                   "dtype"))
def _calibrate_rows(lv, v0, kappa, theta, xi, rho, k0, k1,
                    n_particles: int, n_steps: int, reg, lev_min, lev_max,
                    smooth_bins: int, dtype):
    from montecarlo.engine.simulate import path_ids_for
    from montecarlo.rng.normal import normal_draw

    ids = path_ids_for(n_particles, 0)
    log_s0 = log32(lv.s0).astype(dtype)
    x0 = lv.x0.astype(dtype)
    dx = lv.dx.astype(dtype)
    dt = lv.dt.astype(dtype)
    rho_ = jnp.asarray(rho, dtype)
    # Triangular smoothing kernel over knots (static length, unit mass).
    half = (smooth_bins - 1) // 2
    kern = jnp.asarray(
        np.convolve(np.ones(half + 1), np.ones(half + 1))
        / float((half + 1) ** 2), dtype)

    def body(carry, t):
        log_s, v = carry
        v_plus = jnp.maximum(v, 0.0)

        # --- E[v | S] on the knot grid (cloud-in-cell Nadaraya-Watson) ---
        x = log_s - log_s0
        u = (x - x0) / dx
        i = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, KNOTS - 2)
        frac = jnp.clip(u - i.astype(dtype), 0.0, 1.0)
        w_lo, w_hi = 1.0 - frac, frac
        denom = (jax.ops.segment_sum(w_lo, i, num_segments=KNOTS)
                 + jax.ops.segment_sum(w_hi, i + 1, num_segments=KNOTS))
        numer = (jax.ops.segment_sum(w_lo * v_plus, i, num_segments=KNOTS)
                 + jax.ops.segment_sum(w_hi * v_plus, i + 1,
                                       num_segments=KNOTS))
        denom_s = jnp.convolve(denom, kern, mode="same")
        numer_s = jnp.convolve(numer, kern, mode="same")
        # Shrink unvisited/thin bins to the cross-section mean variance —
        # those bins carry (almost) no particles, so their leverage only
        # matters as flat extrapolation for strays.
        vbar = jnp.mean(v_plus)
        ev = (numer_s + reg * vbar) / (denom_s + reg)

        # --- Gyongy: L = sigma_LV / sqrt(E[v|S]) on the grid ---
        sig_row = lv._row(t, dtype)
        lev_row = jnp.clip(sig_row / jnp.sqrt(jnp.maximum(ev, 1e-8)),
                           lev_min, lev_max)

        # --- advance particles with this row (NormalDrawsMixin streams:
        # simulate(SLV, seed=calibration seed) re-walks these particles) ---
        d0 = jnp.asarray(t).astype(jnp.uint32) * jnp.uint32(2)
        z1 = normal_draw(k0, k1, ids, d0, dtype)
        z2 = normal_draw(k0, k1, ids, d0 + jnp.uint32(1), dtype)
        z_v = rho_ * z1 + jnp.sqrt(1.0 - jnp.square(rho_)) * z2
        positive = v_plus > 0
        v_safe = jnp.where(positive, v_plus, 1.0)
        sq_vdt = jnp.where(positive, jnp.sqrt(v_safe * dt), 0.0)
        lev = _interp_row(lev_row, x, x0, dx)
        log_s = (log_s
                 + ((lv.rate.astype(dtype)
                     - 0.5 * jnp.square(lev) * v_plus) * dt
                    + lev * sq_vdt * z1))
        v = (v + jnp.asarray(kappa, dtype)
             * (jnp.asarray(theta, dtype) - v_plus) * dt
             + jnp.asarray(xi, dtype) * sq_vdt * z_v)
        return (log_s, v), lev_row

    log_s_init = jnp.full((n_particles,), log_s0, dtype)
    v_init = jnp.full((n_particles,), jnp.asarray(v0, dtype), dtype)
    _, lev_rows = jax.lax.scan(body, (log_s_init, v_init),
                               jnp.arange(n_steps, dtype=jnp.int32))
    return lev_rows


def calibrate_slv(lv: LocalVolGBM, *, v0, kappa, theta, xi, rho,
                  n_steps: int, n_particles: int = 1 << 17, seed: int = 0,
                  reg: float = 1.0, lev_min: float = 0.05,
                  lev_max: float = 20.0, smooth_bins: int = 5,
                  dtype=jnp.float32) -> SLV:
    """Calibrate an :class:`SLV` process to a Dupire local-vol target.

    Args:
      lv: the target local-vol model (`LocalVolGBM`, typically built via
        `processes.dupire.local_vol_fn_from_ivs`) — supplies s0, rate, dt,
        the knot grid, and sigma_LV(t, S).  Create it with the SAME
        ``n_steps``/``dt`` used here so its time knots span the horizon.
      v0/kappa/theta/xi/rho: the Heston mixing dynamics (choose freely —
        e.g. from a time-series fit or exotics calibration; leverage
        absorbs the vanilla surface either way).
      n_particles: particles for the conditional-expectation estimate.
      reg: shrink-to-mean weight (in particle-count units) for thin bins.
      smooth_bins: triangular smoothing width over the 128 knots (odd).

    Returns the calibrated SLV process (one device program; the returned
    ``lev_rows`` grid is (n_steps, 128)).
    """
    if smooth_bins < 1 or smooth_bins % 2 == 0:
        raise ValueError("smooth_bins must be odd and >= 1")
    k0, k1 = key_from_seed_dynamic(seed, 0)
    lev_rows = _calibrate_rows(
        lv, v0, kappa, theta, xi, rho, k0, k1, n_particles, n_steps,
        jnp.asarray(reg, dtype), jnp.asarray(lev_min, dtype),
        jnp.asarray(lev_max, dtype), smooth_bins, dtype)
    as_ = lambda val: jnp.asarray(val, dtype)
    return SLV(s0=as_(lv.s0), rate=as_(lv.rate), v0=as_(v0),
               kappa=as_(kappa), theta=as_(theta), xi=as_(xi), rho=as_(rho),
               dt=as_(lv.dt), x0=as_(lv.x0), dx=as_(lv.dx),
               lev_rows=lev_rows)


__all__ = ["SLV", "SLVKnots", "SLVState", "calibrate_slv",
           "slv_to_kernel"]
