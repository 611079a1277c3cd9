"""Local-volatility process: sigma(t, S) from a device-resident surface.

The industry-standard generalization of GBM (Dupire 1994): the instantaneous
volatility is a deterministic function of time and spot,

    d log S = (r - sigma(t, S)^2 / 2) dt + sigma(t, S) dW.

Design:
- the surface lives as a small grid of **time-knot rows** (default 16
  pillars — market surfaces have ~10-20 expiries) x **128 log-moneyness
  knots**, stored flat;
- the value at (t, S) is bilinear: linear in time between the two
  bracketing time knots, linear in log-moneyness between the two
  bracketing knots, flat outside the knot range (market practice) — four
  table reads per path, a gather in the scan engine and indexed loads
  inside the fused kernel.

Runs in the scan engine and the fused path kernel unchanged.  The
reference has only constant/GARCH vols (reference app.py:586-657); local
vol is what production equity-derivatives MC actually calibrates to.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from montecarlo.rng.normal import exp32, log32
import numpy as np

from montecarlo.processes.base import NormalDrawsMixin

KNOTS = 128
DEFAULT_TIME_KNOTS = 16


def _bracket(x, x0, dx):
    """Lower knot index and weight of the upper knot for log-moneyness x
    (edge-clamped: flat extrapolation outside the grid)."""
    u = (x - x0) / dx
    i = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, KNOTS - 2)
    frac = jnp.clip(u - i.astype(x.dtype), 0.0, 1.0)
    return i, frac


def interp_row_1d(row, x, x0, dx):
    """Linear interpolation of a (KNOTS,) row at coordinates x,
    edge-clamped (flat extrapolation, market practice)."""
    i, frac = _bracket(x, x0, dx)
    return row[i] * (1.0 - frac) + frac * row[i + 1]


def knot_blend(flat, n_time_knots: int, u, i):
    """Entry ``i`` of a flat (n_time_knots * KNOTS,) surface at fractional
    time knot ``u``: linear between the two bracketing time-knot rows,
    flat beyond the first and last knot."""
    u = jnp.clip(u, 0.0, n_time_knots - 1.0)
    j0 = jnp.minimum(jnp.floor(u).astype(jnp.int32), n_time_knots - 2)
    w = u - j0.astype(u.dtype)
    at = j0 * KNOTS + i
    return (1.0 - w) * flat[at] + w * flat[at + KNOTS]


def surface_interp(flat, n_time_knots: int, u, x, x0, dx):
    """Bilinear read of a flat knot surface at time knot ``u`` and
    log-moneyness ``x``."""
    i, frac = _bracket(x, x0, dx)
    return (knot_blend(flat, n_time_knots, u, i) * (1.0 - frac)
            + frac * knot_blend(flat, n_time_knots, u, i + 1))


class LocalVolState(NamedTuple):
    log_s: jnp.ndarray  # (n_paths,)


class LocalVolGBM(NormalDrawsMixin, NamedTuple("LocalVolFields", [
        ("s0", jnp.ndarray),
        ("rate", jnp.ndarray),
        ("dt", jnp.ndarray),
        ("x0", jnp.ndarray),        # first log-moneyness knot
        ("dx", jnp.ndarray),        # log-moneyness knot spacing
        ("dt_knot", jnp.ndarray),   # time-knot spacing (years)
        ("vol_flat", jnp.ndarray),  # (n_time_knots * 128,) row-major surface
])):
    """GBM with state-and-time-dependent volatility from a sampled surface."""

    n_draws = 1

    @classmethod
    def create(cls, s0, rate, dt, n_steps: int,
               vol_fn: Callable[[float, np.ndarray], np.ndarray],
               x_min: float = -1.5, x_max: float = 1.5,
               n_time_knots: int | None = None,
               dtype=jnp.float32) -> "LocalVolGBM":
        """Sample ``vol_fn(t, spots) -> vols`` onto the surface grid.

        ``vol_fn`` is evaluated host-side at ``n_time_knots`` uniform knot
        times spanning [0, n_steps * dt] over spots ``s0 * exp(x)`` for 128
        uniform log-moneyness knots x in [x_min, x_max].  Between knots the
        vol interpolates linearly in time (exact for surfaces linear in t);
        a surface needing finer time structure passes more knots.
        """
        n_tk = (min(max(n_steps, 2), DEFAULT_TIME_KNOTS)
                if n_time_knots is None else n_time_knots)
        if n_tk < 2:
            raise ValueError("need at least 2 time knots")
        horizon = n_steps * float(dt)
        dt_knot = horizon / (n_tk - 1)
        x = np.linspace(x_min, x_max, KNOTS)
        spots = float(s0) * np.exp(x)
        rows = np.stack([
            np.asarray(vol_fn(j * dt_knot, spots), np.float64)
            for j in range(n_tk)])
        if rows.shape != (n_tk, KNOTS):
            raise ValueError(f"vol_fn must return {KNOTS} vols per knot")
        if np.any(rows <= 0) or not np.all(np.isfinite(rows)):
            raise ValueError("vol surface must be positive and finite")
        as_ = lambda v: jnp.asarray(v, dtype)
        return cls(s0=as_(s0), rate=as_(rate), dt=as_(dt),
                   x0=as_(x[0]), dx=as_(x[1] - x[0]), dt_knot=as_(dt_knot),
                   vol_flat=as_(rows.reshape(-1)))

    @property
    def n_time_knots(self) -> int:
        return self.vol_flat.shape[0] // KNOTS

    def init_state(self, path_ids, dtype=jnp.float32) -> LocalVolState:
        return LocalVolState(log_s=jnp.full(
            path_ids.shape, log32(self.s0).astype(dtype), dtype))

    def _time_knot(self, t, dtype):
        return (jnp.asarray(t).astype(dtype) * self.dt.astype(dtype)
                / self.dt_knot.astype(dtype))

    def _row(self, t, dtype):
        """The whole surface row at (traced) step t."""
        return knot_blend(self.vol_flat.astype(dtype), self.n_time_knots,
                          self._time_knot(t, dtype),
                          jnp.arange(KNOTS, dtype=jnp.int32))

    def local_vol(self, log_s, t, dtype=None):
        """sigma(t, S) by bilinear interpolation (time knots x
        log-moneyness, edge-clamped)."""
        dtype = dtype or log_s.dtype
        x = log_s - log32(self.s0).astype(dtype)
        return surface_interp(self.vol_flat.astype(dtype),
                              self.n_time_knots, self._time_knot(t, dtype),
                              x, self.x0.astype(dtype),
                              self.dx.astype(dtype))

    def step(self, state: LocalVolState, eps, t) -> LocalVolState:
        z = eps[0]
        dtype = state.log_s.dtype
        sig = self.local_vol(state.log_s, t, dtype)
        dt = self.dt.astype(dtype)
        drift = (self.rate.astype(dtype) - 0.5 * jnp.square(sig)) * dt
        return LocalVolState(
            # Increment grouped before the add (see GBM.step).
            log_s=state.log_s + (drift + sig * jnp.sqrt(dt) * z))

    def prices(self, state: LocalVolState):
        return exp32(state.log_s)

    def log_prices(self, state):
        """Native log prices — the functional engines fold log-space
        functionals on these directly (no per-step exp/log)."""
        return state.log_s
