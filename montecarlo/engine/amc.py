"""American Monte Carlo exposure: regression-marked trades for netting
sets.

Products without closed-form conditional values — Bermudan swaptions,
callables — enter an xVA netting set through the industry-standard AMC
technique: one backward Longstaff-Schwartz pass on the ENGINE'S OWN
simulation fits the exercise policy, then every exposure date gets a
cross-sectional regression of the policy's future discounted cashflows,
whose fitted value IS the trade's mark on still-alive paths; exercised
paths switch to the underlying's exact closed form.

This extends the framework's LSM family (`engine.american` for equity
payoffs, `engine.bermudan` for swaption PRICING) to exposure profiles —
the piece a desk needs to charge CVA on a Bermudan book.  The reference
app has nothing in this space (its risk surface stops at VaR/CVaR,
reference app.py:639-656).

Accuracy contract, stated rather than hidden:

- The conditional-value marks carry basis error (a cubic in the short
  rate here) and O(1/n_paths) regression noise, and fitting on the
  exposure paths themselves adds the standard AMC foresight bias (the
  regression "peeks" at each path's own future through the pooled fit;
  it vanishes at the 1/n_paths rate).  Tested: with ONE exercise date the
  whole profile must agree with the EXACT Jamshidian-marked European
  swaption trade — identical tails (the policies coincide), regression-
  tolerance option phase.
- Exercise is restricted to float-reset dates (real Bermudan swaption
  terms), which keeps the exercised tail's in-period fixing exact.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from montecarlo.engine.exposure import (SimulationMarkedTrade,
                                            swap_value_fn)
from montecarlo.engine.precision import mm as _mm
from montecarlo.processes.shortrate import Vasicek


class AMCSwaptionSpec(NamedTuple):
    """Structured description of a Bermudan-swaption AMC fit — what the
    SHARDED netting engines need to decompose the regression into
    gathered fixed-block Gram sums (`parallel.sharded._amc_fit_sharded`)
    instead of running the opaque `mark_fn` closure per shard.

    All fields are static (floats/tuples/closures), so the spec can ride
    the jit-static ``sets`` tuple.  ``swap`` is the remaining-swap
    valuation closure (`swap_value_fn`'s 2- and 4-argument forms);
    ``ex_dates``/``resets`` are absolute times; ``notional`` scales the
    returned marks (exercise decisions are scale-invariant).
    """

    swap: object
    sign: float
    notional: float
    ex_dates: tuple
    resets: tuple
    degree: int


def _slope_ok(var, r2, dtype, one_pass: bool = False):
    """Is the cross-sectional variance REAL, or rounding noise of a
    (numerically) constant regressor?  Below the noise floor of the
    variance computation the data carry NO slope information and the
    honest regression slope is zero.  Without this, the standardized
    slope ``poly'(z) / sd`` divides f32 noise by the 1e-12 variance
    floor and the date-0 delta-normal IM explodes by ~1e6 (found
    driving ``xva --underlying g2pp --swaption-leg`` on chip; the
    scalar Vasicek AMC had the same latent bug at float32).

    The floor depends on the variance ALGEBRA: the two-pass
    ``E[w (r-m)^2]`` form's noise is quadratic in eps at the
    regressor's scale (``(64 eps)^2 E[r^2]``), the sharded engines'
    one-pass ``E[r^2] - m^2`` form cancels two eps-accurate numbers and
    its noise is LINEAR in eps (``64 eps E[r^2]``) — pass
    ``one_pass=True`` there."""
    eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
    tol = (64.0 * eps) if one_pass else (64.0 * eps) ** 2
    return var > tol * r2


def _weighted_polyfit(r, y, w, degree: int, dtype):
    """Weighted least-squares polynomial fit in standardized coordinates.

    Returns ``(beta, mean, std, slope_ok)`` with ``beta`` the
    coefficients on ``z^0..z^degree``, ``z = (r - mean)/std`` (the
    standardization keeps the Gram conditioned at any rate scale; same
    recipe as `engine.bermudan.bermudan_swaption_lsm`) and ``slope_ok``
    the :func:`_slope_ok` degeneracy flag slope consumers must apply.
    """
    wsum = jnp.maximum(jnp.sum(w), 1.0)
    m = jnp.sum(w * r) / wsum
    var = jnp.sum(w * jnp.square(r - m)) / wsum
    sd = jnp.sqrt(var + 1e-12)
    ok = _slope_ok(var, jnp.sum(w * r * r) / wsum, dtype)
    z = (r - m) / sd
    cols = [jnp.ones_like(z)]
    for _ in range(degree):
        cols.append(cols[-1] * z)
    x = jnp.stack(cols, axis=-1)                       # (N, deg+1)
    xw = x * w[:, None]
    a = _mm(xw.T, x) / wsum + 1e-8 * jnp.eye(degree + 1, dtype=dtype)
    b = _mm(xw.T, y) / wsum
    return jnp.linalg.solve(a, b), m, sd, ok


def _poly_and_slope(beta, r, m, sd, degree: int):
    z = (r - m) / sd
    val = jnp.zeros_like(r)
    slope = jnp.zeros_like(r)
    zp = jnp.ones_like(r)                              # z^i
    for i in range(degree + 1):
        val = val + beta[i] * zp
        if i + 1 <= degree:
            slope = slope + beta[i + 1] * (i + 1) * zp
        zp = zp * z
    return val, slope / sd


def bermudan_swaption_amc_trade(model: Vasicek, strike: float,
                                payment_times, pay_dt: float, *,
                                n_exercise: int, payer: bool = True,
                                notional: float = 1.0,
                                degree: int = 3, dtype=None):
    """Bermudan payer/receiver swaption as an AMC-marked netting trade.

    The holder may exercise into the REMAINING swap at the first
    ``n_exercise`` float-reset dates (``payment_times[j] - pay_dt``;
    ``n_exercise = 1`` is the European contract).  Returns a
    :class:`~montecarlo.engine.exposure.SimulationMarkedTrade`:

    - **Policy fit** (once, backward): at each exercise date, intrinsic =
      the remaining payer swap's exact affine value; continuation by
      ITM-weighted cubic LSM; exercise where intrinsic wins (exactly the
      `engine.bermudan.bermudan_swaption_lsm` recipe, so the t=0 mark
      converges to that engine's price — tested).
    - **Alive marks** (every exposure date): regress the policy's future
      cashflows, discounted to the date, on all still-alive paths; the
      clamped fit is the conditional value estimate.
    - **Exercised marks**: exact remaining-swap closed form with the
      in-period float fixing read from the path row at the latest reset
      (same machinery as `swaption_value_fn`'s physical tail).
    - ``dvalues`` for the delta-normal IM: the regression's analytic
      slope on alive paths (the fitted betas are FROZEN — standard
      delta-normal practice), the swap jvp on exercised ones.

    ``notional`` scales the returned marks and slopes (exercise
    decisions are scale-invariant, so a scaled trade has the same
    policy); ``dtype=None`` follows the model's parameter dtype (see
    `engine.exposure.swap_value_fn`).

    The returned trade carries an :class:`AMCSwaptionSpec` so the SHARDED
    netting engines can re-run the identical fit on gathered fixed-block
    Gram sums (`parallel.sharded._amc_fit_sharded`).
    """
    from montecarlo.engine.exposure import _model_dtype

    dtype = _model_dtype(model, dtype)
    times_np = [float(t) for t in payment_times]
    n_pay = len(times_np)
    if not 1 <= n_exercise <= n_pay:
        raise ValueError(f"n_exercise={n_exercise} not in [1, {n_pay}]")
    ex_dates = [times_np[j] - pay_dt for j in range(n_exercise)]
    if ex_dates[0] <= 1e-9:
        raise ValueError("first exercise date (first payment - pay_dt) "
                         "must be strictly positive")
    resets_np = [times_np[j] - pay_dt for j in range(n_pay)]
    sign = 1.0 if payer else -1.0
    scale = jnp.asarray(notional, dtype)
    swap = swap_value_fn(model, strike, times_np, pay_dt, dtype=dtype)

    def mark_fn(paths, times, T):
        n_steps = paths.shape[0] - 1
        n = paths.shape[1]
        dt = T / n_steps
        k_ex = [int(round(e / dt)) for e in ex_dates]
        for e, k in zip(ex_dates, k_ex):
            if abs(k * dt - e) > 1e-9:
                raise ValueError(
                    f"exercise date {e} does not lie on the exposure grid "
                    f"(dt={dt}); choose n_steps so resets are grid rows")
        # Pathwise discount factors, the engine's trapezoid convention.
        mid = 0.5 * (paths[:-1] + paths[1:]) * dt
        disc = jnp.exp(-jnp.concatenate(
            [jnp.zeros((1, n), dtype), jnp.cumsum(mid, axis=0)], axis=0))

        # --- backward LSM policy fit over the exercise dates ---------
        never = jnp.int32(n_steps + 1)
        k_last = k_ex[-1]
        ex_val = sign * swap(paths[k_last], jnp.asarray(ex_dates[-1],
                                                        dtype))
        take = ex_val > 0
        cash = jnp.where(take, ex_val, 0.0) * disc[k_last]   # disc to 0
        tau = jnp.where(take, jnp.int32(k_last), never)
        for j in range(n_exercise - 2, -1, -1):
            r_j = paths[k_ex[j]]
            ex_val = sign * swap(r_j, jnp.asarray(ex_dates[j], dtype))
            itm = ex_val > 0
            beta, m, sd, _ok = _weighted_polyfit(
                r_j, cash / jnp.maximum(disc[k_ex[j]], 1e-300),
                itm.astype(dtype), degree, dtype)
            cont, _ = _poly_and_slope(beta, r_j, m, sd, degree)
            take = itm & (ex_val >= cont)
            cash = jnp.where(take, ex_val * disc[k_ex[j]], cash)
            tau = jnp.where(take, jnp.int32(k_ex[j]), tau)

        # --- per-date marks -------------------------------------------
        resets = jnp.asarray(resets_np, dtype)
        k_resets_list = []
        for e in resets_np:
            k_r = int(round(e / dt))
            if e <= T + 1e-9 and abs(k_r * dt - e) > 1e-9:
                # A fixing row off the grid would silently accrue the
                # in-period coupon from the wrong date — same contract as
                # the exercise-date check above.
                raise ValueError(
                    f"reset {e} does not lie on the exposure grid "
                    f"(dt={dt}); choose n_steps so period starts are "
                    "grid rows")
            # Resets beyond the exposure horizon are never selected
            # (selection requires reset <= t <= T) — clip their indices
            # rather than rely on gather clamping.
            k_resets_list.append(min(max(k_r, 0), n_steps))
        k_resets = jnp.asarray(k_resets_list, jnp.int32)
        ones = jnp.ones((n,), dtype)

        def row(k):
            r = paths[k]
            t = times[k]
            alive = tau > k
            w = alive.astype(dtype)
            y = cash / jnp.maximum(disc[k], 1e-300)
            beta, m, sd, ok = _weighted_polyfit(r, y, w, degree, dtype)
            fit, slope = _poly_and_slope(beta, r, m, sd, degree)
            v_alive = jnp.maximum(fit, 0.0)
            dv_alive = jnp.where(ok & (fit > 0), slope, 0.0)
            # Exercised tail: remaining swap with the in-period fixing.
            le = resets <= t + 1e-9
            idx = jnp.argmax(jnp.where(le, resets, -jnp.inf))
            t_fix = resets[idx]
            r_fix = paths[k_resets[idx]]
            v_sw, dv_sw = jax.jvp(
                lambda rr: sign * swap(rr, t, r_fix, t_fix), (r,), (ones,))
            exercised = ~alive
            return (scale * jnp.where(exercised, v_sw, v_alive),
                    scale * jnp.where(exercised, dv_sw, dv_alive))

        return jax.lax.map(row, jnp.arange(n_steps + 1))

    spec = AMCSwaptionSpec(swap=swap, sign=sign, notional=float(notional),
                           ex_dates=tuple(ex_dates),
                           resets=tuple(resets_np), degree=degree)
    return SimulationMarkedTrade(mark_fn, spec)


# ---------------------------------------------------------------------------
# Multi-state AMC: Bermudan swaptions under full curve models (G2++ / LMM)
# ---------------------------------------------------------------------------

class AMCSwaptionSpecMS(NamedTuple):
    """The multi-state twin of :class:`AMCSwaptionSpec` — a Bermudan
    swaption AMC fit on a MULTI-STATE underlying (G2++'s two factors,
    the LMM's full forward curve).

    The regression state is the trade's own SIGNED intrinsic value
    ``z = sign * swap(cols, t)`` — the classic Longstaff-Schwartz
    regress-on-the-payoff choice, and the natural 1-D summary of a
    C-component state (it is exactly the quantity the exercise decision
    compares against).  ``swap`` is the model's exact remaining-swap
    closure (`g2pp_swap_value_fn` / `lmm_swap_value_fn`); ``resets`` the
    float-leg period starts when the closure needs explicit fixing rows
    for the exercised tail (G2++'s 4-argument form) and ``()`` when the
    state itself carries the fixings (the LMM freezes dead forwards).
    """

    swap: object
    sign: float
    notional: float
    ex_dates: tuple
    resets: tuple
    degree: int


def _ms_discount_rows(model, paths, dt, dtype):
    """Pathwise discount rows for a multi-state exposure simulation, by
    the model's declared kind — the same rule as
    `engine.exposure._simulate_and_discount` (exact integral for
    LMM/hybrid, trapezoid short rate for G2++)."""
    kind = getattr(model, "exposure_discount_kind", None)
    if kind == "exact":
        return model.pathwise_discount(paths)
    if kind == "rate":
        r = model.pathwise_rate(paths)
        n = r.shape[-1]
        mid = 0.5 * (r[:-1] + r[1:]) * dt
        return jnp.exp(-jnp.concatenate(
            [jnp.zeros((1, n), dtype), jnp.cumsum(mid, axis=0)], axis=0))
    raise TypeError(
        f"{type(model).__name__}: AMC trades need a pathwise discount "
        "(exposure_discount_kind 'exact' or 'rate')")


def _ms_amc_trade(model, swap, *, sign: float, notional: float,
                  ex_dates, resets, degree: int, dtype):
    """Generic multi-state AMC mark closure + spec (shared by the G2++
    and LMM constructors).  Same backward-induction / per-date
    conditional-value recipe as `bermudan_swaption_amc_trade`, with the
    scalar short rate replaced by the signed intrinsic ``z`` as the
    regression state and the per-path state derivative carried PER
    COMPONENT (``dvalues`` (T+1, C, N)) for the multivariate
    delta-normal IM: on alive paths the frozen-beta chain rule
    ``poly'(z) * dz/dc_j`` (dz by `jax.linearize`, batched over the C
    unit tangents exactly like the engine's own marks), on exercised
    paths the exact swap derivative."""
    ex_np = [float(e) for e in ex_dates]
    resets_np = [float(e) for e in resets]
    scale_f = float(notional)

    def mark_fn(paths, times, T):
        n_steps = paths.shape[0] - 1
        n_comp, n = paths.shape[1], paths.shape[2]
        dt = T / n_steps
        k_ex = [int(round(e / dt)) for e in ex_np]
        for e, k in zip(ex_np, k_ex):
            if abs(k * dt - e) > 1e-9:
                raise ValueError(
                    f"exercise date {e} does not lie on the exposure grid "
                    f"(dt={dt}); choose n_steps so resets are grid rows")
        disc = _ms_discount_rows(model, paths, dt, dtype)
        scale = jnp.asarray(scale_f, dtype)
        sgn = jnp.asarray(sign, dtype)
        tang = (jnp.eye(n_comp, dtype=dtype)[:, :, None]
                * jnp.ones((1, 1, n), dtype))

        # --- backward LSM policy fit on the intrinsic -----------------
        never = jnp.int32(n_steps + 1)
        k_last = k_ex[-1]
        z = sgn * swap(paths[k_last], jnp.asarray(ex_np[-1], dtype))
        take = z > 0
        cash = jnp.where(take, z, 0.0) * disc[k_last]
        tau = jnp.where(take, jnp.int32(k_last), never)
        for j in range(len(k_ex) - 2, -1, -1):
            z = sgn * swap(paths[k_ex[j]], jnp.asarray(ex_np[j], dtype))
            itm = z > 0
            beta, m, sd, _ok = _weighted_polyfit(
                z, cash / jnp.maximum(disc[k_ex[j]], 1e-300),
                itm.astype(dtype), degree, dtype)
            cont, _ = _poly_and_slope(beta, z, m, sd, degree)
            take = itm & (z >= cont)
            cash = jnp.where(take, z * disc[k_ex[j]], cash)
            tau = jnp.where(take, jnp.int32(k_ex[j]), tau)

        # --- per-date marks -------------------------------------------
        if resets_np:
            res_arr = jnp.asarray(resets_np, dtype)
            k_res_list = []
            for e in resets_np:
                k_r = int(round(e / dt))
                if e <= T + 1e-9 and abs(k_r * dt - e) > 1e-9:
                    raise ValueError(
                        f"reset {e} does not lie on the exposure grid "
                        f"(dt={dt}); choose n_steps so period starts are "
                        "grid rows")
                k_res_list.append(min(max(k_r, 0), n_steps))
            k_res = jnp.asarray(k_res_list, jnp.int32)

        def row(k):
            c = paths[k]
            t = times[k]
            reg = lambda cc: sgn * swap(cc, t)              # noqa: E731
            z_k, lin = jax.linearize(reg, c)
            alive = tau > k
            w = alive.astype(dtype)
            y = cash / jnp.maximum(disc[k], 1e-300)
            beta, m, sd, ok = _weighted_polyfit(z_k, y, w, degree, dtype)
            fit, slope = _poly_and_slope(beta, z_k, m, sd, degree)
            dz = jax.vmap(lin)(tang)                        # (C, N)
            v_alive = jnp.maximum(fit, 0.0)
            dv_alive = jnp.where(ok & (fit > 0), slope, 0.0)[None] * dz
            # Exercised tail: the exact remaining swap (the LMM state
            # carries its own fixings; G2++ reads the latest reset row).
            if resets_np:
                le = res_arr <= t + 1e-9
                idx = jnp.argmax(jnp.where(le, res_arr, -jnp.inf))
                t_fix = res_arr[idx]
                c_fix = paths[k_res[idx]]
                tail = lambda cc: sgn * swap(cc, t, c_fix,  # noqa: E731
                                             t_fix)
            else:
                tail = reg
            v_sw, lin_sw = jax.linearize(tail, c)
            dv_sw = jax.vmap(lin_sw)(tang)                  # (C, N)
            ex = ~alive
            return (scale * jnp.where(ex, v_sw, v_alive),
                    scale * jnp.where(ex[None], dv_sw, dv_alive))

        return jax.lax.map(row, jnp.arange(n_steps + 1))

    spec = AMCSwaptionSpecMS(swap=swap, sign=float(sign),
                             notional=scale_f, ex_dates=tuple(ex_np),
                             resets=tuple(resets_np), degree=degree)
    return SimulationMarkedTrade(mark_fn, spec)


def bermudan_swaption_amc_trade_g2pp(model, strike: float, payment_times,
                                     pay_dt: float, *, n_exercise: int,
                                     payer: bool = True,
                                     notional: float = 1.0,
                                     degree: int = 3, dtype=None):
    """Bermudan swaption as an AMC-marked netting trade under TWO-FACTOR
    G2++ rates — the multi-state extension of
    :func:`bermudan_swaption_amc_trade` (same calendar contract: may
    exercise into the remaining swap at the first ``n_exercise``
    float-reset dates; ``n_exercise=1`` is the European contract, whose
    t=0 mark must agree with the exact `processes.g2pp.g2pp_swaption`
    quadrature within regression/MC tolerance — tested).

    Regression state is the signed intrinsic (see
    :class:`AMCSwaptionSpecMS`); the exercised tail is the exact G2++
    affine swap with the in-period float fixing read from the path row
    at the latest reset (`g2pp_swap_value_fn`'s 4-argument form).
    """
    from montecarlo.engine.exposure import _model_dtype
    from montecarlo.processes.g2pp import g2pp_swap_value_fn

    dtype = _model_dtype(model, dtype)
    times_np = [float(t) for t in payment_times]
    n_pay = len(times_np)
    if not 1 <= n_exercise <= n_pay:
        raise ValueError(f"n_exercise={n_exercise} not in [1, {n_pay}]")
    ex_dates = [times_np[j] - pay_dt for j in range(n_exercise)]
    if ex_dates[0] <= 1e-9:
        raise ValueError("first exercise date (first payment - pay_dt) "
                         "must be strictly positive")
    resets = [times_np[j] - pay_dt for j in range(n_pay)]
    swap = g2pp_swap_value_fn(model, strike, times_np, pay_dt, dtype=dtype)
    return _ms_amc_trade(model, swap, sign=1.0 if payer else -1.0,
                         notional=notional, ex_dates=ex_dates,
                         resets=resets, degree=degree, dtype=dtype)


def bermudan_swaption_amc_trade_lmm(model, strike: float, start_idx: int,
                                    end_idx: int, *, n_exercise: int,
                                    payer: bool = True,
                                    notional: float = 1.0,
                                    degree: int = 3, dtype=None):
    """Bermudan swaption as an AMC-marked netting trade under the FULL
    FORWARD-CURVE Libor Market Model: exercise at resets
    ``start_idx .. start_idx + n_exercise - 1`` into the remaining swap
    out to ``end_idx`` (the co-terminal Bermudan — the same contract as
    `engine.bermudan.lmm_bermudan_swaption_lsm`, whose t=0 price the
    AMC t=0 mark must reproduce within regression tolerance — tested).

    No fixing plumbing: the LMM state FREEZES dead forwards, so
    `lmm_swap_value_fn` marks the in-flight payment exactly at every
    grid date (``resets=()`` in the spec).
    """
    from montecarlo.engine.exposure import _model_dtype
    from montecarlo.processes.lmm import lmm_swap_value_fn

    dtype = _model_dtype(model, dtype)
    k_fwd = int(model.sigma.shape[0])
    if not 1 <= start_idx < end_idx <= k_fwd:
        raise ValueError(f"need 1 <= start ({start_idx}) < end "
                         f"({end_idx}) <= K ({k_fwd})")
    if not 1 <= n_exercise <= end_idx - start_idx:
        raise ValueError(f"n_exercise={n_exercise} must be in "
                         f"[1, {end_idx - start_idx}]")
    dlt = float(model.delta)
    ex_dates = [dlt * (start_idx + j) for j in range(n_exercise)]
    swap = lmm_swap_value_fn(model, strike, start_idx, end_idx,
                             dtype=dtype)
    return _ms_amc_trade(model, swap, sign=1.0 if payer else -1.0,
                         notional=notional, ex_dates=ex_dates,
                         resets=(), degree=degree, dtype=dtype)


__all__ = ["AMCSwaptionSpec", "AMCSwaptionSpecMS",
           "bermudan_swaption_amc_trade",
           "bermudan_swaption_amc_trade_g2pp",
           "bermudan_swaption_amc_trade_lmm"]
