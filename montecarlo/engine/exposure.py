"""Counterparty exposure profiles (EPE/ENE/PFE) and the xVA set.

Given a short-rate model and a valuation function v(r, t) for the
instrument's mark-to-market at grid time t (affine closed forms make this
exact for swaps/bonds under Vasicek), simulate rate paths once and reduce:

    EPE(t)   = E[max(V_t, 0)]               (expected positive exposure)
    ENE(t)   = E[max(-V_t, 0)]              (expected negative exposure)
    PFE_q(t) = quantile_q(max(V_t, 0))      (potential future exposure)
    EE*(t)   = running max of EPE           (effective EPE, Basel)

plus the discounted credit/funding adjustments — unilateral & bilateral
CVA, DVA, and FCA/FBA/FVA under flat hazards and a flat funding spread.
All of it comes from ONE (T+1, N) simulation — the paths are the expensive
part; every profile is a per-row reduction and every xVA a weighted sum.

The reference app has nothing in this space; this extends the risk surface
(VaR/CVaR in :mod:`montecarlo.api.var`) to counterparty credit.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from montecarlo.engine.rates import vasicek_bond_from_rate
from montecarlo.engine.simulate import simulate
from montecarlo.processes.shortrate import Vasicek


def _model_dtype(model, dtype):
    """Resolve a value-closure dtype: explicit wins; otherwise follow the
    MODEL's parameter dtype (CLAUDE.md: library code pins dtypes
    explicitly — a hard f64 default silently truncated to f32 under
    non-x64 runtimes whenever the caller's model was f32)."""
    return jnp.result_type(model.sigma) if dtype is None else dtype


def swap_value_fn(model: Vasicek, strike: float, payment_times,
                  pay_dt: float, dtype=None):
    """Valuation closure for a payer swap with fixed payment calendar.

    ``payment_times``: (P,) absolute times of the remaining fixed/float
    payments.  Returns ``v(r, t[, r_fix, t_fix])`` valuing the not-yet-paid
    legs at time t (payments strictly after t), affine in r through the
    Vasicek bond.

    Float leg between payment dates: the in-period coupon was FIXED at the
    period start, so the leg is worth ``P(t,t_next)(1 + L_fix*delta) -
    P(t,T_last)`` where ``L_fix`` is the simple rate set at ``t_fix`` —
    pass the path's rate at the period start as ``r_fix``
    (`exposure_profile(fixing_times=...)` does this). Called with two
    arguments, the leg falls back to ``1 - P(t,T_last)``, which is exact
    only ON payment dates (it drops the in-period fixing — the two forms
    coincide at t = t_fix).  ``dtype`` pins the calendar's precision
    (CLAUDE.md: library code pins dtypes explicitly) — the default
    follows the model's parameter dtype (f64 in the x64 test env, f32
    for an f32 model under the CLI/driver runtimes).
    """
    dtype = _model_dtype(model, dtype)
    times = jnp.asarray(payment_times, dtype)

    def value(r, t, r_fix=None, t_fix=None):
        taus = times - t                       # (P,)
        alive = taus > 1e-9                    # payments still ahead
        p = vasicek_bond_from_rate(r[..., None], model.kappa, model.theta,
                                   model.sigma, jnp.maximum(taus, 1e-9))
        p = jnp.where(alive, p, 0.0)
        idx_last = jnp.argmax(jnp.where(alive, times, -jnp.inf))
        p_last = p[..., idx_last]
        any_alive = jnp.any(alive)
        if r_fix is None:
            # Reset-date replication: exact only when t is a payment date.
            float_leg = jnp.where(any_alive,
                                  1.0 * (p_last > 0) - p_last, 0.0)
        else:
            # Next payment t_next and the coupon fixed at t_fix for
            # [t_fix, t_next]: L = (1/P(t_fix, t_next) - 1) / delta.
            t_next = jnp.min(jnp.where(alive, times, jnp.inf))
            tau_next = jnp.maximum(t_next - t, 1e-9)
            p_next = vasicek_bond_from_rate(r, model.kappa, model.theta,
                                            model.sigma, tau_next)
            delta = jnp.maximum(t_next - t_fix, 1e-9)
            p_fix = vasicek_bond_from_rate(r_fix, model.kappa, model.theta,
                                           model.sigma, delta)
            growth = 1.0 / p_fix  # 1 + L*delta
            float_leg = jnp.where(any_alive,
                                  p_next * growth - p_last, 0.0)
        fixed_leg = strike * pay_dt * jnp.sum(p, axis=-1)
        return float_leg - fixed_leg

    return value


@partial(jax.jit, static_argnames=("value_fn", "n_paths", "n_steps", "seed",
                                   "dtype", "has_fixings"))
def _exposure_profile(model, value_fn, n_paths: int, n_steps: int, *,
                      T: float, seed: int, sampler=None,
                      quantile: float = 0.95,
                      hazard_rate: float = 0.0, recovery: float = 0.4,
                      own_hazard_rate: float = 0.0,
                      own_recovery: float = 0.4,
                      funding_spread: float = 0.0,
                      im_spread: float = 0.0,
                      im_quantile: float = 0.99,
                      mpor: float = 10.0 / 252.0,
                      flat_rate=None,
                      dtype=jnp.float64, fixing_times=None,
                      has_fixings: bool = False) -> dict:
    dt = T / n_steps
    paths = simulate(model, n_paths, n_steps, seed=seed, mode="paths",
                     sampler=sampler, dtype=dtype)     # (T+1, N)
    times = jnp.arange(n_steps + 1, dtype=dtype) * dt

    if has_fixings:
        ft = jnp.asarray(fixing_times, dtype)          # (F,)
        # Most recent fixing <= t_k (clamped to the first fixing), and its
        # grid row — the path value at the period start is the in-period
        # coupon's fixing state.
        le = ft[None, :] <= times[:, None] + 1e-9
        t_fix_arr = jnp.max(jnp.where(le, ft[None, :], ft[0]), axis=1)
        k_fix_arr = jnp.clip(jnp.round(t_fix_arr / dt).astype(jnp.int32),
                             0, n_steps)

    if flat_rate is None:
        # Short-rate underlying: pathwise discount factors D(0, t_k)
        # (trapezoid, as in engine.rates).
        mid = 0.5 * (paths[:-1] + paths[1:]) * dt
        disc = jnp.exp(-jnp.concatenate(
            [jnp.zeros((1, n_paths), dtype), jnp.cumsum(mid, axis=0)],
            axis=0))
    else:
        # Equity/FX underlying (paths are PRICES, not rates): flat
        # deterministic discounting.
        disc = jnp.exp(-jnp.asarray(flat_rate, dtype)
                       * times)[:, None] * jnp.ones((1, n_paths), dtype)

    # Delta-normal dynamic initial margin: IM_t = z_q |dV/dr| sigma_r(MPOR)
    # per path, with dV/dr from ONE jvp through the valuation (each path's
    # value depends only on its own rate, so a ones-tangent jvp IS the
    # elementwise derivative).  sigma_r over the margin period uses the
    # model's OU conditional std when it exposes (kappa, sigma) — Vasicek/
    # Hull-White — else the sigma sqrt(dt) diffusion limit.
    z_im = jax.scipy.special.ndtri(jnp.asarray(im_quantile, dtype))
    kap = getattr(model, "kappa", getattr(model, "a", None))
    sig_model = jnp.asarray(model.sigma, dtype)
    mpor_t = jnp.asarray(mpor, dtype)
    lognormal_im = flat_rate is not None
    if kap is not None and not lognormal_im:
        kap = jnp.asarray(kap, dtype)
        sig_mpor = sig_model * jnp.sqrt(
            (1.0 - jnp.exp(-2.0 * kap * mpor_t))
            / jnp.maximum(2.0 * kap, 1e-12))
    else:
        sig_mpor = sig_model * jnp.sqrt(mpor_t)

    def row(k_t):
        k, t = k_t
        if has_fixings:
            val = lambda rr: value_fn(rr, t, paths[k_fix_arr[k]],
                                      t_fix_arr[k])
        else:
            val = lambda rr: value_fn(rr, t)
        v, dv = jax.jvp(val, (paths[k],), (jnp.ones((n_paths,), dtype),))
        pos = jnp.maximum(v, 0.0)
        neg = jnp.maximum(-v, 0.0)
        epe = jnp.mean(pos)
        ene = jnp.mean(neg)
        pfe = jnp.quantile(pos, quantile)
        depe = jnp.mean(disc[k] * pos)        # discounted EPE for CVA/FCA
        dene = jnp.mean(disc[k] * neg)        # discounted ENE for DVA/FBA
        # Rate states shock additively (OU conditional std); price states
        # shock multiplicatively — std(dS) ~ S sigma sqrt(mpor).
        state_shock = (sig_mpor * paths[k] if lognormal_im else sig_mpor)
        im_path = z_im * jnp.abs(dv) * state_shock
        im = jnp.mean(im_path)
        dim = jnp.mean(disc[k] * im_path)     # discounted E[IM] for MVA
        return epe, ene, pfe, depe, dene, im, dim

    # vmap over rows would rebuild the (P,) bond vector per element; a scan
    # over the T+1 rows keeps everything batched per time.
    def scan_body(carry, k):
        t = times[k]
        out = row((k, t))
        return carry, out

    _, (epe, ene, pfe, depe, dene, im, dim) = jax.lax.scan(
        scan_body, 0, jnp.arange(n_steps + 1))
    eepe = jax.lax.associative_scan(jnp.maximum, epe)
    lam_c = jnp.asarray(hazard_rate, dtype)
    lam_o = jnp.asarray(own_hazard_rate, dtype)
    surv_c = jnp.exp(-lam_c * times)
    surv_o = jnp.exp(-lam_o * times)
    zero1 = jnp.zeros((1,), dtype)
    dpd_c = jnp.concatenate([zero1, surv_c[:-1] - surv_c[1:]])
    dpd_o = jnp.concatenate([zero1, surv_o[:-1] - surv_o[1:]])
    # Bilateral weighting: a party's default loss counts only while the
    # OTHER party has survived to the period start (the standard
    # first-to-default discretization; own_hazard = 0 reduces CVA to the
    # unilateral formula exactly).
    w_o = jnp.concatenate([jnp.ones((1,), dtype), surv_o[:-1]])
    w_c = jnp.concatenate([jnp.ones((1,), dtype), surv_c[:-1]])
    cva = (1.0 - recovery) * jnp.sum(depe * dpd_c * w_o)
    dva = (1.0 - own_recovery) * jnp.sum(dene * dpd_o * w_c)
    # Funding while both parties are alive: cost of funding the positive
    # exposure at the spread, benefit on the negative side.  Trapezoid
    # weights (half dt at t=0 and t=T): a full-weight rectangle over all
    # n_steps+1 points carries an extra ~dt panel (~1/n_steps upward bias)
    # vs the continuous spread-accrual integral.
    sf = jnp.asarray(funding_spread, dtype)
    alive = surv_c * surv_o
    trap = jnp.full((n_steps + 1,), dt, dtype)
    trap = trap.at[0].set(0.5 * dt).at[-1].set(0.5 * dt)
    fca = sf * jnp.sum(depe * alive * trap)
    fba = sf * jnp.sum(dene * alive * trap)
    # MVA: funding the posted IM at its spread while both parties live.
    mva = jnp.asarray(im_spread, dtype) * jnp.sum(dim * alive * trap)
    return {"times": times, "epe": epe, "ene": ene, "pfe": pfe,
            "eepe": eepe, "im": im, "cva": cva, "dva": dva,
            "bcva": cva - dva, "fca": fca, "fba": fba, "fva": fca - fba,
            "mva": mva}


def exposure_profile(model, value_fn, n_paths: int, n_steps: int, *,
                     T: float, seed: int, sampler=None,
                     quantile: float = 0.95,
                     hazard_rate: float = 0.0, recovery: float = 0.4,
                     own_hazard_rate: float = 0.0,
                     own_recovery: float = 0.4,
                     funding_spread: float = 0.0,
                     im_spread: float = 0.0,
                     im_quantile: float = 0.99,
                     mpor: float = 10.0 / 252.0,
                     flat_rate=None,
                     dtype=jnp.float64, fixing_times=None) -> dict:
    """Exposure profiles and the xVA set, all from ONE simulation.

    ``model`` may be a short-rate process (Vasicek/CIR/Hull-White — paths
    discount pathwise through the simulated rate) or, with ``flat_rate=r``,
    ANY price process (GBM/Heston/...) for equity/FX underlyings —
    ``value_fn(s, t)`` then marks the derivative at spot ``s`` and
    discounting is the flat curve (the IM shock also switches to the
    lognormal ``S sigma sqrt(MPOR)`` form).

    ``fixing_times``: optional (F,) period-start times (e.g.
    ``payment_times - pay_dt`` for a spot-starting swap).  When given,
    ``value_fn`` is called as ``value_fn(r_t, t, r_fix, t_fix)`` with the
    path state at the most recent fixing — mid-grid swap values then carry
    the in-period coupon exactly instead of the reset-date approximation
    (which silently mis-valued profiles on grids finer than the payment
    calendar).

    Credit/funding inputs (flat hazards; zero switches a term off):
      hazard_rate/recovery: counterparty (drives CVA).
      own_hazard_rate/own_recovery: own credit (drives DVA).
      funding_spread: flat funding spread over the risk-free curve (drives
        FCA/FBA/FVA, accrued while BOTH parties survive).
      im_spread/im_quantile/mpor: initial-margin funding spread, IM
        confidence level, and margin period of risk (years) — drive MVA
        under a delta-normal dynamic IM, IM_t = z_q |dV/dr| sigma_r(MPOR),
        with dV/dr by autodiff through the valuation (im_spread = 0
        switches MVA off; the "im" profile is reported either way).

    Returns profile arrays of length ``n_steps + 1`` plus scalars::

      {"times", "epe", "ene", "pfe", "eepe", "im",
       "cva",   # (1-R_c) sum D EPE dPD_c S_own(start)  — bilateral weight
       "dva",   # (1-R_o) sum D ENE dPD_o S_cpty(start)
       "bcva",  # cva - dva
       "fca", "fba", "fva",  # s_f sum D {EPE, ENE} S_c S_o dt; fva=fca-fba
       "mva"}   # s_im sum D E[IM] S_c S_o dt

    With ``own_hazard_rate=0`` the CVA reduces exactly to the unilateral
    ``(1-R) sum D(0,t) EPE(t) dPD(t)`` of earlier revisions.
    """
    if is_multistate(model):
        raise TypeError(
            f"{type(model).__name__} is a multi-state exposure underlying "
            "— run it through netting_set_profile (a one-trade netting "
            "set is the same profile)")
    return _exposure_profile(
        model, value_fn, n_paths, n_steps, T=T, seed=seed, sampler=sampler,
        quantile=quantile, hazard_rate=hazard_rate, recovery=recovery,
        own_hazard_rate=own_hazard_rate, own_recovery=own_recovery,
        funding_spread=funding_spread, im_spread=im_spread,
        im_quantile=im_quantile, mpor=mpor, flat_rate=flat_rate,
        dtype=dtype, fixing_times=fixing_times,
        has_fixings=fixing_times is not None)


# ---------------------------------------------------------------------------
# Netting sets + CSA collateral
# ---------------------------------------------------------------------------

class SimulationMarkedTrade(NamedTuple):
    """A netting-set trade marked by regression on the engine's OWN
    simulation (American Monte Carlo) — for products without closed-form
    conditional values: Bermudan swaptions, callables.

    ``mark_fn(paths, times, T) -> (values, dvalues)``: full-grid
    ``(T+1, N)`` marks and their per-path state derivatives (for the
    netted delta-normal IM); ``T`` is the static horizon, so the trade
    can place its calendar on the grid.  The fit runs on the same paths the
    exposure is measured on — the standard AMC shortcut; its regression
    noise/foresight bias is O(1/n_paths) and second-order in the basis
    error (documented at the concrete trades, e.g.
    :func:`montecarlo.engine.amc.bermudan_swaption_amc_trade`).

    ``spec``: optional structured description of the fit (a
    `montecarlo.engine.amc.AMCSwaptionSpec`, or `AMCSwaptionSpecMS`
    for multi-state G2++/LMM books) — the sharded netting engines
    decompose the regression into gathered fixed-block Gram sums
    (`parallel.sharded._amc_fit_sharded`) and need the pieces, not the
    opaque closure; the `bermudan_swaption_amc_trade*` constructors
    attach it.  On multi-state underlyings ``mark_fn`` receives the
    (T+1, C, N) exposure paths and must return per-component
    ``dvalues`` (T+1, C, N).  The STREAMING engine marks AMC trades by
    running the fit as extra sweeps over the chunk stream, then
    replaying each chunk's exercise states from the frozen policy
    (`engine.streaming._amc_fit_streaming` /
    `parallel.sharded._amc_replay`).
    """

    mark_fn: object
    spec: object = None


class PathDependentTrade(NamedTuple):
    """A netting-set trade whose mark needs the path state at earlier
    observation dates — e.g. a physically-settled swaption's exercise
    indicator at expiry plus the float-leg fixings at each period start.

    The engines call ``value_fn(state_t, t, *obs_rows)`` with one row per
    entry of ``obs_times`` (each rounded to the exposure grid): the path
    row AT that date for grid dates at/after it, and the CURRENT row for
    earlier dates (so no future information can leak — the closure's
    pre-observation branches must not use those rows, and whatever they
    would read there is the adapted present state anyway).
    """

    value_fn: object
    obs_times: tuple


def swaption_value_fn(model: Vasicek, strike: float, expiry: float,
                      payment_times, pay_dt: float, *, payer: bool = True,
                      physical: bool = True, dtype=None):
    """European swaption as a netting-set trade, marked in closed form.

    Before expiry the mark is the Jamshidian (1989) decomposition: the
    payer (receiver) swaption is a portfolio of puts (calls) on the
    zero-coupon bonds maturing at each payment date, struck at the
    critical-rate bond prices ``K_i = P(T0, T_i; r*)``.  Time-homogeneity
    makes ``r*`` a function of the EXPIRY-date par condition only — one
    scalar root shared by every (path, grid date) mark.  The root is a
    clipped jnp Newton iteration (the par gap is a smooth, monotone
    exponential sum), NOT a host brentq, so the whole mark is
    differentiable and swaption books work under :func:`xva_greeks`.

    After expiry: ``physical=True`` returns a :class:`PathDependentTrade`
    whose mark is ``1{swap value at expiry > 0} * remaining swap value``
    — the exercise indicator is read from the path row at ``expiry``, and
    the swap is valued with its EXACT in-period float-leg fixing (the
    path row at the latest period start, `swap_value_fn`'s 4-argument
    form), so the discounted mark is a true martingale between payment
    dates on grids finer than the payment calendar; ``physical=False`` is
    the cash-settled contract — the payoff settles at expiry and the
    exposure drops to zero after it.

    Validation (tested): the t=0 mark equals
    :func:`montecarlo.engine.bermudan.vasicek_swaption_jamshidian`;
    payer minus receiver equals the forward swap value (parity); the
    discounted mark is a martingale across the whole grid (physical) /
    up to expiry (cash).  ``dtype=None`` follows the model's parameter
    dtype (see `swap_value_fn`).
    """
    dtype = _model_dtype(model, dtype)
    times_np = [float(t) for t in payment_times]
    if min(times_np) <= float(expiry):
        raise ValueError("every payment must be after the swaption expiry "
                         f"(expiry={expiry}, first payment={min(times_np)})")
    for i, t_i in enumerate(times_np):
        want = float(expiry) + (i + 1) * float(pay_dt)
        if abs(t_i - want) > 1e-9:
            # The post-exercise fixing rows assume period starts at
            # expiry + i*pay_dt; a misaligned calendar would silently
            # accrue the in-period coupon over the wrong fixing window.
            raise ValueError(
                f"payment_times[{i}]={t_i} != expiry + {i + 1}*pay_dt="
                f"{want}: the swaption's swap must pay every pay_dt "
                "starting one period after expiry")
    n_pay = len(times_np)
    coupons_np = [strike * pay_dt] * n_pay
    coupons_np[-1] += 1.0
    taus_exp = jnp.asarray([t - float(expiry) for t in times_np], dtype)
    cs = jnp.asarray(coupons_np, dtype)
    tms = jnp.asarray(times_np, dtype)
    t0 = jnp.asarray(expiry, dtype)
    kap, th, sg = model.kappa, model.theta, model.sigma

    # r*: coupon bond at par at expiry.  Newton on the (convex, strictly
    # decreasing) exponential sum, clipped to a wide bracket; 40
    # iterations converge to f64 roundoff from any start in the bracket.
    def par_gap_and_slope(r):
        p = vasicek_bond_from_rate(r, kap, th, sg, taus_exp)
        b = (1.0 - jnp.exp(-jnp.asarray(kap, dtype) * taus_exp)) \
            / jnp.asarray(kap, dtype)
        f = jnp.sum(cs * p) - 1.0
        fp = -jnp.sum(cs * b * p)
        return f, fp

    def newton(_, r):
        f, fp = par_gap_and_slope(r)
        # fp < 0 analytically, but long-tenor f32 bond prices can
        # underflow at the clip boundary — guard like the batched
        # calibration solver (rates_calibration.py).
        return jnp.clip(r - f / jnp.minimum(fp, -1e-12), -2.0, 3.0)

    r_star = jax.lax.fori_loop(0, 40, newton, jnp.asarray(th, dtype))
    ks = vasicek_bond_from_rate(r_star, kap, th, sg, taus_exp)   # (P,)

    swap = swap_value_fn(model, strike, times_np, pay_dt, dtype=dtype)
    sign = 1.0 if payer else -1.0

    def option_value(r, t):
        from montecarlo.engine.rates import vasicek_bond_option_from_rate

        tau1 = jnp.maximum(t0 - t, 1e-12)
        tau2 = jnp.maximum(tms - t, 1e-9)
        # payer swaption = coupon-bond PUT struck at par; receiver = CALL.
        return jnp.sum(cs * vasicek_bond_option_from_rate(
            r[..., None], kap, th, sg, tau1, tau2, ks, call=not payer),
            axis=-1)

    if not physical:
        def value_cash(r, t):
            return jnp.where(t <= t0, option_value(r, t),
                             jnp.zeros_like(r))

        return value_cash

    # Observation rows: expiry (exercise indicator) doubles as the first
    # period's fixing; later fixings at each subsequent period start.
    resets_np = [float(expiry) + i * pay_dt for i in range(n_pay)]
    resets = jnp.asarray(resets_np, dtype)

    def value_physical(r, t, *rows):
        exercised = sign * swap(rows[0], t0) > 0
        # Latest reset <= t supplies the in-period float fixing (before
        # expiry the selection is masked off by the pre-branch anyway).
        le = resets <= t + 1e-9
        idx = jnp.argmax(jnp.where(le, resets, -jnp.inf))
        t_fix = resets[idx]
        r_fix = jnp.stack(rows)[idx]
        post = jnp.where(exercised, sign * swap(r, t, r_fix, t_fix), 0.0)
        return jnp.where(t <= t0, option_value(r, t), post)

    return PathDependentTrade(value_physical, tuple(resets_np))


class CSA(NamedTuple):
    """Credit-support-annex terms for variation margin on a netting set.

    ``threshold``: counterparty's threshold — they post collateral only on
    netted value above it.  ``own_threshold``: ours, on the negative side.
    ``mta``: minimum transfer amount — a collateral call below it is not
    made (deadband; per-date recompute, no ratchet memory — the standard
    simplification).  ``mpor``: margin period of risk in YEARS — the
    collateral held at t was called against the netted value observed at
    t - mpor (default 10 business days), which is exactly the gap risk
    every real CSA leaves open.
    """

    threshold: float = 0.0
    own_threshold: float = 0.0
    mta: float = 0.0
    mpor: float = 10.0 / 252.0


def _wwr_default_increments(paths, times, hazard_rate, beta, dt, dtype):
    """Pathwise default-probability increments under wrong-way risk.

    Intensity model (Hull–White 2012 style): over the period
    ``(t_{k-1}, t_k]`` each path's hazard is ``c_k * exp(beta * z_{k-1})``
    — predictable (period-start state), with ``z`` the per-date
    cross-sectionally standardized underlying and the scalar ``c_k``
    calibrated by Newton so the UNCONDITIONAL survival curve equals the
    flat-hazard curve ``exp(-hazard_rate * t_k)`` EXACTLY for any beta
    (the CDS curve is an input, not a model output; beta only reshapes
    WHICH paths default).  Returns ``(dpd, surv_mean)``: (T+1, N)
    per-path increments (row 0 is zero) and the calibrated mean survival
    curve (a diagnostic — equals the flat curve to Newton tolerance).
    """
    lam = jnp.asarray(hazard_rate, dtype)
    b = jnp.asarray(beta, dtype)
    mean_k = jnp.mean(paths, axis=1, keepdims=True)
    std_k = jnp.std(paths, axis=1, keepdims=True)
    z = jnp.where(std_k > 0, (paths - mean_k) / jnp.where(std_k > 0,
                                                          std_k, 1.0), 0.0)
    w = jnp.exp(b * z)                                  # (T+1, N)
    targets = jnp.exp(-lam * times)                     # (T+1,)

    def per_date(s_prev, inp):
        w_start, target = inp                           # state at t_{k-1}

        def newton(_, c):
            f = jnp.mean(s_prev * jnp.exp(-c * w_start * dt))
            fp = dt * jnp.mean(s_prev * w_start
                               * jnp.exp(-c * w_start * dt))
            return c + (f - target) / jnp.maximum(fp, 1e-300)

        c = jax.lax.fori_loop(0, 12, newton, lam)
        s_new = s_prev * jnp.exp(-c * w_start * dt)
        return s_new, (s_prev - s_new, jnp.mean(s_new))

    s0 = jnp.ones((paths.shape[1],), dtype)
    _, (dpd, surv) = jax.lax.scan(per_date, s0, (w[:-1], targets[1:]))
    zero_row = jnp.zeros((1, paths.shape[1]), dtype)
    return (jnp.concatenate([zero_row, dpd], axis=0),
            jnp.concatenate([jnp.ones((1,), dtype), surv]))


def _credit_funding_scalars(depe, dene, depe_per_trade, eepe, pbar, times,
                            dt, n_steps, *, hazard_rate, recovery,
                            own_hazard_rate, own_recovery, funding_spread,
                            kva_cost, kva_capital_ratio, dtype):
    """Survival weights + the deterministic adjustment algebra, shared by
    the unsharded and sharded netting engines (ONE copy — the two must
    never diverge; they differ only in how the input means were reduced).

    CVA/DVA: first-to-default discretization — a party's default loss
    counts only while the OTHER party has survived to the period start
    (own_hazard = 0 reduces CVA to the unilateral formula exactly).
    cva_no_netting: the sum of standalone per-trade CVAs — the number
    netting + CSA are bought to beat.  FCA/FBA and KVA accrue on the
    trapezoid (half weight at both endpoints); KVA's capital profile is
    ``kva_capital_ratio * EEPE(t)`` (the Basel alpha*RW*8% chain in one
    user ratio) discounted at the mean pathwise discount ``pbar``.

    Returns ``(scalars, aux)`` with ``aux`` carrying the weights the
    callers' extra terms (WWR tilt, MVA) reuse.
    """
    lam_c = jnp.asarray(hazard_rate, dtype)
    lam_o = jnp.asarray(own_hazard_rate, dtype)
    surv_c = jnp.exp(-lam_c * times)
    surv_o = jnp.exp(-lam_o * times)
    zero1 = jnp.zeros((1,), dtype)
    dpd_c = jnp.concatenate([zero1, surv_c[:-1] - surv_c[1:]])
    dpd_o = jnp.concatenate([zero1, surv_o[:-1] - surv_o[1:]])
    w_o = jnp.concatenate([jnp.ones((1,), dtype), surv_o[:-1]])
    w_c = jnp.concatenate([jnp.ones((1,), dtype), surv_c[:-1]])
    cva = (1.0 - recovery) * jnp.sum(depe * dpd_c * w_o)
    dva = (1.0 - own_recovery) * jnp.sum(dene * dpd_o * w_c)
    cva_no_netting = (1.0 - recovery) * jnp.sum(
        depe_per_trade * (dpd_c * w_o)[None, :])
    sf = jnp.asarray(funding_spread, dtype)
    alive = surv_c * surv_o
    trap = jnp.full((n_steps + 1,), dt, dtype)
    trap = trap.at[0].set(0.5 * dt).at[-1].set(0.5 * dt)
    fca = sf * jnp.sum(depe * alive * trap)
    fba = sf * jnp.sum(dene * alive * trap)
    kva = (jnp.asarray(kva_cost, dtype)
           * jnp.sum(jnp.asarray(kva_capital_ratio, dtype) * eepe
                     * pbar * alive * trap))
    scalars = {"cva": cva, "dva": dva, "bcva": cva - dva,
               "cva_no_netting": cva_no_netting, "fca": fca, "fba": fba,
               "fva": fca - fba, "kva": kva}
    return scalars, {"dpd_c": dpd_c, "w_o": w_o, "alive": alive,
                     "trap": trap}


def _observe_exposure(process, state):
    """The multi-state observation hook for `simulate(observe=...)`."""
    return process.exposure_obs(state)


def is_multistate(model) -> bool:
    """Does ``model`` expose a multi-component exposure observation?

    Multi-state underlyings (G2++'s two factors, the equity-rates
    hybrid's (S, r, integral)) declare the protocol class attributes
    ``exposure_components`` (names tuple), ``exposure_discount_kind``
    ("rate": trapezoid on `pathwise_rate(obs)`; "exact":
    `pathwise_discount(obs)`; "flat": the engine's flat_rate), an
    ``exposure_obs(state) -> (N, C)`` method, plus ``im_tangent`` /
    ``im_shock(obs, mpor)`` / ``wwr_state(obs)`` for the IM and WWR
    machinery.  Their exposure paths are (T+1, C, N) and trades are
    called as ``v(cols, t)`` with the (C, N) state columns.
    """
    return getattr(model, "exposure_components", None) is not None


def _trapezoid_discount(rate_rows, dt, dtype):
    n = rate_rows.shape[1]
    mid = 0.5 * (rate_rows[:-1] + rate_rows[1:]) * dt
    return jnp.exp(-jnp.concatenate(
        [jnp.zeros((1, n), dtype), jnp.cumsum(mid, axis=0)], axis=0))


def _simulate_and_discount(model, n_paths, n_steps, *, T, seed, flat_rate,
                           dtype, sampler=None):
    """One exposure simulation + its discount rows (shared by every
    netting set of a portfolio — the paths are the expensive part).

    Multi-state models return paths (T+1, C, N) with discounting by the
    model's declared kind; scalar models the usual (T+1, N)."""
    dt = T / n_steps
    times = jnp.arange(n_steps + 1, dtype=dtype) * dt
    if is_multistate(model):
        paths = simulate(model, n_paths, n_steps, seed=seed, mode="paths",
                         sampler=sampler, dtype=dtype,
                         observe=_observe_exposure)     # (T+1, N, C)
        paths = jnp.moveaxis(paths, -1, 1)              # (T+1, C, N)
        kind = model.exposure_discount_kind
        if kind == "exact":
            disc = model.pathwise_discount(paths)
        elif kind == "rate":
            disc = _trapezoid_discount(model.pathwise_rate(paths), dt,
                                       dtype)
        else:
            if flat_rate is None:
                raise ValueError(
                    f"{type(model).__name__} declares flat discounting — "
                    "pass flat_rate")
            disc = jnp.exp(-jnp.asarray(flat_rate, dtype)
                           * times)[:, None] * jnp.ones((1, n_paths),
                                                        dtype)
        return paths, disc, times
    paths = simulate(model, n_paths, n_steps, seed=seed, mode="paths",
                     sampler=sampler, dtype=dtype)      # (T+1, N)
    if flat_rate is None:
        disc = _trapezoid_discount(paths, dt, dtype)
    else:
        disc = jnp.exp(-jnp.asarray(flat_rate, dtype)
                       * times)[:, None] * jnp.ones((1, n_paths), dtype)
    return paths, disc, times


def _netting_body(model, trades, n_paths: int, n_steps: int, *,
                  T: float, seed: int, csa: CSA | None,
                  sampler=None, quantile: float, hazard_rate: float,
                  recovery: float, own_hazard_rate: float,
                  own_recovery: float, funding_spread: float,
                  wwr_beta: float, im_spread: float,
                  im_quantile: float, im_mpor: float,
                  kva_cost: float, kva_capital_ratio: float,
                  flat_rate, dtype) -> dict:
    """Un-jitted netting-set body — also traced inside :func:`xva_greeks`,
    where the trade closures capture differentiation tracers and therefore
    must NOT cross a nested-jit static-argument boundary."""
    paths, disc, times = _simulate_and_discount(
        model, n_paths, n_steps, T=T, seed=seed, flat_rate=flat_rate,
        dtype=dtype, sampler=sampler)
    return _netting_from_paths(
        paths, disc, times, model, trades, T=T, n_steps=n_steps, csa=csa,
        quantile=quantile, hazard_rate=hazard_rate, recovery=recovery,
        own_hazard_rate=own_hazard_rate, own_recovery=own_recovery,
        funding_spread=funding_spread, wwr_beta=wwr_beta,
        im_spread=im_spread, im_quantile=im_quantile, im_mpor=im_mpor,
        kva_cost=kva_cost, kva_capital_ratio=kva_capital_ratio,
        flat_rate=flat_rate, dtype=dtype)


def _netting_from_paths(paths, disc, times, model, trades, *, T: float,
                        n_steps: int, csa: CSA | None, quantile: float,
                        hazard_rate: float, recovery: float,
                        own_hazard_rate: float, own_recovery: float,
                        funding_spread: float, wwr_beta: float,
                        im_spread: float, im_quantile: float,
                        im_mpor: float, kva_cost: float,
                        kva_capital_ratio: float, flat_rate, dtype) -> dict:
    dt = T / n_steps
    n_paths = paths.shape[-1]
    multi = paths.ndim == 3
    # Delta-normal IM sensitivities: scalar models carry ONE jvp per mark
    # (dV/d state); multi-state models carry one tangent PER COMPONENT
    # (jax.linearize: one primal pass + C tangent replays per date) so the
    # IM is the full multivariate delta-normal
    # ``sqrt(dV' Sigma_mpor dV)`` with the model-declared margin-period
    # covariance (`im_norm`) — a single-direction shock would miss
    # cross-factor offsets (e.g. an equity forward hedged with a swap on
    # the hybrid underlying).
    if multi:
        n_comp = paths.shape[1]
        # (C, C, N) stacked unit tangents — the C replays batch into ONE
        # vmapped pass of linearize's lin (flat trace size in C; the LMM
        # carries K+1 components).
        tang_stack = (jnp.eye(n_comp, dtype=dtype)[:, :, None]
                      * jnp.ones((1, 1, n_paths), dtype))
    else:
        tangent = jnp.ones((n_paths,), dtype)

    # Every trade marked on the SAME paths: v_all[i, k, :] = trade i's value
    # at grid time k.  The simulation is the expensive part; each mark is a
    # per-row closed form.  One jvp per mark carries dV/d(state) along for
    # the netted delta-normal IM (each path's value depends only on its own
    # state, so a ones-tangent jvp IS the elementwise derivative).
    # PathDependentTrades additionally see the path row at their
    # observation date (current row before it — no future leakage); the
    # IM jvp stays w.r.t. the CURRENT state only (the observation, e.g. a
    # swaption's exercise indicator, is frozen history by then).
    def mark_trade(trade):
        if isinstance(trade, SimulationMarkedTrade):
            return trade.mark_fn(paths, times, T)
        if isinstance(trade, PathDependentTrade):
            k_obs = tuple(min(max(int(round(float(ot) / dt)), 0), n_steps)
                          for ot in trade.obs_times)

            def fn_at(k):
                obs = tuple(paths[jnp.minimum(k, ko)] for ko in k_obs)
                return lambda rr: trade.value_fn(rr, times[k], *obs)
        else:
            def fn_at(k):
                return lambda rr: trade(rr, times[k])

        if multi:
            def row(k):
                v, lin = jax.linearize(fn_at(k), paths[k])
                return v, jax.vmap(lin)(tang_stack)
        else:
            def row(k):
                return jax.jvp(fn_at(k), (paths[k],), (tangent,))
        return jax.lax.map(row, jnp.arange(n_steps + 1))

    marked = [mark_trade(v) for v in trades]
    v_all = jnp.stack([m[0] for m in marked])           # (n_tr, T+1, N)
    v_net = jnp.sum(v_all, axis=0)                      # (T+1, N)
    dv_net = sum(m[1] for m in marked)                  # (T+1, N)

    if csa is None:
        coll = jnp.zeros_like(v_net)
    else:
        h_c = jnp.asarray(csa.threshold, dtype)
        h_o = jnp.asarray(csa.own_threshold, dtype)
        mta = jnp.asarray(csa.mta, dtype)
        k_lag = int(round(float(csa.mpor) / dt))
        if float(csa.mpor) > 0 and k_lag == 0:
            import warnings

            warnings.warn(
                f"CSA margin period of risk ({float(csa.mpor):.4f}y) is "
                f"finer than the exposure grid (dt={dt:.4f}y) and rounds "
                "to a ZERO-step lag — the collateralized exposure will "
                "show no gap risk; raise n_steps so dt <= mpor",
                stacklevel=2)
        # Collateral held at k was called on the value observed at k - lag
        # (clamped at inception: the first call is against V_0).
        lag_idx = jnp.maximum(jnp.arange(n_steps + 1) - k_lag, 0)
        v_obs = v_net[lag_idx]
        they_post = jnp.maximum(v_obs - h_c, 0.0)
        we_post = jnp.maximum(-v_obs - h_o, 0.0)
        they_post = jnp.where(they_post >= mta, they_post, 0.0)
        we_post = jnp.where(we_post >= mta, we_post, 0.0)
        coll = they_post - we_post

    gap = v_net - coll                                  # collateralized MTM
    epe_u = jnp.mean(jnp.maximum(v_net, 0.0), axis=1)
    ene_u = jnp.mean(jnp.maximum(-v_net, 0.0), axis=1)
    pos = jnp.maximum(gap, 0.0)
    neg = jnp.maximum(-gap, 0.0)
    epe = jnp.mean(pos, axis=1)
    ene = jnp.mean(neg, axis=1)
    pfe = jnp.quantile(pos, quantile, axis=1)
    depe = jnp.mean(disc * pos, axis=1)
    dene = jnp.mean(disc * neg, axis=1)
    depe_u = jnp.mean(disc * jnp.maximum(v_all, 0.0), axis=2)  # per trade
    eepe = jax.lax.associative_scan(jnp.maximum, epe)

    pbar = jnp.mean(disc, axis=1)
    scalars, aux = _credit_funding_scalars(
        depe, dene, depe_u, eepe, pbar, times, dt, n_steps,
        hazard_rate=hazard_rate, recovery=recovery,
        own_hazard_rate=own_hazard_rate, own_recovery=own_recovery,
        funding_spread=funding_spread, kva_cost=kva_cost,
        kva_capital_ratio=kva_capital_ratio, dtype=dtype)
    w_o, alive, trap = aux["w_o"], aux["alive"], aux["trap"]
    # Wrong-way risk: CVA as the PATHWISE tilted expectation
    # (1-R) sum_k E[D_k V_k^+ dPD_k(path)] * S_own(start) with per-path
    # default increments whose intensity loads on the underlying state
    # (beta per cross-sectional sigma).  beta = 0 makes dpd deterministic
    # and reduces to `cva` exactly; the unconditional survival curve is
    # calibrated to the flat-hazard curve for ANY beta, so cva_wwr - cva
    # isolates the exposure-default covariance.
    dpd_paths, surv_wwr = _wwr_default_increments(
        model.wwr_state(paths) if multi else paths, times, hazard_rate,
        wwr_beta, dt, dtype)
    cva_wwr = (1.0 - recovery) * jnp.sum(
        jnp.mean(disc * pos * dpd_paths, axis=1) * w_o)
    # Netted delta-normal dynamic IM + MVA — same model as the single-trade
    # profile (`_exposure_profile`), with dV/dr the NETTED sensitivity:
    # IM_t = z_q |sum_i dV_i/dr| sigma_state(im_mpor) per path.
    z_im = jax.scipy.special.ndtri(jnp.asarray(im_quantile, dtype))
    mpor_t = jnp.asarray(im_mpor, dtype)
    if multi:
        # dv_net: (T+1, C, N) per-component netted sensitivities; the
        # model folds them with its margin-period covariance.
        im_path = z_im * model.im_norm(dv_net, paths, mpor_t)
    else:
        kap = getattr(model, "kappa", getattr(model, "a", None))
        sig_model = jnp.asarray(model.sigma, dtype)
        lognormal_im = flat_rate is not None
        if kap is not None and not lognormal_im:
            kap = jnp.asarray(kap, dtype)
            sig_mpor = sig_model * jnp.sqrt(
                (1.0 - jnp.exp(-2.0 * kap * mpor_t))
                / jnp.maximum(2.0 * kap, 1e-12))
        else:
            sig_mpor = sig_model * jnp.sqrt(mpor_t)
        state_shock = sig_mpor * paths if lognormal_im else sig_mpor
        im_path = z_im * jnp.abs(dv_net) * state_shock  # (T+1, N)
    im = jnp.mean(im_path, axis=1)
    dim = jnp.mean(disc * im_path, axis=1)
    mva = jnp.asarray(im_spread, dtype) * jnp.sum(dim * alive * trap)
    return {"times": times, "epe": epe, "ene": ene, "pfe": pfe,
            "eepe": eepe, "epe_uncollateralized": epe_u,
            "ene_uncollateralized": ene_u, "im": im,
            "cva_wwr": cva_wwr, "survival_wwr": surv_wwr, "mva": mva,
            **scalars}


_netting_set_profile = partial(
    jax.jit, static_argnames=("trades", "n_paths", "n_steps", "seed",
                              "csa", "T", "dtype"))(_netting_body)


def netting_set_profile(model, trades, n_paths: int, n_steps: int, *,
                        T: float, seed: int, csa: CSA | None = None,
                        sampler=None,
                        quantile: float = 0.95, hazard_rate: float = 0.0,
                        recovery: float = 0.4,
                        own_hazard_rate: float = 0.0,
                        own_recovery: float = 0.4,
                        funding_spread: float = 0.0,
                        wwr_beta: float = 0.0,
                        im_spread: float = 0.0,
                        im_quantile: float = 0.99,
                        im_mpor: float = 10.0 / 252.0,
                        kva_cost: float = 0.0,
                        kva_capital_ratio: float = 0.112,
                        flat_rate=None, dtype=jnp.float64) -> dict:
    """Collateralized netting-set exposure and xVA from ONE simulation.

    ``trades``: tuple of valuation closures ``v(state_row, t)`` — swaps via
    :func:`swap_value_fn` (possibly scaled/negated for notional/direction),
    forwards, bonds — all marked on the same simulated underlying (a
    short-rate model, or any price process with ``flat_rate``).  Values net
    per date: ``V_net(t) = sum_i v_i`` — the counterparty owes / is owed
    only the net.

    ``csa``: variation-margin terms (:class:`CSA`).  Collateral held at t
    was called on ``V_net(t - mpor)`` above the thresholds, with calls
    below the minimum transfer amount skipped; the collateralized exposure
    is ``(V_net(t) - C(t))^+`` — what the margin-period-of-risk gap leaves
    open.  ``csa=None`` reproduces uncollateralized netting.

    Returns profiles (``epe``/``ene``/``pfe``/``eepe`` on the
    collateralized exposure, ``epe_uncollateralized`` for comparison) and
    scalars ``cva``/``dva``/``bcva``/``fca``/``fba``/``fva`` (all on the
    collateralized exposure, survival-weighted exactly as
    :func:`exposure_profile`) plus ``cva_no_netting`` — the sum of
    standalone per-trade CVAs, the netting benefit's baseline.

    ``wwr_beta``: wrong-way risk — the counterparty's default intensity
    over each period loads on the period-start underlying state,
    ``lambda_k(path) = c_k exp(beta * z_{k-1})`` with ``z`` the
    cross-sectionally standardized state (beta is "intensity log-points
    per sigma of the underlying") and ``c_k`` Newton-calibrated so the
    unconditional survival curve equals the flat-hazard curve EXACTLY for
    any beta — the CDS curve stays an input; beta only correlates WHO
    defaults with WHERE the exposure is.  ``cva_wwr`` is the pathwise
    ``(1-R) sum E[D V^+ dPD(path)]`` (own-survival weighted as ``cva``);
    ``survival_wwr`` returns the calibrated mean survival curve as a
    diagnostic.  ``beta = 0`` reduces ``cva_wwr`` to ``cva``; beta > 0
    with exposure increasing in the state is wrong-way (cva_wwr > cva),
    beta < 0 right-way.  DVA keeps the flat own-hazard (own-default WWR
    is out of scope).

    ``im_spread``/``im_quantile``/``im_mpor``: delta-normal dynamic
    initial margin on the NETTED book — IM_t = z_q |dV_net/d state|
    sigma_state(im_mpor) per path, with dV_net carried by one jvp per
    trade mark; the ``im`` profile is always reported, ``mva`` funds it
    at ``im_spread`` while both parties survive (0 switches MVA off).
    A single-trade netting set reproduces `exposure_profile`'s ``im``/
    ``mva`` (tested).

    ``kva_cost``/``kva_capital_ratio``: capital valuation adjustment.
    The regulatory capital held against this netting set is modeled as
    ``K(t) = kva_capital_ratio * EEPE(t)`` — the Basel counterparty-credit
    chain (EAD = alpha*EEPE, RWA = RW*EAD, K = 8%*RWA) collapsed into one
    ratio, default ``1.4 * 1.0 * 0.08 = 0.112`` — and
    ``KVA = kva_cost * sum_k K(t_k) P(0,t_k) S_c S_o trap_k`` with
    ``P(0,t)`` the mean pathwise discount factor (the model's own zero
    curve) and the same trapezoid accrual as FCA/FBA/MVA; ``kva_cost`` is
    the hurdle rate on capital (e.g. 0.10).  ``kva_cost = 0`` switches the
    term off (the default); a deterministic-exposure book reproduces the
    closed-form capital integral (tested).  Note KVA uses the
    COLLATERALIZED EEPE — variation margin reduces capital here, matching
    the exposure the capital is held against.

    Pinned limits (tested): zero thresholds + zero MTA + zero MPoR make
    the collateralized EPE identically 0; with MPoR = delta on a linear
    trade ``c * r`` under near-Brownian rates the collateralized EPE
    reproduces the closed-form gap risk ``c sigma sqrt(delta) / sqrt(2 pi)``;
    a NumPy re-implementation of the WWR tilt reproduces ``cva_wwr``.
    """
    return _netting_set_profile(
        model, tuple(trades), n_paths, n_steps, T=T, seed=seed, csa=csa,
        sampler=sampler, quantile=quantile, hazard_rate=hazard_rate,
        recovery=recovery,
        own_hazard_rate=own_hazard_rate, own_recovery=own_recovery,
        funding_spread=funding_spread, wwr_beta=wwr_beta,
        im_spread=im_spread, im_quantile=im_quantile, im_mpor=im_mpor,
        kva_cost=kva_cost, kva_capital_ratio=kva_capital_ratio,
        flat_rate=flat_rate, dtype=dtype)


def netting_set_profile_rqmc(model, trades, n_paths: int, n_steps: int, *,
                             T: float, seed: int, n_replicates: int = 8,
                             qmc_seed: int = 0, **kw) -> dict:
    """Netting-set xVA under randomized QMC with HONEST error bars.

    The `price_to_tolerance_rqmc` pattern applied to the risk engine:
    ``n_paths`` total paths split into ``n_replicates`` INDEPENDENTLY
    scrambled Sobol replicates (each a `samplers.SobolSampler.for_process`
    table — mixed normal/uniform slots included, so every process the
    netting engine simulates qualifies), each replicate running the full
    `netting_set_profile`.  Profile arrays return the replicate mean;
    every scalar adjustment gains a ``<name>_std_err`` companion — the
    replicate-spread standard error ``std(replicate values, ddof=1) /
    sqrt(R)``, the honest QMC bar (the iid formula overstates QMC error
    by the full convergence gain and is not reported).

    The replicate index plays the stream role: global path ids within a
    replicate are 0..n_paths/R-1 against that replicate's own scrambled
    table, so the estimate is reproducible and mesh-friendly by the same
    contract as the plain engine.  Measured (tests): >= 2x std-err
    reduction on the demo netting-set CVA at equal paths vs plain MC
    replicates.

    Accepts every `netting_set_profile` keyword via ``kw``.
    """
    from montecarlo.samplers import SobolSampler

    if n_replicates < 2:
        raise ValueError("n_replicates must be >= 2 (the error bar is the "
                         "spread across replications)")
    if n_paths % n_replicates:
        raise ValueError(f"n_paths={n_paths} not divisible by "
                         f"n_replicates={n_replicates}")
    per = n_paths // n_replicates
    profs = []
    for r in range(n_replicates):
        smp = SobolSampler.for_process(model, per, n_steps,
                                       seed=qmc_seed + r)
        profs.append(netting_set_profile(model, trades, per, n_steps,
                                         T=T, seed=seed, sampler=smp,
                                         **kw))
    out = {}
    r_f = float(n_replicates)
    for k in profs[0]:
        stack = jnp.stack([jnp.asarray(p[k]) for p in profs])
        out[k] = jnp.mean(stack, axis=0)
        if stack.ndim == 1 and k != "times":
            out[k + "_std_err"] = (jnp.std(stack, ddof=1)
                                   / jnp.sqrt(jnp.asarray(r_f,
                                                          stack.dtype)))
    out["times"] = profs[0]["times"]
    out["n_replicates"] = n_replicates
    return out


# ---------------------------------------------------------------------------
# Multi-counterparty portfolio: several netting sets, ONE simulation
# ---------------------------------------------------------------------------

#: Per-set credit/collateral scalars (operands) with their defaults; the
#: remaining spec keys (trades, csa) are static.
_SET_SCALARS = (("hazard_rate", 0.0), ("recovery", 0.4),
                ("wwr_beta", 0.0), ("im_spread", 0.0),
                ("kva_cost", 0.0), ("kva_capital_ratio", 0.112))


@partial(jax.jit, static_argnames=("sets", "n_paths", "n_steps", "seed",
                                   "T", "quantile", "dtype"))
def _portfolio_xva(model, credit, shared, n_paths, n_steps, *, T, seed,
                   sets, quantile, flat_rate, dtype, sampler=None):
    paths, disc, times = _simulate_and_discount(
        model, n_paths, n_steps, T=T, seed=seed, flat_rate=flat_rate,
        dtype=dtype, sampler=sampler)
    out = {}
    for (name, trades, csa), cred in zip(sets, credit):
        out[name] = _netting_from_paths(
            paths, disc, times, model, trades, T=T, n_steps=n_steps,
            csa=csa, quantile=quantile, flat_rate=flat_rate, dtype=dtype,
            own_hazard_rate=shared["own_hazard_rate"],
            own_recovery=shared["own_recovery"],
            funding_spread=shared["funding_spread"],
            im_quantile=shared["im_quantile"], im_mpor=shared["im_mpor"],
            **cred)
    return out


def portfolio_xva(model, netting_sets, n_paths: int, n_steps: int, *,
                  T: float, seed: int, sampler=None,
                  quantile: float = 0.95,
                  own_hazard_rate: float = 0.0, own_recovery: float = 0.4,
                  funding_spread: float = 0.0, im_quantile: float = 0.99,
                  im_mpor: float = 10.0 / 252.0, flat_rate=None,
                  dtype=jnp.float64) -> dict:
    """Multi-counterparty xVA: several netting sets on ONE simulation.

    Real books face many counterparties; netting applies only WITHIN each
    counterparty's set, while the simulation of the underlying is shared.
    ``netting_sets`` maps name -> spec dict: ``trades`` (required tuple),
    ``csa`` (optional :class:`CSA`), and per-counterparty scalars
    ``hazard_rate``/``recovery``/``wwr_beta``/``im_spread``/``kva_cost``/
    ``kva_capital_ratio`` (defaults as in :func:`netting_set_profile`).
    Own-credit and funding inputs are portfolio-level keywords (they are
    OURS, not the counterparty's).

    Returns ``{"sets": {name: profile}, "portfolio": totals}`` where each
    per-set profile is exactly `netting_set_profile`'s dict (a one-set
    portfolio is bitwise identical to that engine — tested) and totals
    sum the adjustment scalars plus the per-date collateralized ``epe``.
    Splitting offsetting trades across counterparties INCREASES the total
    CVA versus netting them in one set (tested) — that lost offset is
    precisely what the aggregation exists to measure.
    """
    sets = []
    credit = []
    for name, spec in netting_sets.items():
        unknown = set(spec) - {"trades", "csa"} - {k for k, _ in
                                                   _SET_SCALARS}
        if unknown:
            raise ValueError(f"netting set {name!r}: unknown keys "
                             f"{sorted(unknown)}")
        sets.append((name, tuple(spec["trades"]), spec.get("csa")))
        credit.append({k: jnp.asarray(spec.get(k, d), dtype)
                       for k, d in _SET_SCALARS})
    shared = {k: jnp.asarray(v, dtype) for k, v in
              dict(own_hazard_rate=own_hazard_rate,
                   own_recovery=own_recovery,
                   funding_spread=funding_spread, im_quantile=im_quantile,
                   im_mpor=im_mpor).items()}
    per_set = _portfolio_xva(model, tuple(credit), shared, n_paths,
                             n_steps, T=T, seed=seed, sets=tuple(sets),
                             quantile=quantile, flat_rate=flat_rate,
                             dtype=dtype, sampler=sampler)
    totals = {k: sum(per_set[name][k] for name in per_set)
              for k in ("cva", "dva", "bcva", "cva_no_netting", "fca",
                        "fba", "fva", "mva", "kva", "epe")}
    totals["peak_epe"] = jnp.max(totals["epe"])
    return {"sets": per_set, "portfolio": totals}


# ---------------------------------------------------------------------------
# Market-risk VaR on the trade book (full revaluation at a horizon)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("trades", "n_paths", "n_steps", "seed",
                                   "horizon", "levels", "dtype"))
def _book_var(model, trades, n_paths: int, n_steps: int, *,
              horizon: float, seed: int, levels, flat_rate, dtype) -> dict:
    dt = horizon / n_steps
    t_h = jnp.asarray(horizon, dtype)
    if is_multistate(model):
        paths = simulate(model, n_paths, n_steps, seed=seed, mode="paths",
                         dtype=dtype, observe=_observe_exposure)
        paths = jnp.moveaxis(paths, -1, 1)              # (T+1, C, N)
        kind = model.exposure_discount_kind
        if kind == "exact":
            disc_h = model.pathwise_discount(paths)[-1]
        elif kind == "rate":
            r = model.pathwise_rate(paths)
            disc_h = jnp.exp(-jnp.sum(0.5 * (r[:-1] + r[1:]) * dt, axis=0))
        else:
            disc_h = jnp.full((n_paths,),
                              jnp.exp(-jnp.asarray(flat_rate, dtype)
                                      * t_h), dtype)
    else:
        paths = simulate(model, n_paths, n_steps, seed=seed, mode="paths",
                         dtype=dtype)                   # rows 0..n_steps
        if flat_rate is None:
            mid = 0.5 * (paths[:-1] + paths[1:]) * dt
            disc_h = jnp.exp(-jnp.sum(mid, axis=0))     # (N,) D(0, h)
        else:
            disc_h = jnp.full((n_paths,),
                              jnp.exp(-jnp.asarray(flat_rate, dtype)
                                      * t_h), dtype)

    def mark(trade, row, t, k):
        if isinstance(trade, PathDependentTrade):
            k_obs = tuple(min(max(int(round(float(ot) / dt)), 0), n_steps)
                          for ot in trade.obs_times)
            obs = tuple(paths[min(k, ko)] for ko in k_obs)
            return trade.value_fn(row, t, *obs)
        return trade(row, t)

    v0 = sum(mark(tr, paths[0], jnp.asarray(0.0, dtype), 0)
             for tr in trades)[0]
    vh = sum(mark(tr, paths[-1], t_h, n_steps) for tr in trades)
    pnl = disc_h * vh - v0                              # (N,)
    pnl_sorted = jnp.sort(pnl)
    n = jnp.asarray(n_paths, dtype)
    out = {"horizon": t_h, "v0": v0,
           "mean_pnl": jnp.mean(pnl),
           "std_pnl": jnp.std(pnl, ddof=1)}
    def sorted_quantile(p):
        # pnl is already sorted — jnp.quantile would re-sort O(N log N)
        # per call; interpolate the order statistics directly.
        idx = jnp.clip(jnp.asarray(p, dtype), 0.0, 1.0) * (n - 1.0)
        lo = jnp.floor(idx).astype(jnp.int32)
        hi = jnp.minimum(lo + 1, n_paths - 1)
        w = idx - lo.astype(dtype)
        return pnl_sorted[lo] * (1.0 - w) + pnl_sorted[hi] * w

    qs = jnp.asarray(levels, dtype)
    lo_q = sorted_quantile(1.0 - qs)
    for i, q in enumerate(levels):
        var_q = -lo_q[i]
        tail = pnl <= -var_q
        w = tail.astype(dtype)
        tail_n = jnp.maximum(jnp.sum(w), 1.0)
        cvar_q = -jnp.sum(w * pnl) / tail_n
        # Asymptotic order-statistic band: se(VaR) = sqrt(q(1-q)/n) Q'(p)
        # with the quantile-function slope Q' by a central difference.
        eps = 2.0 / jnp.sqrt(n)
        ql = sorted_quantile(1.0 - q - eps)
        qh = sorted_quantile(1.0 - q + eps)
        qprime = jnp.maximum((qh - ql) / (2.0 * eps), 1e-30)
        se = jnp.sqrt(q * (1.0 - q) / n) * qprime
        pct = int(round(q * 100))
        out[f"var_{pct}"] = var_q
        out[f"var_{pct}_std_err"] = se
        out[f"cvar_{pct}"] = cvar_q
        out[f"cvar_{pct}_std_err"] = (
            jnp.sqrt(jnp.sum(w * jnp.square(-pnl - cvar_q)) / tail_n)
            / jnp.sqrt(tail_n))
    return out


def book_var(model, trades, n_paths: int, *, horizon: float,
             n_steps: int = 10, seed: int = 0, levels=(0.95, 0.99),
             flat_rate=None, dtype=jnp.float64) -> dict:
    """Market-risk VaR/CVaR of the netted trade book by FULL REVALUATION.

    The desk-risk companion to the counterparty engine: simulate the
    underlying to ``horizon`` (``n_steps`` sub-steps so pathwise rate
    discounting stays accurate), remark the whole book with the same
    closed-form/`PathDependentTrade` machinery `netting_set_profile`
    uses, and measure the discounted P&L

        PnL = D(0, h) * V_net(state_h, h) - V_net(state_0, 0).

    No delta-gamma approximation anywhere — every trade revalues exactly
    at the horizon state, so the numbers are right even where Taylor VaR
    fails (options near expiry, large moves).  Exact-sort quantiles
    (horizon runs are one row, not a grid — no sketch needed) with the
    standard order-statistic standard error (q(1-q)/n over a central
    density estimate); CVaR over the empirical tail.

    Assumes no contractual cashflows inside the horizon (10d market-risk
    horizons sit well inside swap periods; a payment inside the horizon
    would need flow accrual this function does not model).

    Returns ``{"horizon", "v0", "mean_pnl", "std_pnl"}`` plus, per level
    ``q``: ``var_<q>``, ``var_<q>_std_err``, ``cvar_<q>``,
    ``cvar_<q>_std_err`` (losses positive).  Closed-form pins (tested):
    a linear rate trade reproduces the normal ``c sigma_h z_q``; an
    equity forward reproduces the lognormal quantile exactly.
    """
    if isinstance(trades, SimulationMarkedTrade) or any(
            isinstance(t, SimulationMarkedTrade) for t in trades):
        raise TypeError("book_var revalues closed-form /"
                        " PathDependentTrade books; AMC regression marks "
                        "are fitted on the exposure grid, not a horizon "
                        "slice — mark Bermudans via netting_set_profile")
    # simulate() advances by the PROCESS's own dt; a model built for the
    # exposure grid (dt = maturity/steps) would diffuse n_steps * that,
    # not the VaR horizon — silently inflating VaR by sqrt(dt_ratio).
    step_dt = getattr(model, "dt", None)
    if step_dt is not None:
        step_dt = float(jnp.asarray(step_dt))
        # f32 models store dt rounded — allow that, catch grid mixups
        # (those are off by the steps ratio, orders of magnitude).
        if abs(step_dt * n_steps - horizon) > 1e-8 + 1e-5 * abs(horizon):
            raise ValueError(
                f"model.dt * n_steps = {step_dt * n_steps:.6g} != horizon "
                f"= {horizon:.6g}: rebuild the model with dt = horizon / "
                "n_steps (valuation closures never read dt, so the same "
                "trades can be reused)")
    return _book_var(model, tuple(trades), n_paths, n_steps,
                     horizon=horizon, seed=seed, levels=tuple(levels),
                     flat_rate=flat_rate, dtype=dtype)


# ---------------------------------------------------------------------------
# xVA sensitivities (pathwise AD through the netting-set engine)
# ---------------------------------------------------------------------------

# Credit/funding scalars that become differentiable when present in the
# params dict passed to `xva_greeks` (they override the keyword defaults).
_GREEK_KWARGS = ("hazard_rate", "recovery", "own_hazard_rate",
                 "own_recovery", "funding_spread", "wwr_beta", "im_spread",
                 "kva_cost", "kva_capital_ratio")


@partial(jax.jit, static_argnames=("build_fn", "n_paths", "n_steps", "seed",
                                   "csa", "T", "outputs", "dtype"))
def _xva_greeks(build_fn, params, base, n_paths, n_steps, *, T, seed, csa,
                outputs, dtype):
    def scalars(p):
        model, trades, flat_rate = build_fn(p)
        kw = dict(base)
        for k in _GREEK_KWARGS:
            if k in p:
                kw[k] = p[k]
        res = _netting_body(model, tuple(trades), n_paths, n_steps, T=T,
                            seed=seed, csa=csa, flat_rate=flat_rate,
                            dtype=dtype, **kw)
        return {k: res[k] for k in outputs}

    # One forward tangent per param (few params, many outputs — forward
    # mode is the cheap direction, and it differentiates through the WWR
    # Newton `fori_loop`, which reverse mode cannot).  linearize shares
    # the single primal pass between the values and every tangent
    # (jacfwd would re-run the primal).
    vals, lin = jax.linearize(scalars, params)
    zeros = {k: jnp.zeros_like(v) for k, v in params.items()}
    per_param = {}
    for k in params:
        tangent = dict(zeros)
        tangent[k] = jnp.ones_like(params[k])
        per_param[k] = lin(tangent)
    return vals, {out: {k: per_param[k][out] for k in params}
                  for out in outputs}


def xva_greeks(build_fn, params, n_paths: int, n_steps: int, *, T: float,
               seed: int, csa: CSA | None = None,
               outputs=("cva", "dva", "bcva", "fca", "fba", "fva", "mva"),
               quantile: float = 0.95, hazard_rate: float = 0.0,
               recovery: float = 0.4, own_hazard_rate: float = 0.0,
               own_recovery: float = 0.4, funding_spread: float = 0.0,
               wwr_beta: float = 0.0, im_spread: float = 0.0,
               im_quantile: float = 0.99, im_mpor: float = 10.0 / 252.0,
               kva_cost: float = 0.0, kva_capital_ratio: float = 0.112,
               dtype=jnp.float64) -> dict:
    """xVA sensitivities by pathwise AD through the netting-set engine.

    Desks hedge CVA/FVA, so the adjustments need Greeks, not just levels.
    One forward-mode pass per parameter differentiates the WHOLE pipeline
    — simulation (the processes' exact transitions are smooth in their
    parameters), trade marking, netting, CSA collateral, survival
    weighting — under common random numbers: the returned numbers are the
    exact derivatives of THIS seed's estimator, so same-seed finite
    differences reproduce them (tested) and they converge to the true
    Greeks at the estimator's own MC rate (tested against the equity
    forward's Black-Scholes CVA closed form).

    ``build_fn(params) -> (model, trades, flat_rate)``: rebuilds the book
    from the dict of scalars being differentiated — trade closures capture
    model parameters, so valuation sensitivities flow only if the trades
    are REBUILT from ``params`` (e.g. ``swap_value_fn(model, ...)`` inside
    ``build_fn``).  ``flat_rate`` may itself be a ``params`` leaf (equity
    books: discounting sensitivity), or None for short-rate underlyings.
    ``build_fn`` is a static jit argument — define it once at module level
    or reuse the same function object to avoid recompiles.

    ``params``: dict of scalars to differentiate with respect to.  Keys in
    ``_GREEK_KWARGS`` (``hazard_rate``, ``funding_spread``, ...) also
    OVERRIDE the corresponding keyword and so become differentiable credit
    inputs (e.g. ``d cva / d hazard_rate`` is the flat-curve CVA01 up to
    scaling); every other key is consumed by ``build_fn``.

    ``outputs``: which scalar adjustments to differentiate (any of
    ``cva``/``dva``/``bcva``/``fca``/``fba``/``fva``/``mva``/``kva``/
    ``cva_wwr``).

    Caveats, stated rather than hidden:
      - CSA terms live in the STATIC ``csa`` tuple — thresholds are not
        differentiable here (their max-kinks would be fine; it is a jit
        staticness choice, not a math one).
      - A nonzero ``csa.mta`` makes collateral a JUMP function of the
        lagged value; pathwise AD ignores the deadband's boundary term and
        is biased by the (density x jump) mass there — a warning is
        raised.  Everything else (max-kinks at V=0, |dV| in the IM) is
        kink-only: pathwise derivatives are a.e. exact and unbiased for
        continuous state distributions.

    Returns ``{"values": {out: scalar}, "greeks": {out: {param: d out /
    d param}}}``.
    """
    if csa is not None and float(csa.mta) > 0:
        import warnings

        warnings.warn(
            "xva_greeks with csa.mta > 0: the MTA deadband is a jump "
            "discontinuity in collateral, and pathwise AD drops its "
            "boundary term — greeks are biased by the probability mass "
            "crossing the deadband; set mta=0 for exact pathwise greeks",
            stacklevel=2)
    params = {k: jnp.asarray(v, dtype) for k, v in params.items()}
    base = dict(quantile=quantile, hazard_rate=hazard_rate,
                recovery=recovery, own_hazard_rate=own_hazard_rate,
                own_recovery=own_recovery, funding_spread=funding_spread,
                wwr_beta=wwr_beta, im_spread=im_spread,
                im_quantile=im_quantile, im_mpor=im_mpor,
                kva_cost=kva_cost, kva_capital_ratio=kva_capital_ratio)
    base = {k: jnp.asarray(v, dtype) for k, v in base.items()}
    vals, grads = _xva_greeks(build_fn, params, base, n_paths, n_steps,
                              T=T, seed=seed, csa=csa,
                              outputs=tuple(outputs), dtype=dtype)
    return {"values": vals, "greeks": grads}


def _scaled_trades(trades, w):
    """Each trade's mark multiplied by its (traced) notional scale w[i] —
    the differentiation handle for Euler allocation.  The scale rides the
    closure, so `_netting_body` (un-jitted, tracer-safe — same contract
    `xva_greeks` relies on) nets ``sum_i w_i V_i`` without any engine
    plumbing."""
    scaled = []
    for i, tr in enumerate(trades):
        wi = w[i]
        if isinstance(tr, SimulationMarkedTrade):
            def mark_fn(paths, times, T, _tr=tr, _w=wi):
                v, dv = _tr.mark_fn(paths, times, T)
                return _w * v, _w * dv

            scaled.append(SimulationMarkedTrade(mark_fn))
        elif isinstance(tr, PathDependentTrade):
            scaled.append(PathDependentTrade(
                lambda r, t, *obs, _tr=tr, _w=wi:
                    _w * _tr.value_fn(r, t, *obs),
                tr.obs_times))
        else:
            scaled.append(lambda r, t, _tr=tr, _w=wi: _w * _tr(r, t))
    return tuple(scaled)


#: Scalar adjustments eligible for trade-level allocation (profiles like
#: ``epe``/``pfe`` are vectors; ``cva_no_netting`` is already per trade).
_ALLOC_OUTPUTS = ("cva", "dva", "bcva", "fca", "fba", "fva", "kva", "mva",
                  "cva_wwr")


def xva_trade_allocations(model, trades, n_paths: int, n_steps: int, *,
                          T: float, seed: int, csa: CSA | None = None,
                          outputs=("cva", "dva", "fva"),
                          quantile: float = 0.95,
                          hazard_rate: float = 0.0, recovery: float = 0.4,
                          own_hazard_rate: float = 0.0,
                          own_recovery: float = 0.4,
                          funding_spread: float = 0.0,
                          wwr_beta: float = 0.0, im_spread: float = 0.0,
                          im_quantile: float = 0.99,
                          im_mpor: float = 10.0 / 252.0,
                          kva_cost: float = 0.0,
                          kva_capital_ratio: float = 0.112,
                          flat_rate=None, dtype=jnp.float64) -> dict:
    """Euler (marginal) allocation of netting-set xVA to its trades.

    A desk needs to charge each trade its share of the netting set's CVA —
    but netted adjustments don't decompose by construction (the whole point
    of netting is that ``CVA(book) != sum_i CVA(trade_i)``).  The standard
    answer (Tasche; Pykhtin-Rosen for CVA) is the Euler allocation

        alloc_i = d xVA(w) / d w_i  at  w = 1,

    where ``w_i`` scales trade i's mark inside the netted value
    ``V_net = sum_i w_i V_i``.  Because exposure ``(V_net - C)^+``, the
    running-max EEPE, and the ``|dV_net|`` initial margin are all
    positively homogeneous of degree 1 in ``w`` whenever collateral is
    (``csa=None``, or a CSA with zero threshold/MTA), Euler's theorem makes
    the allocations ADD UP EXACTLY: ``sum_i alloc_i = xVA``.  A fixed
    threshold or MTA breaks homogeneity — the returned
    ``allocation_gap[out] = total - sum(alloc)`` then reports the
    unallocated remainder instead of hiding it (a warning is raised).

    Computed as ONE primal netting pass (`jax.linearize` through
    :func:`netting_set_profile`'s body under common random numbers) plus
    one forward tangent per trade — forward mode because the wrong-way-risk
    Newton calibration sits in the primal graph (same reasoning as
    :func:`xva_greeks`).  The derivative is pathwise-exact: the max-kinks
    at ``V_net = 0`` are measure-zero for continuous state distributions.

    ``outputs``: any of ``{"cva", "dva", "bcva", "fca", "fba", "fva",
    "kva", "mva", "cva_wwr"}``.

    Returns ``{"values": {out: total}, "allocations": {out: (n_trades,)},
    "allocation_gap": {out: total - sum}}``.

    Reference: the reference app (`/root/reference/app.py`) has no
    counterparty-credit analog; this deepens the xVA subsystem the rebuild
    added (VERDICT r3 ask #3's netting engine).
    """
    bad = [k for k in outputs if k not in _ALLOC_OUTPUTS]
    if bad:
        raise ValueError(f"xva_trade_allocations: non-scalar or unknown "
                         f"outputs {bad}; allocatable: {_ALLOC_OUTPUTS}")
    if csa is not None and (float(csa.threshold) > 0
                            or float(csa.own_threshold) > 0
                            or float(csa.mta) > 0):
        import warnings

        warnings.warn(
            "xva_trade_allocations with a nonzero CSA threshold/MTA: "
            "collateral is no longer positively homogeneous in the trade "
            "scales, so Euler allocations will not sum to the total — "
            "see the returned allocation_gap",
            stacklevel=2)
    outputs = tuple(outputs)
    n_tr = len(trades)
    kw = dict(quantile=quantile, hazard_rate=hazard_rate,
              recovery=recovery, own_hazard_rate=own_hazard_rate,
              own_recovery=own_recovery, funding_spread=funding_spread,
              wwr_beta=wwr_beta, im_spread=im_spread,
              im_quantile=im_quantile, im_mpor=im_mpor, kva_cost=kva_cost,
              kva_capital_ratio=kva_capital_ratio)

    def scalars(w):
        res = _netting_body(model, _scaled_trades(trades, w), n_paths,
                            n_steps, T=T, seed=seed, csa=csa,
                            flat_rate=flat_rate, dtype=dtype, **kw)
        return {k: res[k] for k in outputs}

    def run(w0):
        vals, lin = jax.linearize(scalars, w0)
        # vmap the linear tangent map over the n_trades basis vectors:
        # one traced tangent computation instead of n_trades unrolled
        # copies (trace/compile size stays O(1) in book size).
        allocs = jax.vmap(lin)(jnp.eye(n_tr, dtype=dtype))
        return vals, allocs

    vals, allocs = jax.jit(run)(jnp.ones((n_tr,), dtype))
    gap = {k: vals[k] - jnp.sum(allocs[k]) for k in outputs}
    return {"values": vals, "allocations": allocs, "allocation_gap": gap}


__all__ = ["CSA", "PathDependentTrade", "SimulationMarkedTrade",
           "book_var", "exposure_profile", "netting_set_profile",
           "portfolio_xva", "swap_value_fn", "swaption_value_fn",
           "xva_greeks", "xva_trade_allocations"]
