"""Path functionals: running statistics accumulated inside the scan.

Path-dependent payoffs (Asian averages, barrier breaches, lookbacks) need
per-path running statistics over the whole trajectory.  Materializing the
(T+1, N) path array for that is exactly the memory pattern this framework
avoids — instead, functionals fold into the simulation scan and memory stays
O(paths):

    result = simulate_functionals(proc, N, T, seed=...,
                                  functionals={"avg": ARITH_MEAN,
                                               "max": RUNNING_MAX})
    result["terminal"], result["avg"], result["max"]

Each functional is (init, update, finalize) over per-step prices.  All are
pure elementwise ops, so the whole thing stays one fused device program and
inherits the engine's shard-invariance.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, NamedTuple

import jax
import jax.numpy as jnp

from montecarlo.engine.simulate import path_ids_for
from montecarlo.engine.simulate import check_sampler
from montecarlo.rng.normal import exp32, log32
from montecarlo.samplers import PlainSampler


def _static_steps(n_steps, what: str) -> int:
    """Concrete step count for finalizes that must validate it.

    Autocallables check period divisibility (and build the maturity
    discount factor) from ``n_steps``, so their ``finalize`` requires a
    STATIC step count — `simulate_functionals` always provides one.  Call
    sites that finalize with a traced index (e.g.
    ``lsm_price_path_dependent`` finalizes at every exercise date ``t``)
    would otherwise die in ``int(tracer)`` with an inscrutable
    ConcretizationTypeError; fail with the actual contract instead.
    """
    if isinstance(n_steps, jax.core.Tracer):
        raise TypeError(
            f"{what}.finalize requires a static (concrete) step count: the "
            "period-divisibility check and maturity discounting need a "
            "Python int.  Engines that finalize at a traced time index "
            "(e.g. lsm_price_path_dependent) cannot drive this functional.")
    return int(n_steps)


class PathFunctional(NamedTuple):
    """(init, update, finalize) fold over per-step observations.

    init(obs0) -> acc;  update(acc, obs, t) -> acc;
    finalize(acc, n_steps) -> value.  ``t`` is the 1-based step index of the
    observation being folded (the spot is folded by ``init``).

    ``space`` selects what the fold observes each step:

    - ``"price"``: per-step prices (``process.prices(state)``).
    - ``"log"``: per-step LOG prices — the log-state processes hand their
      state over directly, skipping the per-step exp and the per-step
      ``log`` the price-space fold would reapply (an accelerator's
      runtime ``log`` may be biased; DEVNOTES "Transcendental
      accuracy").  ``finalize`` still returns price-space
      values, so payoffs are space-agnostic.  Requires positive prices on
      processes without ``log_prices`` (the fallback is ``log32(prices)``)
      — don't use log-space functionals on short-rate processes.

    The engines compute only the observables some functional asks for
    (the other branch is dead-code-eliminated).
    """

    init: callable
    update: callable
    finalize: callable
    space: str = "price"


def functional_observables(process, state, functionals):
    """Per-functional observation tuple for one step — THE shared
    dispatch of ``space`` (scan engine, fused kernels, and the LSM fold
    must agree or log/price folds silently diverge)."""
    spaces = [getattr(f, "space", "price") for f in functionals]
    need_price = ("price" in spaces
                  or ("log" in spaces
                      and not hasattr(process, "log_prices")))
    prices = process.prices(state) if need_price else None
    logp = None
    if "log" in spaces:
        logp = (process.log_prices(state)
                if hasattr(process, "log_prices") else log32(prices))
    return tuple(logp if sp == "log" else prices for sp in spaces)


#: Arithmetic mean of the T+1 observations (spot included) — Asian options.
ARITH_MEAN = PathFunctional(
    init=lambda s: s,
    update=lambda acc, s, t: acc + s,
    finalize=lambda acc, n_steps: acc / (n_steps + 1.0),
)

#: Geometric mean of the T+1 observations — has a closed form under GBM.
GEO_MEAN = PathFunctional(
    init=lambda lp: lp,
    update=lambda acc, lp, t: acc + lp,
    finalize=lambda acc, n_steps: exp32(acc / (n_steps + 1.0)),
    space="log",
)

#: Running maximum / minimum — barriers and lookbacks.  Folded in log
#: space (monotone, so max/min commute with exp); finalized to prices.
RUNNING_MAX = PathFunctional(
    init=lambda lp: lp,
    update=lambda acc, lp, t: jnp.maximum(acc, lp),
    finalize=lambda acc, n_steps: exp32(acc),
    space="log",
)
RUNNING_MIN = PathFunctional(
    init=lambda lp: lp,
    update=lambda acc, lp, t: jnp.minimum(acc, lp),
    finalize=lambda acc, n_steps: exp32(acc),
    space="log",
)


def barrier_survival_up(barrier: float, sigma: float, dt: float
                        ) -> PathFunctional:
    """Probability the *continuous* path stayed below an up barrier.

    Discretely monitored barriers systematically underestimate knockouts;
    the Brownian-bridge correction multiplies, per step, the exact
    conditional crossing probability of log-GBM between grid points,

        P(cross | S_t, S_{t+1}) = exp(-2 a b / (sigma^2 dt)),
        a = log(B/S_t), b = log(B/S_{t+1})   (both > 0 below the barrier),

    which makes the up-and-out price *unbiased for the continuous barrier
    at any monitoring frequency* (exact under GBM, where log S is Brownian
    with drift between grid points; for state-dependent vol pass the
    near-barrier vol).  Use as

        E[payoff(S_T) * survival]        (knock-out)
        E[payoff(S_T) * (1 - survival)]  (knock-in, same run)

    The accumulator carries (survival probability, previous log price);
    the fold runs in log space — the crossing probability only needs log
    prices, which the log-state processes provide exactly (the price-space
    fold's per-step ``jnp.log`` is the platform's runtime approximation).
    """
    log_b = math.log(barrier)
    inv = 1.0 / (float(sigma) ** 2 * float(dt))

    def update(acc, log_s, t):
        surv, prev = acc
        a = log_b - prev
        b = log_b - log_s
        p_cross = exp32(-2.0 * a * b * inv)
        alive = (a > 0) & (b > 0)
        return (surv * jnp.where(alive, 1.0 - p_cross, 0.0), log_s)

    return PathFunctional(
        init=lambda log_s: (jnp.where(log_s < log_b, 1.0, 0.0), log_s),
        update=update,
        finalize=lambda acc, n_steps: acc[0],
        space="log",
    )


def cliquet_sum(period: int, local_floor: float, local_cap: float
                ) -> PathFunctional:
    """Cliquet / ratchet leg: sum of collared period returns.

    Every ``period`` steps the return since the last reset is collared to
    [local_floor, local_cap] and accumulated:

        leg = sum_j clip(S_{t_j} / S_{t_{j-1}} - 1, floor, cap),
        t_j = j * period.

    The classic capped-and-floored cliquet pays ``max(leg, global_floor)``
    on the notional.  The accumulator carries (running sum, price at the
    last reset); a trailing partial period is ignored (choose n_steps as a
    multiple of ``period``).
    """
    if period < 1:
        raise ValueError("period must be >= 1")

    def update(acc, s, t):
        total, prev = acc
        at_reset = (t % period) == 0
        ret = jnp.clip(s / prev - 1.0, local_floor, local_cap)
        return (jnp.where(at_reset, total + ret, total),
                jnp.where(at_reset, s, prev))

    return PathFunctional(
        init=lambda s: (jnp.zeros_like(s), s),
        update=update,
        finalize=lambda acc, n_steps: acc[0],
    )


def autocallable(period: int, trigger: float, coupon: float, r_dt: float,
                 pdi_barrier: float, s0: float) -> PathFunctional:
    """Discounted payoff of an autocallable (Phoenix-style) note.

    At every observation t_j = j*period: if the note is still alive and
    ``S >= trigger``, it autocalls, paying notional + j accrued coupons,
    discounted pathwise by ``exp(-r_dt * t_j)``.  If never called, at
    maturity it pays 1 + n coupons when ``S_T >= trigger``; otherwise
    capital is at risk through a European down-and-in put struck at
    ``s0`` (the standard PDI leg): pays ``S_T / s0`` if the running
    minimum ever breached ``pdi_barrier``, else 1.

    The whole product folds into the simulation scan as ONE functional
    (state: alive flag, discounted-payout accumulator, running minimum) —
    fused-kernel eligible, and by linearity of the fold it composes with
    any process (jumps, stochastic/local vol).  ``finalize`` returns the
    discounted payoff per path; price = its plain mean (no further
    discounting).
    """
    if period < 1:
        raise ValueError("period must be >= 1")

    def update(acc, s, t):
        alive, pay, run_min, _ = acc
        run_min = jnp.minimum(run_min, s)
        tf = jnp.asarray(t).astype(s.dtype)
        j = tf / period  # integer-valued at observations
        at_obs = (jnp.asarray(t) % period) == 0
        called = at_obs & (alive > 0.5) & (s >= trigger)
        call_value = (1.0 + coupon * j) * exp32(-r_dt * tf)
        pay = jnp.where(called, call_value, pay)
        alive = jnp.where(called, jnp.zeros_like(alive), alive)
        return (alive, pay, run_min, s)

    def finalize(acc, n_steps):
        n_steps = _static_steps(n_steps, "autocallable")
        if n_steps % period != 0:
            # Without a maturity observation, surviving S_T >= trigger
            # paths would silently forfeit every accrued coupon.
            raise ValueError(
                f"n_steps={n_steps} must be a multiple of the "
                f"observation period {period}")
        alive, pay, run_min, last = acc
        # The maturity observation (t = n_steps) already paid
        # S_T >= trigger paths via `update`; the remaining alive paths
        # settle the capital leg: full notional unless the PDI barrier was
        # ever breached, else short the s0-struck put — min(S_T/s0, 1)
        # (uncapped S_T/s0 would pay MORE than notional when a breached
        # path recovers above s0).
        df_t = exp32(jnp.asarray(-r_dt * n_steps, pay.dtype))
        breached = run_min <= pdi_barrier
        settle = df_t * jnp.where(breached,
                                  jnp.minimum(last / s0, 1.0),
                                  jnp.ones_like(last))
        return jnp.where(alive > 0.5, settle, pay)

    return PathFunctional(
        init=lambda s: (jnp.ones_like(s), jnp.zeros_like(s), s, s),
        update=update,
        finalize=finalize,
    )


def worst_of_autocallable(period: int, trigger: float, coupon: float,
                          r_dt: float, pdi_barrier: float, s0
                          ) -> PathFunctional:
    """Discounted payoff of a WORST-OF autocallable on a multi-asset
    process — the dominant retail equity structured product.

    Identical contract to :func:`autocallable`, but every observation and
    the PDI leg read the worst PERFORMANCE across assets,
    ``W_t = min_a S_{t,a} / s0_a`` (so ``trigger`` and ``pdi_barrier`` are
    in performance units, e.g. 1.0 and 0.7): autocall when the worst
    performer is at/above trigger; if never called, capital at maturity is
    ``min(W_T, 1)`` when the worst performer ever breached the barrier.

    ``s0``: (A,) initial prices.  The accumulator leaves are (n_paths,)
    while the observed state is (n_paths, A) — the functional protocol is
    shape-agnostic, and with A = 1 this reproduces :func:`autocallable`
    exactly (tested).  Multi-asset states run the scan engine.
    """
    if period < 1:
        raise ValueError("period must be >= 1")
    s0v = jnp.asarray(s0)

    def perf(s):
        return jnp.min(s / s0v.astype(s.dtype), axis=-1)

    def init(s):
        w = perf(s)
        return (jnp.ones_like(w), jnp.zeros_like(w), w, w)

    def update(acc, s, t):
        alive, pay, run_min, _ = acc
        w = perf(s)
        run_min = jnp.minimum(run_min, w)
        tf = jnp.asarray(t).astype(w.dtype)
        j = tf / period
        at_obs = (jnp.asarray(t) % period) == 0
        called = at_obs & (alive > 0.5) & (w >= trigger)
        call_value = (1.0 + coupon * j) * exp32(-r_dt * tf)
        pay = jnp.where(called, call_value, pay)
        alive = jnp.where(called, jnp.zeros_like(alive), alive)
        return (alive, pay, run_min, w)

    def finalize(acc, n_steps):
        n_steps = _static_steps(n_steps, "worst_of_autocallable")
        if n_steps % period != 0:
            raise ValueError(
                f"n_steps={n_steps} must be a multiple of the "
                f"observation period {period}")
        alive, pay, run_min, last = acc
        df_t = exp32(jnp.asarray(-r_dt * n_steps, pay.dtype))
        breached = run_min <= pdi_barrier
        settle = df_t * jnp.where(breached, jnp.minimum(last, 1.0),
                                  jnp.ones_like(last))
        return jnp.where(alive > 0.5, settle, pay)

    return PathFunctional(init=init, update=update, finalize=finalize)


def realized_variance() -> PathFunctional:
    """Sum of squared log returns over the step grid — the variance-swap
    payoff leg.  Annualize with 1/T: fair strike = E[sum] / T.  The
    accumulator carries (running sum, previous log price); log-space fold
    (squared log-return increments need nothing but log prices)."""
    return PathFunctional(
        init=lambda lp: (jnp.zeros_like(lp), lp),
        update=lambda acc, lp, t: (
            acc[0] + jnp.square(lp - acc[1]), lp),
        finalize=lambda acc, n_steps: acc[0],
        space="log",
    )


def trapezoid_integral(dt: float) -> PathFunctional:
    """Pathwise trapezoid rule: int_0^T x_t dt over the step grid.

    The discount integral of short-rate models (``exp(-int r dt)`` — see
    :mod:`montecarlo.engine.rates`); O(dt^2) weak error vs the left
    rule's O(dt).  The accumulator carries (running sum, previous value).
    """
    half_dt = 0.5 * float(dt)
    return PathFunctional(
        init=lambda s: (jnp.zeros_like(s), s),
        update=lambda acc, s, t: (acc[0] + (acc[1] + s) * half_dt, s),
        finalize=lambda acc, n_steps: acc[0],
    )


@partial(jax.jit, static_argnames=("n_paths", "n_steps", "dtype",
                                   "functional_items"))
def _simulate_functionals(process, n_paths, n_steps, seed, stream, sampler,
                          dtype, path_offset, functional_items):
    # seed/stream arrive as folded Threefry key words (traced operands) —
    # see engine.simulate.simulate: switching seeds never recompiles.
    names = [k for k, _ in functional_items]
    fns = [f for _, f in functional_items]
    if sampler is None:
        sampler = PlainSampler()
    check_sampler(sampler, process, n_steps)
    ids = path_ids_for(n_paths, path_offset)
    state0 = process.init_state(ids, dtype)
    accs0 = tuple(f.init(o) for f, o in
                  zip(fns, functional_observables(process, state0, fns)))

    def body(carry, t):
        state, accs = carry
        eps = sampler.draws(process, seed, stream, ids, t, dtype)
        state = process.step(state, eps, t)
        obs = functional_observables(process, state, fns)
        accs = tuple(f.update(a, o, t + 1)
                     for f, a, o in zip(fns, accs, obs))
        return (state, accs), None

    (final_state, accs), _ = jax.lax.scan(
        body, (state0, accs0), jnp.arange(n_steps, dtype=jnp.int32))
    out = {"terminal": process.prices(final_state)}
    for name, f, a in zip(names, fns, accs):
        out[name] = f.finalize(a, float(n_steps))
    return out


def simulate_functionals(process, n_paths: int, n_steps: int, *, seed: int,
                         functionals: Dict[str, PathFunctional],
                         stream: int = 0, sampler=None, dtype=jnp.float32,
                         path_offset=0, prefer_fused: bool = True):
    """Terminal prices plus named path functionals, O(paths) memory.

    On the GPU, eligible runs (fusable process, plain/antithetic/device-Sobol
    sampling, f32) fold the functional updates into the fused kernel's
    time loop (`ops.fused_engine.fused_functionals_pallas`) — identical
    results without the per-step state traffic; everything else takes
    the `lax.scan` engine.
    """
    items = tuple(functionals.items())
    if prefer_fused:
        from montecarlo.engine.dispatch import (_fused_eligible,
                                                    _kernel_sampler)
        from montecarlo.samplers import AntitheticSampler

        if _fused_eligible(process, sampler, n_steps, dtype):
            from montecarlo.ops.fused_engine import (
                fused_functionals_pallas)

            return fused_functionals_pallas(
                process, n_paths, n_steps, seed=seed,
                functional_items=items, stream=stream,
                path_offset=path_offset,
                antithetic=isinstance(sampler, AntitheticSampler),
                sampler=_kernel_sampler(sampler))
    from montecarlo.rng.threefry import key_from_seed_dynamic

    k0, k1 = key_from_seed_dynamic(seed, stream)
    return _simulate_functionals(process, n_paths, n_steps, k0, k1,
                                 sampler, dtype, path_offset, items)


# --- payoffs over functionals ------------------------------------------------

def asian_call(avg, strike):
    return jnp.maximum(avg - strike, 0.0)


def up_and_out_call(terminal, running_max, strike, barrier):
    """Knocked out if the (discretely monitored) max breached the barrier."""
    alive = running_max < barrier
    return jnp.where(alive, jnp.maximum(terminal - strike, 0.0), 0.0)


def down_and_out_call(terminal, running_min, strike, barrier):
    alive = running_min > barrier
    return jnp.where(alive, jnp.maximum(terminal - strike, 0.0), 0.0)


def lookback_call_floating(terminal, running_min):
    """Floating-strike lookback call: S_T - min S_t."""
    return terminal - running_min


def variance_swap_strike_mc(process, n_paths: int, n_steps: int, *,
                            T: float, seed: int, dtype=jnp.float32,
                            **sim_kw) -> dict:
    """Fair variance-swap strike (annualized) by simulation.

    K_var = E[sum (log S_{t+1}/S_t)^2] / T — discretely monitored realized
    variance, the standard OTC contract.  Under Heston the continuous limit
    has the closed form E[int v dt]/T = theta + (v0-theta)(1-e^{-kT})/(kT),
    the validation oracle in tests.
    """
    out = simulate_functionals(process, n_paths, n_steps, seed=seed,
                               dtype=dtype,
                               functionals={"rv": realized_variance()},
                               **sim_kw)
    rv = out["rv"] / T
    from montecarlo.engine.pricing import mc_estimate

    est = mc_estimate(rv)
    return {"strike": est["price"], "std_err": est["std_err"],
            "n_paths": est["n_paths"]}


def geometric_asian_call_closed_form(s0, strike, r, sigma, T, n_steps):
    """Closed form for the discretely-monitored geometric Asian call under
    GBM (the geometric mean of lognormals is lognormal).

    Monitoring at the N+1 equally spaced times 0, T/N, ..., T (spot
    included), matching GEO_MEAN over the engine's T+1 observations.
    """
    import numpy as np

    n = n_steps
    dt = T / n
    times = np.arange(0, n + 1) * dt
    m = len(times)
    mu_g = (r - 0.5 * sigma**2) * times.mean()
    # Var of mean of correlated BMs: cov(W_ti, W_tj) = min(ti, tj).
    cov_sum = 0.0
    for i in range(m):
        for j in range(m):
            cov_sum += min(times[i], times[j])
    var_g = sigma**2 * cov_sum / m**2
    sd_g = np.sqrt(var_g)
    from scipy.stats import norm

    d1 = (np.log(s0 / strike) + mu_g + var_g) / sd_g
    d2 = d1 - sd_g
    fwd = s0 * np.exp(mu_g + 0.5 * var_g)
    return np.exp(-r * T) * (fwd * norm.cdf(d1) - strike * norm.cdf(d2))
