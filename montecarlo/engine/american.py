"""American option pricing by Longstaff-Schwartz least-squares Monte Carlo.

Backward induction over simulated paths with a polynomial regression of the
continuation value on in-the-money paths (Longstaff & Schwartz 2001).  The
whole algorithm is one jitted program: the backward pass is a `lax.scan`
over time, each step solving a tiny (degree+1)^2 weighted normal-equation
system — static shapes throughout (ITM selection is a weight mask, not a
gather).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from montecarlo.engine.precision import mm as _mm
from montecarlo.engine.simulate import simulate


def _basis(s, degree: int):
    """Polynomial basis on normalized prices: [1, x, x^2, ...]."""
    cols = [jnp.ones_like(s)]
    for p in range(1, degree + 1):
        cols.append(cols[-1] * s)
    return jnp.stack(cols, axis=-1)  # (..., degree+1)


def _regression_step(s_t, disc, payoff_fn, degree: int, dtype):
    """One backward LSM regression with a per-step standardized basis.

    Raw polynomial bases on tightly clustered prices are near-collinear —
    the f32 Gram matrix goes singular around degree 3 — so the regressor is
    standardized over the ITM paths (weighted mean/std) and the normal
    equations are averaged, not summed.  Returns
    (new_cashflow, beta, mean, std).
    """
    exercise = payoff_fn(s_t)
    itm = exercise > 0
    w = itm.astype(dtype)
    wsum = jnp.maximum(jnp.sum(w), 1.0)
    m = jnp.sum(w * s_t) / wsum
    sd = jnp.sqrt(jnp.sum(w * jnp.square(s_t - m)) / wsum + 1e-12)
    x = _basis((s_t - m) / sd, degree)
    xw = x * w[:, None]
    a = _mm(xw.T, x) / wsum + 1e-6 * jnp.eye(degree + 1, dtype=dtype)
    b = _mm(xw.T, disc) / wsum
    beta = jnp.linalg.solve(a, b)
    continuation = _mm(x, beta)
    take = itm & (exercise >= continuation)
    return jnp.where(take, exercise, disc), beta, m, sd


@partial(jax.jit, static_argnames=("payoff_fn", "n_paths", "n_steps",
                                   "seed", "degree", "dtype"))
def lsm_price(process, payoff_fn, n_paths: int, n_steps: int, *, seed: int,
              rate, dt, degree: int = 2, dtype=jnp.float32):
    """Price an American-exercise payoff via LSM.

    Args:
      payoff_fn: immediate-exercise payoff of the price array.
      rate, dt: per-unit-time discount rate and step size (discount per
        step = exp(-rate*dt)).

    Returns ``{"price", "std_err", "n_paths"}``.  The estimate carries the
    usual small low bias of plain LSM (suboptimal regressed policy).
    """
    result, _ = lsm_policy(process, payoff_fn, n_paths, n_steps, seed=seed,
                           rate=rate, dt=dt, degree=degree, dtype=dtype,
                           fit_value=False)
    return result


@partial(jax.jit, static_argnames=("payoff_fn", "n_paths", "n_steps",
                                   "seed", "degree", "value_degree",
                                   "dtype", "fit_value"))
def lsm_policy(process, payoff_fn, n_paths: int, n_steps: int, *, seed: int,
               rate, dt, degree: int = 2, value_degree: int | None = None,
               dtype=jnp.float32, fit_value: bool = True):
    """LSM price **and** a value-function surrogate of the policy.

    Besides the ITM continuation regression that drives exercise, each
    backward step fits an **all-paths** polynomial (degree ``value_degree``,
    default ``2 * degree + 1``) to the realized value — the surrogate the
    Andersen-Broadie dual bound builds its martingale from (the ITM-only
    continuation fit extrapolates poorly out of the money, which costs
    dual tightness).

    Returns ``(result_dict, policy)`` with ``policy = (vbetas, vmeans,
    vstds)`` for exercise dates t = 1..T-1, basis standardized by
    ``(s - vmeans[t-1]) / vstds[t-1]``.
    """
    vdeg = 2 * degree + 1 if value_degree is None else value_degree
    paths = simulate(process, n_paths, n_steps, seed=seed, mode="paths",
                     dtype=dtype)
    df = jnp.exp(jnp.asarray(-rate * dt, dtype))
    n = jnp.asarray(n_paths, dtype)
    cashflow = payoff_fn(paths[-1])

    def step(cashflow, s_t):
        new_cash, _, _, _ = _regression_step(
            s_t, df * cashflow, payoff_fn, degree, dtype)
        if not fit_value:
            # Price-only mode (lsm_price): skip the all-paths surrogate —
            # it roughly doubles the backward-pass FLOPs and only the
            # Andersen-Broadie dual consumes it.
            z = jnp.zeros((vdeg + 1,), dtype)
            return new_cash, (z, jnp.zeros((), dtype), jnp.ones((), dtype))
        # All-paths value regression (for the dual surrogate).
        ma = jnp.mean(s_t)
        sda = jnp.std(s_t) + 1e-12
        xa = _basis((s_t - ma) / sda, vdeg)
        aa = _mm(xa.T, xa) / n + 1e-6 * jnp.eye(vdeg + 1, dtype=dtype)
        ba = _mm(xa.T, new_cash) / n
        vbeta = jnp.linalg.solve(aa, ba)
        return new_cash, (vbeta, ma, sda)

    inner = paths[1:-1][::-1]
    cashflow, (vb_rev, vm_rev, vs_rev) = jax.lax.scan(step, cashflow, inner)
    value = df * cashflow
    result = {
        "price": jnp.mean(value),
        "std_err": jnp.std(value, ddof=1) / jnp.sqrt(n),
        "n_paths": n_paths,
    }
    return result, (vb_rev[::-1], vm_rev[::-1], vs_rev[::-1])


def _basis2(x, y, degree: int):
    """2-D polynomial basis of total degree <= ``degree``:
    [1, x, y, x^2, xy, y^2, ...] — (degree+1)(degree+2)/2 terms."""
    cols = []
    for i in range(degree + 1):
        xi = jnp.ones_like(x) if i == 0 else x ** i
        for j in range(degree + 1 - i):
            cols.append(xi if j == 0 else xi * y ** j)
    return jnp.stack(cols, axis=-1)


@partial(jax.jit, static_argnames=("payoff_fn", "functional", "n_paths",
                                   "n_steps", "seed", "degree",
                                   "exercise_from", "dtype"))
def lsm_price_path_dependent(process, payoff_fn, functional, n_paths: int,
                             n_steps: int, *, seed: int, rate, dt,
                             degree: int = 2, exercise_from: int = 1,
                             dtype=jnp.float32):
    """American exercise on a PATH-DEPENDENT payoff via LSM on the joint
    (spot, running functional) state.

    ``payoff_fn(s_t, a_t)`` is the immediate-exercise value at step t, with
    ``a_t`` the running value of ``functional`` (a
    :class:`engine.functionals.PathFunctional`, finalized at every step
    with the step count so e.g. ARITH_MEAN yields the to-date average) —
    American-Asian calls/puts, lookback exercises, etc.  The continuation
    regression uses a 2-D polynomial basis of total degree ``degree`` in
    the (per-step ITM-standardized) pair, the Longstaff-Schwartz (2001)
    treatment of their Asian example.  ``exercise_from`` is the first
    exercisable step (``n_steps`` = European: no early exercise at all).

    Returns ``{"price", "std_err", "n_paths"}`` (plain-LSM low bias).
    """
    paths = simulate(process, n_paths, n_steps, seed=seed, mode="paths",
                     dtype=dtype)  # (T+1, N)

    # Running functional value a_t at every step (finalized with t so the
    # to-date normalization is correct, e.g. mean over t+1 observations).
    # Log-space functionals observe log prices (engine.functionals) —
    # here recovered from the materialized price paths.
    from montecarlo.rng.normal import log32

    obs_paths = (log32(paths)
                 if getattr(functional, "space", "price") == "log"
                 else paths)
    acc0 = functional.init(obs_paths[0])

    def acc_step(acc, st):
        s_t, t = st
        acc = functional.update(acc, s_t, t)
        return acc, functional.finalize(acc, t)

    ts = jnp.arange(1, n_steps + 1, dtype=jnp.float32)
    _, a_traj = jax.lax.scan(acc_step, acc0, (obs_paths[1:], ts))
    a_full = jnp.concatenate(
        [functional.finalize(acc0, 0.0)[None], a_traj], axis=0)  # (T+1, N)

    df = jnp.exp(jnp.asarray(-rate * dt, dtype))
    n = jnp.asarray(n_paths, dtype)
    n_terms = (degree + 1) * (degree + 2) // 2
    cashflow = payoff_fn(paths[-1], a_full[-1])

    def step(cashflow, inputs):
        s_t, a_t, t_idx = inputs
        disc = df * cashflow
        exercise = payoff_fn(s_t, a_t)
        itm = exercise > 0
        w = itm.astype(dtype)
        wsum = jnp.maximum(jnp.sum(w), 1.0)
        ms = jnp.sum(w * s_t) / wsum
        ss = jnp.sqrt(jnp.sum(w * jnp.square(s_t - ms)) / wsum + 1e-12)
        ma = jnp.sum(w * a_t) / wsum
        sa = jnp.sqrt(jnp.sum(w * jnp.square(a_t - ma)) / wsum + 1e-12)
        x = _basis2((s_t - ms) / ss, (a_t - ma) / sa, degree)
        xw = x * w[:, None]
        a_mat = _mm(xw.T, x) / wsum + 1e-6 * jnp.eye(n_terms, dtype=dtype)
        b = _mm(xw.T, disc) / wsum
        beta = jnp.linalg.solve(a_mat, b)
        continuation = _mm(x, beta)
        take = itm & (exercise >= continuation) & (t_idx >= exercise_from)
        return jnp.where(take, exercise, disc), None

    t_inner = jnp.arange(1, n_steps, dtype=jnp.int32)[::-1]
    cashflow, _ = jax.lax.scan(
        step, cashflow, (paths[1:-1][::-1], a_full[1:-1][::-1], t_inner))
    value = df * cashflow
    return {
        "price": jnp.mean(value),
        "std_err": jnp.std(value, ddof=1) / jnp.sqrt(n),
        "n_paths": n_paths,
    }


@partial(jax.jit, static_argnames=("payoff_fn", "n_outer", "n_inner",
                                   "n_steps", "seed", "degree",
                                   "value_degree", "dtype"))
def andersen_broadie_bound(process, payoff_fn, policy, n_outer: int,
                           n_inner: int, n_steps: int, *, seed: int,
                           rate, dt, degree: int = 2,
                           value_degree: int | None = None,
                           dtype=jnp.float32):
    """Duality (Andersen-Broadie 2004 / Haugh-Kogan) **upper bound** on the
    American price, from the value surrogate of :func:`lsm_policy`.

    V_0 <= E[ max_t (disc_t h_t - M_t) ] for any martingale M; M is built
    from the surrogate v_t(s) = max(h_t(s), basis(s) vbeta_t):
    dM_t = disc_t v_t(S_t) - E[disc_t v_t(S_t) | state_{t-1}], with the
    one-step conditional expectation estimated by ``n_inner`` fresh
    sub-samples per outer path (a separate RNG stream; process-generic —
    any state pytree).  Pairs with LSM's low-biased estimate to bracket the
    true price; the gap measures surrogate quality (a degree-7 value fit
    brackets the 6m American put to ~0.1 on a 7.4 price).

    Returns ``{"upper", "std_err", "n_paths"}`` (std-err of the dual mean;
    the dual estimator's own bias is positive, i.e. conservatively high).
    """
    from montecarlo.engine.simulate import path_ids_for

    ids = path_ids_for(n_outer, 0)
    best = _ab_best(process, payoff_fn, policy, ids, n_inner, n_steps,
                    seed=seed, rate=rate, dt=dt, degree=degree,
                    value_degree=value_degree, dtype=dtype)
    n = jnp.asarray(n_outer, dtype)
    return {
        "upper": jnp.mean(best),
        "std_err": jnp.std(best, ddof=1) / jnp.sqrt(n),
        "n_paths": n_outer,
    }


def _ab_best(process, payoff_fn, policy, ids, n_inner: int, n_steps: int, *,
             seed, rate, dt, degree: int, value_degree, dtype):
    """Per-path dual pathwise maxima ``max_t (disc_t h_t - M_t)`` for the
    GLOBAL path ids ``ids`` — the shared core of
    :func:`andersen_broadie_bound` and the sharded variant
    (`parallel.sharded.sharded_andersen_broadie_bound`).  Every draw (outer
    and inner) is a pure function of (seed, stream, global id, t), so a
    shard evaluating a subset of ids produces bitwise the values the full
    run would."""
    from montecarlo.samplers import PlainSampler

    vdeg = 2 * degree + 1 if value_degree is None else value_degree
    betas, means, stds = policy
    sampler = PlainSampler()
    n_ids = ids.shape[0]
    state0 = process.init_state(ids, dtype)
    df_t = jnp.exp(jnp.asarray(-rate * dt, dtype))

    # Dedicated streams: the outer paths must NOT reuse stream 0, or a
    # caller passing the same seed as lsm_policy would evaluate the dual on
    # the exact training paths — in-sample surrogate bias silently breaks
    # the upper-bound guarantee.  Inner ids are disjoint per (outer path,
    # inner sample) on a third stream.
    outer_stream = 0xAB50
    inner_ids = (ids[:, None] * jnp.uint32(n_inner)
                 + jnp.arange(n_inner, dtype=jnp.uint32)[None, :])
    inner_stream = 0xAB51

    def surrogate(prices, beta, m, sd, disc, is_last):
        h = payoff_fn(prices)
        fit = _mm(_basis((prices - m) / sd, vdeg), beta)
        v = jnp.where(is_last, h, jnp.maximum(h, fit))
        return disc * v, disc * h

    def body(carry, t):
        state, mart, best, disc = carry
        disc = disc * df_t
        is_last = t == n_steps - 1
        k = jnp.minimum(t, n_steps - 2)
        beta, m, sd = betas[k], means[k], stds[k]

        # Inner one-step expectation from state_{t-1}.
        rep = jax.tree.map(
            lambda x: jnp.broadcast_to(x[:, None],
                                       (n_ids, n_inner) + x.shape[1:]),
            state)
        eps_in = sampler.draws(process, seed, inner_stream, inner_ids, t,
                               dtype)
        stepped_in = process.step(rep, eps_in, t)
        v_in, _ = surrogate(process.prices(stepped_in), beta, m, sd, disc,
                            is_last)
        vbar = jnp.mean(v_in, axis=1)

        # Outer step (the actual path).
        eps = sampler.draws(process, seed, outer_stream, ids, t, dtype)
        state = process.step(state, eps, t)
        v_out, h_out = surrogate(process.prices(state), beta, m, sd, disc,
                                 is_last)

        mart = mart + (v_out - vbar)
        best = jnp.maximum(best, h_out - mart)
        return (state, mart, best, disc), None

    h0 = payoff_fn(process.prices(state0))
    init = (state0, jnp.zeros(n_ids, dtype), h0,
            jnp.asarray(1.0, dtype))
    (_, _, best, _), _ = jax.lax.scan(
        body, init, jnp.arange(n_steps, dtype=jnp.int32))
    return best


@partial(jax.jit, static_argnames=("payoff_fn", "n_paths", "n_steps",
                                   "seed", "degree", "dtype"))
def lsm_exercise_policy(process, payoff_fn, n_paths: int, n_steps: int, *,
                        seed: int, rate, dt, degree: int = 2,
                        dtype=jnp.float32):
    """The CONTINUATION regression parameters (beta, mean, std) for steps
    1..T-1 — the exercise rule itself, as opposed to :func:`lsm_policy`'s
    all-paths value surrogate (which feeds the dual).  Feeds
    :func:`american_price_and_greeks`'s frozen-policy forward pass."""
    paths = simulate(process, n_paths, n_steps, seed=seed, mode="paths",
                     dtype=dtype)
    df = jnp.exp(jnp.asarray(-rate * dt, dtype))
    cashflow = payoff_fn(paths[-1])

    def step(cashflow, s_t):
        new_cash, beta, m, sd = _regression_step(
            s_t, df * cashflow, payoff_fn, degree, dtype)
        return new_cash, (beta, m, sd)

    _, (b_rev, m_rev, s_rev) = jax.lax.scan(step, cashflow,
                                            paths[1:-1][::-1])
    return b_rev[::-1], m_rev[::-1], s_rev[::-1]


@partial(jax.jit, static_argnames=("payoff_fn", "n_paths", "n_steps",
                                   "seed", "stream", "degree", "dtype"))
def american_price_and_greeks(process, payoff_fn, policy, n_paths: int,
                              n_steps: int, *, seed: int, rate, dt,
                              stream: int = 0x4A3E, degree: int = 2,
                              dtype=jnp.float32):
    """American price and pathwise Greeks by POLICY FREEZING.

    With the exercise rule frozen (``policy`` from
    :func:`lsm_exercise_policy`, treated as constants), the stopped value
    E[D^tau h(S_tau)] is pathwise differentiable in the process parameters
    wherever ``h`` is: the stopping indicators are piecewise constant, and
    the first-order effect of the policy's own parameter dependence
    vanishes at the optimum (envelope theorem — the Broadie-Glasserman /
    Piterbarg American-Greeks construction).  The forward pass runs on a
    FRESH stream, so the returned price is an out-of-sample (honest)
    lower-bound estimate alongside the Greeks.

    Returns ``(price, grads)`` with ``grads`` shaped like ``process``
    (``grads.s0`` = delta, ``grads.sigma`` = vega, ...), common random
    numbers by construction.
    """
    from montecarlo.engine.simulate import path_ids_for
    from montecarlo.samplers import PlainSampler

    betas, ms, sds = jax.tree.map(jax.lax.stop_gradient, policy)
    sampler = PlainSampler()
    ids = path_ids_for(n_paths, 0)
    df = jnp.exp(jnp.asarray(-rate * dt, dtype))

    def price_fn(proc):
        state0 = proc.init_state(ids, dtype)

        def body(carry, t):
            state, alive, acc, disc = carry
            eps = sampler.draws(proc, seed, stream, ids, t, dtype)
            state = proc.step(state, eps, t)
            disc = disc * df
            s = proc.prices(state)
            h = payoff_fn(s)
            is_last = t == n_steps - 1
            k = jnp.minimum(t, n_steps - 2)
            cont = _mm(_basis((s - ms[k]) / sds[k], degree), betas[k])
            take = alive & (h > 0) & (is_last | (h >= cont))
            acc = acc + jnp.where(take, disc * h, 0.0)
            alive = alive & ~take
            return (state, alive, acc, disc), None

        init = (state0, jnp.ones((n_paths,), bool),
                jnp.zeros((n_paths,), dtype), jnp.asarray(1.0, dtype))
        (_, _, acc, _), _ = jax.lax.scan(
            jax.checkpoint(body), init,
            jnp.arange(n_steps, dtype=jnp.int32))
        return jnp.mean(acc)

    price, grads = jax.value_and_grad(price_fn, allow_int=True)(process)
    return price, grads


def _default_aux(state):
    """Auxiliary regression state for stochastic-vol LSM: the variance
    leaf every SV process here carries (Heston/Bates/SLV `v`, GARCH
    `var`)."""
    for name in ("v", "var"):
        if hasattr(state, name):
            return getattr(state, name)
    raise ValueError(
        f"{type(state).__name__} has no variance leaf — pass aux_fn")


@partial(jax.jit, static_argnames=("payoff_fn", "aux_fn", "n_paths",
                                   "n_steps", "seed", "degree",
                                   "value_degree", "dtype", "fit_value"))
def lsm_policy_sv(process, payoff_fn, n_paths: int, n_steps: int, *,
                  seed: int, rate, dt, aux_fn=_default_aux,
                  degree: int = 2, value_degree: int | None = None,
                  dtype=jnp.float32, fit_value: bool = True):
    """LSM for STOCHASTIC-VOL processes: the continuation regression runs
    on the joint (spot, auxiliary-state) pair — Heston/Bates/SLV variance,
    the GARCH conditional variance, or anything ``aux_fn(state)`` exposes.

    Regressing on spot alone (plain :func:`lsm_policy`) still yields a
    valid lower bound, but the exercise policy cannot see the vol state —
    under stochastic vol the continuation value at fixed S *depends on v*
    (high variance raises it, deferring exercise), so the 2-D basis prices
    strictly better.  Basis: total-degree-``degree`` polynomial in the
    per-step ITM-standardized pair (`_basis2`, as the path-dependent LSM).

    Returns ``(result, policy)``; ``policy = (vbetas, vmeans(2,), vstds(2,)
    per step)`` feeds :func:`andersen_broadie_bound_sv`.
    """
    from montecarlo.engine.simulate import path_ids_for
    from montecarlo.samplers import PlainSampler

    vdeg = degree + 1 if value_degree is None else value_degree
    sampler = PlainSampler()
    ids = path_ids_for(n_paths, 0)
    state0 = process.init_state(ids, dtype)

    def fwd(state, t):
        eps = sampler.draws(process, seed, jnp.uint32(0), ids, t, dtype)
        state = process.step(state, eps, t)
        return state, (process.prices(state), aux_fn(state))

    _, (s_traj, a_traj) = jax.lax.scan(
        fwd, state0, jnp.arange(n_steps, dtype=jnp.int32))

    df = jnp.exp(jnp.asarray(-rate * dt, dtype))
    n = jnp.asarray(n_paths, dtype)
    n_terms = (degree + 1) * (degree + 2) // 2
    n_vterms = (vdeg + 1) * (vdeg + 2) // 2
    cashflow = payoff_fn(s_traj[-1])

    def step(cashflow, inputs):
        s_t, a_t = inputs
        disc = df * cashflow
        exercise = payoff_fn(s_t)
        itm = exercise > 0
        w = itm.astype(dtype)
        wsum = jnp.maximum(jnp.sum(w), 1.0)
        ms = jnp.sum(w * s_t) / wsum
        ss = jnp.sqrt(jnp.sum(w * jnp.square(s_t - ms)) / wsum + 1e-12)
        ma = jnp.sum(w * a_t) / wsum
        sa = jnp.sqrt(jnp.sum(w * jnp.square(a_t - ma)) / wsum + 1e-12)
        x = _basis2((s_t - ms) / ss, (a_t - ma) / sa, degree)
        xw = x * w[:, None]
        a_mat = _mm(xw.T, x) / wsum + 1e-6 * jnp.eye(n_terms, dtype=dtype)
        beta = jnp.linalg.solve(a_mat, _mm(xw.T, disc) / wsum)
        continuation = _mm(x, beta)
        take = itm & (exercise >= continuation)
        new_cash = jnp.where(take, exercise, disc)
        if not fit_value:
            return new_cash, (jnp.zeros((n_vterms,), dtype),
                              jnp.zeros((2,), dtype),
                              jnp.ones((2,), dtype))
        msa = jnp.mean(s_t)
        ssa = jnp.std(s_t) + 1e-12
        maa = jnp.mean(a_t)
        saa = jnp.std(a_t) + 1e-12
        xa = _basis2((s_t - msa) / ssa, (a_t - maa) / saa, vdeg)
        aa = _mm(xa.T, xa) / n + 1e-6 * jnp.eye(n_vterms, dtype=dtype)
        vbeta = jnp.linalg.solve(aa, _mm(xa.T, new_cash) / n)
        return new_cash, (vbeta, jnp.stack([msa, maa]),
                          jnp.stack([ssa, saa]))

    cashflow, (vb_rev, vm_rev, vs_rev) = jax.lax.scan(
        step, cashflow, (s_traj[:-1][::-1], a_traj[:-1][::-1]))
    value = df * cashflow
    result = {
        "price": jnp.mean(value),
        "std_err": jnp.std(value, ddof=1) / jnp.sqrt(n),
        "n_paths": n_paths,
    }
    return result, (vb_rev[::-1], vm_rev[::-1], vs_rev[::-1])


def lsm_price_sv(process, payoff_fn, n_paths: int, n_steps: int, *,
                 seed: int, rate, dt, aux_fn=_default_aux, degree: int = 2,
                 dtype=jnp.float32):
    """Stochastic-vol American LSM price (see :func:`lsm_policy_sv`)."""
    result, _ = lsm_policy_sv(process, payoff_fn, n_paths, n_steps,
                              seed=seed, rate=rate, dt=dt, aux_fn=aux_fn,
                              degree=degree, dtype=dtype, fit_value=False)
    return result


@partial(jax.jit, static_argnames=("payoff_fn", "aux_fn", "n_outer",
                                   "n_inner", "n_steps", "seed", "degree",
                                   "value_degree", "dtype"))
def andersen_broadie_bound_sv(process, payoff_fn, policy, n_outer: int,
                              n_inner: int, n_steps: int, *, seed: int,
                              rate, dt, aux_fn=_default_aux,
                              degree: int = 2,
                              value_degree: int | None = None,
                              dtype=jnp.float32):
    """Duality upper bound with the (spot, aux) value surrogate of
    :func:`lsm_policy_sv` — same martingale construction and stream
    separation as :func:`andersen_broadie_bound`, the surrogate just sees
    the vol state too (which is what makes it tight under stochastic
    vol)."""
    from montecarlo.engine.simulate import path_ids_for
    from montecarlo.samplers import PlainSampler

    vdeg = degree + 1 if value_degree is None else value_degree
    betas, means, stds = policy
    sampler = PlainSampler()
    ids = path_ids_for(n_outer, 0)
    state0 = process.init_state(ids, dtype)
    df_t = jnp.exp(jnp.asarray(-rate * dt, dtype))

    outer_stream = 0xAB54
    inner_ids = (ids[:, None] * jnp.uint32(n_inner)
                 + jnp.arange(n_inner, dtype=jnp.uint32)[None, :])
    inner_stream = 0xAB55

    def surrogate(state, beta, m, sd, disc, is_last):
        prices = process.prices(state)
        h = payoff_fn(prices)
        xs = (prices - m[0]) / sd[0]
        xa = (aux_fn(state) - m[1]) / sd[1]
        fit = _mm(_basis2(xs, xa, vdeg), beta)
        v = jnp.where(is_last, h, jnp.maximum(h, fit))
        return disc * v, disc * h

    def body(carry, t):
        state, mart, best, disc = carry
        disc = disc * df_t
        is_last = t == n_steps - 1
        k = jnp.minimum(t, n_steps - 2)
        beta, m, sd = betas[k], means[k], stds[k]

        rep = jax.tree.map(
            lambda x: jnp.broadcast_to(x[:, None],
                                       (n_outer, n_inner) + x.shape[1:]),
            state)
        eps_in = sampler.draws(process, seed, inner_stream, inner_ids, t,
                               dtype)
        stepped_in = process.step(rep, eps_in, t)
        v_in, _ = surrogate(stepped_in, beta, m, sd, disc, is_last)
        vbar = jnp.mean(v_in, axis=1)

        eps = sampler.draws(process, seed, outer_stream, ids, t, dtype)
        state = process.step(state, eps, t)
        v_out, h_out = surrogate(state, beta, m, sd, disc, is_last)

        mart = mart + (v_out - vbar)
        best = jnp.maximum(best, h_out - mart)
        return (state, mart, best, disc), None

    h0 = payoff_fn(process.prices(state0))
    init = (state0, jnp.zeros(n_outer, dtype), h0, jnp.asarray(1.0, dtype))
    (_, _, best, _), _ = jax.lax.scan(
        body, init, jnp.arange(n_steps, dtype=jnp.int32))
    n = jnp.asarray(n_outer, dtype)
    return {
        "upper": jnp.mean(best),
        "std_err": jnp.std(best, ddof=1) / jnp.sqrt(n),
        "n_paths": n_outer,
    }


def _multi_indices(n_vars: int, degree: int):
    """All exponent tuples with total degree <= ``degree`` (host-side,
    static), ordered by total degree then lexicographically."""
    from itertools import product as _product

    idxs = [m for m in _product(range(degree + 1), repeat=n_vars)
            if sum(m) <= degree]
    return sorted(idxs, key=lambda m: (sum(m), m))


def _basis_multi(x, degree: int):
    """Multivariate polynomial basis of total degree <= ``degree``.

    ``x`` is (..., A); returns (..., n_terms) with
    n_terms = C(A+degree, A).  Monomials are built by repeated multiplies
    (degree is tiny), so the whole basis is fused elementwise work.
    """
    a = x.shape[-1]
    # Power table per coordinate: pows[c][p] = x[..., c]**p.
    pows = []
    for c in range(a):
        col = [jnp.ones_like(x[..., c])]
        for _ in range(degree):
            col.append(col[-1] * x[..., c])
        pows.append(col)
    cols = []
    for m in _multi_indices(a, degree):
        term = None
        for c, p in enumerate(m):
            if p == 0:
                continue
            term = pows[c][p] if term is None else term * pows[c][p]
        cols.append(jnp.ones_like(x[..., 0]) if term is None else term)
    return jnp.stack(cols, axis=-1)


def _wstats(x, w, wsum):
    """Weighted per-coordinate mean/std of x (N, A) under weights w (N,)."""
    m = jnp.sum(w[:, None] * x, axis=0) / wsum
    sd = jnp.sqrt(jnp.sum(w[:, None] * jnp.square(x - m[None, :]), axis=0)
                  / wsum + 1e-12)
    return m, sd


@partial(jax.jit, static_argnames=("payoff_fn", "n_paths", "n_steps",
                                   "seed", "degree", "value_degree",
                                   "dtype", "fit_value", "sort_assets"))
def lsm_policy_multi(process, payoff_fn, n_paths: int, n_steps: int, *,
                     seed: int, rate, dt, degree: int = 3,
                     value_degree: int | None = None, dtype=jnp.float32,
                     fit_value: bool = True, sort_assets: bool = True):
    """Multi-asset LSM price **and** value surrogate (the Bermudan
    max-call workhorse — Longstaff-Schwartz 2001 §8.1 / Andersen-Broadie
    2004 benchmark family).

    ``payoff_fn(prices)`` maps (N, A) immediate prices to (N,) exercise
    values (e.g. :func:`engine.payoffs.max_call`).  The continuation
    regression uses a total-degree-``degree`` multivariate polynomial in
    the per-step ITM-standardized **sorted** prices: for exchangeable
    payoffs (max/min/basket on symmetric assets) sorting makes the fitted
    function symmetric by construction — one function of the order
    statistics instead of A! orderings, the standard basis for max-calls.
    Set ``sort_assets=False`` for payoffs that are not exchangeable.

    Returns ``(result, policy)`` where ``policy = (vbetas, vmeans, vstds)``
    feeds :func:`andersen_broadie_bound_multi` (all-paths value fit of
    total degree ``value_degree``, default ``degree + 1``).
    """
    vdeg = degree + 1 if value_degree is None else value_degree
    paths = simulate(process, n_paths, n_steps, seed=seed, mode="paths",
                     dtype=dtype)  # (T+1, N, A)
    n_assets = paths.shape[-1]
    n_terms = len(_multi_indices(n_assets, degree))
    n_vterms = len(_multi_indices(n_assets, vdeg))
    df = jnp.exp(jnp.asarray(-rate * dt, dtype))
    n = jnp.asarray(n_paths, dtype)
    cashflow = payoff_fn(paths[-1])

    def feats_of(s_t):
        return jnp.sort(s_t, axis=-1)[..., ::-1] if sort_assets else s_t

    def step(cashflow, s_t):
        disc = df * cashflow
        feats = feats_of(s_t)
        exercise = payoff_fn(s_t)
        itm = exercise > 0
        w = itm.astype(dtype)
        wsum = jnp.maximum(jnp.sum(w), 1.0)
        m, sd = _wstats(feats, w, wsum)
        x = _basis_multi((feats - m[None, :]) / sd[None, :], degree)
        xw = x * w[:, None]
        a_mat = _mm(xw.T, x) / wsum + 1e-6 * jnp.eye(n_terms, dtype=dtype)
        b = _mm(xw.T, disc) / wsum
        beta = jnp.linalg.solve(a_mat, b)
        continuation = _mm(x, beta)
        take = itm & (exercise >= continuation)
        new_cash = jnp.where(take, exercise, disc)
        if not fit_value:
            return new_cash, (jnp.zeros((n_vterms,), dtype),
                              jnp.zeros((n_assets,), dtype),
                              jnp.ones((n_assets,), dtype))
        ones = jnp.ones_like(w)
        ma, sda = _wstats(feats, ones, n)
        xa = _basis_multi((feats - ma[None, :]) / sda[None, :], vdeg)
        aa = _mm(xa.T, xa) / n + 1e-6 * jnp.eye(n_vterms, dtype=dtype)
        ba = _mm(xa.T, new_cash) / n
        vbeta = jnp.linalg.solve(aa, ba)
        return new_cash, (vbeta, ma, sda)

    cashflow, (vb_rev, vm_rev, vs_rev) = jax.lax.scan(
        step, cashflow, paths[1:-1][::-1])
    value = df * cashflow
    result = {
        "price": jnp.mean(value),
        "std_err": jnp.std(value, ddof=1) / jnp.sqrt(n),
        "n_paths": n_paths,
    }
    return result, (vb_rev[::-1], vm_rev[::-1], vs_rev[::-1])


def lsm_price_multi(process, payoff_fn, n_paths: int, n_steps: int, *,
                    seed: int, rate, dt, degree: int = 3,
                    dtype=jnp.float32, sort_assets: bool = True):
    """Multi-asset American/Bermudan LSM price (see
    :func:`lsm_policy_multi`).  Returns ``{"price","std_err","n_paths"}``
    with plain LSM's small low bias."""
    result, _ = lsm_policy_multi(
        process, payoff_fn, n_paths, n_steps, seed=seed, rate=rate, dt=dt,
        degree=degree, dtype=dtype, fit_value=False,
        sort_assets=sort_assets)
    return result


@partial(jax.jit, static_argnames=("payoff_fn", "n_outer", "n_inner",
                                   "n_steps", "seed", "degree",
                                   "value_degree", "dtype", "sort_assets"))
def andersen_broadie_bound_multi(process, payoff_fn, policy, n_outer: int,
                                 n_inner: int, n_steps: int, *, seed: int,
                                 rate, dt, degree: int = 3,
                                 value_degree: int | None = None,
                                 dtype=jnp.float32,
                                 sort_assets: bool = True):
    """Duality upper bound for multi-asset Bermudan payoffs, from
    :func:`lsm_policy_multi`'s value surrogate (the multi-asset analog of
    :func:`andersen_broadie_bound`; same martingale construction and
    disjoint outer/inner streams).  With the LSM lower bound this brackets
    the published Andersen-Broadie (2004) max-call values.
    """
    from montecarlo.engine.simulate import path_ids_for
    from montecarlo.samplers import PlainSampler

    vdeg = degree + 1 if value_degree is None else value_degree
    betas, means, stds = policy
    sampler = PlainSampler()
    ids = path_ids_for(n_outer, 0)
    state0 = process.init_state(ids, dtype)
    df_t = jnp.exp(jnp.asarray(-rate * dt, dtype))

    outer_stream = 0xAB52
    inner_ids = (ids[:, None] * jnp.uint32(n_inner)
                 + jnp.arange(n_inner, dtype=jnp.uint32)[None, :])
    inner_stream = 0xAB53

    def feats_of(s):
        return jnp.sort(s, axis=-1)[..., ::-1] if sort_assets else s

    def surrogate(prices, beta, m, sd, disc, is_last):
        h = payoff_fn(prices)
        z = (feats_of(prices) - m) / sd
        fit = _mm(_basis_multi(z, vdeg), beta)
        v = jnp.where(is_last, h, jnp.maximum(h, fit))
        return disc * v, disc * h

    def body(carry, t):
        state, mart, best, disc = carry
        disc = disc * df_t
        is_last = t == n_steps - 1
        k = jnp.minimum(t, n_steps - 2)
        beta, m, sd = betas[k], means[k], stds[k]

        rep = jax.tree.map(
            lambda x: jnp.broadcast_to(x[:, None],
                                       (n_outer, n_inner) + x.shape[1:]),
            state)
        eps_in = sampler.draws(process, seed, inner_stream, inner_ids, t,
                               dtype)
        stepped_in = process.step(rep, eps_in, t)
        v_in, _ = surrogate(process.prices(stepped_in), beta, m, sd, disc,
                            is_last)
        vbar = jnp.mean(v_in, axis=1)

        eps = sampler.draws(process, seed, outer_stream, ids, t, dtype)
        state = process.step(state, eps, t)
        v_out, h_out = surrogate(process.prices(state), beta, m, sd, disc,
                                 is_last)

        mart = mart + (v_out - vbar)
        best = jnp.maximum(best, h_out - mart)
        return (state, mart, best, disc), None

    h0 = payoff_fn(process.prices(state0))
    init = (state0, jnp.zeros(n_outer, dtype), h0, jnp.asarray(1.0, dtype))
    (_, _, best, _), _ = jax.lax.scan(
        body, init, jnp.arange(n_steps, dtype=jnp.int32))
    n = jnp.asarray(n_outer, dtype)
    return {
        "upper": jnp.mean(best),
        "std_err": jnp.std(best, ddof=1) / jnp.sqrt(n),
        "n_paths": n_outer,
    }


def binomial_american_put(s0, strike, r, sigma, T, n_steps: int = 1000):
    """CRR binomial-tree American put — the validation oracle."""
    import numpy as np

    dt = T / n_steps
    u = np.exp(sigma * np.sqrt(dt))
    d = 1.0 / u
    p = (np.exp(r * dt) - d) / (u - d)
    disc = np.exp(-r * dt)
    j = np.arange(n_steps + 1)
    prices = s0 * u ** (n_steps - j) * d ** j
    values = np.maximum(strike - prices, 0.0)
    for step in range(n_steps - 1, -1, -1):
        prices = prices[:-1] / u  # prices at this layer
        values = disc * (p * values[:-1] + (1 - p) * values[1:])
        values = np.maximum(values, strike - prices)
    return float(values[0])
