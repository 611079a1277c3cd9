"""Multilevel Monte Carlo (Giles 2008) — coupled-level estimation on device.

Single-level MC of a discretized SDE pays O(eps^-2) paths *times* O(eps^-1)
steps to reach RMSE eps (statistical error + discretization bias).  MLMC
telescopes the fine-grid expectation over a geometric ladder of step sizes,

    E[P_L] = E[P_0] + sum_{l=1..L} E[P_l - P_{l-1}],

estimating each difference with *coupled* paths (fine and coarse driven by
the same Brownian increments).  Because the coupling variance V_l decays
like O(dt_l) for Euler schemes, almost all paths run on the cheapest grids
and the total cost drops to O(eps^-2 (log eps)^2) — orders of magnitude at
tight tolerances.

Device mapping: each level is the framework's ordinary path engine (a
`lax.scan` over coarse steps with the M fine sub-steps unrolled inside), so
levels inherit the fused/sharded machinery's layout; the level ladder and
the Giles N_l allocation run on host (a handful of small dispatches).

Coupling requires Gaussian innovations that aggregate across sub-steps
(z_coarse = sum of M fine z's / sqrt(M)) — any `NormalDrawsMixin` process
(Euler GBM, Heston, ...) qualifies; bootstrap-GARCH's resampled shocks do
not telescope and are rejected.

Determinism: level l draws on stream ``stream_base + l`` with path ids
continuing across chunks, so a fixed seed reproduces the entire adaptive
run bitwise (the N_l/L decisions are functions of the sampled values only).

The reference app has no comparable machinery (its MC is a fixed-step
bootstrap, reference app.py:612-633); this module exists for the rebuild's
SDE-pricing surface where discretization bias is real (Euler GBM, Heston).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from montecarlo.engine.simulate import path_ids_for, simulate
from montecarlo.processes.base import NormalDrawsMixin
from montecarlo.stats.welford import (
    MomentState,
    moments_from_array,
    moments_merge,
    variance,
)


def _coupled_values(fine, coarse, payoff_fn, n_paths: int,
                    n_coarse_steps: int, m_refine: int, seed: int,
                    stream: int, dtype, path_offset,
                    payoff_on: str = "terminal"):
    """Per-path (Y, P_fine) under the level coupling.

    The fine path takes ``m_refine`` sub-steps per coarse step using its own
    draw schedule; the coarse step consumes the *sum* of those Gaussian
    innovations rescaled by 1/sqrt(M) — the exact distributional coupling of
    the underlying Brownian increments.

    ``payoff_on="mean"`` feeds the payoff each grid's *own* discretely
    monitored arithmetic average (spot included) instead of the terminal —
    the Asian-option telescoping where each level refines the monitoring
    grid itself.
    """
    ids = path_ids_for(n_paths, path_offset)
    f_state = fine.init_state(ids, dtype)
    c_state = coarse.init_state(ids, dtype)
    inv_sqrt_m = jnp.asarray(1.0 / math.sqrt(m_refine), dtype)
    track_mean = payoff_on == "mean"
    f_acc = fine.prices(f_state) if track_mean else jnp.zeros((), dtype)
    c_acc = coarse.prices(c_state) if track_mean else jnp.zeros((), dtype)

    def body(carry, j):
        fs, cs, fa, ca = carry
        t0 = j * m_refine
        sums = None
        for m in range(m_refine):
            eps = fine.draws(seed, stream, ids, t0 + m, dtype)
            fs = fine.step(fs, eps, t0 + m)
            if track_mean:
                fa = fa + fine.prices(fs)
            sums = eps if sums is None else tuple(
                a + b for a, b in zip(sums, eps))
        eps_c = tuple(s * inv_sqrt_m for s in sums)
        cs = coarse.step(cs, eps_c, j)
        if track_mean:
            ca = ca + coarse.prices(cs)
        return (fs, cs, fa, ca), None

    (f_state, c_state, f_acc, c_acc), _ = jax.lax.scan(
        body, (f_state, c_state, f_acc, c_acc),
        jnp.arange(n_coarse_steps, dtype=jnp.int32))
    if track_mean:
        n_fine = n_coarse_steps * m_refine
        p_fine = payoff_fn(f_acc / (n_fine + 1.0))
        p_coarse = payoff_fn(c_acc / (n_coarse_steps + 1.0))
    else:
        p_fine = payoff_fn(fine.prices(f_state))
        p_coarse = payoff_fn(coarse.prices(c_state))
    return p_fine - p_coarse, p_fine


@partial(jax.jit, static_argnames=("payoff_fn", "n_paths", "n_coarse_steps",
                                   "m_refine", "seed", "stream", "dtype",
                                   "payoff_on"))
def _coupled_moments(fine, coarse, payoff_fn, n_paths: int,
                     n_coarse_steps: int, m_refine: int, seed: int,
                     stream: int, dtype, path_offset,
                     payoff_on: str = "terminal"):
    y, p_fine = _coupled_values(fine, coarse, payoff_fn, n_paths,
                                n_coarse_steps, m_refine, seed, stream,
                                dtype, path_offset, payoff_on)
    return (moments_from_array(y, axis=0),
            moments_from_array(p_fine, axis=0))


@partial(jax.jit, static_argnames=("payoff_fn", "n_paths", "n_steps", "seed",
                                   "stream", "dtype", "payoff_on"))
def _level0_moments(proc, payoff_fn, n_paths: int, n_steps: int, seed: int,
                    stream: int, dtype, path_offset,
                    payoff_on: str = "terminal"):
    if payoff_on == "mean":
        from montecarlo.engine.functionals import (
            ARITH_MEAN, _simulate_functionals)
        out = _simulate_functionals(proc, n_paths, n_steps, seed, stream,
                                    None, dtype, path_offset,
                                    (("avg", ARITH_MEAN),))
        p = payoff_fn(out["avg"])
    else:
        p = payoff_fn(simulate(proc, n_paths, n_steps, seed=seed,
                               stream=stream, dtype=dtype,
                               path_offset=path_offset))
    st = moments_from_array(p, axis=0)
    return st, st


def mlmc_level_moments(make_process: Callable[[int], object], payoff_fn,
                       level: int, n_paths: int, *, seed: int = 0,
                       n0_steps: int = 1, m_refine: int = 2,
                       stream_base: int = 0, dtype=jnp.float32,
                       path_offset: int = 0, payoff_on: str = "terminal",
                       mesh=None):
    """(moments of Y_l, moments of P_l-fine) for one MLMC level.

    ``make_process(n_steps)`` must return the process discretized with
    ``dt = T / n_steps`` — the ladder builds fine/coarse pairs from it.
    ``payoff_on``: "terminal" or "mean" (Asian: each level refines the
    monitoring grid, the coarse average matching the previous level's fine
    convention so the telescope is exact).  With ``mesh`` the level shards
    over the path axis (bitwise mesh-shape-invariant block reduction).
    """
    if payoff_on not in ("terminal", "mean"):
        raise ValueError(f"unknown payoff_on={payoff_on!r}")
    n_fine = n0_steps * m_refine**level
    fine = make_process(n_fine)
    if not isinstance(fine, NormalDrawsMixin):
        raise TypeError(
            "MLMC coupling needs Gaussian innovations (NormalDrawsMixin); "
            f"{type(fine).__name__} draws do not telescope across grids")
    if mesh is not None:
        return _sharded_level_moments(make_process, payoff_fn, level,
                                      n_paths, seed, n0_steps, m_refine,
                                      stream_base, dtype, path_offset,
                                      payoff_on, mesh)
    stream = stream_base + level
    if level == 0:
        return _level0_moments(fine, payoff_fn, n_paths, n_fine, seed,
                               stream, dtype, path_offset, payoff_on)
    coarse = make_process(n_fine // m_refine)
    return _coupled_moments(fine, coarse, payoff_fn, n_paths,
                            n_fine // m_refine, m_refine, seed, stream,
                            dtype, path_offset, payoff_on)


@partial(jax.jit, static_argnames=("make_process", "payoff_fn", "level",
                                   "n_paths", "seed", "n0_steps",
                                   "m_refine", "stream_base", "dtype",
                                   "payoff_on", "mesh", "block_size"))
def _sharded_level_moments(make_process, payoff_fn, level: int,
                           n_paths: int, seed: int, n0_steps: int,
                           m_refine: int, stream_base: int, dtype,
                           path_offset, payoff_on: str, mesh,
                           block_size: int = 4096):
    """One MLMC level over a device mesh.

    Per-shard coupled simulation of a contiguous global-path block, per
    fixed-size-block moment states all_gathered in global order and merged
    by the standard fixed pairwise tree — the same reduction contract as
    `parallel.sharded.sharded_mc_estimate`, so the level estimate is
    bitwise identical across mesh shapes.
    """
    from jax.sharding import PartitionSpec as P

    from montecarlo.parallel.mesh import PATHS_AXIS
    from montecarlo.stats.welford import moments_reduce

    n_shards = mesh.shape[PATHS_AXIS]
    if n_paths % (n_shards * block_size) != 0:
        raise ValueError(
            f"n_paths={n_paths} must be divisible by n_shards*block_size="
            f"{n_shards}*{block_size}")
    local_n = n_paths // n_shards
    n_fine = n0_steps * m_refine**level
    fine = make_process(n_fine)
    coarse = make_process(n_fine // m_refine) if level > 0 else None
    stream = stream_base + level

    def shard_fn(off0):
        offset = off0 + jax.lax.axis_index(PATHS_AXIS) * local_n
        if level == 0:
            if payoff_on == "mean":
                from montecarlo.engine.functionals import (
                    ARITH_MEAN, _simulate_functionals)
                out = _simulate_functionals(fine, local_n, n_fine, seed,
                                            stream, None, dtype, offset,
                                            (("avg", ARITH_MEAN),))
                y = payoff_fn(out["avg"])
            else:
                y = payoff_fn(simulate(fine, local_n, n_fine, seed=seed,
                                       stream=stream, dtype=dtype,
                                       path_offset=offset))
            p_fine = y
        else:
            y, p_fine = _coupled_values(
                fine, coarse, payoff_fn, local_n, n_fine // m_refine,
                m_refine, seed, stream, dtype, offset, payoff_on)
        gather = lambda v: jax.tree.map(
            lambda x: jax.lax.all_gather(x, PATHS_AXIS, axis=0, tiled=True),
            moments_from_array(v.reshape(-1, block_size), axis=-1))
        return gather(y), gather(p_fine)

    off0 = jnp.asarray(path_offset, jnp.int32)
    g_y, g_p = jax.shard_map(shard_fn, mesh=mesh, in_specs=(P(),),
                             out_specs=(P(), P()), check_vma=False)(off0)
    return moments_reduce(g_y), moments_reduce(g_p)


class MLMCLevel(NamedTuple):
    n_paths: int
    mean: float
    var: float
    cost: float  # fine-equivalent path-steps per path


def _fit_alpha(means, m_refine):
    """Weak-error rate: regress log_M |mean_l| on l (levels >= 1)."""
    ls, ys = [], []
    for l, m in enumerate(means):
        if l >= 1 and abs(m) > 0:
            ls.append(float(l))
            ys.append(math.log(abs(m), m_refine))
    if len(ls) < 2:
        return 1.0
    n = len(ls)
    sx, sy = sum(ls), sum(ys)
    sxx = sum(x * x for x in ls)
    sxy = sum(x * y for x, y in zip(ls, ys))
    denom = n * sxx - sx * sx
    if denom <= 0:
        return 1.0
    return max(0.5, -(n * sxy - sx * sy) / denom)


def mlmc_estimate(make_process: Callable[[int], object], payoff_fn, *,
                  target_rmse: float, seed: int = 0, n0_steps: int = 1,
                  m_refine: int = 2, min_levels: int = 3,
                  max_levels: int = 12, n_warmup: int = 4096,
                  chunk_paths: int = 1 << 16, discount=1.0,
                  dtype=jnp.float32, payoff_on: str = "terminal",
                  mesh=None) -> dict:
    """Adaptive MLMC (Giles 2008 algorithm): estimate E[payoff] to RMSE
    ``target_rmse``, splitting the error budget evenly between statistical
    error and discretization bias.

    Sampling is chunked (one compiled program per level regardless of N_l)
    and every chunk extends the level's path-id sequence, so the whole
    adaptive run is deterministic for a fixed seed.

    Returns ``{"price", "std_err", "bias_est", "rmse_est", "n_levels",
    "levels": [MLMCLevel...], "cost_path_steps", "single_level_cost_est"}``.
    """
    eps = float(target_rmse)
    if eps <= 0:
        raise ValueError("target_rmse must be positive")
    var_budget = 0.5 * eps * eps  # half of eps^2 for the variance ...
    bias_budget = eps / math.sqrt(2.0)  # ... the other half for bias^2

    states: list[MomentState] = []
    sampled: list[int] = []

    def level_cost(l):
        nf = n0_steps * m_refine**l
        return float(nf if l == 0 else nf + nf // m_refine)

    def ensure(l, n_target):
        """Sample level l up to >= n_target paths (whole chunks).

        With a mesh the chunk rounds UP to the shard quantum
        n_shards * 4096 (each shard must own whole 4096-path stat blocks) —
        a plain ``max`` would still crash on user chunk sizes that are not
        multiples of the quantum.  Each level's moments stay bitwise
        mesh-shape-invariant at equal path counts; the adaptive ladder's
        *sampled counts* can quantize differently across mesh shapes — pass
        ``chunk_paths`` as a multiple of (max shards)*4096 when strict
        cross-mesh reproducibility of the adaptive trajectory matters.
        """
        chunk = max(chunk_paths >> l, 2048)
        if mesh is not None:
            from montecarlo.parallel.mesh import PATHS_AXIS

            q = mesh.shape[PATHS_AXIS] * 4096
            chunk = ((chunk + q - 1) // q) * q
        while sampled[l] < n_target:
            st_y, _ = mlmc_level_moments(
                make_process, payoff_fn, l, chunk, seed=seed,
                n0_steps=n0_steps, m_refine=m_refine, dtype=dtype,
                path_offset=sampled[l], payoff_on=payoff_on, mesh=mesh)
            states[l] = (st_y if sampled[l] == 0
                         else moments_merge(states[l], st_y))
            sampled[l] += chunk

    def add_level():
        states.append(None)
        sampled.append(0)
        ensure(len(states) - 1, n_warmup)

    for _ in range(min_levels):
        add_level()

    while True:
        means = [float(s.mean) for s in states]
        vars_ = [max(float(variance(s, ddof=1)), 0.0) for s in states]
        costs = [level_cost(l) for l in range(len(states))]

        # Giles optimal allocation for the variance half of the budget.
        lam = sum(math.sqrt(v * c) for v, c in zip(vars_, costs))
        for l, (v, c) in enumerate(zip(vars_, costs)):
            n_opt = int(math.ceil(math.sqrt(v / c) * lam / var_budget)) if v > 0 else n_warmup
            ensure(l, n_opt)

        means = [float(s.mean) for s in states]
        vars_ = [max(float(variance(s, ddof=1)), 0.0) for s in states]
        alpha = _fit_alpha(means, m_refine)
        gain = m_refine**alpha - 1.0
        tail = [abs(means[-1]),
                abs(means[-2]) / m_refine**alpha if len(means) > 1 else 0.0]
        bias = max(tail) / gain

        if bias <= bias_budget or len(states) >= max_levels:
            break
        add_level()

    st_sum = 0.0
    var_sum = 0.0
    for s in states:
        st_sum += float(s.mean)
        var_sum += max(float(variance(s, ddof=1)), 0.0) / float(s.count)
    d = float(discount)
    std_err = math.sqrt(var_sum)
    cost = sum(level_cost(l) * sampled[l] for l in range(len(states)))
    # What single-level MC at the finest grid would pay for the same RMSE:
    # Var[P] / var_budget paths, each costing n_fine steps (no coarse
    # companion — level_cost would overstate single-level MC by 1/m).
    v0 = max(float(variance(states[0], ddof=1)), 1e-30)
    single_cost = (v0 / var_budget) * float(
        n0_steps * m_refine ** (len(states) - 1))
    return {
        "price": d * st_sum,
        "std_err": d * std_err,
        "bias_est": d * bias,
        "rmse_est": d * math.sqrt(var_sum + bias * bias),
        "n_levels": len(states),
        "levels": [
            MLMCLevel(n_paths=sampled[l], mean=float(states[l].mean),
                      var=max(float(variance(states[l], ddof=1)), 0.0),
                      cost=level_cost(l))
            for l in range(len(states))
        ],
        "alpha": alpha,
        "cost_path_steps": cost,
        "single_level_cost_est": single_cost,
    }


__all__ = ["mlmc_estimate", "mlmc_level_moments", "MLMCLevel"]
