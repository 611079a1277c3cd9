"""`shard_map`-sharded simulation with shard-shape-invariant reductions.

Replaces the reference's parallelism (single-host NumPy vectorization over
`n_sims` + a thread pool over tickers, reference app.py:612-633 and
1391-1418) with SPMD over a `jax.sharding.Mesh`:

- Each device simulates a contiguous block of **global** path ids
  (``path_offset = axis_index * local_n``), so the union of all shards is
  bitwise identical to an unsharded run — the counter-based RNG guarantees
  per-path equality, and the reduction scheme below guarantees estimate
  equality.

- Statistics are accumulated per fixed-size *path block* (``block_size``
  consecutive global paths), all-gathered in global block order, and merged
  with a pairwise tree that depends only on the number of blocks.  Since
  neither the per-block reduction shape nor the merge tree depends on the
  mesh, the final estimate is **bitwise identical across mesh shapes** —
  including a 1-device mesh, which is how the tests verify it.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from montecarlo.engine.dispatch import terminal_prices
from montecarlo.engine.precision import HIGHEST, mm
from montecarlo.engine.exposure import (
    PathDependentTrade, SimulationMarkedTrade, _credit_funding_scalars)
from montecarlo.parallel.mesh import PATHS_AXIS, SLICES_AXIS
from montecarlo.stats.welford import (
    MomentState,
    moments_from_array,
    moments_reduce,
    std_error,
    tree_sum,
)
from montecarlo.stats.quantiles import sketch_from_array

#: Paths per statistics block. Fixed (mesh-independent) by design — do not
#: scale it with the device count or reproducibility across mesh shapes dies.
DEFAULT_BLOCK = 4096


def _check_divisible(n_paths: int, n_shards: int, block_size: int):
    if n_paths % (n_shards * block_size) != 0:
        raise ValueError(
            f"n_paths={n_paths} must be divisible by n_shards*block_size="
            f"{n_shards}*{block_size}"
        )


def _slice_layout(mesh, axis: str):
    """(n_slices, n_path_shards, total_shards) for a ([slices,] paths) mesh.

    A mesh with a ``slices`` axis is the multi-slice (DCN) layout: shard s of
    slice k owns global shard index ``k * n_path_shards + s`` — paths are
    laid out slice-major, so intra-slice shards are contiguous in global
    path order and each slice's blocks form one contiguous run (what the
    two-level merge tree below relies on).
    """
    n_slices = mesh.shape.get(SLICES_AXIS, 1)
    n_path_shards = mesh.shape[axis]
    return n_slices, n_path_shards, n_slices * n_path_shards


def _check_two_level_tree(blocks_per_slice: int):
    """The two-level merge (per-slice tree, then tree over slice states) is
    bitwise identical to the flat global tree iff blocks-per-slice is a
    power of two: `moments_reduce` pairs strided neighbors level by level,
    and an odd level count would pair blocks across a slice boundary."""
    if blocks_per_slice & (blocks_per_slice - 1):
        raise ValueError(
            f"multi-slice meshes need a power-of-two number of stat blocks "
            f"per slice for the bitwise-invariant two-level merge; got "
            f"{blocks_per_slice} (adjust n_paths or block_size)")


def _gather_two_level(local_stats, axis: str, has_slices: bool):
    """Gather per-block states for the fixed-tree merge.

    Flat mesh: one `all_gather` of every block state over the paths axis.
    Multi-slice mesh: gather block states intra-slice (ICI), tree-merge each
    slice's blocks locally, and send only the O(n_slices) merged states over
    DCN — bitwise identical to the flat gather + global tree (see
    `_check_two_level_tree`), with DCN traffic independent of block count.
    """
    gathered = jax.tree.map(
        lambda x: jax.lax.all_gather(x, axis, axis=0, tiled=True),
        local_stats,
    )
    if not has_slices:
        return gathered
    slice_state = moments_reduce(gathered)
    return jax.tree.map(
        lambda x: jax.lax.all_gather(x[None], SLICES_AXIS, axis=0,
                                     tiled=True),
        slice_state,
    )


@partial(jax.jit, static_argnames=("n_paths", "n_steps", "seed", "stream",
                                   "dtype", "axis", "mesh"))
def sharded_terminal(process, n_paths: int, n_steps: int, *, seed: int,
                     mesh, stream: int = 0, sampler=None,
                     dtype=jnp.float32, axis: str = PATHS_AXIS,
                     path_offset=0):
    """Terminal prices as a global array sharded over the path axis.

    ``path_offset`` is a traced operand: chunked callers (streaming) reuse
    ONE compiled program across chunks — a per-call closure would retrace
    and recompile for every chunk offset.
    """
    n_slices, n_path_shards, n_shards = _slice_layout(mesh, axis)
    if n_paths % n_shards != 0:
        raise ValueError(f"n_paths={n_paths} not divisible by {n_shards} shards")
    local_n = n_paths // n_shards

    def shard_fn(proc, sampler_, off0):
        shard_idx = jax.lax.axis_index(axis)
        if n_slices > 1:
            shard_idx = (jax.lax.axis_index(SLICES_AXIS) * n_path_shards
                         + shard_idx)
        offset = off0 + shard_idx.astype(jnp.uint32) * jnp.uint32(local_n)
        return terminal_prices(proc, local_n, n_steps, seed=seed,
                               stream=stream, sampler=sampler_, dtype=dtype,
                               path_offset=offset)

    # uint32: the path-id space — an int32 pin overflowed at
    # offset 2^31, half the addressable ids (streamed pod runs).
    off0 = jnp.asarray(path_offset, jnp.uint32)
    spec_in = jax.tree.map(lambda _: P(), (process, sampler, off0))
    out_spec = P((SLICES_AXIS, axis)) if n_slices > 1 else P(axis)
    return jax.shard_map(shard_fn, mesh=mesh, in_specs=spec_in,
                         out_specs=out_spec,
                         check_vma=False)(process, sampler, off0)


def block_moments(values, block_size: int = DEFAULT_BLOCK) -> MomentState:
    """Per-block moment states over consecutive global path blocks."""
    values = jnp.asarray(values)
    blocks = values.reshape(-1, block_size)
    return moments_from_array(blocks, axis=-1)


@partial(jax.jit, static_argnames=("n_paths", "n_steps", "seed", "stream",
                                   "dtype", "block_size", "axis", "mesh",
                                   "payoff_fn"))
def sharded_mc_estimate(process, payoff_fn, n_paths: int, n_steps: int, *,
                        seed: int, mesh, discount=1.0, stream: int = 0,
                        sampler=None, dtype=jnp.float32,
                        block_size: int = DEFAULT_BLOCK,
                        axis: str = PATHS_AXIS, path_offset=0):
    """Sharded MC mean/std-err of ``payoff_fn(terminal_prices)``.

    Returns ``{"price", "std_err", "n_paths"}`` — bitwise identical for any
    mesh shape (given the same backend), replicated on every device.
    ``path_offset`` (traced ok) starts the global path ids — the pod-scale
    chunking hook.
    """
    n_slices, n_path_shards, n_shards = _slice_layout(mesh, axis)
    has_slices = n_slices > 1
    _check_divisible(n_paths, n_shards, block_size)
    local_n = n_paths // n_shards
    if has_slices:
        _check_two_level_tree(n_paths // block_size // n_slices)

    def shard_fn(proc, sampler_, off0):
        shard_idx = jax.lax.axis_index(axis)
        if has_slices:
            shard_idx = (jax.lax.axis_index(SLICES_AXIS) * n_path_shards
                         + shard_idx)
        offset = off0 + shard_idx.astype(jnp.uint32) * jnp.uint32(local_n)
        # Dispatch: fused path kernel on the GPU (same draw streams), scan
        # engine elsewhere — per-shard work is the single-card fast path,
        # collectives only touch the tiny block stats.
        terminal = terminal_prices(proc, local_n, n_steps, seed=seed,
                                   stream=stream, sampler=sampler_,
                                   dtype=dtype, path_offset=offset)
        payoffs = payoff_fn(terminal)
        local_stats = block_moments(payoffs, block_size)
        # Gather per-block stats in global block order (two-level on a
        # multi-slice mesh: ICI carries blocks, DCN carries one state per
        # slice); the merge below is then executed identically (replicated)
        # on every device.
        return _gather_two_level(local_stats, axis, has_slices)

    # uint32: the path-id space — an int32 pin overflowed at
    # offset 2^31, half the addressable ids (streamed pod runs).
    off0 = jnp.asarray(path_offset, jnp.uint32)
    spec_in = jax.tree.map(lambda _: P(), (process, sampler, off0))
    stats = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=spec_in, out_specs=P(),
        check_vma=False,
    )(process, sampler, off0)
    total = moments_reduce(stats)
    d = jnp.asarray(discount, total.mean.dtype)
    return {
        "price": d * total.mean,
        "std_err": d * std_error(total),
        "n_paths": total.count,
    }


@partial(jax.jit, static_argnames=("payoff_fn", "n_paths", "n_steps",
                                   "seed", "stream", "dtype", "block_size",
                                   "mesh"))
def sharded_basket_estimate(basket, payoff_fn, n_paths: int, n_steps: int,
                            *, seed: int, mesh, discount=1.0,
                            stream: int = 0, dtype=jnp.float32,
                            block_size: int = DEFAULT_BLOCK):
    """2-D sharding for large correlated baskets: paths x assets.

    The trick counter-based RNG buys: correlating asset shards needs the
    *full* shock vector z, but every shard can regenerate all of z locally
    from (seed, global path id, t) — **zero communication** inside the time
    loop.  Each device updates only its asset slice (its rows of the
    Cholesky factor: an (A_local, A) x (A, paths) matmul); the
    only collectives are one `psum` of partial basket values over the asset
    axis at the end, and the usual tiny block-stat `all_gather` over paths.

    Takes a `BasketGBM`; requires mesh axes ("paths", "assets") with
    n_assets % asset_shards == 0.  Matches the unsharded engine to float
    round-off; bitwise invariant across *path* shardings at a fixed asset
    sharding.
    """
    from montecarlo.parallel.mesh import ASSETS_AXIS
    from montecarlo.rng.normal import normal_draw

    n_shards_p = mesh.shape[PATHS_AXIS]
    n_shards_a = mesh.shape.get(ASSETS_AXIS, 1)
    a_total = basket.n_assets
    if a_total % n_shards_a or n_paths % (n_shards_p * block_size):
        raise ValueError("shape not divisible by mesh/block")
    a_local = a_total // n_shards_a
    local_n = n_paths // n_shards_p

    def shard_fn(proc):
        p_idx = jax.lax.axis_index(PATHS_AXIS)
        a_idx = (jax.lax.axis_index(ASSETS_AXIS) if n_shards_a > 1
                 else jnp.int32(0))
        offset = p_idx * local_n
        a0 = a_idx * a_local
        ids = (jnp.asarray(offset).astype(jnp.uint32)
               + jnp.arange(local_n, dtype=jnp.uint32))

        s0_l = jax.lax.dynamic_slice(proc.s0, (a0,), (a_local,))
        mu_l = jax.lax.dynamic_slice(proc.mu, (a0,), (a_local,))
        sig_l = jax.lax.dynamic_slice(proc.sigma, (a0,), (a_local,))
        w_l = jax.lax.dynamic_slice(proc.weights, (a0,), (a_local,))
        chol_rows = jax.lax.dynamic_slice(
            proc.chol_flat.reshape(a_total, a_total),
            (a0, jnp.zeros_like(a0)), (a_local, a_total))
        drift = ((mu_l - 0.5 * jnp.square(sig_l)) * proc.dt).astype(dtype)
        scale = (sig_l * jnp.sqrt(proc.dt)).astype(dtype)

        state0 = jnp.broadcast_to(jnp.log(s0_l).astype(dtype)[:, None],
                                  (a_local, local_n))

        def body(state, t):
            # Full shock vector regenerated locally — no collective.
            z = jnp.stack([
                normal_draw(seed, stream, ids,
                            jnp.asarray(t).astype(jnp.uint32)
                            * jnp.uint32(a_total) + jnp.uint32(d), dtype)
                for d in range(a_total)])  # (A, local_n)
            zc = jnp.dot(chol_rows.astype(dtype), z, precision=HIGHEST,
                         preferred_element_type=dtype).astype(dtype)
            # Increment grouped before the add (see GBM.step).
            return state + (drift[:, None] + scale[:, None] * zc), None

        state, _ = jax.lax.scan(body, state0,
                                jnp.arange(n_steps, dtype=jnp.int32))
        partial_value = jnp.sum(w_l.astype(dtype)[:, None]
                                * jnp.exp(state), axis=0)
        basket_vals = (jax.lax.psum(partial_value, ASSETS_AXIS)
                       if n_shards_a > 1 else partial_value)
        payoffs = payoff_fn(basket_vals)
        local_stats = block_moments(payoffs, block_size)
        return jax.tree.map(
            lambda x: jax.lax.all_gather(x, PATHS_AXIS, axis=0, tiled=True),
            local_stats)

    spec_in = jax.tree.map(lambda _: P(), basket)
    stats = jax.shard_map(shard_fn, mesh=mesh, in_specs=(spec_in,),
                          out_specs=P(), check_vma=False)(basket)
    total = moments_reduce(stats)
    d = jnp.asarray(discount, total.mean.dtype)
    return {
        "price": d * total.mean,
        "std_err": d * std_error(total),
        "n_paths": total.count,
    }


@partial(jax.jit, static_argnames=("functional_items", "payoff_of",
                                   "n_paths", "n_steps", "seed", "stream",
                                   "dtype", "block_size", "axis", "mesh"))
def _sharded_functional_estimate(process, functional_items, payoff_of,
                                 n_paths: int, n_steps: int, *, seed: int,
                                 mesh, discount, stream: int, sampler,
                                 dtype, block_size: int, axis: str):
    from montecarlo.engine.functionals import simulate_functionals

    n_slices, n_path_shards, n_shards = _slice_layout(mesh, axis)
    has_slices = n_slices > 1
    _check_divisible(n_paths, n_shards, block_size)
    local_n = n_paths // n_shards
    if has_slices:
        _check_two_level_tree(n_paths // block_size // n_slices)

    def shard_fn(proc, sampler_):
        shard_idx = jax.lax.axis_index(axis)
        if has_slices:
            shard_idx = (jax.lax.axis_index(SLICES_AXIS) * n_path_shards
                         + shard_idx)
        offset = shard_idx.astype(jnp.uint32) * jnp.uint32(local_n)
        out = simulate_functionals(
            proc, local_n, n_steps, seed=seed,
            functionals=dict(functional_items), stream=stream,
            sampler=sampler_, dtype=dtype, path_offset=offset)
        payoffs = payoff_of(out)
        local_stats = block_moments(payoffs, block_size)
        return _gather_two_level(local_stats, axis, has_slices)

    spec_in = jax.tree.map(lambda _: P(), (process, sampler))
    stats = jax.shard_map(shard_fn, mesh=mesh, in_specs=spec_in,
                          out_specs=P(), check_vma=False)(process, sampler)
    total = moments_reduce(stats)
    d = jnp.asarray(discount, total.mean.dtype)
    return {
        "price": d * total.mean,
        "std_err": d * std_error(total),
        "n_paths": total.count,
    }


def sharded_functional_estimate(process, functionals, payoff_of,
                                n_paths: int, n_steps: int, *, seed: int,
                                mesh, discount=1.0, stream: int = 0,
                                sampler=None, dtype=jnp.float32,
                                block_size: int = DEFAULT_BLOCK,
                                axis: str = PATHS_AXIS):
    """Pod-scale PATH-DEPENDENT pricing: `simulate_functionals` per shard
    (running statistics folded into the time loop — the fused functional
    kernel where eligible), block-stat gather + fixed-tree merge as
    `sharded_mc_estimate`.

    ``payoff_of`` maps the shard's functional outputs (a dict with
    "terminal" plus every named functional, each (local_n,)) to per-path
    payoffs — the same closure the unsharded CLI exotics use.  Bitwise
    identical across mesh shapes, multi-slice meshes included; works for
    multi-asset processes (worst-of notes) through the scan fallback.
    """
    return _sharded_functional_estimate(
        process, tuple(functionals.items()), payoff_of, n_paths, n_steps,
        seed=seed, mesh=mesh, discount=discount, stream=stream,
        sampler=sampler, dtype=dtype, block_size=block_size, axis=axis)


@partial(jax.jit, static_argnames=("payoff_fn", "n_paths", "n_steps",
                                   "seed", "stream", "dtype", "block_size",
                                   "axis", "mesh", "remat"))
def sharded_price_and_greeks(process, payoff_fn, n_paths: int, n_steps: int,
                             *, seed: int, mesh, discount=1.0,
                             stream: int = 0, dtype=jnp.float32,
                             block_size: int = DEFAULT_BLOCK,
                             axis: str = PATHS_AXIS, remat: bool = True):
    """POD-SCALE PATHWISE GREEKS: price and its gradient w.r.t. every
    process parameter, sharded over the path axis.

    Risk at pod scale needs sensitivities, not just prices — this is
    `engine.greeks.price_and_greeks` (reverse-mode through the simulator)
    under the same fixed-block reduction contract as `sharded_mc_estimate`.
    The mesh-shape-bitwise-invariance trick: a single backward pass per
    shard would accumulate per-path gradient contributions in a
    shard-local order (invariance dies with the mesh shape), so instead
    each fixed ``block_size`` run of GLOBAL path ids is differentiated as
    its own unit — `lax.map` of a block-wide `value_and_grad` (NOT vmap:
    vmap's batch width is blocks-per-shard, which changes with the mesh,
    and the fused draw->step codegen is only value-stable at a fixed
    compile width — DEVNOTES "Determinism contract") — and the per-block
    gradient means are all-gathered in global block order and merged by
    the same fixed pairwise tree as the payoff moments.  Every block's
    computation is identical whatever mesh it lands on, so price AND
    grads are **bitwise identical across mesh shapes** (multi-slice
    two-level merges included).

    ``remat``: checkpoint the scan body (O(paths) residual memory instead
    of O(paths x steps)) — pod-scale runs keep it on.

    Returns ``{"price", "std_err", "n_paths", "grads", "grad_std_err"}``
    replicated on every device: ``grads`` is a pytree shaped like
    ``process`` (e.g. GBM: ``grads.s0`` is delta, ``grads.sigma`` vega);
    ``grad_std_err`` is its blockwise-CLT standard-error twin (block
    gradient means are iid).  Integer process leaves (e.g. the GARCH
    bootstrap's ``n_table``) get zero gradients (the unsharded engine
    reports float0 there).  Non-smooth payoffs (digitals) need the
    smoothed variants (`engine.greeks.smoothed_digital`) exactly as in the
    unsharded engine.
    """
    from montecarlo.engine.simulate import simulate

    n_slices, n_path_shards, n_shards = _slice_layout(mesh, axis)
    has_slices = n_slices > 1
    _check_divisible(n_paths, n_shards, block_size)
    local_n = n_paths // n_shards
    n_local_blocks = local_n // block_size
    if has_slices:
        _check_two_level_tree(n_paths // block_size // n_slices)
    d = jnp.asarray(discount, dtype)
    is_state = lambda x: isinstance(x, MomentState)

    def _grad_or_zero(g, prim):
        # allow_int returns float0 for integer leaves; zeros keep the
        # gather/merge arithmetic uniform.
        if g.dtype == jax.dtypes.float0:
            return jnp.zeros(jnp.shape(prim), dtype)
        return g

    def shard_fn(proc):
        shard_idx = jax.lax.axis_index(axis)
        if has_slices:
            shard_idx = (jax.lax.axis_index(SLICES_AXIS) * n_path_shards
                         + shard_idx)
        offset = shard_idx.astype(jnp.uint32) * jnp.uint32(local_n)

        def block_stats(off_b):
            def mean_payoff(p):
                terminal = simulate(p, block_size, n_steps, seed=seed,
                                    stream=stream, dtype=dtype,
                                    path_offset=off_b, remat=remat)
                pay = payoff_fn(terminal)
                m = jnp.mean(pay)
                return m, jnp.sum(jnp.square(pay - m))

            (m, m2), g = jax.value_and_grad(
                mean_payoff, has_aux=True, allow_int=True)(proc)
            return m, m2, jax.tree.map(_grad_or_zero, g, proc)

        offsets = (offset
                   + jnp.arange(n_local_blocks, dtype=jnp.uint32)
                   * jnp.uint32(block_size))
        # lax.map, NOT vmap: the fused draw->step codegen is only
        # value-stable at a FIXED compile width (DEVNOTES "Determinism
        # contract"), and vmap's batch width (blocks per shard) changes
        # with the mesh — map runs the identical block-wide program
        # whatever mesh the block lands on.
        means, m2s, g_blocks = jax.lax.map(block_stats, offsets)
        pay_state = MomentState(
            count=jnp.full((n_local_blocks,), jnp.asarray(block_size, dtype)),
            mean=means, m2=m2s)
        # One MomentState per gradient leaf: count 1 per block (equal-weight
        # fixed-tree average of block gradient means), m2 accumulates the
        # between-block spread for the CLT error bar.
        grad_states = jax.tree.map(
            lambda gb: MomentState(
                count=jnp.ones((n_local_blocks,) + (1,) * (gb.ndim - 1),
                               dtype),
                mean=gb, m2=jnp.zeros_like(gb)),
            g_blocks)
        return jax.tree.map(
            lambda st: _gather_two_level(st, axis, has_slices),
            {"pay": pay_state, "grads": grad_states}, is_leaf=is_state)

    spec_in = jax.tree.map(lambda _: P(), process)
    stats = jax.shard_map(shard_fn, mesh=mesh, in_specs=(spec_in,),
                          out_specs=P(), check_vma=False)(process)
    totals = jax.tree.map(moments_reduce, stats, is_leaf=is_state)
    pay = totals["pay"]
    return {
        "price": d * pay.mean,
        "std_err": d * std_error(pay),
        "n_paths": pay.count,
        "grads": jax.tree.map(lambda st: d * st.mean, totals["grads"],
                              is_leaf=is_state),
        "grad_std_err": jax.tree.map(lambda st: d * std_error(st),
                                     totals["grads"], is_leaf=is_state),
    }


@partial(jax.jit, static_argnames=("payoff_fn", "n_paths", "n_steps",
                                   "seed", "degree", "dtype", "block_size",
                                   "axis", "mesh"))
def sharded_lsm_price(process, payoff_fn, n_paths: int, n_steps: int, *,
                      seed: int, rate, dt, mesh, degree: int = 3,
                      dtype=jnp.float32, block_size: int = DEFAULT_BLOCK,
                      axis: str = PATHS_AXIS):
    """POD-SCALE AMERICAN PRICING: Longstaff-Schwartz LSM sharded over the
    path axis.

    Each shard simulates and keeps only its own (T+1, local_n) paths; the
    backward induction runs in lockstep, and the ONLY cross-shard traffic
    per exercise date is the tiny sufficient statistics of the continuation
    regression — per-block partial sums of (w, w s, w s^2) for the ITM
    standardization and the (k x k) weighted Gram / moment vector of the
    polynomial basis.  Blocks are ``block_size`` consecutive GLOBAL paths
    and the gathered (n_blocks, ...) arrays are reduced in a fixed order,
    so — like `sharded_mc_estimate` — the price is **bitwise identical
    across mesh shapes** (1 device included, which is how the tests pin
    it).  The normal-equation solve runs replicated on every shard from
    identical inputs.

    Differences vs the single-chip `engine.american.lsm_price` (same
    policy family, NOT bitwise-equal to it): the ITM std uses the one-pass
    E[s^2] - m^2 form (block sums compose across shards) and sums are
    block-ordered; the two agree to regression-conditioning noise and the
    tests assert statistical equality.

    **Collective schedule** (the pod-scale cost): the round-3 version
    fired THREE synchronous collectives per exercise date (ITM sums to
    learn the standardization, then the Gram, then the rhs).  Here the
    Gram and rhs ship in ONE fused gather — two collectives per date, the
    minimum for per-date ITM standardization (the sums must be global
    before the basis exists; every one-gather variant measured WORSE at
    mesh=1: pipelining the next date's sums through the scan carry
    streams two path rows per iteration instead of one (+40% marginal),
    and batching all dates' sums up front costs an extra sweep over the
    whole (T, n) array (+30%)).  The per-block Gram/rhs are batched
    matmuls — the explicit (n, k, k) outer-product intermediate of
    round 3 cost ~55% marginal in HBM traffic alone.

    Returns ``{"price", "std_err", "n_paths"}`` replicated everywhere.
    """
    from montecarlo.engine.american import _basis
    from montecarlo.engine.simulate import simulate

    n_slices, n_path_shards, n_shards = _slice_layout(mesh, axis)
    _check_divisible(n_paths, n_shards, block_size)
    local_n = n_paths // n_shards
    if n_slices > 1:
        _check_two_level_tree(n_paths // block_size // n_slices)
    gather_axes = (SLICES_AXIS, axis) if n_slices > 1 else axis
    k_terms = degree + 1
    df = jnp.exp(jnp.asarray(-rate * dt, dtype))

    def blocks(x):
        return x.reshape(-1, block_size)

    def gather_blocks(x, block_axis: int = 0):
        """All-gather per-block partials along their block axis into global
        block order (slice-major on multi-slice meshes)."""
        return jax.lax.all_gather(x, gather_axes, axis=block_axis,
                                  tiled=True)

    def shard_fn(proc):
        shard_idx = jax.lax.axis_index(axis)
        if n_slices > 1:
            shard_idx = (jax.lax.axis_index(SLICES_AXIS) * n_path_shards
                         + shard_idx)
        offset = shard_idx.astype(jnp.uint32) * jnp.uint32(local_n)
        paths = simulate(proc, local_n, n_steps, seed=seed, mode="paths",
                         dtype=dtype, path_offset=offset)  # (T+1, local_n)
        cashflow = payoff_fn(paths[-1])
        s_inner = paths[1:-1]                    # (T-1, local_n)

        def step(cashflow, s_t):
            disc = df * cashflow
            exercise = payoff_fn(s_t)
            itm = exercise > 0
            w = itm.astype(dtype)
            # Gather #1: ITM standardization sums (must be global before
            # the basis exists).  Per-block partials come from fixed
            # single-block lax.map bodies (see _amc_sums3_blocks): a
            # batched reduction over the resident blocks compiles
            # differently per block count, which flips ULPs between mesh
            # shapes on the GPU.
            sums = jnp.sum(gather_blocks(
                _amc_sums3_blocks(blocks(w), blocks(s_t))), axis=0)
            wsum = jnp.maximum(sums[0], 1.0)
            m = sums[1] / wsum
            sd = jnp.sqrt(jnp.maximum(sums[2] / wsum - m * m, 0.0) + 1e-12)

            def gram_rhs(t):
                sb, wb, db = t
                xb = _basis((sb - m) / sd, degree)
                xw = xb * wb[:, None]
                gram = jnp.einsum("ni,nj->ij", xw, xb, precision=HIGHEST,
                                  preferred_element_type=dtype)
                rhs = jnp.einsum("ni,n->i", xw, db, precision=HIGHEST,
                                 preferred_element_type=dtype)
                return jnp.concatenate([gram.reshape(-1), rhs])

            # Gather #2: [Gram | rhs] in one fused collective.
            fused = jnp.sum(gather_blocks(jax.lax.map(
                gram_rhs, (blocks(s_t), blocks(w), blocks(disc)))),
                axis=0) / wsum
            a_mat = (fused[:k_terms ** 2].reshape(k_terms, k_terms)
                     + 1e-6 * jnp.eye(k_terms, dtype=dtype))
            beta = jnp.linalg.solve(
                a_mat, fused[k_terms ** 2:])  # replicated, identical
            # Per-path dot with the k coefficients, unrolled: elementwise
            # work whose rounding does not depend on the path count.
            x = _basis((s_t - m) / sd, degree)
            continuation = sum(x[:, i] * beta[i] for i in range(k_terms))
            take = itm & (exercise >= continuation)
            return jnp.where(take, exercise, disc), None

        cashflow, _ = jax.lax.scan(step, cashflow, s_inner[::-1])
        value = df * cashflow
        local_stats = block_moments(value, block_size)
        return _gather_two_level(local_stats, axis, n_slices > 1)

    spec_in = jax.tree.map(lambda _: P(), process)
    stats = jax.shard_map(shard_fn, mesh=mesh, in_specs=(spec_in,),
                          out_specs=P(), check_vma=False)(process)
    total = moments_reduce(stats)
    return {
        "price": total.mean,
        "std_err": std_error(total),
        "n_paths": total.count,
    }


@partial(jax.jit, static_argnames=("payoff_fn", "n_outer", "n_inner",
                                   "n_steps", "seed", "degree",
                                   "value_degree", "dtype", "block_size",
                                   "axis", "mesh"))
def sharded_andersen_broadie_bound(process, payoff_fn, policy, n_outer: int,
                                   n_inner: int, n_steps: int, *, seed: int,
                                   rate, dt, mesh, degree: int = 2,
                                   value_degree: int | None = None,
                                   dtype=jnp.float32,
                                   block_size: int = DEFAULT_BLOCK,
                                   axis: str = PATHS_AXIS):
    """POD-SCALE AMERICAN UPPER BOUND: the Andersen-Broadie dual sharded
    over the OUTER path axis — with `sharded_lsm_price` below, the
    distributed American price is bracketed from both sides.

    The dual is embarrassingly parallel: each outer path's martingale
    increments need only its own ``n_inner`` one-step sub-samples, whose
    ids derive from the GLOBAL outer id (`engine.american._ab_best`) — so
    a shard owning outer ids [o, o+local_n) computes bitwise the same
    per-path maxima the unsharded run would, and the ONLY collective is
    the final block-stat gather + fixed-tree merge.  Upper bound and its
    std-err are **bitwise identical across mesh shapes** (multi-slice
    included); ``policy`` is the replicated `lsm_policy` surrogate.

    Returns ``{"upper", "std_err", "n_paths"}`` replicated everywhere.
    """
    from montecarlo.engine.american import _ab_best
    from montecarlo.engine.simulate import path_ids_for

    n_slices, n_path_shards, n_shards = _slice_layout(mesh, axis)
    has_slices = n_slices > 1
    _check_divisible(n_outer, n_shards, block_size)
    local_n = n_outer // n_shards
    if has_slices:
        _check_two_level_tree(n_outer // block_size // n_slices)

    def shard_fn(proc, pol):
        shard_idx = jax.lax.axis_index(axis)
        if has_slices:
            shard_idx = (jax.lax.axis_index(SLICES_AXIS) * n_path_shards
                         + shard_idx)
        ids = path_ids_for(local_n,
                           shard_idx.astype(jnp.uint32)
                           * jnp.uint32(local_n))
        best = _ab_best(proc, payoff_fn, pol, ids, n_inner, n_steps,
                        seed=seed, rate=rate, dt=dt, degree=degree,
                        value_degree=value_degree, dtype=dtype)
        local_stats = block_moments(best, block_size)
        return _gather_two_level(local_stats, axis, has_slices)

    spec_in = jax.tree.map(lambda _: P(), (process, policy))
    stats = jax.shard_map(shard_fn, mesh=mesh, in_specs=spec_in,
                          out_specs=P(), check_vma=False)(process, policy)
    total = moments_reduce(stats)
    return {
        "upper": total.mean,
        "std_err": std_error(total),
        "n_paths": total.count,
    }


@partial(jax.jit, static_argnames=("n_paths", "n_steps", "seed", "stream",
                                   "dtype", "block_size", "axis", "mesh",
                                   "bins", "lo", "hi"))
def sharded_terminal_sketch(process, n_paths: int, n_steps: int, *,
                            seed: int, mesh, lo: float, hi: float,
                            bins: int = 4096, stream: int = 0, sampler=None,
                            dtype=jnp.float32,
                            block_size: int = DEFAULT_BLOCK,
                            axis: str = PATHS_AXIS):
    """Pod-scale quantile path: a mergeable histogram sketch of terminal
    prices plus exact moments — O(bins) memory per device regardless of path
    count (BASELINE.json config 5).

    Counts are int32 (exact adds to 2^31 per bin), so `psum`-merging is
    exact and mesh-shape invariant; f32 lanes would silently lose counts
    past 2^24 per bin at pod-scale path counts.
    """
    n_slices, n_path_shards, n_shards = _slice_layout(mesh, axis)
    has_slices = n_slices > 1
    _check_divisible(n_paths, n_shards, block_size)
    local_n = n_paths // n_shards
    if has_slices:
        _check_two_level_tree(n_paths // block_size // n_slices)
    # Hierarchical reduction axes: psum intra-slice first (ICI), then
    # across slices (DCN) — integer adds are exact and order-free, so this
    # equals the flat psum bitwise while DCN carries one O(bins) vector per
    # slice instead of per shard.
    sum_axes = (axis, SLICES_AXIS) if has_slices else axis

    def shard_fn(proc, sampler_):
        shard_idx = jax.lax.axis_index(axis)
        if has_slices:
            shard_idx = (jax.lax.axis_index(SLICES_AXIS) * n_path_shards
                         + shard_idx)
        offset = shard_idx.astype(jnp.uint32) * jnp.uint32(local_n)
        terminal = terminal_prices(proc, local_n, n_steps, seed=seed,
                                   stream=stream, sampler=sampler_,
                                   dtype=dtype, path_offset=offset)
        sketch = sketch_from_array(terminal, lo, hi, bins, dtype)
        moments = block_moments(terminal, block_size)
        # Sketch counts: exact integer adds -> psum is safe and exact.
        # Scalar totals: a float psum rounds (order-dependently) past 2^24
        # samples, which would break bitwise mesh-shape invariance — the
        # global total is just the static n_paths.  Under/overflow are
        # RECOUNTED here as int32 (sketch_add's masks verbatim): the
        # sketch's own float scalars are already rounded past 2^24 per
        # shard, and a rounded-then-int32 psum would be mesh-dependent.
        f = sketch.total.dtype
        width_s = (sketch.hi - sketch.lo) / bins
        idx_s = jnp.floor((jnp.asarray(terminal, sketch.lo.dtype)
                           - sketch.lo) / width_s).astype(jnp.int32)
        merged_sketch = type(sketch)(
            lo=sketch.lo,
            hi=sketch.hi,
            counts=jax.lax.psum(sketch.counts, sum_axes),
            total=jnp.asarray(n_paths, f),
            underflow=jax.lax.psum(
                jnp.sum(idx_s < 0, dtype=jnp.int32), sum_axes).astype(f),
            overflow=jax.lax.psum(
                jnp.sum(idx_s >= bins, dtype=jnp.int32),
                sum_axes).astype(f),
            vmin=jax.lax.pmin(sketch.vmin, sum_axes),
            vmax=jax.lax.pmax(sketch.vmax, sum_axes),
        )
        gathered_moments = _gather_two_level(moments, axis, has_slices)
        return merged_sketch, gathered_moments

    spec_in = jax.tree.map(lambda _: P(), (process, sampler))
    sketch, moments = jax.shard_map(
        shard_fn, mesh=mesh, in_specs=spec_in, out_specs=(P(), P()),
        check_vma=False,
    )(process, sampler)
    return sketch, moments_reduce(moments)


# ---------------------------------------------------------------------------
# Pod-scale netting-set xVA
# ---------------------------------------------------------------------------

def _sim_disc_block(model, off, *, n_steps, dt, seed, flat_rate, dtype,
                    block_size, sampler=None):
    """Simulate ONE fixed-width block of global path ids + its pathwise
    discount rows — the simulation unit every netting engine (sharded /
    streaming / the AMC and WWR pre/post passes) shares, so block b's
    paths are identical wherever they are produced.  ``sampler`` (e.g. a
    Sobol table indexed by GLOBAL path id) rides through unchanged, so
    QMC draws are as mesh-invariant as the counter-based PRNG's.

    Multi-state underlyings (`engine.exposure.is_multistate`) return
    paths (T+1, C, bs) — the full exposure observation — with discount
    rows by the model's declared kind (exact integral / trapezoid short
    rate / flat), mirroring the unsharded `_simulate_and_discount`."""
    from montecarlo.engine.exposure import (_observe_exposure,
                                                is_multistate)
    from montecarlo.engine.simulate import simulate

    times = jnp.arange(n_steps + 1, dtype=dtype) * dt
    if is_multistate(model):
        paths = simulate(model, block_size, n_steps, seed=seed,
                         mode="paths", dtype=dtype, sampler=sampler,
                         path_offset=off,
                         observe=_observe_exposure)        # (T+1, bs, C)
        paths = jnp.moveaxis(paths, -1, 1)                 # (T+1, C, bs)
        kind = model.exposure_discount_kind
        if kind == "exact":
            disc = model.pathwise_discount(paths)
        elif kind == "rate":
            r = model.pathwise_rate(paths)
            mid = 0.5 * (r[:-1] + r[1:]) * dt
            disc = jnp.exp(-jnp.concatenate(
                [jnp.zeros((1, block_size), dtype),
                 jnp.cumsum(mid, axis=0)], axis=0))
        else:
            if flat_rate is None:
                raise ValueError(
                    f"{type(model).__name__} declares flat discounting — "
                    "pass flat_rate")
            disc = jnp.exp(-jnp.asarray(flat_rate, dtype)
                           * times)[:, None] * jnp.ones((1, block_size),
                                                        dtype)
        return paths, disc
    paths = simulate(model, block_size, n_steps, seed=seed,
                     mode="paths", dtype=dtype, sampler=sampler,
                     path_offset=off)                      # (T+1, bs)
    if flat_rate is None:
        mid = 0.5 * (paths[:-1] + paths[1:]) * dt
        disc = jnp.exp(-jnp.concatenate(
            [jnp.zeros((1, block_size), dtype),
             jnp.cumsum(mid, axis=0)], axis=0))
    else:
        disc = jnp.exp(-jnp.asarray(flat_rate, dtype)
                       * times)[:, None] * jnp.ones((1, block_size),
                                                    dtype)
    return paths, disc


def _amc_poly_rows(paths, amc_op, spec, times, dt, n_steps, dtype):
    """Mark an AMC (regression-marked) trade on ONE block given the
    GLOBALLY-fitted regression surfaces: per-date standardization
    ``(m, sd)`` and coefficients ``beta`` from `_amc_fit_sharded`, plus
    this block's per-path exercise step ``tau``.  Block-local and
    elementwise — the identical math `engine.amc`'s per-date marks run,
    with the local polyfit replaced by the global one.

    Returns ``(values, dvalues)`` of shape (T+1, bs)."""
    m, sd, beta, tau, ok = (amc_op["m"], amc_op["sd"], amc_op["beta"],
                            amc_op["tau"], amc_op["ok"])
    degree = spec.degree
    resets = jnp.asarray(spec.resets, dtype)
    k_resets = jnp.asarray(
        [min(max(int(round(float(e) / float(dt))), 0), n_steps)
         for e in spec.resets], jnp.int32)
    sign = jnp.asarray(spec.sign, dtype)
    notional = jnp.asarray(spec.notional, dtype)
    ones = jnp.ones(paths.shape[1:], dtype)

    def row(k):
        r = paths[k]
        t = times[k]
        z = (r - m[k]) / sd[k]
        val = jnp.zeros_like(r)
        slope = jnp.zeros_like(r)
        zp = jnp.ones_like(r)
        for i in range(degree + 1):
            val = val + beta[k, i] * zp
            if i + 1 <= degree:
                slope = slope + beta[k, i + 1] * (i + 1) * zp
            zp = zp * z
        v_alive = jnp.maximum(val, 0.0)
        dv_alive = jnp.where(ok[k] & (val > 0), slope / sd[k], 0.0)
        # Exercised tail: exact remaining swap with the in-period fixing
        # (same machinery as engine.amc's row / swaption_value_fn's tail).
        le = resets <= t + 1e-9
        idx = jnp.argmax(jnp.where(le, resets, -jnp.inf))
        t_fix = resets[idx]
        r_fix = paths[k_resets[idx]]
        v_sw, dv_sw = jax.jvp(
            lambda rr: sign * spec.swap(rr, t, r_fix, t_fix), (r,), (ones,))
        alive = tau > k
        return (notional * jnp.where(alive, v_alive, v_sw),
                notional * jnp.where(alive, dv_alive, dv_sw))

    return jax.lax.map(row, jnp.arange(n_steps + 1))


def _amc_z_rows_ms(paths, spec, *, dt, n_steps, dtype):
    """Signed-intrinsic regressor rows for a MULTI-STATE AMC trade:
    ``z[b, k] = sign * swap(paths[b, k], t_k)`` over this shard's blocks
    — the (n_blk, T+1, bs) array `_amc_fit_sharded` regresses on in its
    ``z_all`` form.  Block-local and elementwise per path, so it is
    bitwise mesh-invariant by the same argument as every mark."""
    sign = jnp.asarray(spec.sign, dtype)
    times = jnp.arange(n_steps + 1, dtype=dtype) * dt

    def per_block(pb):                                   # (T+1, C, bs)
        return jax.lax.map(lambda k: sign * spec.swap(pb[k], times[k]),
                           jnp.arange(n_steps + 1))

    return jax.lax.map(per_block, paths)                 # (n_blk, T+1, bs)


def _amc_poly_rows_ms(paths, amc_op, spec, times, dt, n_steps, dtype):
    """Multi-state `_amc_poly_rows`: mark a `AMCSwaptionSpecMS` trade on
    ONE (T+1, C, bs) block given the globally-fitted surfaces.  The
    regressor is the signed intrinsic (recomputed block-locally — same
    numbers as `_amc_z_rows_ms` fed the fit); ``dvalues`` carry the
    frozen-beta chain rule per component, ``poly'(z) * dz/dc_j``, with
    dz by `jax.linearize` batched over the C unit tangents — exactly
    `engine.amc._ms_amc_trade`'s row with the local polyfit replaced by
    the global one.  Returns (values (T+1, bs), dvalues (T+1, C, bs))."""
    m, sd, beta, tau, ok = (amc_op["m"], amc_op["sd"], amc_op["beta"],
                            amc_op["tau"], amc_op["ok"])
    degree = spec.degree
    sign = jnp.asarray(spec.sign, dtype)
    notional = jnp.asarray(spec.notional, dtype)
    n_comp = paths.shape[1]
    tang = (jnp.eye(n_comp, dtype=dtype)[:, :, None]
            * jnp.ones((1, 1, paths.shape[-1]), dtype))
    if spec.resets:
        res_arr = jnp.asarray(spec.resets, dtype)
        k_res = jnp.asarray(
            [min(max(int(round(float(e) / float(dt))), 0), n_steps)
             for e in spec.resets], jnp.int32)

    def row(k):
        c = paths[k]
        t = times[k]
        reg = lambda cc: sign * spec.swap(cc, t)            # noqa: E731
        z_k, lin = jax.linearize(reg, c)
        z = (z_k - m[k]) / sd[k]
        val = jnp.zeros_like(z)
        slope = jnp.zeros_like(z)
        zp = jnp.ones_like(z)
        for i in range(degree + 1):
            val = val + beta[k, i] * zp
            if i + 1 <= degree:
                slope = slope + beta[k, i + 1] * (i + 1) * zp
            zp = zp * z
        dz = jax.vmap(lin)(tang)                            # (C, bs)
        v_alive = jnp.maximum(val, 0.0)
        dv_alive = (jnp.where(ok[k] & (val > 0), slope / sd[k], 0.0)[None]
                    * dz)
        if spec.resets:
            le = res_arr <= t + 1e-9
            idx = jnp.argmax(jnp.where(le, res_arr, -jnp.inf))
            t_fix = res_arr[idx]
            c_fix = paths[k_res[idx]]
            tail = lambda cc: sign * spec.swap(cc, t,       # noqa: E731
                                               c_fix, t_fix)
        else:
            tail = reg
        v_sw, lin_sw = jax.linearize(tail, c)
        dv_sw = jax.vmap(lin_sw)(tang)                      # (C, bs)
        alive = tau > k
        return (notional * jnp.where(alive, v_alive, v_sw),
                notional * jnp.where(alive[None], dv_alive, dv_sw))

    return jax.lax.map(row, jnp.arange(n_steps + 1))


def _amc_basis_z(z, degree):
    """Standardized polynomial basis columns ``[1, z, .., z^degree]`` —
    the ONE basis constructor every AMC fit/replay path shares (bitwise
    contracts between engines hinge on the same expression tree)."""
    cols = [jnp.ones_like(z)]
    for _ in range(degree):
        cols.append(cols[-1] * z)
    return jnp.stack(cols, axis=-1)


def _amc_sums3_blocks(w, r):
    """Per-block (w, wr, wr^2) standardization partial sums: (n_blk, 3).

    A FIXED single-block lax.map body — (bs,)-shaped per block whatever
    the resident block count, so the partials are bitwise identical
    wherever block b is computed (mesh shard or streamed chunk)."""
    return jax.lax.map(
        lambda t: jnp.sum(jnp.stack([t[0], t[0] * t[1],
                                     t[0] * t[1] * t[1]], -1), axis=0),
        (w, r))


def _amc_gram_blocks(w, r, y, m, sd, degree, dtype):
    """Per-block fused [Gram | rhs] partial rows: (n_blk, k^2 + k) with
    ``k = degree + 1`` — same fixed single-block body contract as
    :func:`_amc_sums3_blocks`."""
    k_terms = degree + 1

    def one(t):
        wb, rb, yb = t
        xb = _amc_basis_z((rb - m) / sd, degree)    # (bs, k)
        xw = xb * wb[:, None]
        gram = jnp.einsum("ni,nj->ij", xw, xb, precision=HIGHEST,
                          preferred_element_type=dtype).reshape(-1)
        rhs = jnp.einsum("ni,n->i", xw, yb, precision=HIGHEST,
                         preferred_element_type=dtype)
        return jnp.concatenate([gram, rhs])

    return jax.lax.map(one, (w, r, y))


def _amc_replay(paths, disc, spec, pol_beta, pol_m, pol_sd, *, dt, n_steps,
                dtype, z_all=None, j_stop=0):
    """Re-derive the AMC backward-induction state ``(tau, cash)`` from
    FROZEN policy regressions — the streaming engine's fit/mark primitive.

    Applies the last exercise date's threshold rule and then, for
    ``j = n_ex-2 .. j_stop`` (backward), the frozen-beta exercise rule
    ``take = itm & (ex_val >= poly_j(z))``.  The expressions (including
    the per-block ``cont`` lax.map body) are verbatim
    `_amc_fit_sharded`'s, so for policy constants bitwise equal to that
    fit's, the replayed ``tau``/``cash`` are bitwise the fit's own
    backward state at step ``j_stop - 1`` — what lets a chunked stream
    regenerate per-path exercise states from nothing but path ids plus
    O(n_ex * degree) fitted scalars.

    ``paths``/``disc``: (n_blk, T+1, bs) (``paths`` unused when the
    multi-state ``z_all`` regressor rows are given); ``pol_*`` are the
    full-length (n_ex-1, ...) policy arrays (entries below ``j_stop``
    may be anything — they are not read).  Returns ``tau`` (n_blk, bs)
    int32 and ``cash`` (n_blk, bs) discounted-to-0 policy cashflows.
    """
    sign = jnp.asarray(spec.sign, dtype)
    degree = spec.degree
    k_ex = [int(round(float(e) / dt)) for e in spec.ex_dates]
    never = jnp.int32(n_steps + 1)
    k_last = k_ex[-1]
    if z_all is not None:
        ex_val = z_all[:, k_last]
    else:
        ex_val = sign * spec.swap(paths[:, k_last],
                                  jnp.asarray(spec.ex_dates[-1], dtype))
    take = ex_val > 0
    cash = jnp.where(take, ex_val, 0.0) * disc[:, k_last]
    tau = jnp.where(take, jnp.int32(k_last), never)
    for j in range(len(k_ex) - 2, j_stop - 1, -1):
        if z_all is not None:
            r_j = ex_val = z_all[:, k_ex[j]]
        else:
            r_j = paths[:, k_ex[j]]
            ex_val = sign * spec.swap(r_j,
                                      jnp.asarray(spec.ex_dates[j], dtype))
        itm = ex_val > 0
        m_j, sd_j, beta_j = pol_m[j], pol_sd[j], pol_beta[j]
        cont = jax.lax.map(
            lambda rb: mm(_amc_basis_z((rb - m_j) / sd_j, degree), beta_j),
            r_j)
        take = itm & (ex_val >= cont)
        cash = jnp.where(take, ex_val * disc[:, k_ex[j]], cash)
        tau = jnp.where(take, jnp.int32(k_ex[j]), tau)
    return tau, cash


def netting_block_stats(model, off, *, sets, n_steps, dt, seed, flat_rate,
                        dtype, block_size, im_quantile: float = 0.99,
                        im_mpor: float = 10.0 / 252.0, paths_disc=None,
                        amc_ops=None, sampler=None):
    """Simulate + mark + net + collateralize ONE fixed-width block of
    global path ids — the unit BOTH the sharded netting engines and the
    streaming (checkpoint/resume) engine map over, so their per-block
    values are identical by construction.

    The fixed compile width is what makes the profiles bitwise
    mesh-invariant: XLA's codegen for the fused draw->step chain is only
    guaranteed value-stable at a FIXED batch shape (measured: the f64
    Vasicek scan flips 1 ULP on ~1/1000 paths between 1024- and
    4096-wide compilations of the same global ids on XLA:CPU), so every
    mesh shape / chunking must run the identical block-wide program.

    Every mark is carried with its state derivative (one jvp per trade,
    exactly `engine.exposure._netting_from_paths`) so the netted
    delta-normal IM rides the block contract: rows 7/8 of each set's
    quant stack are the IM profile and its discounted mean (MVA's
    integrand).

    ``paths_disc``: optionally the precomputed ``(paths, disc)`` for this
    block (the AMC fit pre-pass already simulated them — passing them in
    avoids a second simulation); ``None`` simulates here, in the same
    fused program as the marking (the plain-book fast path).
    ``amc_ops``: dict mapping (set_idx, trade_idx) of each
    `SimulationMarkedTrade` to its globally-fitted regression operands
    (see `_amc_fit_sharded`) — required whenever an AMC trade is present.

    Returns ``(MomentState (Q_total, T+1), pos (n_sets, T+1, bs))``.
    """
    from montecarlo.engine.exposure import is_multistate

    n_dates = n_steps + 1
    if paths_disc is None:
        paths, disc = _sim_disc_block(
            model, off, n_steps=n_steps, dt=dt, seed=seed,
            flat_rate=flat_rate, dtype=dtype, block_size=block_size,
            sampler=sampler)
    else:
        paths, disc = paths_disc
    times = jnp.arange(n_dates, dtype=dtype) * dt
    multi = is_multistate(model)
    if multi:
        n_comp = paths.shape[1]
        # (C, C, N) stacked unit tangents: the C tangent replays batch
        # into ONE vmapped pass of linearize's lin (trace/compile size
        # stays flat in the component count — the LMM carries K+1
        # components, where an unrolled loop was K+1 traced replays).
        tang_stack = (jnp.eye(n_comp, dtype=dtype)[:, :, None]
                      * jnp.ones((1, 1, block_size), dtype))
    else:
        ones = jnp.ones((block_size,), dtype)

    def mark_trade(trade, amc_op):
        # Same PathDependentTrade protocol as the unsharded engine: the
        # observation row is block-local (each block simulates its own
        # full time grid), so sharding cannot change the indicator.  One
        # jvp per mark carries dV/d(state) for the netted delta-normal IM
        # (each path's value depends only on its own state); multi-state
        # models carry one tangent per component (linearize) for the
        # multivariate IM, exactly like the unsharded engine.
        if isinstance(trade, SimulationMarkedTrade):
            if amc_op is None:
                raise TypeError(
                    "the sharded/streaming netting engines can only mark "
                    "SimulationMarkedTrade (AMC) trades through a "
                    "globally-fitted regression (construct them via "
                    "engine.amc.bermudan_swaption_amc_trade so the spec "
                    "rides along: the sharded engines fit on gathered "
                    "block Grams, the streaming engine via "
                    "engine.streaming._amc_fit_streaming's extra sweeps)")
            from montecarlo.engine.amc import AMCSwaptionSpecMS

            rows = (_amc_poly_rows_ms
                    if isinstance(trade.spec, AMCSwaptionSpecMS)
                    else _amc_poly_rows)
            return rows(paths, amc_op, trade.spec, times, dt,
                        n_steps, dtype)
        if isinstance(trade, PathDependentTrade):
            k_obs = tuple(min(max(int(round(float(ot) / dt)), 0),
                              n_steps) for ot in trade.obs_times)

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
                return jax.jvp(fn_at(k), (paths[k],), (ones,))
        return jax.lax.map(row, jnp.arange(n_dates))

    # Delta-normal IM state shock — same model as the unsharded engine
    # (`_netting_from_paths`): OU conditional std over the margin period
    # for short-rate underlyings, lognormal S*sigma*sqrt(mpor) otherwise;
    # multi-state models fold per-component sensitivities with their
    # declared margin-period covariance (`im_norm`).
    z_im = jax.scipy.special.ndtri(jnp.asarray(im_quantile, dtype))
    mpor_t = jnp.asarray(im_mpor, dtype)
    if not multi:
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

    n_q_total = sum(9 + len(tr) for _, tr, _ in sets)
    all_quants = []
    all_pos = []
    for si, (_nm, trades_s, csa_s) in enumerate(sets):
        marked = [mark_trade(v, None if amc_ops is None
                             else amc_ops.get((si, ti)))
                  for ti, v in enumerate(trades_s)]
        v_all = jnp.stack([mk[0] for mk in marked])
        v_net = jnp.sum(v_all, axis=0)                      # (T+1, bs)
        dv_net = sum(mk[1] for mk in marked)
        if multi:
            im_path = z_im * model.im_norm(dv_net, paths, mpor_t)
        else:
            im_path = z_im * jnp.abs(dv_net) * state_shock

        if csa_s is None:
            gap = v_net
        else:
            h_c = jnp.asarray(csa_s.threshold, dtype)
            h_o = jnp.asarray(csa_s.own_threshold, dtype)
            mta = jnp.asarray(csa_s.mta, dtype)
            k_lag = int(round(float(csa_s.mpor) / dt))
            lag_idx = jnp.maximum(jnp.arange(n_dates) - k_lag, 0)
            v_obs = v_net[lag_idx]
            they_post = jnp.maximum(v_obs - h_c, 0.0)
            we_post = jnp.maximum(-v_obs - h_o, 0.0)
            they_post = jnp.where(they_post >= mta, they_post, 0.0)
            we_post = jnp.where(we_post >= mta, we_post, 0.0)
            gap = v_net - (they_post - we_post)

        pos = jnp.maximum(gap, 0.0)
        # Every per-date mean target stacked into ONE (Q, T+1, bs)
        # array per set: rows 0..5 = pos, neg, disc*pos, disc*neg,
        # pos_u, neg_u; row 6 = disc itself (P(0,t) for the KVA
        # capital integral); rows 7/8 = IM and disc*IM (the delta-normal
        # initial-margin profile and MVA's integrand); rows 9.. =
        # per-trade disc * v_i^+ (the no-netting baseline).  Sets
        # concatenate along Q so the whole book reduces in one moment
        # pass (row-local algebra — a one-set stack is bitwise the
        # single-set engine's).
        all_quants.append(jnp.concatenate([
            jnp.stack([pos, jnp.maximum(-gap, 0.0), disc * pos,
                       disc * jnp.maximum(-gap, 0.0),
                       jnp.maximum(v_net, 0.0),
                       jnp.maximum(-v_net, 0.0), disc, im_path,
                       disc * im_path]),
            disc[None] * jnp.maximum(v_all, 0.0),
        ]))
        all_pos.append(pos)
    quants = jnp.concatenate(all_quants)
    stats = moments_from_array(
        quants.reshape(n_q_total * n_dates, block_size), axis=-1)
    stats = MomentState(*(x.reshape(n_q_total, n_dates)
                          for x in stats))
    return stats, jnp.stack(all_pos)                        # (S, T+1, bs)


def _amc_fit_sharded(paths, disc, spec, *, dt, n_steps, gather, dtype,
                     z_all=None):
    """Distributed American-Monte-Carlo fit for ONE regression-marked
    trade: the `engine.amc.bermudan_swaption_amc_trade` policy fit and
    per-date conditional-value regressions, with every cross-path sum
    replaced by fixed-block partial sums gathered in global block order —
    the identical machinery `sharded_lsm_price` uses, so policies,
    standardizations, and betas are **bitwise identical across mesh
    shapes** (the per-block partials are the same whatever mesh a block
    lands on, and the post-gather reductions see a mesh-independent
    (n_blocks, ...) array).

    Differences vs the unsharded fit (same contract as `sharded_lsm_price`
    vs `lsm_price`): standardizations use the one-pass E[x^2]-m^2 form
    (block sums compose) and sums are block-ordered, so the two engines
    agree to regression-conditioning noise, not bitwise — tested
    statistically, with the European limit pinned against the exact
    Jamshidian-marked trade.

    Collective schedule: 2 gathers per EXERCISE date (standardization
    sums must be global before the basis exists, then one fused
    [Gram|rhs]) + 2 gathers for ALL exposure dates' conditional-value
    regressions (each date's sums stack into one collective, then one
    batched solve) — the per-date marks themselves are block-local
    polynomial evaluations (`_amc_poly_rows`).

    ``paths``/``disc``: (n_blk, T+1, bs) — this shard's blocks.  Returns
    ``{"m": (T+1,), "sd": (T+1,), "beta": (T+1, degree+1),
    "tau": (n_blk, bs) int32}`` with m/sd/beta replicated and ``tau`` the
    shard-local per-path exercise steps.

    ``z_all``: the MULTI-STATE form (`engine.amc.AMCSwaptionSpecMS`) —
    the precomputed (n_blk, T+1, bs) signed-intrinsic regressor rows
    ``z = sign * swap(cols, t)`` (see `_amc_z_rows_ms`).  The intrinsic
    doubles as the exercise value, so ``ex_val = r`` everywhere the
    scalar form evaluates the swap; everything else (Gram gathers,
    standardizations, backward induction) is IDENTICAL — which is what
    keeps the bitwise-mesh-invariance argument one argument.  ``paths``
    is unused in this form (may be the (n_blk, T+1, C, bs) state).
    """
    from montecarlo.engine.amc import _slope_ok as _amc_slope_ok

    degree = spec.degree
    k_terms = degree + 1
    if z_all is not None:
        n_blk, n_dates, _bs = z_all.shape
    else:
        n_blk, n_dates, _bs = paths.shape
    sign = jnp.asarray(spec.sign, dtype)

    k_ex = []
    for e in spec.ex_dates:
        k = int(round(float(e) / dt))
        if abs(k * dt - float(e)) > 1e-9:
            raise ValueError(
                f"AMC exercise date {e} does not lie on the exposure grid "
                f"(dt={dt}); choose n_steps so resets are grid rows")
        k_ex.append(k)
    for e in spec.resets:
        k = int(round(float(e) / dt))
        if float(e) <= n_steps * dt + 1e-9 and abs(k * dt - float(e)) > 1e-9:
            raise ValueError(
                f"AMC reset {e} does not lie on the exposure grid "
                f"(dt={dt}); choose n_steps so period starts are grid rows")
    never = jnp.int32(n_steps + 1)

    def gsum(x_blocks, block_axis=0):
        """Per-block partials -> the global (mesh-invariant) sum.

        Both sides of the gather sit behind `optimization_barrier`: the
        partial-sum producers and the closing reduction must compile the
        same way at EVERY mesh shape, but XLA fuses them differently
        when the local block count collapses to 1 (a trip-1 lax.map gets
        unrolled into its consumers) — measured as a 1-ULP flip in the
        multi-state fit at n_paths == mesh * block_size.  The barriers
        pin the boundary; they move no data.  The closing sum is
        `stats.welford.tree_sum` — a fixed pairwise tree, so the
        streaming fit's closings (different compiled programs over the
        SAME concatenated partials) reproduce it bitwise."""
        x = jax.lax.optimization_barrier(x_blocks)
        g = jax.lax.optimization_barrier(gather(x, block_axis))
        return tree_sum(g, axis=block_axis)

    # Every per-block partial below is produced by a lax.map over the
    # block axis with a FIXED single-block body — (bs, ...) shapes that
    # do not depend on how many blocks this shard holds (the shared
    # `_amc_sums3_blocks` / `_amc_gram_blocks`, which the STREAMING fit
    # maps over its chunks too).  Batched (n_blk, bs, k) einsums compiled
    # DIFFERENTLY at n_blk == 1 vs > 1 (XLA retiles the contraction),
    # flipping fit ULPs between mesh shapes at n_paths == mesh *
    # block_size; fixed-shape bodies keep the block contract the block
    # contract.
    def sums3_blocks(w, r):
        return _amc_sums3_blocks(w, r)

    def gram_blocks(w, r, y, m, sd):
        return _amc_gram_blocks(w, r, y, m, sd, degree, dtype)

    def basis(z):
        return _amc_basis_z(z, degree)

    def fit(w, r, y):
        """Global weighted polyfit from this shard's (n_blk, bs) pieces —
        same algebra as `engine.amc._weighted_polyfit` with one-pass
        standardization; returns (beta, m, sd) replicated."""
        sums = gsum(sums3_blocks(w, r))
        wsum = jnp.maximum(sums[0], 1.0)
        m = sums[1] / wsum
        sd = jnp.sqrt(jnp.maximum(sums[2] / wsum - m * m, 0.0) + 1e-12)
        fused = gsum(gram_blocks(w, r, y, m, sd)) / wsum
        a = (fused[:k_terms ** 2].reshape(k_terms, k_terms)
             + 1e-8 * jnp.eye(k_terms, dtype=dtype))
        return jnp.linalg.solve(a, fused[k_terms ** 2:]), m, sd

    # --- backward policy fit over the exercise dates -------------------
    k_last = k_ex[-1]
    if z_all is not None:
        ex_val = z_all[:, k_last]
    else:
        ex_val = sign * spec.swap(paths[:, k_last],
                                  jnp.asarray(spec.ex_dates[-1], dtype))
    take = ex_val > 0
    cash = jnp.where(take, ex_val, 0.0) * disc[:, k_last]
    tau = jnp.where(take, jnp.int32(k_last), never)
    pol = [None] * (len(k_ex) - 1)     # (beta_j, m_j, sd_j) per early date
    for j in range(len(k_ex) - 2, -1, -1):
        if z_all is not None:
            r_j = ex_val = z_all[:, k_ex[j]]
        else:
            r_j = paths[:, k_ex[j]]
            ex_val = sign * spec.swap(r_j,
                                      jnp.asarray(spec.ex_dates[j], dtype))
        itm = ex_val > 0
        beta_j, m_j, sd_j = fit(itm.astype(dtype), r_j,
                                cash / jnp.maximum(disc[:, k_ex[j]],
                                                   1e-300))
        pol[j] = (beta_j, m_j, sd_j)
        cont = jax.lax.map(
            lambda rb: mm(basis((rb - m_j) / sd_j), beta_j), r_j)
        take = itm & (ex_val >= cont)
        cash = jnp.where(take, ex_val * disc[:, k_ex[j]], cash)
        tau = jnp.where(take, jnp.int32(k_ex[j]), tau)

    # --- batched per-date conditional-value regressions -----------------
    # All dates' standardization sums ride ONE gather; m/sd known, all
    # dates' [Gram|rhs] partials ride a second; one vmapped solve.  The
    # per-date loops run as lax.map so the basis tensor never exceeds
    # O(local_n * k_terms) memory.
    dates = jnp.arange(n_dates)
    reg_all = z_all if z_all is not None else paths

    def date_sums(k):
        r = reg_all[:, k]
        w = (tau > k).astype(dtype)
        return sums3_blocks(w, r)

    s3 = jax.lax.map(date_sums, dates)              # (T+1, n_blk, 3)
    sums = gsum(s3, block_axis=1)                   # (T+1, 3)
    wsum_k = jnp.maximum(sums[:, 0], 1.0)
    m_k = sums[:, 1] / wsum_k
    var_k = jnp.maximum(sums[:, 2] / wsum_k - m_k * m_k, 0.0)
    sd_k = jnp.sqrt(var_k + 1e-12)
    # Degenerate-regressor flag per date (e.g. date 0: every path holds
    # the same state) — slope consumers zero the IM sensitivity there,
    # exactly like the unsharded fit (engine.amc._slope_ok).
    ok_k = _amc_slope_ok(var_k, sums[:, 2] / wsum_k, dtype,
                         one_pass=True)

    def date_gram(k):
        r = reg_all[:, k]
        w = (tau > k).astype(dtype)
        y = cash / jnp.maximum(disc[:, k], 1e-300)
        return gram_blocks(w, r, y, m_k[k], sd_k[k])

    gr = jax.lax.map(date_gram, dates)              # (T+1, n_blk, k²+k)
    fused = gsum(gr, block_axis=1) / wsum_k[:, None]
    a = (fused[:, :k_terms ** 2].reshape(n_dates, k_terms, k_terms)
         + 1e-8 * jnp.eye(k_terms, dtype=dtype)[None])
    beta = jax.vmap(jnp.linalg.solve)(a, fused[:, k_terms ** 2:])
    # Policy constants ride along (replicated, O(n_ex * degree) scalars):
    # `_amc_replay` regenerates tau/cash from them alone — the streaming
    # engine's whole AMC story, and checkable against this fit's tau.
    if pol:
        pol_beta = jnp.stack([p[0] for p in pol])
        pol_m = jnp.stack([p[1] for p in pol])
        pol_sd = jnp.stack([p[2] for p in pol])
    else:
        pol_beta = jnp.zeros((0, k_terms), dtype)
        pol_m = jnp.zeros((0,), dtype)
        pol_sd = jnp.zeros((0,), dtype)
    return {"m": m_k, "sd": sd_k, "beta": beta, "tau": tau, "ok": ok_k,
            "pol_beta": pol_beta, "pol_m": pol_m, "pol_sd": pol_sd}


def _wwr_pass(paths, disc, pos, *, lam, beta, n_paths, dt, n_steps,
              gather, dtype):
    """Sharded wrong-way-risk tilt for ONE netting set: the
    `engine.exposure._wwr_default_increments` intensity model with every
    global mean computed from fixed-block partial sums gathered in global
    block order — calibration constants, per-path default increments, and
    the tilted CVA integrand are therefore **bitwise identical across
    mesh shapes**.

    The Newton survival calibration is inherently sequential (date k's
    constant needs the survival state left by date k-1), so each of the
    12 iterations per date gathers one (n_blk, 2) partial-sum pair — tiny
    latency-bound collectives (T x 12 of them), the honest price of exact
    pod-scale WWR; the standardization and the final contribution/survival
    means batch into three more gathers total.

    ``paths``/``disc``/``pos``: (n_blk, T+1, bs) — this shard's blocks
    (pos is the COLLATERALIZED exposure from `netting_block_stats`).
    Returns ``(dpd_weighted_means (T+1,), survival (T+1,))`` replicated:
    ``dpd_weighted_means[k] = E[disc_k * pos_k * dPD_k(path)]`` (row 0
    zero) and the calibrated mean survival curve diagnostic.
    """
    n_blk, n_dates, _bs = paths.shape
    n_f = jnp.asarray(n_paths, dtype)
    lam = jnp.asarray(lam, dtype)
    b = jnp.asarray(beta, dtype)
    times = jnp.arange(n_dates, dtype=dtype) * dt

    def gsum(x_blocks, block_axis=0):
        return jnp.sum(gather(x_blocks, block_axis), axis=block_axis)

    # Per-date global mean/std of the underlying state (ONE gather for all
    # dates) — the cross-sectional standardization the intensity loads on.
    s2 = jax.lax.map(
        lambda k: jnp.sum(jnp.stack([paths[:, k],
                                     jnp.square(paths[:, k])], -1), axis=1),
        jnp.arange(n_dates))                       # (T+1, n_blk, 2)
    sums = gsum(s2, block_axis=1)                  # (T+1, 2)
    mean_k = sums[:, 0] / n_f
    sd_k = jnp.sqrt(jnp.maximum(sums[:, 1] / n_f - jnp.square(mean_k),
                                0.0))
    targets = jnp.exp(-lam * times)

    def per_date(s_prev, k):
        x_k = paths[:, k]                          # period-start state
        z = jnp.where(sd_k[k] > 0,
                      (x_k - mean_k[k]) / jnp.where(sd_k[k] > 0,
                                                    sd_k[k], 1.0), 0.0)
        w = jnp.exp(b * z)
        target = targets[k + 1]

        def newton(_, c):
            e = s_prev * jnp.exp(-c * w * dt)
            fs = gsum(jnp.stack([jnp.sum(e, axis=1),
                                 jnp.sum(dt * w * e, axis=1)], -1)) / n_f
            return c + (fs[0] - target) / jnp.maximum(fs[1], 1e-300)

        c = jax.lax.fori_loop(0, 12, newton, lam)
        s_new = s_prev * jnp.exp(-c * w * dt)
        dpd = s_prev - s_new
        contrib_b = jnp.sum(disc[:, k + 1] * pos[:, k + 1] * dpd, axis=1)
        surv_b = jnp.sum(s_new, axis=1)
        return s_new, (contrib_b, surv_b)

    s0 = jnp.ones((n_blk, paths.shape[2]), dtype)  # (n_blk, bs)
    _, (contrib, surv) = jax.lax.scan(per_date, s0,
                                      jnp.arange(n_steps))
    zero1 = jnp.zeros((1,), dtype)
    dpd_means = jnp.concatenate([zero1,
                                 gsum(contrib, block_axis=1) / n_f])
    surv_curve = jnp.concatenate([jnp.ones((1,), dtype),
                                  gsum(surv, block_axis=1) / n_f])
    return dpd_means, surv_curve


@partial(jax.jit, static_argnames=("sets", "n_paths", "n_steps", "seed",
                                   "T", "dtype", "mesh", "axis",
                                   "block_size", "pfe_bins", "with_wwr"))
def _sharded_portfolio_core(model, sets, credit, shared, n_paths: int,
                            n_steps: int, *, T: float, seed: int, mesh,
                            quantile, pfe_bins: int, flat_rate, dtype,
                            block_size: int, axis: str,
                            with_wwr: bool = False, sampler=None) -> dict:
    """Shared pod-scale netting machinery: N netting sets, ONE simulation.

    ``sets`` is a static tuple of ``(name, trades, csa)``; ``credit`` a
    matching tuple of per-set operand dicts (hazard_rate / recovery /
    wwr_beta / im_spread / kva_cost / kva_capital_ratio); ``shared`` the
    portfolio-level operands (own_hazard_rate / own_recovery /
    funding_spread / im_quantile / im_mpor).  Each fixed-width block
    simulates ONCE and every set marks/nets/collateralizes the same
    paths; per-set quant stacks are concatenated so cross-shard traffic
    stays ONE block-stat gather + ONE int32 histogram psum regardless of
    set count (plus the WWR calibration gathers when ``with_wwr``).
    `sharded_netting_profile` is the single-set instance of this core (a
    one-set portfolio runs the identical per-row program, so it is
    bitwise equal — tested).  Returns ``{name: profile dict}``.

    Contract notes (apply to both public wrappers):

    The pod-scale twin of `engine.exposure.netting_set_profile`: each shard
    simulates its contiguous run of global path ids, marks every trade, nets,
    and applies the CSA lag locally; cross-shard traffic is ONE gather of the
    stacked per-(quantity, date) block-moment states (fixed global block
    order, pairwise-tree merged — every mean is bitwise identical across
    mesh shapes, multi-slice included) plus ONE int32 `psum` of the per-date
    PFE histograms (integer adds are exact and order-free) whose grids come
    from an exact `pmax`.  PFE is therefore the sketch quantile: its
    deterministic grid error (one bin width at the quantile) is reported as
    ``pfe_grid_err`` — same honesty contract as `api.var`.

    The full unsharded adjustment set rides the same contracts:
      - ``im``/``mva``: the netted delta-normal IM is block-local (one jvp
        per mark carries dV/d state) — rows 7/8 of each set's quant stack.
      - ``cva_wwr``/``survival_wwr`` (``with_wwr=True``): the wrong-way
        Newton calibration runs replicated on gathered fixed-block partial
        sums (`_wwr_pass`) — T x 12 tiny serialized collectives, bitwise
        mesh-invariant.
      - AMC (`SimulationMarkedTrade`) trades: the regression fit runs on
        gathered fixed-block Gram/moment sums (`_amc_fit_sharded`, the
        `sharded_lsm_price` machinery); marks are then block-local
        polynomial evaluations.  Books with AMC or WWR pre-simulate their
        blocks once (`_sim_disc_block`) and feed paths into the marking
        map — still ONE simulation per block.

    Differences from the unsharded profile, by design:
      - ``pfe`` carries a <= one-bin-width grid error (exact sorting does
        not scale to pod path counts); raise ``pfe_bins`` to shrink it.
      - memory is O(n_steps * local_paths) per device — the exposure grid
        must be marked at every date; shard counts size the local run
        (AMC/WWR books hold paths + discounts for the whole shard, ~3x).
      - simulation + marking run per fixed ``block_size``-wide block
        (`lax.map`), because XLA's fused draw->step codegen is only
        value-stable at a fixed batch width (see `netting_block_stats`);
        raise ``block_size`` if block-dispatch overhead shows at pod
        scale.

    ``kva`` rides the block-moment contract (the capital profile is a
    deterministic function of EEPE and the mean discount) and is bitwise
    mesh-invariant like every mean.
    """
    n_slices, n_path_shards, n_shards = _slice_layout(mesh, axis)
    has_slices = n_slices > 1
    _check_divisible(n_paths, n_shards, block_size)
    local_n = n_paths // n_shards
    if has_slices:
        _check_two_level_tree(n_paths // block_size // n_slices)
    sum_axes = (axis, SLICES_AXIS) if has_slices else axis
    from montecarlo.stats.quantiles import histogram_counts

    dt = T / n_steps
    n_dates = n_steps + 1
    for _name, _trades, csa_s in sets:
        if (csa_s is not None and float(csa_s.mpor) > 0
                and int(round(float(csa_s.mpor) / dt)) == 0):
            import warnings

            # Same guard as the unsharded profile: a zero-step lag
            # silently hides ALL gap risk.
            warnings.warn(
                f"CSA margin period of risk ({float(csa_s.mpor):.4f}y) is "
                f"finer than the exposure grid (dt={dt:.4f}y) and rounds "
                "to a ZERO-step lag — the collateralized exposure will "
                "show no gap risk; raise n_steps so dt <= mpor",
                stacklevel=2)

    n_sets = len(sets)
    n_blk = local_n // block_size
    gather_axes = (SLICES_AXIS, axis) if has_slices else axis

    def gather_blocks(x, block_axis=0):
        """All-gather per-block partials along their block axis into
        global block order (slice-major on multi-slice meshes) — the AMC
        fit's and WWR calibration's reduction primitive."""
        return jax.lax.all_gather(x, gather_axes, axis=block_axis,
                                  tiled=True)

    from montecarlo.engine.exposure import is_multistate

    multi = is_multistate(model)
    # AMC (regression-marked) trades: static detection + spec validation.
    amc_items = tuple(
        (si, ti) for si, (_n, trs, _c) in enumerate(sets)
        for ti, tr in enumerate(trs)
        if isinstance(tr, SimulationMarkedTrade))
    if amc_items:
        from montecarlo.engine.amc import AMCSwaptionSpecMS
    for si, ti in amc_items:
        spec_ = getattr(sets[si][1][ti], "spec", None)
        if spec_ is None:
            raise TypeError(
                "the sharded netting engines mark AMC trades through "
                "their structured spec — construct them via "
                "engine.amc.bermudan_swaption_amc_trade (a bare "
                "SimulationMarkedTrade closure cannot be decomposed "
                "into the distributed regression fit)")
        if multi != isinstance(spec_, AMCSwaptionSpecMS):
            raise TypeError(
                "AMC spec/underlying mismatch: multi-state books need "
                "the AMCSwaptionSpecMS form (engine.amc."
                "bermudan_swaption_amc_trade_g2pp / _lmm), scalar "
                "short-rate books the scalar bermudan_swaption_amc_trade")
    need_paths = with_wwr or bool(amc_items)

    def shard_fn(model_, credit_, shared_, sampler_):
        shard_idx = jax.lax.axis_index(axis)
        if has_slices:
            shard_idx = (jax.lax.axis_index(SLICES_AXIS) * n_path_shards
                         + shard_idx)
        offs = (shard_idx.astype(jnp.uint32) * jnp.uint32(local_n)
                + jnp.arange(n_blk, dtype=jnp.uint32)
                * jnp.uint32(block_size))
        one_block = partial(netting_block_stats, sets=sets,
                            n_steps=n_steps, dt=dt, seed=seed,
                            flat_rate=flat_rate, dtype=dtype,
                            block_size=block_size, sampler=sampler_,
                            im_quantile=shared_["im_quantile"],
                            im_mpor=shared_["im_mpor"])
        # lax.map over the shard's fixed-width blocks: block b's program is
        # the SAME compiled body at every mesh shape (only the trip count
        # changes), so block stats and exposures are bitwise reproducible.
        if need_paths:
            # AMC fits and the WWR calibration need the shard's paths as
            # data: pre-simulate per fixed-width block (same program unit,
            # `_sim_disc_block`) and feed them into the marking map — one
            # simulation per block either way.
            paths_all, disc_all = jax.lax.map(
                partial(_sim_disc_block, model_, n_steps=n_steps, dt=dt,
                        seed=seed, flat_rate=flat_rate, dtype=dtype,
                        block_size=block_size, sampler=sampler_),
                offs)                                  # (n_blk, T+1, bs)
            # Stage boundaries behind `optimization_barrier`: the
            # pre-simulated paths, the regressor rows, and the fit
            # outputs each feed several downstream consumers, and XLA
            # fuses producer into consumer DIFFERENTLY when the local
            # block count collapses to 1 (a trip-1 lax.map unrolls) —
            # measured as a 1-ULP mark flip at n_paths == mesh *
            # block_size.  Barriers pin each stage to one compilation
            # at every mesh shape; they move no data.
            paths_all, disc_all = jax.lax.optimization_barrier(
                (paths_all, disc_all))
            amc_fits = {}
            for key in amc_items:
                spec_k = sets[key[0]][1][key[1]].spec
                # Multi-state specs regress on the signed intrinsic —
                # computed block-locally once, then the fit runs the
                # IDENTICAL gathered-Gram program as the scalar form.
                z_all = (jax.lax.optimization_barrier(
                            _amc_z_rows_ms(paths_all, spec_k, dt=dt,
                                           n_steps=n_steps, dtype=dtype))
                         if multi else None)
                amc_fits[key] = jax.lax.optimization_barrier(
                    _amc_fit_sharded(
                        paths_all, disc_all, spec_k, dt=dt,
                        n_steps=n_steps, gather=gather_blocks,
                        dtype=dtype, z_all=z_all))
            taus = tuple(amc_fits[key]["tau"] for key in amc_items)

            def block_with_paths(args):
                off_b, paths_b, disc_b = args[0], args[1], args[2]
                ops = {key: {**{f: amc_fits[key][f]
                                for f in ("m", "sd", "beta", "ok")},
                             "tau": args[3 + j]}
                       for j, key in enumerate(amc_items)}
                return one_block(model_, off_b,
                                 paths_disc=(paths_b, disc_b),
                                 amc_ops=ops or None)

            local_stats, pos = jax.lax.map(
                block_with_paths, (offs, paths_all, disc_all, *taus))
        else:
            local_stats, pos = jax.lax.map(
                lambda off: one_block(model_, off), offs)
        # pos: (n_blk, S, T+1, bs); per-set block view for the WWR pass.
        wwr_out = ()
        if with_wwr:
            # The state the intensity loads on: the raw scalar paths, or
            # the multi-state model's declared projection (short rate for
            # G2++, the equity spot for the hybrid).
            wwr_src = (model_.wwr_state(paths_all) if multi
                       else paths_all)
            dpds, survs = [], []
            for si in range(n_sets):
                dpd_m, surv = _wwr_pass(
                    wwr_src, disc_all, pos[:, si],
                    lam=credit_[si]["hazard_rate"],
                    beta=credit_[si]["wwr_beta"], n_paths=n_paths,
                    dt=dt, n_steps=n_steps, gather=gather_blocks,
                    dtype=dtype)
                dpds.append(dpd_m)
                survs.append(surv)
            wwr_out = ((jnp.stack(dpds), jnp.stack(survs)),)
        # (n_blk, S, T+1, bs) -> (S, T+1, local_n), global path order.
        pos = jnp.moveaxis(pos, 0, 2).reshape(n_sets, n_dates, local_n)
        gathered = _gather_two_level(local_stats, axis, has_slices)

        # PFE histograms: per-date grid [0, hi_k) with hi_k an exact pmax
        # (order-free -> mesh-invariant grids), counts via ONE flattened
        # (T+1)*pfe_bins histogram, int32-psum'd (exact adds; the bin index
        # is elementwise on bitwise-stable pos/width, so it is exact too).
        # stop_gradient: the PFE sketch is not a greek output (quantile
        # sensitivities need the unsharded engine's exact quantile), and
        # `pmax` has no JVP rule — zero tangents here let
        # `sharded_xva_greeks` forward-differentiate the rest.
        pos_sg = jax.lax.stop_gradient(pos)
        hi = jax.lax.pmax(jnp.max(pos_sg, axis=2), sum_axes)  # (S, T+1)
        hi = jnp.where(hi > 0, hi * (1.0 + 1e-9), 1.0)
        width = hi / pfe_bins
        idx = jnp.clip((pos_sg / width[:, :, None]).astype(jnp.int32),
                       0, pfe_bins - 1)
        idx = idx + (jnp.arange(n_sets * n_dates, dtype=jnp.int32)
                     .reshape(n_sets, n_dates) * pfe_bins)[:, :, None]
        counts = histogram_counts(idx, n_sets * n_dates * pfe_bins,
                                  jnp.int32)
        counts = jax.lax.psum(
            counts.reshape(n_sets, n_dates, pfe_bins), sum_axes)
        return (gathered, counts, width) + wwr_out

    spec_in = jax.tree.map(lambda _: P(), (model, credit, shared, sampler))
    out_specs = (P(), P(), P()) + ((P(),) if with_wwr else ())
    res = jax.shard_map(
        shard_fn, mesh=mesh, in_specs=spec_in, out_specs=out_specs,
        check_vma=False)(model, credit, shared, sampler)
    stats, counts, width = res[:3]
    dpd_means, surv_wwr = res[3] if with_wwr else (None, None)
    means = moments_reduce(stats).mean                      # (Q_total, T+1)

    # Sketch quantile per (set, date): rank within the counts' cumsum,
    # linear interpolation inside the crossing bin (same scheme as
    # stats.quantiles.sketch_quantile, vectorized over rows).
    rank = quantile * n_paths
    # Cumulate in float: an int32 CDF wraps past 2^31 total paths and the
    # quantile silently collapses to bin 0 (per-bin counts stay int32 —
    # exact adds; the float CDF is the same rule as sketch_quantile).
    cnt2 = counts.reshape(n_sets * n_dates, pfe_bins)
    cum = jnp.cumsum(cnt2.astype(width.dtype), axis=1)
    bin_idx = jnp.argmax(cum >= rank, axis=1)           # (S*(T+1),)
    take = lambda a, j: jnp.take_along_axis(a, j[:, None], 1)[:, 0]
    cum_before = jnp.where(bin_idx > 0,
                           take(cum, jnp.maximum(bin_idx - 1, 0)), 0)
    in_bin = jnp.maximum(take(cnt2, bin_idx), 1)
    frac = jnp.clip((rank - cum_before) / in_bin, 0.0, 1.0)
    pfe = ((bin_idx.astype(width.dtype) + frac)
           * width.reshape(n_sets * n_dates)).reshape(n_sets, n_dates)

    times = jnp.arange(n_dates, dtype=dtype) * dt
    out = {}
    row = 0
    for i, (name, trades_s, _csa) in enumerate(sets):
        m = means[row:row + 9 + len(trades_s)]
        row += 9 + len(trades_s)
        epe, ene, depe, dene, epe_u, ene_u, pbar, im, dim = (
            m[j] for j in range(9))
        eepe = jax.lax.associative_scan(jnp.maximum, epe)
        # ONE copy of the credit/funding/capital algebra, shared with the
        # unsharded engine — the per-date means above already carry the
        # block-moment contract, so every scalar is bitwise mesh-invariant.
        scalars, aux = _credit_funding_scalars(
            depe, dene, m[9:], eepe, pbar, times, dt, n_steps,
            hazard_rate=credit[i]["hazard_rate"],
            recovery=credit[i]["recovery"],
            own_hazard_rate=shared["own_hazard_rate"],
            own_recovery=shared["own_recovery"],
            funding_spread=shared["funding_spread"],
            kva_cost=credit[i]["kva_cost"],
            kva_capital_ratio=credit[i]["kva_capital_ratio"], dtype=dtype)
        mva = credit[i]["im_spread"] * jnp.sum(dim * aux["alive"]
                                               * aux["trap"])
        out[name] = {"times": times, "epe": epe, "ene": ene, "pfe": pfe[i],
                     "pfe_grid_err": width[i], "eepe": eepe,
                     "epe_uncollateralized": epe_u,
                     "ene_uncollateralized": ene_u, "im": im, "mva": mva,
                     **scalars}
        if with_wwr:
            out[name]["cva_wwr"] = ((1.0 - credit[i]["recovery"])
                                    * jnp.sum(dpd_means[i] * aux["w_o"]))
            out[name]["survival_wwr"] = surv_wwr[i]
    return out


def _wwr_requested(wwr_beta) -> bool:
    """Auto-detect whether the WWR pass must run: a nonzero concrete beta,
    or a traced beta (someone is differentiating with respect to it)."""
    try:
        return float(wwr_beta) != 0.0
    except (TypeError, jax.errors.TracerArrayConversionError,
            jax.errors.ConcretizationTypeError):
        return True


def sharded_netting_profile(model, trades, n_paths: int, n_steps: int, *,
                            T: float, seed: int, mesh, csa=None,
                            quantile: float = 0.95, pfe_bins: int = 4096,
                            hazard_rate: float = 0.0, recovery: float = 0.4,
                            own_hazard_rate: float = 0.0,
                            own_recovery: float = 0.4,
                            funding_spread: float = 0.0,
                            wwr_beta: float = 0.0,
                            im_spread: float = 0.0,
                            im_quantile: float = 0.99,
                            im_mpor: float = 10.0 / 252.0,
                            kva_cost: float = 0.0,
                            kva_capital_ratio: float = 0.112,
                            flat_rate=None, sampler=None,
                            dtype=jnp.float64,
                            block_size: int = DEFAULT_BLOCK,
                            axis: str = PATHS_AXIS,
                            with_wwr: bool | None = None) -> dict:
    """Collateralized netting-set exposure + xVA, sharded over paths.

    The pod-scale twin of `engine.exposure.netting_set_profile` — the
    single-set instance of `_sharded_portfolio_core`, which carries the
    full contract (fixed-width block simulation, one block-stat gather +
    one int32 PFE-histogram psum, bitwise mesh-shape invariance).  The
    whole unsharded adjustment surface is supported: ``im``/``mva`` ride
    the block contract, AMC (`SimulationMarkedTrade`) books run the
    distributed regression fit, and ``wwr_beta != 0`` (or
    ``with_wwr=True``) adds the ``cva_wwr``/``survival_wwr`` keys via the
    gathered Newton calibration — see the core's docstring.  For several
    counterparties on one simulation use :func:`sharded_portfolio_xva`.
    """
    if with_wwr is None:
        with_wwr = _wwr_requested(wwr_beta)
    credit = ({"hazard_rate": jnp.asarray(hazard_rate, dtype),
               "recovery": jnp.asarray(recovery, dtype),
               "wwr_beta": jnp.asarray(wwr_beta, dtype),
               "im_spread": jnp.asarray(im_spread, dtype),
               "kva_cost": jnp.asarray(kva_cost, dtype),
               "kva_capital_ratio": jnp.asarray(kva_capital_ratio, dtype)},)
    shared = {"own_hazard_rate": jnp.asarray(own_hazard_rate, dtype),
              "own_recovery": jnp.asarray(own_recovery, dtype),
              "funding_spread": jnp.asarray(funding_spread, dtype),
              "im_quantile": jnp.asarray(im_quantile, dtype),
              "im_mpor": jnp.asarray(im_mpor, dtype)}
    return _sharded_portfolio_core(
        model, (("_set", tuple(trades), csa),), credit, shared, n_paths,
        n_steps, T=T, seed=seed, mesh=mesh, quantile=quantile,
        pfe_bins=pfe_bins, flat_rate=flat_rate, dtype=dtype,
        block_size=block_size, axis=axis, with_wwr=with_wwr,
        sampler=sampler)["_set"]


#: Per-set operand scalars the sharded portfolio engine accepts — the
#: same set as the unsharded `engine.exposure._SET_SCALARS`.
_SHARDED_SET_SCALARS = (("hazard_rate", 0.0), ("recovery", 0.4),
                        ("wwr_beta", 0.0), ("im_spread", 0.0),
                        ("kva_cost", 0.0), ("kva_capital_ratio", 0.112))


def sharded_portfolio_xva(model, netting_sets, n_paths: int, n_steps: int,
                          *, T: float, seed: int, mesh,
                          quantile: float = 0.95, pfe_bins: int = 4096,
                          own_hazard_rate: float = 0.0,
                          own_recovery: float = 0.4,
                          funding_spread: float = 0.0,
                          im_quantile: float = 0.99,
                          im_mpor: float = 10.0 / 252.0, flat_rate=None,
                          sampler=None, dtype=jnp.float64,
                          block_size: int = DEFAULT_BLOCK,
                          axis: str = PATHS_AXIS) -> dict:
    """Multi-counterparty xVA at pod scale: N netting sets, ONE sharded
    simulation.

    The pod twin of `engine.exposure.portfolio_xva` with the SAME spec
    dicts: ``trades`` required (AMC `SimulationMarkedTrade`s included —
    they run the distributed regression fit), optional ``csa`` and
    per-counterparty ``hazard_rate``/``recovery``/``wwr_beta``/
    ``im_spread``/``kva_cost``/``kva_capital_ratio``.  Each fixed-width
    block simulates the underlying ONCE and every netting set
    marks/nets/collateralizes the same paths, so the simulation cost is
    shared across counterparties exactly as in the unsharded engine;
    cross-shard traffic stays ONE stacked block-moment gather + ONE int32
    histogram psum for the whole book (plus the per-set WWR calibration
    gathers when any ``wwr_beta != 0``).  Guarantees (tested): a one-set
    portfolio is bitwise identical to `sharded_netting_profile`; every
    per-set profile and scalar is bitwise mesh-shape-invariant; totals
    are exactly additive over sets.

    Returns ``{"sets": {name: profile}, "portfolio": totals}`` where each
    profile is `sharded_netting_profile`'s dict (PFE as a sketch quantile
    with its ``pfe_grid_err``) and ``totals`` sums the adjustment scalars
    and the collateralized ``epe`` (plus ``peak_epe``).
    """
    allowed = {"trades", "csa"} | {k for k, _ in _SHARDED_SET_SCALARS}
    sets, credit = [], []
    with_wwr = False
    for name, spec in netting_sets.items():
        unknown = set(spec) - allowed
        if unknown:
            raise ValueError(f"netting set {name!r}: unknown keys "
                             f"{sorted(unknown)}")
        sets.append((name, tuple(spec["trades"]), spec.get("csa")))
        credit.append({k: jnp.asarray(spec.get(k, d), dtype)
                       for k, d in _SHARDED_SET_SCALARS})
        with_wwr = with_wwr or _wwr_requested(spec.get("wwr_beta", 0.0))
    shared = {"own_hazard_rate": jnp.asarray(own_hazard_rate, dtype),
              "own_recovery": jnp.asarray(own_recovery, dtype),
              "funding_spread": jnp.asarray(funding_spread, dtype),
              "im_quantile": jnp.asarray(im_quantile, dtype),
              "im_mpor": jnp.asarray(im_mpor, dtype)}
    per_set = _sharded_portfolio_core(
        model, tuple(sets), tuple(credit), shared, n_paths, n_steps, T=T,
        seed=seed, mesh=mesh, quantile=quantile, pfe_bins=pfe_bins,
        flat_rate=flat_rate, dtype=dtype, block_size=block_size, axis=axis,
        with_wwr=with_wwr, sampler=sampler)
    totals = {k: sum(per_set[name][k] for name in per_set)
              for k in ("cva", "dva", "bcva", "cva_no_netting", "fca",
                        "fba", "fva", "mva", "kva", "epe")}
    totals["peak_epe"] = jnp.max(totals["epe"])
    return {"sets": per_set, "portfolio": totals}


@partial(jax.jit, static_argnames=("build_fn", "n_paths", "n_steps", "seed",
                                   "mesh", "csa", "T", "outputs", "dtype",
                                   "pfe_bins", "block_size", "axis",
                                   "with_wwr"))
def _sharded_xva_greeks(build_fn, params, base, n_paths, n_steps, *, T,
                        seed, mesh, csa, outputs, dtype, pfe_bins,
                        block_size, axis, with_wwr):
    def scalars(p):
        model, trades, flat_rate = build_fn(p)
        kw = dict(base)
        for k in ("hazard_rate", "recovery", "own_hazard_rate",
                  "own_recovery", "funding_spread", "wwr_beta",
                  "im_spread", "kva_cost", "kva_capital_ratio"):
            if k in p:
                kw[k] = p[k]
        res = sharded_netting_profile(
            model, trades, n_paths, n_steps, T=T, seed=seed, mesh=mesh,
            csa=csa, pfe_bins=pfe_bins, flat_rate=flat_rate, dtype=dtype,
            block_size=block_size, axis=axis, with_wwr=with_wwr, **kw)
        return {k: res[k] for k in outputs}

    # One jax.jvp per parameter, NOT jax.linearize: the linearized
    # tangent-only replay compiles as a separate program whose XLA
    # fusion/FMA choices turned out to differ between mesh shapes
    # (measured: the f32 fva/sigma tangent flipped a few ULPs between
    # 1- and 8-device meshes, breaking the bitwise contract), while the
    # interleaved primal+tangent jvp program is mesh-stable.  The P
    # primal re-traces are identical HLO inside this one jit, so XLA
    # CSEs them — values come from the first call.
    zeros = {k: jnp.zeros_like(v) for k, v in params.items()}
    vals = None
    per_param = {}
    for k in params:
        tangent = dict(zeros)
        tangent[k] = jnp.ones_like(params[k])
        vals_k, per_param[k] = jax.jvp(scalars, (params,), (tangent,))
        vals = vals_k if vals is None else vals
    return vals, {out: {k: per_param[k][out] for k in params}
                  for out in outputs}


def sharded_xva_greeks(build_fn, params, n_paths: int, n_steps: int, *,
                       T: float, seed: int, mesh, csa=None,
                       outputs=("cva", "dva", "bcva", "fca", "fba", "fva"),
                       quantile: float = 0.95, pfe_bins: int = 4096,
                       hazard_rate: float = 0.0, recovery: float = 0.4,
                       own_hazard_rate: float = 0.0,
                       own_recovery: float = 0.4,
                       funding_spread: float = 0.0,
                       wwr_beta: float = 0.0, im_spread: float = 0.0,
                       im_quantile: float = 0.99,
                       im_mpor: float = 10.0 / 252.0,
                       kva_cost: float = 0.0,
                       kva_capital_ratio: float = 0.112,
                       dtype=jnp.float64, block_size: int = DEFAULT_BLOCK,
                       axis: str = PATHS_AXIS) -> dict:
    """Pod-scale xVA sensitivities: forward-mode AD through
    `sharded_netting_profile`.

    The pod twin of `engine.exposure.xva_greeks` (same ``build_fn`` /
    ``params`` contract — rebuild the book from the differentiable
    scalars so valuation sensitivity flows through the trade closures;
    same caveats: CSA terms are static, a nonzero ``mta`` biases pathwise
    greeks and warns).  One jvp tangent per parameter rides the SAME
    fixed-block program as the level profile — tangents of a fixed-width
    block program are themselves fixed-width, and every tangent mean
    crosses the mesh through the identical block-moment gather +
    pairwise-tree merge — so values AND greeks are bitwise identical
    across mesh shapes (tested on 1/2/4/8-device and multi-slice meshes).

    ``outputs`` may include any scalar the sharded profile reports —
    ``cva``/``dva``/``bcva``/``fca``/``fba``/``fva``/``mva``/``kva``,
    plus ``cva_wwr`` when the WWR pass runs (``wwr_beta != 0`` or
    ``"wwr_beta" in params`` or ``"cva_wwr" in outputs``).

    Returns ``{"values": {out: scalar}, "greeks": {out: {param: grad}}}``.
    """
    if csa is not None and float(csa.mta) > 0:
        import warnings

        warnings.warn(
            "sharded_xva_greeks with csa.mta > 0: the MTA deadband is a "
            "jump discontinuity in collateral and pathwise AD drops its "
            "boundary term — set mta=0 for exact pathwise greeks",
            stacklevel=2)
    with_wwr = ("cva_wwr" in outputs or "wwr_beta" in params
                or _wwr_requested(wwr_beta))
    params = {k: jnp.asarray(v, dtype) for k, v in params.items()}
    base = dict(quantile=quantile, hazard_rate=hazard_rate,
                recovery=recovery, own_hazard_rate=own_hazard_rate,
                own_recovery=own_recovery, funding_spread=funding_spread,
                wwr_beta=wwr_beta, im_spread=im_spread,
                im_quantile=im_quantile, im_mpor=im_mpor,
                kva_cost=kva_cost, kva_capital_ratio=kva_capital_ratio)
    base = {k: jnp.asarray(v, dtype) for k, v in base.items()}
    vals, grads = _sharded_xva_greeks(
        build_fn, params, base, n_paths, n_steps, T=T, seed=seed,
        mesh=mesh, csa=csa, outputs=tuple(outputs), dtype=dtype,
        pfe_bins=pfe_bins, block_size=block_size, axis=axis,
        with_wwr=with_wwr)
    return {"values": vals, "greeks": grads}


@partial(jax.jit, static_argnames=("payoff_fn", "n_paths", "seed", "stream",
                                   "block_size", "axis", "mesh"))
def sharded_rbergomi_estimate(model, payoff_fn, n_paths: int, *, seed: int,
                              mesh, discount=1.0, stream: int = 0,
                              block_size: int = DEFAULT_BLOCK,
                              axis: str = PATHS_AXIS):
    """Pod-scale rough Bergomi: the own-simulator sampler sharded over paths.

    `rbergomi_simulate` is not a per-step process (the Volterra factor is
    one matmul per path block), so it cannot ride `sharded_mc_estimate` —
    this applies the same fixed-block contract directly: each shard runs
    the sampler per fixed ``block_size``-wide block of GLOBAL path ids
    (`lax.map` — the fixed compile width is what makes per-path values
    reproducible across mesh shapes, see DEVNOTES "Determinism contract"),
    payoffs reduce to per-block moments, and blocks merge by the fixed
    pairwise tree — price and std-err bitwise identical on any mesh,
    multi-slice included.

    Throughput note: blocks run sequentially per shard; raise
    ``block_size`` (multiples of 1024 keep the Pallas draw kernel engaged)
    when per-block dispatch shows at scale.
    """
    from montecarlo.processes.rough_bergomi import rbergomi_simulate

    n_slices, n_path_shards, n_shards = _slice_layout(mesh, axis)
    has_slices = n_slices > 1
    _check_divisible(n_paths, n_shards, block_size)
    local_n = n_paths // n_shards
    n_blk = local_n // block_size
    if has_slices:
        _check_two_level_tree(n_paths // block_size // n_slices)

    def shard_fn(model_):
        shard_idx = jax.lax.axis_index(axis)
        if has_slices:
            shard_idx = (jax.lax.axis_index(SLICES_AXIS) * n_path_shards
                         + shard_idx)

        def one_block(off):
            s_t = rbergomi_simulate(model_, block_size, seed=seed,
                                    stream=stream, path_offset=off)
            return moments_from_array(payoff_fn(s_t).reshape(1, block_size),
                                      axis=-1)

        offs = (shard_idx.astype(jnp.uint32) * jnp.uint32(local_n)
                + jnp.arange(n_blk, dtype=jnp.uint32)
                * jnp.uint32(block_size))
        stats = jax.lax.map(one_block, offs)       # leaves (n_blk, 1)
        local_stats = MomentState(*(x.reshape(n_blk) for x in stats))
        return _gather_two_level(local_stats, axis, has_slices)

    spec_in = jax.tree.map(lambda _: P(), model)
    stats = jax.shard_map(shard_fn, mesh=mesh, in_specs=(spec_in,),
                          out_specs=P(), check_vma=False)(model)
    total = moments_reduce(stats)
    d = jnp.asarray(discount, total.mean.dtype)
    return {"price": d * total.mean, "std_err": d * std_error(total),
            "n_paths": total.count}


# ---------------------------------------------------------------------------
# Pod-scale portfolio credit (Gaussian-copula baskets / CDO tranches)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("product", "k", "n_paths", "n_steps",
                                   "seed", "T", "dtype", "mesh", "axis",
                                   "block_size", "copula", "df"))
def _sharded_credit_legs(hazards, loss_w, rho, attach, detach, recovery,
                         n_paths, n_steps, *, product, k, T, seed, rate,
                         mesh, dtype, block_size, axis, copula, df,
                         sampler=None):
    from montecarlo.engine.credit import credit_legs_pathwise

    n_slices, n_path_shards, n_shards = _slice_layout(mesh, axis)
    has_slices = n_slices > 1
    _check_divisible(n_paths, n_shards, block_size)
    local_n = n_paths // n_shards
    n_blk = local_n // block_size
    if has_slices:
        _check_two_level_tree(n_paths // block_size // n_slices)

    def shard_fn(h_, w_, rho_, a_, b_, rec_, rate_, sampler_):
        shard_idx = jax.lax.axis_index(axis)
        if has_slices:
            shard_idx = (jax.lax.axis_index(SLICES_AXIS) * n_path_shards
                         + shard_idx)

        def one_block(off):
            prot, prem = credit_legs_pathwise(
                h_, w_, rho_, product=product, attach=a_, detach=b_, k=k,
                recovery=rec_, n_paths=block_size, n_steps=n_steps, T=T,
                seed=seed, rate=rate_, dtype=dtype, path_offset=off,
                copula=copula, df=df, sampler=sampler_)
            # Third row: the cross product, so the merged moments carry
            # cov(prot, prem) for the linearized par-spread error.
            rows = jnp.stack([prot, prem, prot * prem])
            return moments_from_array(rows, axis=-1)

        offs = (shard_idx.astype(jnp.uint32) * jnp.uint32(local_n)
                + jnp.arange(n_blk, dtype=jnp.uint32)
                * jnp.uint32(block_size))
        # Leaves stay (n_blk, 3): the gather stacks global blocks on the
        # leading axis and moments_reduce folds it (same layout as the
        # netting engine's (n_blk, Q, T+1) stats).
        local_stats = jax.lax.map(one_block, offs)
        return _gather_two_level(local_stats, axis, has_slices)

    args = (hazards, loss_w, rho, attach, detach, recovery,
            jnp.asarray(rate, dtype), sampler)
    spec_in = jax.tree.map(lambda _: P(), args)
    stats = jax.shard_map(shard_fn, mesh=mesh, in_specs=spec_in,
                          out_specs=P(), check_vma=False)(*args)
    total = moments_reduce(stats)                     # rows (3,)
    p_mean, q_mean, pq_mean = total.mean
    n = total.count[0]
    # ddof=1 like stats.welford.std_error (the unsharded engine's bars);
    # cov keeps the population normalization n, so rescale to match the
    # resid-moment variance var(p - s q) the unsharded record computes.
    var1 = total.m2 / (n - 1.0)
    spread = p_mean / q_mean
    cov1 = (pq_mean - p_mean * q_mean) * n / (n - 1.0)
    var_resid = (var1[0] + spread * spread * var1[1]
                 - 2.0 * spread * cov1)
    se_spread = jnp.sqrt(jnp.maximum(var_resid, 0.0) / n) / q_mean
    return {"protection_leg": p_mean,
            "protection_leg_std_err": jnp.sqrt(var1[0] / n),
            "premium_leg_per_spread": q_mean,
            "premium_leg_std_err": jnp.sqrt(var1[1] / n),
            "par_spread": spread, "par_spread_std_err": se_spread,
            "n_paths": jnp.asarray(n_paths, dtype)}


def sharded_credit_legs(hazards, rho: float, n_paths: int, n_steps: int, *,
                        T: float, seed: int, mesh, product: str = "tranche",
                        attach: float = 0.0, detach: float = 0.03,
                        k: int = 1, recovery=0.4, weights=None,
                        rate: float = 0.0, copula: str = "gaussian",
                        df: int = 4, sampler=None, dtype=jnp.float64,
                        block_size: int = DEFAULT_BLOCK,
                        axis: str = PATHS_AXIS) -> dict:
    """Pod-scale Gaussian-copula credit legs (CDO tranche or kth-to-default).

    The pod twin of `engine.credit.cdo_tranche` /
    `engine.credit.kth_to_default_cds`: each fixed ``block_size``-wide run
    of GLOBAL path ids draws its copula variables (counter-based: factor =
    draw 0, name i = draw 1 + i) and computes its pathwise (protection,
    premium) legs with the identical discretized-leg algebra
    (`credit_legs_pathwise` — ONE shared copy); per-block moments of
    ``(prot, prem, prot*prem)`` cross the mesh through the standard
    block-stat gather + fixed pairwise tree, so the legs, the par spread,
    and its linearized std error (the covariance rides the third row) are
    bitwise identical across mesh shapes.  Per-date expected-loss
    profiles are an unsharded-engine feature (they are T+1 more gathered
    rows — ask if pod-scale profiles are needed).

    ``product``: ``"tranche"`` (uses ``attach``/``detach``/``weights``/
    per-name ``recovery``) or ``"kth"`` (uses ``k`` and scalar
    ``recovery``).  Returns the leg/spread record (no profile).
    """
    hazards = jnp.asarray(hazards, dtype)
    n = hazards.shape[0]
    if product == "tranche":
        if not 0.0 <= attach < detach:
            raise ValueError("need 0 <= attach < detach")
        w = (jnp.full((n,), 1.0 / n, dtype) if weights is None
             else jnp.asarray(weights, dtype))
        loss_w = w * (1.0 - jnp.broadcast_to(
            jnp.asarray(recovery, dtype), (n,)))
    elif product == "kth":
        if not 1 <= k <= n:
            raise ValueError(f"k must be in [1, {n}]")
        loss_w = jnp.ones((n,), dtype)
    else:
        raise ValueError(f"unknown credit product {product!r}")
    return _sharded_credit_legs(
        hazards, loss_w, jnp.asarray(rho, dtype),
        jnp.asarray(attach, dtype), jnp.asarray(detach, dtype),
        jnp.asarray(recovery, dtype), n_paths, n_steps, product=product,
        k=k, T=T, seed=seed, rate=rate, mesh=mesh, dtype=dtype,
        block_size=block_size, axis=axis, copula=copula, df=df,
        sampler=sampler)
