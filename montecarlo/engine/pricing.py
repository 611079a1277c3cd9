"""Monte Carlo estimators over simulated terminal prices."""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from montecarlo.stats.welford import (
    MomentState,
    moments_from_array,
    moments_merge,
    std_error,
)


def mc_estimate(payoffs, discount=1.0) -> dict:
    """Mean estimator with standard error.

    Returns ``{"price", "std_err", "n_paths"}`` — ``std_err`` is the
    discounted standard error of the mean, the convergence criterion of the
    driver's wall-clock-to-1e-3 benchmark metric.
    """
    payoffs = jnp.asarray(payoffs)
    if not jnp.issubdtype(payoffs.dtype, jnp.floating):
        # Bool/int payoffs (digitals, indicators): casting the DISCOUNT to
        # their dtype would truncate it to True/0 and silently corrupt the
        # price; promote the payoffs to float instead.
        payoffs = payoffs.astype(jnp.float32)
    st: MomentState = moments_from_array(payoffs, axis=0)
    d = jnp.asarray(discount, payoffs.dtype)
    return {
        "price": d * st.mean,
        "std_err": d * std_error(st),
        "n_paths": st.count,
    }


@partial(jax.jit, static_argnames=("payoff_fn", "chunk_paths", "n_steps",
                                   "max_chunks", "use_fused"))
def price_to_tolerance(process, payoff_fn, *, target_std_err, seed,
                       chunk_paths: int = 1 << 22, n_steps: int = 252,
                       discount=1.0, max_chunks: int = 1024,
                       use_fused: bool = True):
    """Price until the (discounted) standard error reaches the target —
    entirely on device (`lax.while_loop` over path chunks), one host
    round-trip total.  This is the driver metric's 'wall-clock to std-err
    1e-3' mode; the checkpointable/bitwise-deterministic variant is
    `engine.streaming.streaming_estimate(target_std_err=...)`.

    Returns ``{"price", "std_err", "n_paths", "n_chunks"}``.
    """
    from montecarlo.engine.dispatch import payoff_block_moments
    from montecarlo.stats.welford import moments_reduce

    if chunk_paths * max_chunks > 1 << 32:
        # Path ids are uint32: offsets past 2^32 wrap and REPLAY earlier
        # chunks' draws — duplicates would be merged as independent samples
        # and the reported std_err silently understated.
        raise ValueError(
            f"chunk_paths*max_chunks = {chunk_paths}*{max_chunks} exceeds "
            "the 2^32 global path-id space; lower one of them or use "
            "streaming_estimate with distinct streams")
    d = jnp.asarray(discount, jnp.float32)
    target = jnp.asarray(target_std_err, jnp.float32)

    def chunk_stats(i):
        # Payoff + block stats fused into the path kernel when eligible —
        # the (chunk_paths,) terminal array never reaches HBM.
        blocks = payoff_block_moments(
            process, payoff_fn, chunk_paths, n_steps, seed=seed,
            path_offset=i * chunk_paths, prefer_fused=use_fused)
        return moments_reduce(blocks)

    def cond(carry):
        st, i = carry
        return (i < max_chunks) & ((i < 1) | (d * std_error(st) > target))

    def body(carry):
        st, i = carry
        return moments_merge(st, chunk_stats(i)), i + 1

    z = jnp.float32(0.0)
    st, n_chunks = jax.lax.while_loop(
        cond, body, (MomentState(count=z, mean=z, m2=z), jnp.int32(0)))
    return {
        "price": d * st.mean,
        "std_err": d * std_error(st),
        "n_paths": st.count,
        "n_chunks": n_chunks,
    }


def price_to_tolerance_rqmc(process, payoff_fn, *, target_std_err, seed,
                            n_replicates: int = 8,
                            chunk_paths: int = 1 << 18, n_steps: int = 252,
                            discount=1.0, max_chunks: int = 256,
                            min_chunks: int = 1, use_fused: bool = True,
                            sampler_factory=None):
    """Price to a target std-err with randomized QMC — entirely on device.

    The driver's wall-clock-to-tolerance metric with the repo's strongest
    sampler: ``n_replicates`` independently scrambled+shifted Sobol
    replicates, each consuming the SAME growing prefix of point indices,
    inside ONE jitted ``lax.while_loop``.  Per iteration, every replicate
    prices ``chunk_paths`` more Sobol points (a `lax.scan` over the stacked
    replicate tables — R kernel launches per iteration, all on device); the
    loop stops when the replicate-spread standard error

        std_err = d * std(replicate running means, ddof=1) / sqrt(R)

    reaches ``target_std_err``.  That spread is the honest QMC error bar
    (see `rqmc_estimate`); the iid formula `price_to_tolerance` uses would
    overstate QMC error ~30x and run ~30x more paths than needed.

    One host round-trip total, instead of one dispatch per replicate.

    Honesty floor: below ``std_err ~ 3e-6 * price`` the replicate spread
    is tighter than the f32 pipeline itself — accumulation-order rounding
    (block-moments tree vs flat mean) alone moves the estimate by ~2e-6
    relative, which the spread cannot see.  Don't interpret bars below
    ~1e-5 absolute as calibrated.

    Returns ``{"price", "std_err", "n_paths", "n_chunks", "n_replicates"}``.
    """
    from montecarlo.rng.sobol import SobolDeviceSampler

    if n_replicates < 2:
        raise ValueError("n_replicates must be >= 2 (the error bar is the "
                         "spread across replications)")
    if chunk_paths * max_chunks > 1 << 30:
        # Device Sobol integers carry 30 bits: point indices past 2^30 wrap
        # (sobol_bits reads 30 Gray-code bits) and silently REPLAY earlier
        # points, understating the reported spread.
        raise ValueError(
            f"chunk_paths*max_chunks = {chunk_paths}*{max_chunks} exceeds "
            "the 2^30 Sobol point space per replicate; lower one of them")
    if sampler_factory is None:
        sampler_factory = lambda r: SobolDeviceSampler.create(
            n_steps, process.n_draws, scramble_seed=seed + r)
    stacked = _stack_samplers([sampler_factory(r)
                               for r in range(n_replicates)])
    rep_seeds = _replicate_shift_seeds(seed, n_replicates)
    return _ptt_rqmc(process, payoff_fn, stacked, rep_seeds,
                     target_std_err=jnp.asarray(target_std_err, jnp.float32),
                     discount=jnp.asarray(discount, jnp.float32),
                     chunk_paths=chunk_paths, n_steps=n_steps,
                     max_chunks=max_chunks, min_chunks=min_chunks,
                     n_replicates=n_replicates, use_fused=use_fused)


@partial(jax.jit, static_argnames=("payoff_fn", "chunk_paths", "n_steps",
                                   "max_chunks", "min_chunks",
                                   "n_replicates", "use_fused"))
def _ptt_rqmc(process, payoff_fn, stacked_sampler, rep_seeds, *,
              target_std_err, discount, chunk_paths: int, n_steps: int,
              max_chunks: int, min_chunks: int, n_replicates: int,
              use_fused: bool):
    from montecarlo.engine.dispatch import payoff_block_moments
    from montecarlo.stats.welford import moments_reduce

    d = discount.astype(jnp.float32)
    target = target_std_err.astype(jnp.float32)
    rf = jnp.float32(n_replicates)

    def chunk_means(i):
        def rep(carry, xs):
            smp, rseed = xs
            blocks = payoff_block_moments(
                process, payoff_fn, chunk_paths, n_steps, seed=rseed,
                path_offset=i * chunk_paths, sampler=smp,
                prefer_fused=use_fused)
            return carry, moments_reduce(blocks).mean
        _, means = jax.lax.scan(rep, jnp.int32(0),
                                (stacked_sampler, rep_seeds))
        return means  # (R,) this chunk's per-replicate means

    def spread_se(means):
        return d * jnp.std(means, ddof=1) / jnp.sqrt(rf)

    def cond(carry):
        means, i = carry
        return (i < max_chunks) & ((i < min_chunks)
                                   | (spread_se(means) > target))

    def body(carry):
        means, i = carry
        cm = chunk_means(i)
        # Equal-size chunks -> exact running replicate means.
        new = means + (cm - means) / (i + 1).astype(jnp.float32)
        return new, i + 1

    means0 = jnp.zeros((n_replicates,), jnp.float32)
    means, n_chunks = jax.lax.while_loop(cond, body, (means0, jnp.int32(0)))
    return {
        "price": d * jnp.mean(means),
        "std_err": spread_se(means),
        "n_paths": n_chunks * jnp.float32(chunk_paths * n_replicates),
        "n_chunks": n_chunks,
        "n_replicates": n_replicates,
    }


def _replicate_shift_seeds(seed: int, n_replicates: int):
    """Per-replicate randomization seeds (Owen-hash keys) as a device operand.

    Masked to 31 bits: the fused kernel takes the seed as a traced int32
    operand, and an unmasked golden-ratio stride overflows it (the CPU scan
    path used to take seeds statically and hid this).
    """
    import numpy as np

    return jnp.asarray(
        [(seed + 0x9E3779B9 * (r + 1)) & 0x7FFFFFFF
         for r in range(n_replicates)], np.uint32)


def _stack_samplers(samplers):
    """Stack same-structure sampler pytrees along a new replicate axis, so
    a `lax.scan` over the result re-materializes each replicate's sampler
    (direction tables and all) as operands of ONE compiled program."""
    return jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]),
                        *samplers)


@partial(jax.jit, static_argnames=("payoff_fn", "n_per", "n_steps",
                                   "functional_items", "dtype"))
def _rqmc_replicate_means(process, payoff_fn, stacked_sampler, rep_seeds,
                          *, n_per: int, n_steps: int,
                          functional_items=None, dtype=jnp.float32):
    """Per-replicate payoff means, all replicates inside ONE device program.

    `lax.scan` over the stacked sampler pytree + shift seeds: each
    iteration rebuilds that replicate's sampler from operands and runs the
    dispatcher (fused path kernel on the GPU, scan engine elsewhere).  One
    compile, one dispatch — a python loop would pay a dispatch and a
    scan-engine recompile per replicate.
    """
    from montecarlo.engine.dispatch import terminal_prices
    from montecarlo.engine.functionals import simulate_functionals

    def rep(carry, xs):
        smp, rseed = xs
        if functional_items is None:
            terminal = terminal_prices(process, n_per, n_steps, seed=rseed,
                                       sampler=smp, dtype=dtype)
            payoffs = payoff_fn(terminal)
        else:
            out = simulate_functionals(process, n_per, n_steps, seed=rseed,
                                       functionals=dict(functional_items),
                                       sampler=smp, dtype=dtype)
            payoffs = payoff_fn(out)
        return carry, jnp.mean(payoffs)

    _, means = jax.lax.scan(rep, jnp.int32(0), (stacked_sampler, rep_seeds))
    return means


def rqmc_estimate(process, payoff_fn, n_paths: int, n_steps: int, *,
                  seed: int, sampler_factory=None, n_replicates: int = 8,
                  discount=1.0, dtype=jnp.float32, functionals=None) -> dict:
    """Randomized-QMC estimate with an HONEST error bar.

    The iid std-err formula is meaningless for QMC (points are negatively
    dependent by construction; it overstates the true error ~30x on smooth
    payoffs).  The statistically sound estimate runs ``n_replicates``
    independent *randomizations* of the same point set — here the
    per-dimension Owen-hash scramble, keyed by the seed — and reports

        price   = mean of replicate means,
        std_err = std(replicate means) / sqrt(R).

    ``sampler_factory(replicate_index) -> sampler`` defaults to device
    Sobol samplers with a FRESH linear-matrix scramble per replicate: the
    historical digital shift alone left shift-invariant error components
    identical across replicates (the replicate spread then *under*stated
    the true error — observed 8-sigma misses on the bridge sampler).
    Today's per-replicate Owen-hash keys are nonlinear and re-randomize
    strata on their own; the fresh LMS scrambles are kept as a second,
    structurally different randomization layer.  Each replicate uses
    ``n_paths // n_replicates`` paths.

    All replicates run inside ONE compiled device program (the samplers are
    stacked into operands and scanned over — see `_rqmc_replicate_means`);
    replicate means are bitwise identical to running the replicates one
    dispatch at a time.

    ``functionals``: optional ``{name: PathFunctional}`` dict for
    path-dependent payoffs — ``payoff_fn`` then receives the
    `simulate_functionals` output dict (with ``"terminal"``) instead of the
    terminal array, giving Asian/lookback/barrier payoffs the same honest
    replicated error bar.
    """
    from montecarlo.rng.sobol import SobolDeviceSampler

    if n_replicates < 2:
        raise ValueError("n_replicates must be >= 2 (the error bar is the "
                         "spread across replications)")
    if n_paths < n_replicates or n_paths % n_replicates:
        raise ValueError(
            f"n_paths={n_paths} must split into n_replicates="
            f"{n_replicates} equal non-empty QMC replications")
    n_per = n_paths // n_replicates
    if sampler_factory is None:
        sampler_factory = lambda r: SobolDeviceSampler.create(
            n_steps, process.n_draws, scramble_seed=seed + r)

    stacked = _stack_samplers([sampler_factory(r)
                               for r in range(n_replicates)])
    rep_seeds = _replicate_shift_seeds(seed, n_replicates)
    items = tuple(functionals.items()) if functionals is not None else None
    m = _rqmc_replicate_means(process, payoff_fn, stacked, rep_seeds,
                              n_per=n_per, n_steps=n_steps,
                              functional_items=items, dtype=dtype)
    d = jnp.asarray(discount, m.dtype)
    price = d * jnp.mean(m)
    se = d * jnp.std(m, ddof=1) / jnp.sqrt(jnp.asarray(n_replicates,
                                                       m.dtype))
    return {"price": price, "std_err": se, "n_paths": n_paths,
            "n_replicates": n_replicates}
