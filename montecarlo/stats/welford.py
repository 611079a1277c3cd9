"""Mergeable first/second-moment accumulators (Chan/Welford parallel form).

Every accumulator here obeys a *merge law* so per-block partial states can be
combined in a fixed, shard-shape-invariant order — the key to bitwise
reproducible estimates across mesh shapes (see
:mod:`montecarlo.parallel.sharded`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class MomentState(NamedTuple):
    """count / mean / M2 (sum of squared deviations) triple.

    Fields may carry any broadcast-compatible leading shape (e.g. one state
    per path-block, to be tree-merged later).
    """

    count: jnp.ndarray
    mean: jnp.ndarray
    m2: jnp.ndarray


def moments_zero(shape=(), dtype=jnp.float32) -> MomentState:
    z = jnp.zeros(shape, dtype)
    return MomentState(count=z, mean=z, m2=z)


def moments_from_array(x, axis=-1) -> MomentState:
    """Exact per-block moments via XLA's (deterministic, fixed-shape) reductions."""
    x = jnp.asarray(x)
    n = jnp.asarray(x.shape[axis], x.dtype)
    mean = jnp.mean(x, axis=axis)
    m2 = jnp.sum(jnp.square(x - jnp.expand_dims(mean, axis)), axis=axis)
    counts = jnp.broadcast_to(n, mean.shape)
    return MomentState(count=counts, mean=mean, m2=m2)


def moments_merge(a: MomentState, b: MomentState) -> MomentState:
    """Chan et al. pairwise combine — associative, so usable in tree reductions."""
    n = a.count + b.count
    safe_n = jnp.where(n > 0, n, 1)
    delta = b.mean - a.mean
    w_b = b.count / safe_n
    mean = a.mean + delta * w_b
    m2 = a.m2 + b.m2 + jnp.square(delta) * a.count * w_b
    return MomentState(count=n, mean=mean, m2=m2)


def moments_reduce(states: MomentState) -> MomentState:
    """Merge a leading axis of states in a fixed pairwise-tree order.

    The tree depends only on the number of states, never on device layout, so
    the result is bitwise identical no matter where the blocks were computed.
    """
    count, mean, m2 = states
    n = count.shape[0]
    while n > 1:
        half = n // 2
        rest = (
            MomentState(count[2 * half :], mean[2 * half :], m2[2 * half :])
            if n % 2
            else None
        )
        merged = moments_merge(
            MomentState(count[0:2 * half:2], mean[0:2 * half:2], m2[0:2 * half:2]),
            MomentState(count[1:2 * half:2], mean[1:2 * half:2], m2[1:2 * half:2]),
        )
        if rest is not None:
            merged = MomentState(
                jnp.concatenate([merged.count, rest.count]),
                jnp.concatenate([merged.mean, rest.mean]),
                jnp.concatenate([merged.m2, rest.m2]),
            )
        count, mean, m2 = merged
        n = count.shape[0]
    return MomentState(count[0], mean[0], m2[0])


def tree_sum(x, axis=0):
    """Sum along ``axis`` in a fixed pairwise-tree order (adjacent pairing,
    odd leftover carried) — the plain-sum analogue of :func:`moments_reduce`.

    ``jnp.sum``'s re-association is a per-program compiler choice: the same
    (n_blocks, ...) partial-sum array summed in two different compiled
    programs (a shard_map shard program vs. a streaming closing reduction)
    can flip the last ULP.  Each level here is one elementwise add of two
    strided halves — an order XLA cannot legally re-associate — so engines
    that close over the same gathered partials with ``tree_sum`` agree
    bitwise (found as a 1-ULP flip in the AMC per-date gram closings,
    ``tests/test_amc_exposure.py::test_streaming_amc_bitwise...``).
    """
    x = jnp.moveaxis(jnp.asarray(x), axis, 0)
    n = x.shape[0]
    while n > 1:
        half = n // 2
        merged = x[0:2 * half:2] + x[1:2 * half:2]
        if n % 2:
            merged = jnp.concatenate([merged, x[2 * half:]])
        x = merged
        n = x.shape[0]
    return x[0]


def variance(state: MomentState, ddof: int = 0):
    denom = jnp.maximum(state.count - ddof, 1)
    return state.m2 / denom


def std(state: MomentState, ddof: int = 0):
    return jnp.sqrt(variance(state, ddof))


def std_error(state: MomentState):
    """Standard error of the mean — the Monte Carlo convergence metric."""
    return jnp.sqrt(variance(state, ddof=1) / jnp.maximum(state.count, 1))
