"""Property-based tests (hypothesis) for the algebraic invariants the
framework's determinism rests on: merge laws, shard decompositions, RNG
purity."""

import numpy as np
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from montecarlo.rng import normal_draw
from montecarlo.stats import (
    moments_from_array,
    moments_merge,
    moments_reduce,
    sketch_from_array,
    sketch_merge,
    variance,
)

_settings = settings(max_examples=10, deadline=None)


@_settings
@given(st.integers(1, 200), st.integers(1, 200), st.integers(0, 2**31))
def test_moment_merge_is_exact_concatenation(n_a, n_b, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(rng.uniform(-5, 5), rng.uniform(0.1, 3), n_a)
    b = rng.normal(rng.uniform(-5, 5), rng.uniform(0.1, 3), n_b)
    merged = moments_merge(moments_from_array(jnp.asarray(a)),
                           moments_from_array(jnp.asarray(b)))
    both = np.concatenate([a, b])
    assert np.isclose(float(merged.mean), both.mean(), rtol=1e-9, atol=1e-12)
    assert np.isclose(float(variance(merged)), both.var(), rtol=1e-8,
                      atol=1e-12)


@_settings
@given(st.integers(1, 32), st.integers(8, 256), st.integers(0, 2**31))
def test_moments_reduce_any_block_count(n_blocks, block, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_blocks, block))
    st_ = moments_reduce(moments_from_array(jnp.asarray(x), axis=-1))
    flat = x.ravel()
    assert np.isclose(float(st_.mean), flat.mean(), rtol=1e-9, atol=1e-12)
    assert int(st_.count) == flat.size


@_settings
@given(st.integers(2, 6), st.integers(0, 2**31))
def test_sketch_merge_associative_and_exact(n_parts, seed):
    rng = np.random.default_rng(seed)
    parts = [rng.normal(50, 10, rng.integers(10, 500))
             for _ in range(n_parts)]
    mk = lambda x: sketch_from_array(jnp.asarray(x, jnp.float64), 0.0, 100.0,
                                     128, jnp.float64)
    left = mk(parts[0])
    for p in parts[1:]:
        left = sketch_merge(left, mk(p))
    allv = mk(np.concatenate(parts))
    np.testing.assert_array_equal(np.asarray(left.counts),
                                  np.asarray(allv.counts))
    assert float(left.total) == float(allv.total)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(0, 1000),
       st.lists(st.integers(0, 2**20), min_size=1, max_size=6, unique=True))
def test_rng_purity_arbitrary_id_sets(seed, draw_idx, ids):
    """Draws are a pure function of (seed, id, index) — any slicing,
    ordering, or duplication of the id set returns the same values."""
    arr = jnp.asarray(ids, jnp.uint32)
    a = np.asarray(normal_draw(seed, 0, arr, draw_idx))
    perm = np.random.default_rng(0).permutation(len(ids))
    b = np.asarray(normal_draw(seed, 0, arr[perm], draw_idx))
    np.testing.assert_array_equal(a[perm], b)
    one_by_one = np.asarray([float(normal_draw(seed, 0,
                                               jnp.uint32(i), draw_idx))
                             for i in ids])
    np.testing.assert_array_equal(a, one_by_one)
