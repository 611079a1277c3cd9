"""RNG layer tests: cipher correctness, distribution quality, reproducibility."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from montecarlo.rng import (
    categorical_draw,
    normal_draw,
    normal_matrix,
    random_bits,
    threefry2x32,
    uniform_draw,
    uniform_from_bits,
)


def test_threefry_matches_jax_reference():
    """Our Threefry-2x32 must agree bit-for-bit with JAX's own implementation."""
    prng = pytest.importorskip("jax._src.prng")
    rng = np.random.default_rng(0)
    k = rng.integers(0, 2**32, size=2, dtype=np.uint32)
    c0 = rng.integers(0, 2**32, size=128, dtype=np.uint32)
    c1 = rng.integers(0, 2**32, size=128, dtype=np.uint32)

    ours0, ours1 = threefry2x32(k[0], k[1], c0, c1)
    theirs = prng.threefry_2x32(jnp.asarray(k), jnp.concatenate(
        [jnp.asarray(c0), jnp.asarray(c1)]))
    theirs0, theirs1 = theirs[:128], theirs[128:]
    np.testing.assert_array_equal(np.asarray(ours0), np.asarray(theirs0))
    np.testing.assert_array_equal(np.asarray(ours1), np.asarray(theirs1))


def test_threefry_known_answer_vectors():
    """Random123 published known-answer tests for Threefry-2x32, 20 rounds."""
    # counter=(0,0), key=(0,0)
    x0, x1 = threefry2x32(0, 0, 0, 0)
    assert (int(x0), int(x1)) == (0x6B200159, 0x99BA4EFE)
    # counter=(0xffffffff, 0xffffffff), key=(0xffffffff, 0xffffffff)
    x0, x1 = threefry2x32(0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF)
    assert (int(x0), int(x1)) == (0x1CB996FC, 0xBB002BE7)
    # counter=(0x243f6a88, 0x85a308d3), key=(0x13198a2e, 0x03707344)
    x0, x1 = threefry2x32(0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3)
    assert (int(x0), int(x1)) == (0xC4923A9C, 0x483DF7A0)


def test_uniform_open_interval():
    bits = jnp.array([0, 1, 2**32 - 1, 2**31], dtype=jnp.uint32)
    u = uniform_from_bits(bits)
    assert np.all(np.asarray(u) > 0.0)
    assert np.all(np.asarray(u) < 1.0)


def test_normal_moments():
    n = 1 << 20
    ids = jnp.arange(n, dtype=jnp.uint32)
    z = np.asarray(normal_draw(seed=42, stream=0, path_ids=ids, draw_index=0))
    se = 1.0 / np.sqrt(n)
    assert abs(z.mean()) < 5 * se
    assert abs(z.std() - 1.0) < 5 * se
    # Excess kurtosis of a standard normal is 0; std-err ~ sqrt(24/n).
    kurt = ((z - z.mean()) ** 4).mean() / z.var() ** 2 - 3.0
    assert abs(kurt) < 5 * np.sqrt(24.0 / n)


def test_consecutive_draws_consume_both_halves():
    """Draws m and m+1 (even m) come from one cipher call but must differ."""
    ids = jnp.arange(1024, dtype=jnp.uint32)
    z0 = np.asarray(normal_draw(7, 0, ids, 0))
    z1 = np.asarray(normal_draw(7, 0, ids, 1))
    z2 = np.asarray(normal_draw(7, 0, ids, 2))
    assert not np.allclose(z0, z1)
    assert not np.allclose(z0, z2)
    # Correlation between the Box-Muller cos/sin halves should be tiny.
    assert abs(np.corrcoef(z0, z1)[0, 1]) < 0.1


def test_streams_are_independent():
    ids = jnp.arange(4096, dtype=jnp.uint32)
    a = np.asarray(normal_draw(3, 0, ids, 5))
    b = np.asarray(normal_draw(3, 1, ids, 5))
    assert not np.allclose(a, b)
    assert abs(np.corrcoef(a, b)[0, 1]) < 0.1


def test_draws_shard_invariant():
    """Splitting the path axis must not change any draw (counter-based)."""
    ids = jnp.arange(8192, dtype=jnp.uint32)
    full = np.asarray(normal_draw(11, 0, ids, 3))
    parts = [
        np.asarray(normal_draw(11, 0, ids[i : i + 1024], 3))
        for i in range(0, 8192, 1024)
    ]
    np.testing.assert_array_equal(full, np.concatenate(parts))


def test_normal_matrix_convention():
    """normal_matrix(t, D) must equal elementwise normal_draw at m = t*D + d."""
    ids = jnp.arange(128, dtype=jnp.uint32)
    D, t = 3, 7
    mat = np.asarray(normal_matrix(99, 0, ids, t=t, n_draws=D))
    for d in range(D):
        ref = np.asarray(normal_draw(99, 0, ids, t * D + d))
        np.testing.assert_array_equal(mat[:, d], ref)


def test_categorical_uniformity():
    n_cat = 17
    ids = jnp.arange(1 << 16, dtype=jnp.uint32)
    idx = np.asarray(categorical_draw(5, 2, ids, 0, n_cat))
    assert idx.min() >= 0 and idx.max() < n_cat
    counts = np.bincount(idx, minlength=n_cat)
    expected = len(idx) / n_cat
    # chi-square-ish sanity: each bin within 5 sigma of expectation
    assert np.all(np.abs(counts - expected) < 5 * np.sqrt(expected))


def test_jit_and_eager_agree():
    ids = jnp.arange(2048, dtype=jnp.uint32)
    eager = normal_draw(1, 0, ids, 4)
    jitted = jax.jit(lambda i: normal_draw(1, 0, i, 4))(ids)
    np.testing.assert_array_equal(np.asarray(eager), np.asarray(jitted))


def test_uniform_draw_moments():
    ids = jnp.arange(1 << 18, dtype=jnp.uint32)
    u = np.asarray(uniform_draw(21, 0, ids, 0))
    n = len(u)
    assert abs(u.mean() - 0.5) < 5 / np.sqrt(12 * n)
    assert abs(u.var() - 1 / 12) < 5e-3


def test_random_bits_shapes_broadcast():
    b0, b1 = random_bits(0, 0, jnp.zeros((4, 8), jnp.uint32), jnp.uint32(3))
    assert b0.shape == (4, 8) and b1.shape == (4, 8)


# --- accurate f32 elementary functions (exp32 / log32) -------------------
#
# An approximate runtime f32 log that is tens of ULPs off at price-scale
# arguments, or an exp biased ~1e-6 relative, becomes through the ~50x spot
# sensitivity of a 1y call a ~1e-3 price bias — hundreds of sigma under the
# bridge-RQMC error bar.  exp32/log32 (rng/normal.py) are IEEE-exact-
# composed and bitwise identical on every backend; these tests pin their
# accuracy so a future "simplification" back to jnp.exp/jnp.log fails
# loudly.

from montecarlo.rng.normal import exp32, log32  # noqa: E402


def test_exp32_accuracy_and_mean_bias():
    rng = np.random.default_rng(0)
    x = rng.uniform(-20, 20, 500_000).astype(np.float32)
    got = np.asarray(jax.jit(exp32)(x), np.float64)
    exact = np.exp(x.astype(np.float64))
    rel = (got - exact) / exact
    assert np.abs(rel).max() < 2.5e-7, np.abs(rel).max()  # ~2 ULP
    # Mean bias ~0 (a runtime exp biased by 1e-6 would compound per step /
    # per path).
    assert abs(rel.mean()) < 1e-8, rel.mean()


def test_log32_accuracy_and_mean_bias():
    for lo, hi in ((1e-7, 1.0), (0.5, 500.0)):
        v = np.linspace(lo, hi, 500_001).astype(np.float32)
        got = np.asarray(jax.jit(log32)(v), np.float64)
        d = got - np.log(v.astype(np.float64))
        assert np.abs(d).max() < 6e-7, (lo, hi, np.abs(d).max())
        assert abs(d.mean()) < 2e-8, (lo, hi, d.mean())
    # The headline case of the bug:
    err100 = float(jax.jit(log32)(jnp.float32(100.0))) - np.log(100.0)
    assert abs(err100) < 3e-7, err100


def test_exp32_log32_domain_clamps_and_f64_passthrough():
    # Out-of-domain inputs clamp instead of overflowing/NaN-ing.
    assert np.isfinite(float(exp32(jnp.float32(100.0))))
    assert float(exp32(jnp.float32(100.0))) == float(exp32(jnp.float32(20.0)))
    assert np.isfinite(float(log32(jnp.float32(0.0))))
    # Round-trip consistency inside the domain.
    v = jnp.float32(123.456)
    assert abs(float(exp32(log32(v))) - 123.456) < 1e-3
    # f64 inputs delegate to the (accurate) runtime functions, preserving
    # the x64 oracle paths' precision.
    x64 = jnp.asarray(1.2345678901234567, jnp.float64)
    if x64.dtype == jnp.float64:  # only under jax_enable_x64
        np.testing.assert_allclose(float(log32(x64)),
                                   np.log(1.2345678901234567), rtol=1e-15)
        np.testing.assert_allclose(float(exp32(x64)),
                                   np.exp(1.2345678901234567), rtol=1e-15)


def test_exp32_log32_pallas_lowering():
    """Interpret-mode Pallas lowering must agree with plain XLA exactly
    (on the card, chip_smoke.py's kernel phase checks the compiled
    kernels, which call these functions, against the scan engine)."""
    from jax.experimental import pallas as pl

    x = np.linspace(-18.0, 18.0, 8 * 128).astype(np.float32).reshape(8, 128)
    v = np.linspace(0.01, 400.0, 8 * 128).astype(np.float32).reshape(8, 128)

    def kexp(x_ref, o_ref):
        o_ref[...] = exp32(x_ref[...])

    def klog(x_ref, o_ref):
        o_ref[...] = log32(x_ref[...])

    run = lambda body, a: pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct(a.shape, a.dtype),
        interpret=True)(a)
    np.testing.assert_array_equal(np.asarray(run(kexp, jnp.asarray(x))),
                                  np.asarray(jax.jit(exp32)(x)))
    np.testing.assert_array_equal(np.asarray(run(klog, jnp.asarray(v))),
                                  np.asarray(jax.jit(log32)(v)))
