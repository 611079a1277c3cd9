"""Device gamma sampler (`rng/gamma.py`): quantile parity with f64 scipy,
boost-identity moments, KS at moderate and small shapes, and the
wide-range exp extension."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from montecarlo.rng.gamma import (expneg_wide32, gamma1p32,
                                      gamma_from_uniforms32,
                                      gamma_icdf_boost32)
from montecarlo.rng.normal import uniform_draw


def test_gamma1p32_vs_scipy():
    from scipy.special import gamma as gamma_fn

    a = np.linspace(0.0, 1.0, 101)
    got = np.asarray(gamma1p32(jnp.asarray(a, jnp.float32)))
    np.testing.assert_allclose(got, gamma_fn(1.0 + a), atol=5e-7, rtol=0)


def test_expneg_wide32_range():
    xs = np.concatenate([-np.geomspace(1e-3, 87.0, 200), [0.0]])
    got = np.asarray(expneg_wide32(jnp.asarray(xs, jnp.float32)))
    np.testing.assert_allclose(got, np.exp(xs), rtol=3e-6)
    # Past the f32 floor the correct graceful limit is 0, never inf/nan.
    deep = np.asarray(expneg_wide32(jnp.asarray([-200.0, -3000.0],
                                                jnp.float32)))
    assert np.all(deep == 0.0) or np.all(deep < 2e-38)


@pytest.mark.parametrize("b", [1.02, 1.2, 1.5, 1.8, 2.0])
def test_gamma_icdf_vs_scipy(b):
    """Quantile parity with f64 scipy over both tails.  The references are
    f32-faithful: the lower tail inverts P at u_f32, the upper tail inverts
    Q at (1 - u_f32) via gammainccinv — scipy's own gammaincinv loses ~1e-2
    relative accuracy for p near 1, so inverting the complement is the
    honest oracle there."""
    from scipy.special import gammainccinv, gammaincinv

    lo = np.geomspace(1e-6, 0.5, 50)
    hi = np.geomspace(6e-8, 0.5, 50)
    u = np.concatenate([lo, 1.0 - hi]).astype(np.float32)
    ref = np.concatenate([
        gammaincinv(b, lo.astype(np.float32).astype(np.float64)),
        gammainccinv(b, 1.0 - (1.0 - hi).astype(np.float32)
                     .astype(np.float64))])
    got = np.asarray(jax.vmap(gamma_icdf_boost32, in_axes=(None, 0))(
        jnp.float32(b), jnp.asarray(u)))
    np.testing.assert_allclose(got, ref, rtol=5e-6)


def _uniform_pairs(n, seed):
    ids = jnp.arange(n, dtype=jnp.uint32)
    u_w = uniform_draw(seed, 0, ids, jnp.uint32(0))
    u_b = uniform_draw(seed, 0, ids, jnp.uint32(1))
    return u_w, u_b


@pytest.mark.parametrize("a", [0.25, 0.7, 1.0])
def test_gamma_sample_moments(a):
    """Gamma(a, 1): mean a, variance a — end-to-end through the boost."""
    u_w, u_b = _uniform_pairs(1 << 16, seed=11)
    g = np.asarray(gamma_from_uniforms32(jnp.float32(a), u_w, u_b),
                   np.float64)
    n = g.size
    assert g.min() >= 0.0
    assert abs(g.mean() - a) < 5 * g.std() / np.sqrt(n)
    se_var = np.sqrt(((g - g.mean()) ** 4).mean() / n)
    assert abs(g.var() - a) < 5 * se_var


@pytest.mark.parametrize("a", [0.5, 0.9])
def test_gamma_sample_ks(a):
    from scipy.stats import kstest

    u_w, u_b = _uniform_pairs(1 << 14, seed=29)
    g = np.asarray(gamma_from_uniforms32(jnp.float32(a), u_w, u_b),
                   np.float64)
    res = kstest(g, "gamma", args=(a,))
    assert res.pvalue > 1e-4, res


def test_gamma_tiny_shape_tail_mass():
    """At a = 0.02 (daily VG grid) most of the distribution lives below
    f32 and rounds to 0 — by design.  The mass that matters (the fat right
    tail) must still match f64 scipy: compare survival fractions at a few
    thresholds, and the mean (dominated by the tail) must land."""
    from scipy.stats import gamma as gamma_dist

    a = 0.02
    u_w, u_b = _uniform_pairs(1 << 16, seed=5)
    g = np.asarray(gamma_from_uniforms32(jnp.float32(a), u_w, u_b),
                   np.float64)
    n = g.size
    for thr in (1e-6, 1e-3, 0.1):
        frac = (g > thr).mean()
        ref = gamma_dist.sf(thr, a)
        se = np.sqrt(ref * (1 - ref) / n)
        assert abs(frac - ref) < 5 * se + 1e-4, (thr, frac, ref)
    assert abs(g.mean() - a) < 5 * g.std() / np.sqrt(n)


def test_gamma_reflection_anticorrelates():
    """(1-u_w, 1-u_b) must produce a G strongly anticorrelated with the
    original — the antithetic contract VarianceGamma.antithetic relies on."""
    u_w, u_b = _uniform_pairs(1 << 14, seed=3)
    g = np.asarray(gamma_from_uniforms32(jnp.float32(0.5), u_w, u_b),
                   np.float64)
    g_anti = np.asarray(gamma_from_uniforms32(
        jnp.float32(0.5), 1.0 - u_w, 1.0 - u_b), np.float64)
    assert np.corrcoef(g, g_anti)[0, 1] < -0.3


@pytest.mark.parametrize("b", [1.02, 1.2, 1.5, 1.8, 2.0])
def test_gamma_table_vs_scipy(b):
    """The residual-table quantile (`gamma_from_uniforms_table32`, the VG
    hot path) against the same f32-faithful scipy oracles as the Newton
    path.  Body at the f32 floor; the last few representable u before the
    clip inherit ndtri32's tail error scaled by resid' (~1e-4 relative on
    a quantile drawn with probability ~1e-7 — invisible to MC)."""
    from scipy.special import gammainccinv, gammaincinv

    from montecarlo.rng.gamma import (gamma_from_uniforms_table32,
                                          gamma_icdf_resid_table64)

    z0, dz, resid, dresid = gamma_icdf_resid_table64(b)
    lo = np.geomspace(1e-6, 0.5, 50)
    hi = np.geomspace(1e-4, 0.5, 50)          # body + moderate tail
    deep = np.geomspace(6e-8, 1e-4, 20)       # deep upper tail, loose tol
    u = np.concatenate([lo, 1.0 - hi]).astype(np.float32)
    ref = np.concatenate([
        gammaincinv(b, lo.astype(np.float32).astype(np.float64)),
        gammainccinv(b, 1.0 - (1.0 - hi).astype(np.float32)
                     .astype(np.float64))])
    # u_boost = 1 makes the boost factor exactly 1: isolates the W part.
    got = np.asarray(gamma_from_uniforms_table32(
        jnp.float32(b - 1.0), jnp.asarray(u), jnp.ones_like(jnp.asarray(u)),
        z0, dz, jnp.asarray(resid), jnp.asarray(dresid)))
    np.testing.assert_allclose(got, ref, rtol=2e-6)
    u_deep = (1.0 - deep).astype(np.float32)
    ref_deep = gammainccinv(b, 1.0 - u_deep.astype(np.float64))
    got_deep = np.asarray(gamma_from_uniforms_table32(
        jnp.float32(b - 1.0), jnp.asarray(u_deep),
        jnp.ones_like(jnp.asarray(u_deep)), z0, dz, jnp.asarray(resid),
        jnp.asarray(dresid)))
    np.testing.assert_allclose(got_deep, ref_deep, rtol=5e-4)


def test_gamma_table_matches_newton_in_block_layout():
    """A 2-D block of paths evaluates bitwise like the flat 1-D array
    (table reads are plain gathers either way), and both agree with the
    Newton path to the documented tolerance."""
    from montecarlo.rng.gamma import (gamma_from_uniforms_table32,
                                          gamma_icdf_resid_table64)

    a = 0.04
    z0, dz, resid, dresid = gamma_icdf_resid_table64(1.0 + a)
    u_w, u_b = _uniform_pairs(1 << 12, seed=23)
    flat = gamma_from_uniforms_table32(jnp.float32(a), u_w, u_b, z0, dz,
                                       jnp.asarray(resid),
                                       jnp.asarray(dresid))
    blocked = gamma_from_uniforms_table32(
        jnp.float32(a), u_w.reshape(32, 128), u_b.reshape(32, 128), z0, dz,
        jnp.asarray(resid), jnp.asarray(dresid))
    np.testing.assert_array_equal(np.asarray(flat),
                                  np.asarray(blocked).reshape(-1))
    newton = gamma_from_uniforms32(jnp.float32(a), u_w, u_b)
    mask = np.asarray(newton) > 1e-20  # below: both underflow-dominated
    rel = np.abs(np.asarray(flat)[mask] - np.asarray(newton)[mask]) \
        / np.asarray(newton)[mask]
    assert rel.max() < 5e-5, rel.max()
