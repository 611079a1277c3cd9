"""Device-Sobol draws inside the fused path kernel (interpret mode):
parity with the scan engine, table-read equivalence, dispatch eligibility,
and the ndtri32 approximation quality."""

import jax.numpy as jnp
import numpy as np
import pytest

from montecarlo.engine import simulate
from montecarlo.engine.functionals import (ARITH_MEAN, RUNNING_MAX,
                                               _simulate_functionals)
from montecarlo.ops.fused_engine import (fused_functionals_pallas,
                                             fused_terminal_pallas)
from montecarlo.processes import GBM, Heston
from montecarlo.rng.sobol import (SobolDeviceSampler, _scrambled_uniform,
                                      _shifted_normal, direction_numbers,
                                      lms_scramble, sobol_bits)

N = 128 * 128


def _procs():
    return {
        "gbm": GBM.create(s0=100.0, mu=0.03, sigma=0.2, dt=1 / 252),
        "heston": Heston.create(s0=100.0, v0=0.04, mu=0.03, kappa=2.0,
                                theta=0.04, xi=0.5, rho=-0.7, dt=1 / 252),
    }


@pytest.mark.parametrize("name,n_draws", [("gbm", 1), ("heston", 2)])
@pytest.mark.parametrize("n_steps", [8, 9])
def test_fused_sobol_matches_scan_engine(name, n_draws, n_steps):
    proc = _procs()[name]
    sampler = SobolDeviceSampler.create(n_steps + 1, n_draws)
    ref = np.asarray(simulate(proc, N, n_steps, seed=5, sampler=sampler))
    ker = np.asarray(fused_terminal_pallas(
        proc, N, n_steps, seed=5, block=256, interpret=True,
        sampler=sampler))
    # Same values read through indexed loads vs gathers; only FMA
    # re-association can differ (same ULP budget as the rate processes).
    np.testing.assert_allclose(ker, ref, rtol=2e-6)


def test_fused_sobol_functionals_match_scan():
    proc = _procs()["gbm"]
    n_steps = 16
    sampler = SobolDeviceSampler.create(n_steps, 1)
    items = (("avg", ARITH_MEAN), ("mx", RUNNING_MAX))
    ref = _simulate_functionals(proc, N, n_steps, 7, 0, sampler,
                                jnp.float32, 0, items)
    ker = fused_functionals_pallas(proc, N, n_steps, seed=7,
                                   functional_items=items, block=256,
                                   interpret=True, sampler=sampler)
    for key in ("terminal", "avg", "mx"):
        np.testing.assert_allclose(np.asarray(ker[key]),
                                   np.asarray(ref[key]), rtol=2e-6,
                                   err_msg=key)


def test_fused_sobol_path_offset_invariance():
    proc = _procs()["gbm"]
    sampler = SobolDeviceSampler.create(8, 1)
    full = np.asarray(fused_terminal_pallas(
        proc, N, 8, seed=3, block=128, interpret=True, sampler=sampler))
    halves = [np.asarray(fused_terminal_pallas(
        proc, N // 2, 8, seed=3, path_offset=o, block=128,
        interpret=True, sampler=sampler)) for o in (0, N // 2)]
    np.testing.assert_array_equal(full, np.concatenate(halves))


def test_dispatch_eligibility():
    from montecarlo.engine.dispatch import _fusable_sampler

    gbm = _procs()["gbm"]
    heston = _procs()["heston"]
    ok = SobolDeviceSampler.create(16, 1)
    assert _fusable_sampler(ok, gbm, 16)
    assert not _fusable_sampler(ok, gbm, 17)       # table too small
    assert not _fusable_sampler(ok, heston, 16)    # needs 2 draws/step
    assert _fusable_sampler(SobolDeviceSampler.create(16, 2), heston, 16)
    assert _fusable_sampler(None, gbm, 1000)


def test_antithetic_plus_sampler_rejected():
    proc = _procs()["gbm"]
    sampler = SobolDeviceSampler.create(8, 1)
    with pytest.raises(ValueError):
        fused_terminal_pallas(proc, N, 8, seed=0, interpret=True,
                              antithetic=True, sampler=sampler)


def test_ndtri32_accuracy():
    from scipy.special import ndtri as sp_ndtri

    from montecarlo.rng.normal import ndtri32

    u = np.concatenate([np.linspace(2.0**-24, 1 - 2.0**-24, 30001),
                        2.0 ** -np.arange(2, 24.0),
                        1 - 2.0 ** -np.arange(2, 24.0)])
    got = np.asarray(ndtri32(jnp.asarray(u, jnp.float64), jnp.float64))
    assert np.max(np.abs(got - sp_ndtri(u))) < 1e-6  # AS241 PPND7 budget


def test_shifted_normal_edge_bits_finite():
    """Any Sobol integer under any Owen-hash key must map to a finite
    normal — the naive (x+0.5)*2^-30 mapping rounds to 1.0f and NaNs
    (the hashed u stays in the open interval by construction)."""
    x = jnp.asarray([0, 1, (1 << 30) - 2, (1 << 30) - 1], jnp.uint32)
    for key in (0, 1, 0xDEADBEEF, 0x7FFFFFFF):
        z = np.asarray(_shifted_normal(x, jnp.uint32(key), jnp.float32))
        assert np.isfinite(z).all(), key
    # The scramble still reaches the deep tails (top-23-bit resolution).
    xs = jnp.arange(1 << 16, dtype=jnp.uint32) << jnp.uint32(14)
    z = np.asarray(_shifted_normal(xs, jnp.uint32(123), jnp.float32))
    assert np.isfinite(z).all()
    assert z.min() < -4.0 and z.max() > 4.0


def test_owen_scramble_preserves_dyadic_strata():
    """The hash scramble must be a valid OWEN scramble: on each dyadic
    stratification level, the first 2^k points of any dimension still hit
    every stratum of width 2^-m EXACTLY 2^(k-m) times (m <= k).  A hash
    that mixed a bit with anything BELOW it would break this — silently
    degrading QMC convergence to plain-MC while every distributional test
    still passes.  Exact equidistribution is checked on raw Joe-Kuo and
    LMS-scrambled direction numbers, several dims and keys."""
    k = 12
    ids = jnp.arange(1 << k, dtype=jnp.uint32)
    sv_raw = direction_numbers(8)
    sv_lms = lms_scramble(sv_raw, seed=42)
    for sv in (sv_raw, sv_lms):
        for dim in (0, 1, 7):
            x = sobol_bits(jnp.asarray(sv[dim]), ids)
            for key in (0, 1, 0x9E3779B9):
                u = np.asarray(_scrambled_uniform(x, jnp.uint32(key)))
                assert ((u > 0) & (u < 1)).all()
                for m in (2, 6, 10):
                    counts = np.bincount((u * (1 << m)).astype(np.int64),
                                         minlength=1 << m)
                    np.testing.assert_array_equal(
                        counts, np.full(1 << m, 1 << (k - m)),
                        err_msg=f"dim={dim} key={key:#x} m={m}")


def test_owen_scramble_decorrelates_replicates():
    """Distinct keys must give (near-)independent randomizations, unlike
    the old XOR digital shift whose within-stratum offsets differed by a
    constant (pairwise correlation ~1 — the root cause of the
    replicate-spread underestimate).

    The null is NOT |r| ~ 1/sqrt(n): offsets of two INDEPENDENT Owen
    scrambles are permutations of the same sub-positions clustered by
    shared tree nodes, and measured truly-random nested scrambles of this
    exact point set show single-pair r up to +-0.23 (std 0.106).  So the
    test statistic is the MEAN signed correlation over all C(8,2)=28 key
    pairs (null std ~0.106/sqrt(28) ~ 0.02) plus a loose per-pair cap that
    any offset-sharing linear scheme still fails by an order of
    magnitude."""
    ids = jnp.arange(1 << 12, dtype=jnp.uint32)
    sv = direction_numbers(2)
    x = sobol_bits(jnp.asarray(sv[1]), ids)
    # Offset within the 2^-6-wide stratum, in [0, 1).
    def offsets(key):
        u = np.asarray(_scrambled_uniform(x, jnp.uint32(key)))
        return (u * 64.0) % 1.0
    keys = [7, 8, 9, 42, 0x1234, 0x9999, 0x9E3779B9, 1000003]
    offs = [offsets(k) for k in keys]
    rs = [np.corrcoef(offs[i], offs[j])[0, 1]
          for i in range(len(keys)) for j in range(i + 1, len(keys))]
    assert abs(np.mean(rs)) < 0.1, np.mean(rs)
    assert max(abs(r) for r in rs) < 0.5, rs


def test_short_table_rejected_everywhere():
    """A Sobol table smaller than n_steps*n_draws used to clamp the gather
    and silently reuse the last dimension — now every engine rejects it."""
    from montecarlo.rng.sobol import SobolBridgeDeviceSampler

    proc = _procs()["gbm"]
    small = SobolDeviceSampler.create(8, 1)
    with pytest.raises(ValueError, match="Sobol table"):
        simulate(proc, 256, 9, seed=0, sampler=small)
    with pytest.raises(ValueError, match="Sobol table"):
        fused_terminal_pallas(proc, N, 9, seed=0, interpret=True,
                              sampler=small)
    with pytest.raises(ValueError, match="bridge sampler"):
        simulate(proc, 256, 9, seed=0,
                 sampler=SobolBridgeDeviceSampler.create(8))


def test_plain_sampler_is_fusable():
    """The CLI's explicit --sampler plain default must ride the fused
    kernel exactly like sampler=None (identical pass-through streams)."""
    from montecarlo.engine.dispatch import (_fusable_sampler,
                                                _kernel_sampler)
    from montecarlo.samplers import PlainSampler

    gbm = _procs()["gbm"]
    assert _fusable_sampler(PlainSampler(), gbm, 252)
    assert _kernel_sampler(PlainSampler()) is None
