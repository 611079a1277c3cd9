"""QMC through the RISK engines (round 5): the sampler seam in
exposure/netting/credit/VaR, the replicate-spread RQMC wrappers, the
measured variance reduction (>= 2x std-err at equal paths on a
netting-set CVA and a tranche par spread), and the sharded twins'
bitwise mesh invariance with a Sobol table as the draw provider."""

import numpy as np
import pytest
import jax.numpy as jnp

from montecarlo.engine.credit import (CopulaSobolSampler, cdo_tranche,
                                          credit_rqmc,
                                          tranche_spread_exact)
from montecarlo.engine.exposure import (netting_set_profile,
                                            netting_set_profile_rqmc,
                                            swap_value_fn)
from montecarlo.processes import Vasicek
from montecarlo.samplers import SobolSampler

T, N_STEPS = 2.0, 10
R0, KAPPA, THETA, SIG = 0.03, 0.6, 0.04, 0.012


def _book(n_pay=4):
    model = Vasicek.create(R0, KAPPA, THETA, SIG, T / N_STEPS,
                           dtype=jnp.float64)
    pay = np.arange(1, n_pay + 1) * (T / n_pay)
    return model, (swap_value_fn(model, 0.035, pay, T / n_pay),
                   lambda r, t: -0.5 * swap_value_fn(
                       model, 0.04, pay[:2], T / n_pay)(r, t))


def test_netting_rqmc_beats_plain_mc_2x():
    """The round-5 deliverable, measured: scrambled-Sobol replicates of
    the netting-set CVA have >= 2x smaller replicate spread than plain-MC
    replicates at EQUAL total paths (the QMC win the risk engines were
    leaving on the table)."""
    model, trades = _book()
    n_rep, per = 6, 512
    kw = dict(T=T, seed=3, hazard_rate=0.02, funding_spread=0.004)

    res = netting_set_profile_rqmc(model, trades, n_rep * per, N_STEPS,
                                   n_replicates=n_rep, qmc_seed=11, **kw)
    # Plain-MC replicates: independent seeds, same per-replicate size.
    plain = [float(netting_set_profile(model, trades, per, N_STEPS,
                                       **{**kw, "seed": 100 + r})["cva"])
             for r in range(n_rep)]
    se_plain = np.std(plain, ddof=1) / np.sqrt(n_rep)
    se_sobol = float(res["cva_std_err"])
    assert se_sobol > 0
    ratio = se_plain / se_sobol
    assert ratio >= 2.0, (se_plain, se_sobol, ratio)
    # And the estimates agree (Sobol is unbiased): within joint bars.
    gap = abs(float(res["cva"]) - np.mean(plain))
    assert gap < 4.0 * (se_plain + se_sobol), (gap, se_plain, se_sobol)


def test_netting_profile_sampler_seam_smoke():
    """netting_set_profile(sampler=Sobol) runs, reports every key, and
    lands near the plain-MC estimate."""
    model, trades = _book()
    smp = SobolSampler.for_process(model, 2048, N_STEPS, seed=5)
    kw = dict(T=T, seed=3, hazard_rate=0.02, im_spread=0.003,
              wwr_beta=0.5)
    q = netting_set_profile(model, trades, 2048, N_STEPS, sampler=smp,
                            **kw)
    p = netting_set_profile(model, trades, 2048, N_STEPS, **kw)
    for k in ("cva", "mva", "cva_wwr"):
        assert np.isfinite(float(q[k])), k
        # Same order of magnitude — a corrupted-draw regression guard.
        assert abs(float(q[k]) - float(p[k])) < 0.5 * abs(float(p[k])) \
            + 1e-7, (k, float(q[k]), float(p[k]))


def test_sharded_netting_sobol_bitwise_and_matches_unsharded():
    """A Sobol table as the sharded engine's draw provider: rows are
    indexed by GLOBAL path id, so profiles stay bitwise mesh-invariant
    and match the unsharded engine under the SAME table."""
    from montecarlo.parallel import make_mesh, sharded_netting_profile

    model, trades = _book()
    n = 2048
    smp = SobolSampler.for_process(model, n, N_STEPS, seed=5)
    kw = dict(T=T, seed=3, hazard_rate=0.02, funding_spread=0.004)
    got = {m: sharded_netting_profile(model, trades, n, N_STEPS,
                                      mesh=make_mesh(m), block_size=256,
                                      pfe_bins=64, sampler=smp, **kw)
           for m in (1, 4)}
    for k, v in got[1].items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(got[4][k]),
                                      err_msg=k)
    want = netting_set_profile(model, trades, n, N_STEPS, sampler=smp,
                               **kw)
    np.testing.assert_allclose(np.asarray(got[4]["epe"]),
                               np.asarray(want["epe"]), rtol=1e-11,
                               atol=1e-14)
    np.testing.assert_allclose(float(got[4]["cva"]), float(want["cva"]),
                               rtol=1e-10, atol=1e-15)


_POOL = dict(attach=0.0, detach=0.03, T=5.0, n_steps=10, seed=3,
             recovery=0.4)


def test_tranche_rqmc_beats_plain_mc_2x_and_hits_oracle():
    """The second round-5 deliverable: the equity-tranche par spread
    under CopulaSobolSampler replicates — >= 2x smaller std-err than the
    plain engine's own iid bar at equal paths, and the estimate lands on
    the exact Gauss-Hermite x binomial oracle within joint bars."""
    hz, rho, n_names = 0.02, 0.3, 16
    hazards = [hz] * n_names
    n_paths = 1 << 13
    plain = cdo_tranche(hazards, rho, n_paths=n_paths, **_POOL)
    q = credit_rqmc(hazards, rho, product="tranche", n_paths=n_paths,
                    n_replicates=8, qmc_seed=7, **_POOL)
    se_plain = float(plain["par_spread_std_err"])
    se_sobol = float(q["par_spread_std_err"])
    assert se_sobol > 0
    assert se_plain / se_sobol >= 2.0, (se_plain, se_sobol)
    oracle = tranche_spread_exact(
        hz, rho, n_names=n_names, attach=_POOL["attach"],
        detach=_POOL["detach"], T=_POOL["T"], n_steps=_POOL["n_steps"],
        recovery=_POOL["recovery"])["par_spread"]
    assert abs(float(q["par_spread"]) - float(oracle)) \
        < 4.0 * se_sobol + 1e-12, (float(q["par_spread"]), float(oracle))


def test_copula_sampler_validation():
    smp = CopulaSobolSampler.create(8, 256, seed=0)
    with pytest.raises(ValueError, match="names"):
        cdo_tranche([0.02] * 4, 0.3, n_paths=256, sampler=smp, **_POOL)
    with pytest.raises(ValueError, match="mixing"):
        cdo_tranche([0.02] * 8, 0.3, n_paths=256, sampler=smp,
                    copula="student-t", df=4, **_POOL)


def test_sharded_credit_sobol_bitwise():
    """CopulaSobolSampler through the sharded credit twin: global-path-id
    row gathers keep the legs bitwise mesh-invariant and equal to the
    unsharded pricer under the same table (to reassociation noise)."""
    from montecarlo.parallel import make_mesh, sharded_credit_legs

    hazards = [0.02] * 8
    n = 2048
    smp = CopulaSobolSampler.create(8, n, seed=4)
    kw = dict(T=5.0, seed=3, product="tranche", attach=0.0, detach=0.03,
              block_size=256, sampler=smp)
    got = {m: sharded_credit_legs(hazards, 0.3, n, 10,
                                  mesh=make_mesh(m), **kw)
           for m in (1, 4)}
    for k, v in got[1].items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(got[4][k]),
                                      err_msg=k)
    want = cdo_tranche(hazards, 0.3, n_paths=n, sampler=smp, **_POOL)
    np.testing.assert_allclose(float(got[4]["par_spread"]),
                               float(want["par_spread"]), rtol=1e-12)


def test_portfolio_var_sampler_seam():
    """portfolio_var(sampler=...) drives the GARCH-bootstrap process
    through the mixed-slot Sobol table (the uniform slots the reference's
    np.random.choice seam maps to) and lands near the plain estimate."""
    from montecarlo.api.var import portfolio_var
    from montecarlo.processes import GBM

    proc = GBM.create(100.0, 0.05, 0.2, 1.0 / 252, dtype=jnp.float32)
    smp = SobolSampler.for_process(proc, 1 << 14, 20, seed=2,
                                   dtype=jnp.float32)
    q = portfolio_var(proc, 1 << 14, 20, 100.0, seed=3, sampler=smp)
    p = portfolio_var(proc, 1 << 14, 20, 100.0, seed=3)
    assert abs(q["var_95"] - p["var_95"]) < 0.1 * abs(p["var_95"]) + 0.5
    assert q["n_paths"] == 1 << 14
