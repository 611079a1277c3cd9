"""Mixed-draw Sobol QMC (samplers.MixedSobolSampler): QMC for processes
with uniform slots — jump counts (Merton/Kou/Bates), subordinator
inversions (VG/NIG), the QE variance branch, the GARCH bootstrap index.
Checks: slot-layout validation, marginal preservation through the
inverse transforms, unbiasedness + RQMC variance reduction vs plain MC,
and the CLI routing."""

import numpy as np
import jax.numpy as jnp
import pytest

from montecarlo.engine.simulate import simulate
from montecarlo.processes import HestonQE, Kou, Merton
from montecarlo.samplers import MixedSobolSampler, SobolSampler

MERTON = dict(s0=100.0, mu=0.03, sigma=0.2, lam=1.0, jump_mean=-0.05,
              jump_std=0.1)
T, STEPS, N = 1.0, 16, 4096


def _merton(dtype=jnp.float64):
    return Merton.create(dt=T / STEPS, dtype=dtype, **MERTON)


def test_for_process_routes_by_draw_kinds():
    from montecarlo.processes import GBM

    gbm = GBM.create(100.0, 0.03, 0.2, T / STEPS)
    assert isinstance(SobolSampler.for_process(gbm, 64, STEPS),
                      SobolSampler)
    s = SobolSampler.for_process(_merton(), 64, STEPS)
    assert isinstance(s, MixedSobolSampler)
    assert s.kinds == ("normal", "uniform", "normal")
    with pytest.raises(ValueError, match="bridge"):
        SobolSampler.for_process(_merton(), 64, STEPS, bridge=True)


def test_slot_layout_validated_against_process():
    kou = Kou.create(s0=100.0, mu=0.03, sigma=0.2, lam=1.0, p_up=0.4,
                     eta1=10.0, eta2=5.0, dt=T / STEPS)
    s_kou = SobolSampler.for_process(kou, 64, STEPS)
    with pytest.raises(ValueError, match="draw_kinds"):
        simulate(_merton(), 64, STEPS, seed=3, sampler=s_kou)
    # Step overflow is rejected, not clamp-gathered.
    with pytest.raises(ValueError, match="steps"):
        simulate(kou, 64, STEPS + 1, seed=3, sampler=s_kou)
    # The normals-only host sampler still refuses mixed processes.
    with pytest.raises(ValueError, match="non-normal"):
        simulate(kou, 64, STEPS, seed=3,
                 sampler=SobolSampler.create(64, STEPS, kou.n_draws))


def test_uniform_slots_preserve_the_jump_count_marginal():
    """The count slot receives a raw stratified uniform: the Poisson
    inverse CDF then reproduces the count distribution essentially
    exactly (QMC stratification beats the MC error on a marginal)."""
    proc = _merton()
    s = SobolSampler.for_process(proc, N, STEPS, seed=2)
    ids = jnp.arange(N, dtype=jnp.uint32)
    lam_dt = MERTON["lam"] * T / STEPS
    for t in (0, STEPS - 1):
        eps = s.draws(proc, 0, 0, ids, t, jnp.float64)
        counts = np.asarray(proc._poisson_count(eps[1], jnp.float64))
        assert abs(counts.mean() - lam_dt) < 3e-4  # se_mc ~ 3.9e-3
        # And the normal slots are standard normals.
        z = np.asarray(eps[0])
        assert abs(z.mean()) < 4.0 / np.sqrt(N)
        assert abs(z.std() - 1.0) < 4.0 / np.sqrt(2 * N)


def _replicated(proc, payoff, sampler_for, n_rep=8):
    ests = []
    for r in range(n_rep):
        s = np.asarray(simulate(proc, N, STEPS, seed=100 + r,
                                sampler=sampler_for(r), dtype=jnp.float64))
        ests.append(payoff(s).mean())
    return np.asarray(ests)


@pytest.mark.parametrize("which,ratio", [("merton", 0.5),
                                         ("heston-qe", 0.8)])
def test_qmc_is_unbiased_and_beats_plain_mc(which, ratio):
    """8 independent scrambles: the RQMC mean matches the oracle and the
    spread of replicate estimates is well under plain MC's (same paths,
    8 seeds) — jump counts and the QE variance uniform included.  The QE
    variance map is kinked (branch switch + mass at zero), so its QMC
    gain is smaller (~1.8x std here) than the smooth jump-diffusion's
    (>2x) — both real reductions."""
    if which == "merton":
        proc = _merton()
        from montecarlo.processes import merton_call_series

        oracle = float(merton_call_series(
            MERTON["s0"], 100.0, MERTON["mu"], MERTON["sigma"],
            MERTON["lam"], MERTON["jump_mean"], MERTON["jump_std"], T))
    else:
        proc = HestonQE.create(s0=100.0, v0=0.04, mu=0.03, kappa=0.5,
                               theta=0.04, xi=1.0, rho=-0.9,
                               dt=T / STEPS, dtype=jnp.float64)
        from montecarlo.engine.heston_analytic import (HestonParams,
                                                           heston_call_cf)

        oracle = float(heston_call_cf(
            100.0, 100.0, T, 0.03,
            HestonParams(v0=0.04, kappa=0.5, theta=0.04, xi=1.0,
                         rho=-0.9)))
    disc = np.exp(-0.03 * T)
    payoff = lambda s: disc * np.maximum(s - 100.0, 0.0)

    qmc = _replicated(proc, payoff,
                      lambda r: SobolSampler.for_process(
                          proc, N, STEPS, seed=10 + r))
    mc = _replicated(proc, payoff, lambda r: None)
    se_qmc = qmc.std(ddof=1) / np.sqrt(len(qmc))
    assert abs(qmc.mean() - oracle) <= 5.0 * se_qmc
    assert qmc.std(ddof=1) < ratio * mc.std(ddof=1), (qmc.std(), mc.std())


def test_cli_jump_qmc(capsys):
    import json

    from montecarlo import cli

    assert cli.main(["price", "--process", "merton", "--sampler", "sobol",
                     "--paths", "4096", "--steps", "16"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["price"] > 0 and out["std_err"] > 0
    # Device Sobol stays normals-only in-kernel: still a clean rejection.
    with pytest.raises(SystemExit, match="sobol"):
        cli.main(["price", "--process", "merton", "--sampler",
                  "sobol-device", "--paths", "4096", "--steps", "16"])
