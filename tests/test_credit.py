"""Portfolio credit (Gaussian copula): MC vs EXACT semi-analytic oracles.

For a HOMOGENEOUS pool the one-factor copula is exactly integrable:
conditional on the factor M, defaults are iid Bernoulli(p_t(M)) with
``p_t(m) = Phi((C_t - sqrt(rho) m) / sqrt(1 - rho))``, so the default
count is Binomial(N, p_t(M)) and any payoff of the count/loss integrates
over M by Gauss-Hermite quadrature to machine precision.  The oracle
below reproduces the ENGINE'S OWN leg discretization (midpoint
protection, average-outstanding premium), so every comparison is exact
math vs MC noise — the tolerance is the estimator's reported error bar.
"""

import numpy as np
import pytest
import scipy.stats as st
import jax.numpy as jnp

from montecarlo.engine.credit import cdo_tranche, kth_to_default_cds

N_NAMES, HAZ, REC, RHO = 20, 0.02, 0.4, 0.3
T, N_STEPS, N_PATHS, SEED = 5.0, 20, 1 << 16, 11
RATE = 0.03


def _gh_factor(n_nodes=160):
    """Nodes/weights for E[f(M)], M ~ N(0,1), via Gauss-Hermite."""
    x, w = np.polynomial.hermite.hermgauss(n_nodes)
    return np.sqrt(2.0) * x, w / np.sqrt(np.pi)


def _p_cond(times, rho, m):
    """p_t(m): conditional default probability, (dates, nodes)."""
    c = st.norm.ppf(1.0 - np.exp(-HAZ * times))          # (dates,)
    with np.errstate(invalid="ignore"):
        z = (c[:, None] - np.sqrt(rho) * m[None, :]) / np.sqrt(1.0 - rho)
    return np.where(np.isneginf(c)[:, None], 0.0, st.norm.cdf(z))


def _legs(e_profile, times, dt):
    """The engine's leg discretization applied to an expected profile
    (both legs are linear in the profile, so expectations commute)."""
    disc_end = np.exp(-RATE * times[1:])
    disc_mid = np.exp(-RATE * (times[1:] - 0.5 * dt))
    prot = np.sum(disc_mid * np.diff(e_profile))
    return prot, disc_end, disc_mid


def _oracle_tranche(attach, detach, rho):
    times = np.arange(N_STEPS + 1) * (T / N_STEPS)
    dt = T / N_STEPS
    m, w = _gh_factor()
    p = _p_cond(times, rho, m)                           # (dates, nodes)
    counts = np.arange(N_NAMES + 1)
    loss = counts * (1.0 - REC) / N_NAMES
    tl = np.clip(loss - attach, 0.0, detach - attach)    # (counts,)
    pmf = st.binom.pmf(counts[None, None, :], N_NAMES, p[:, :, None])
    e_tl = np.einsum("tnc,c,n->t", pmf, tl, w)           # (dates,)
    prot, disc_end, _ = _legs(e_tl, times, dt)
    out = (detach - attach) - e_tl
    prem = np.sum(disc_end * dt * 0.5 * (out[1:] + out[:-1]))
    return e_tl, prot, prem


def _oracle_kth(k, rho):
    times = np.arange(N_STEPS + 1) * (T / N_STEPS)
    dt = T / N_STEPS
    m, w = _gh_factor()
    p = _p_cond(times, rho, m)
    hit = st.binom.sf(k - 1, N_NAMES, p) @ w             # P(count >= k)
    prot_raw, disc_end, disc_mid = _legs(hit, times, dt)
    prot = (1.0 - REC) * prot_raw
    prem = np.sum(disc_end * dt * (1.0 - hit[1:])) \
        + np.sum(disc_mid * 0.5 * dt * np.diff(hit))
    return hit, prot, prem


def test_tranche_matches_exact_conditional_binomial():
    """Mezzanine tranche on the homogeneous pool: per-date expected
    tranche loss, both legs, and the par spread agree with the exact
    Gauss-Hermite x binomial oracle within the estimator's own bars."""
    a, b = 0.03, 0.10
    res = cdo_tranche([HAZ] * N_NAMES, RHO, attach=a, detach=b, T=T,
                      n_steps=N_STEPS, n_paths=N_PATHS, seed=SEED,
                      rate=RATE, recovery=REC)
    e_tl, prot, prem = _oracle_tranche(a, b, RHO)
    el = np.asarray(res["expected_loss"])
    se = np.asarray(res["expected_loss_std_err"])
    assert np.all(np.abs(el - e_tl) <= 4.0 * se + 1e-12)
    assert abs(float(res["protection_leg"]) - prot) \
        <= 4.0 * float(res["protection_leg_std_err"])
    assert abs(float(res["premium_leg_per_spread"]) - prem) \
        <= 4.0 * float(res["premium_leg_std_err"])
    assert abs(float(res["par_spread"]) - prot / prem) \
        <= 4.0 * float(res["par_spread_std_err"])
    # The bars themselves are sane: a mezz tranche spread is O(1e-3) with
    # a sub-10% relative error at 2^16 paths.
    assert float(res["par_spread_std_err"]) \
        < 0.1 * float(res["par_spread"])


def test_kth_to_default_exact_oracle_and_limits():
    """2nd-to-default at rho=0.35 vs the exact binomial-tail oracle;
    rho=0 & k=1 reproduces the independent first-to-default closed form;
    rho=1 collapses every k to the same record bitwise (all names
    default together on a homogeneous pool)."""
    res = kth_to_default_cds([HAZ] * N_NAMES, 0.35, k=2, T=T,
                             n_steps=N_STEPS, n_paths=N_PATHS, seed=SEED,
                             rate=RATE, recovery=REC)
    hit, prot, prem = _oracle_kth(2, 0.35)
    el = np.asarray(res["expected_loss"])
    se = np.asarray(res["expected_loss_std_err"])
    assert np.all(np.abs(el - hit) <= 4.0 * se + 1e-12)
    assert abs(float(res["par_spread"]) - prot / prem) \
        <= 4.0 * float(res["par_spread_std_err"])

    # rho -> 0, k = 1: basket survival exp(-sum h_i t) EXACTLY.
    r0 = kth_to_default_cds([HAZ] * N_NAMES, 0.0, k=1, T=T,
                            n_steps=N_STEPS, n_paths=N_PATHS, seed=SEED,
                            rate=RATE, recovery=REC)
    times = np.arange(N_STEPS + 1) * (T / N_STEPS)
    hit1 = 1.0 - np.exp(-N_NAMES * HAZ * times)
    el0 = np.asarray(r0["expected_loss"])
    se0 = np.asarray(r0["expected_loss_std_err"])
    assert np.all(np.abs(el0 - hit1) <= 4.0 * se0 + 1e-12)

    # rho = 1 (comonotone): count is {0, N}, so k = 1 and k = 17 trigger
    # identically — records bitwise equal.
    ra = kth_to_default_cds([HAZ] * N_NAMES, 1.0, k=1, T=T,
                            n_steps=N_STEPS, n_paths=4096, seed=SEED,
                            rate=RATE, recovery=REC)
    rb = kth_to_default_cds([HAZ] * N_NAMES, 1.0, k=17, T=T,
                            n_steps=N_STEPS, n_paths=4096, seed=SEED,
                            rate=RATE, recovery=REC)
    for key in ("par_spread", "protection_leg", "premium_leg_per_spread"):
        assert float(ra[key]) == float(rb[key]), key
    # ... and the comonotone basket IS the single-name curve
    # P(count >= k) = 1 - exp(-h t).
    hit_c = 1.0 - np.exp(-HAZ * times)
    ela = np.asarray(ra["expected_loss"])
    sea = np.asarray(ra["expected_loss_std_err"])
    assert np.all(np.abs(ela - hit_c) <= 4.0 * sea + 1e-12)


def test_capital_structure_additivity():
    """Tranches spanning [0, 1-R] decompose the portfolio loss exactly:
    the per-date expected tranche losses sum to the expected portfolio
    loss (pathwise identity, so equality is to float-summation noise)."""
    edges = [0.0, 0.03, 0.07, 0.15, 1.0 - REC]
    kw = dict(T=T, n_steps=N_STEPS, n_paths=8192, seed=SEED, rate=RATE,
              recovery=REC)
    tranches = [cdo_tranche([HAZ] * N_NAMES, RHO, attach=a, detach=b,
                            **kw)
                for a, b in zip(edges[:-1], edges[1:])]
    total_el = sum(np.asarray(t["expected_loss"]) for t in tranches)
    full = cdo_tranche([HAZ] * N_NAMES, RHO, attach=0.0,
                       detach=1.0 - REC, **kw)
    np.testing.assert_allclose(total_el,
                               np.asarray(full["expected_loss"]),
                               rtol=1e-12, atol=1e-14)


def test_heterogeneous_pool_and_determinism():
    """Per-name hazards/recoveries/weights run; same seed is bitwise
    reproducible; rho is a real dependence knob (equity tranche loses
    value as rho rises — the classic correlation direction)."""
    haz = np.linspace(0.005, 0.05, N_NAMES)
    rec = np.linspace(0.3, 0.5, N_NAMES)
    w = np.full(N_NAMES, 1.0 / N_NAMES)
    kw = dict(attach=0.0, detach=0.03, T=T, n_steps=N_STEPS,
              n_paths=8192, seed=SEED, rate=RATE)
    r1 = cdo_tranche(haz, RHO, recovery=rec, weights=w, **kw)
    r2 = cdo_tranche(haz, RHO, recovery=rec, weights=w, **kw)
    assert float(r1["par_spread"]) == float(r2["par_spread"])
    lo = cdo_tranche(haz, 0.05, recovery=rec, weights=w, **kw)
    hi = cdo_tranche(haz, 0.7, recovery=rec, weights=w, **kw)
    assert float(lo["par_spread"]) > float(hi["par_spread"])


def test_sharded_credit_bitwise_mesh_invariant_and_match():
    """Pod twin: legs/spread/bars bitwise across 1/4/8-device meshes
    (incl. the multi-slice mesh) and equal to the unsharded engine to
    fp-reassociation noise."""
    from montecarlo.parallel import make_mesh, sharded_credit_legs

    kw = dict(T=T, seed=SEED, product="tranche", attach=0.03, detach=0.10,
              recovery=REC, rate=RATE, block_size=256)
    res = {n: sharded_credit_legs([HAZ] * N_NAMES, RHO, 4096, N_STEPS,
                                  mesh=make_mesh(n), **kw)
           for n in (1, 4, 8)}
    two = sharded_credit_legs([HAZ] * N_NAMES, RHO, 4096, N_STEPS,
                              mesh=make_mesh(n_path_shards=4, n_slices=2),
                              **kw)
    for k_, v in res[1].items():
        for other in (res[4][k_], res[8][k_], two[k_]):
            assert float(v) == float(other), k_
    want = cdo_tranche([HAZ] * N_NAMES, RHO, attach=0.03, detach=0.10,
                       T=T, n_steps=N_STEPS, n_paths=4096, seed=SEED,
                       rate=RATE, recovery=REC)
    for k_ in ("protection_leg", "premium_leg_per_spread", "par_spread",
               "par_spread_std_err"):
        np.testing.assert_allclose(float(res[8][k_]), float(want[k_]),
                                   rtol=1e-10, err_msg=k_)

    kth = {n: sharded_credit_legs([HAZ] * N_NAMES, 0.35, 4096, N_STEPS,
                                  mesh=make_mesh(n), product="kth", k=2,
                                  recovery=REC, rate=RATE, T=T, seed=SEED,
                                  block_size=256)
           for n in (1, 8)}
    assert float(kth[1]["par_spread"]) == float(kth[8]["par_spread"])
    want_k = kth_to_default_cds([HAZ] * N_NAMES, 0.35, k=2, T=T,
                                n_steps=N_STEPS, n_paths=4096, seed=SEED,
                                rate=RATE, recovery=REC)
    np.testing.assert_allclose(float(kth[8]["par_spread"]),
                               float(want_k["par_spread"]), rtol=1e-10)


# ---------------------------------------------------------------------------
# Student-t copula (tail dependence)
# ---------------------------------------------------------------------------

def test_t_icdf_matches_scipy():
    """The jax-native inverse Student-t CDF (Newton on betainc) agrees
    with scipy.stats.t.ppf to near roundoff across body and tails."""
    from montecarlo.engine.credit import t_icdf

    p = np.array([1e-8, 1e-5, 1e-3, 0.1, 0.5, 0.9, 0.999, 1 - 1e-6])
    for df in (2, 4, 8):
        got = np.asarray(t_icdf(jnp.asarray(p), df, jnp.float64))
        want = st.t.ppf(p, df)
        np.testing.assert_allclose(got, want, rtol=1e-10, err_msg=str(df))


def _oracle_tranche_t(attach, detach, rho, df, n_gh=96, n_gl=96):
    """EXACT homogeneous-pool tranche profile under the t copula:
    conditional on (factor M, chi2 mixing W) the count is
    Binomial(N, p(m, w)) with
    ``p = Phi((C sqrt(w/df) - sqrt(rho) m) / sqrt(1-rho))`` —
    Gauss-Hermite over M x generalized Gauss-Laguerre over W/2 ~
    Gamma(df/2)."""
    import scipy.special as sp

    times = np.arange(N_STEPS + 1) * (T / N_STEPS)
    dt = T / N_STEPS
    m, wm = _gh_factor(n_gh)
    xg, wg = sp.roots_genlaguerre(n_gl, df / 2 - 1)
    wg = wg / sp.gamma(df / 2)               # W = 2 * xg ~ chi2(df)
    c = st.t.ppf(1.0 - np.exp(-HAZ * times), df)          # (dates,)
    scale = np.sqrt(2.0 * xg / df)                        # (gl,)
    z = (c[:, None, None] * scale[None, None, :]
         - np.sqrt(rho) * m[None, :, None]) / np.sqrt(1.0 - rho)
    p = np.where(np.isneginf(c)[:, None, None], 0.0, st.norm.cdf(z))
    # scipy's binom.pmf overflows on subnormal p; clipping 1e-300 -> 1e-12
    # moves e_tl by < N * 1e-12, orders below the MC bars this feeds.
    p = np.where((p > 0) & (p < 1e-12), 1e-12, p)
    counts = np.arange(N_NAMES + 1)
    tl = np.clip(counts * (1.0 - REC) / N_NAMES - attach, 0.0,
                 detach - attach)
    pmf = st.binom.pmf(counts[None, None, None, :], N_NAMES,
                       p[:, :, :, None])
    e_tl = np.einsum("tmwc,c,m,w->t", pmf, tl, wm, wg)
    prot, disc_end, _ = _legs(e_tl, times, dt)
    out = (detach - attach) - e_tl
    prem = np.sum(disc_end * dt * 0.5 * (out[1:] + out[:-1]))
    return e_tl, prot, prem


def test_student_t_copula_exact_oracle_and_tail_dependence():
    """t-copula tranche vs the exact 2-D quadrature oracle; the senior
    tranche carries MORE expected loss under t than Gaussian at the same
    rho (tail dependence — the model-risk axis the Gaussian copula
    famously hides); the single-name marginal stays CDS-exact."""
    df, a, b = 4, 0.10, 0.20
    res = cdo_tranche([HAZ] * N_NAMES, RHO, attach=a, detach=b, T=T,
                      n_steps=N_STEPS, n_paths=N_PATHS, seed=SEED,
                      rate=RATE, recovery=REC, copula="student-t", df=df)
    e_tl, prot, prem = _oracle_tranche_t(a, b, RHO, df)
    el = np.asarray(res["expected_loss"])
    se = np.asarray(res["expected_loss_std_err"])
    assert np.all(np.abs(el - e_tl) <= 4.0 * se + 1e-12)
    assert abs(float(res["par_spread"]) - prot / prem) \
        <= 4.0 * float(res["par_spread_std_err"])

    gauss = cdo_tranche([HAZ] * N_NAMES, RHO, attach=a, detach=b, T=T,
                        n_steps=N_STEPS, n_paths=N_PATHS, seed=SEED,
                        rate=RATE, recovery=REC)
    assert float(res["par_spread"]) > (
        float(gauss["par_spread"])
        + 6.0 * (float(res["par_spread_std_err"])
                 + float(gauss["par_spread_std_err"])))

    # Marginals: a 1-name pool's trigger probability is the CDS curve.
    one = kth_to_default_cds([HAZ], 0.5, k=1, T=T, n_steps=N_STEPS,
                             n_paths=N_PATHS, seed=SEED, rate=RATE,
                             recovery=REC, copula="student-t", df=df)
    times = np.arange(N_STEPS + 1) * (T / N_STEPS)
    want = 1.0 - np.exp(-HAZ * times)
    el1 = np.asarray(one["expected_loss"])
    se1 = np.asarray(one["expected_loss_std_err"])
    assert np.all(np.abs(el1 - want) <= 4.0 * se1 + 1e-12)

    # df must be a positive even integer (exact chi2 from Exp sums).
    with pytest.raises(ValueError, match="EVEN"):
        cdo_tranche([HAZ] * 4, RHO, attach=a, detach=b, T=T, n_steps=4,
                    n_paths=512, seed=SEED, copula="student-t", df=3)


def test_student_t_sharded_bitwise_and_matches_unsharded():
    from montecarlo.parallel import make_mesh, sharded_credit_legs

    kw = dict(T=T, seed=SEED, product="kth", k=2, recovery=REC,
              rate=RATE, copula="student-t", df=4, block_size=256)
    res = {n: sharded_credit_legs([HAZ] * N_NAMES, RHO, 4096, N_STEPS,
                                  mesh=make_mesh(n), **kw)
           for n in (1, 8)}
    for k_, v in res[1].items():
        assert float(v) == float(res[8][k_]), k_
    want = kth_to_default_cds([HAZ] * N_NAMES, RHO, k=2, T=T,
                              n_steps=N_STEPS, n_paths=4096, seed=SEED,
                              rate=RATE, recovery=REC,
                              copula="student-t", df=4)
    np.testing.assert_allclose(float(res[8]["par_spread"]),
                               float(want["par_spread"]), rtol=1e-10)


def test_exact_pricer_matches_independent_oracle_and_mc():
    """`tranche_spread_exact` (the JAX Gauss-Hermite x binomial pricer)
    agrees with this file's independent scipy oracle to quadrature
    precision, and the MC engine sits within its own bars of it."""
    from montecarlo.engine.credit import tranche_spread_exact

    a, b = 0.03, 0.10
    ex = tranche_spread_exact(HAZ, RHO, n_names=N_NAMES, attach=a,
                              detach=b, T=T, n_steps=N_STEPS, rate=RATE,
                              recovery=REC)
    e_tl, prot, prem = _oracle_tranche(a, b, RHO)
    np.testing.assert_allclose(np.asarray(ex["expected_loss"]), e_tl,
                               rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(float(ex["protection_leg"]), prot,
                               rtol=1e-9)
    np.testing.assert_allclose(float(ex["par_spread"]), prot / prem,
                               rtol=1e-9)
    mc = cdo_tranche([HAZ] * N_NAMES, RHO, attach=a, detach=b, T=T,
                     n_steps=N_STEPS, n_paths=N_PATHS, seed=SEED,
                     rate=RATE, recovery=REC)
    assert abs(float(mc["par_spread"]) - float(ex["par_spread"])) \
        <= 4.0 * float(mc["par_spread_std_err"])


def test_exact_pricer_greeks_vs_finite_differences():
    """hazard_delta and rho_sens from autodiff through the quadrature
    match central finite differences of the exact spread."""
    from montecarlo.engine.credit import tranche_spread_exact

    kw = dict(n_names=N_NAMES, attach=0.03, detach=0.10, T=T,
              n_steps=N_STEPS, rate=RATE, recovery=REC)
    ex = tranche_spread_exact(HAZ, RHO, **kw)
    eps = 1e-6
    for key, arg in (("hazard_delta", "h"), ("rho_sens", "r")):
        up = tranche_spread_exact(HAZ + (eps if arg == "h" else 0.0),
                                  RHO + (eps if arg == "r" else 0.0),
                                  **kw)
        dn = tranche_spread_exact(HAZ - (eps if arg == "h" else 0.0),
                                  RHO - (eps if arg == "r" else 0.0),
                                  **kw)
        fd = (float(up["par_spread"]) - float(dn["par_spread"])) / (2 * eps)
        ad = float(ex[key])
        assert np.isfinite(ad)
        np.testing.assert_allclose(ad, fd, rtol=1e-5, err_msg=key)
    # Signs: more hazard -> wider spread; more correlation -> a mezz
    # tranche at these parameters cheapens as mass escapes past detach.
    assert float(ex["hazard_delta"]) > 0


def test_base_correlation_roundtrip():
    """Generate an equity-tranche spread at a known rho, invert it, and
    recover the correlation to bisection precision; the inversion
    rejects unattainable targets with the attainable range."""
    import pytest

    from montecarlo.engine.credit import (base_correlation,
                                              tranche_spread_exact)

    kw = dict(n_names=N_NAMES, T=T, n_steps=N_STEPS, rate=RATE,
              recovery=REC)
    target = float(tranche_spread_exact(HAZ, 0.35, attach=0.0,
                                        detach=0.03, **kw)["par_spread"])
    rho = base_correlation(target, detach=0.03, hazard=HAZ, **kw)
    assert abs(float(rho) - 0.35) < 1e-8
    with pytest.raises(ValueError, match="attainable"):
        base_correlation(1e4, detach=0.03, hazard=HAZ, **kw)


def test_cli_credit(capsys):
    import json

    from montecarlo import cli

    rc = cli.main(["credit", "--names", "20", "--hazard", "0.02",
                   "--rho", "0.3", "--attach", "0.03", "--detach", "0.07",
                   "--paths", "8192", "--steps", "20", "--maturity", "5"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["product"] == "tranche" and out["par_spread"] > 0

    rc = cli.main(["credit", "--names", "20", "--hazard", "0.02",
                   "--rho", "0.3", "--kth", "2", "--paths", "8192",
                   "--steps", "20", "--maturity", "5", "--mesh", "2"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["product"] == "kth-to-default" and out["mesh"] == 2
    assert out["par_spread"] > 0

    # --exact: MC within 4 bars of the printed exact spread + greeks.
    rc = cli.main(["credit", "--names", "20", "--hazard", "0.02",
                   "--rho", "0.3", "--attach", "0.03", "--detach", "0.07",
                   "--paths", "8192", "--steps", "20", "--maturity", "5",
                   "--exact"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert abs(out["par_spread"] - out["par_spread_exact"]) \
        <= 4.0 * out["par_spread_std_err"]
    assert out["hazard_delta"] > 0

    # --base-corr: a generated equity-tranche spread inverts back.
    from montecarlo.engine.credit import tranche_spread_exact

    eq = tranche_spread_exact(0.02, 0.35, n_names=20, attach=0.0,
                              detach=0.03, T=5.0, n_steps=20, rate=0.03)
    rc = cli.main(["credit", "--names", "20", "--hazard", "0.02",
                   "--detach", "0.03", "--maturity", "5", "--steps", "20",
                   "--base-corr", f"{float(eq['par_spread']):.12g}"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert abs(out["base_correlation"] - 0.35) < 1e-6
    # --base-corr never runs MC: flags that request one are rejected,
    # not silently ignored.
    with pytest.raises(SystemExit, match="exact-pricer"):
        cli.main(["credit", "--names", "20", "--hazard", "0.02",
                  "--detach", "0.03", "--base-corr", "0.01",
                  "--mesh", "2"])
