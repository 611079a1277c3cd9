"""xVA sensitivities (`engine.exposure.xva_greeks`): pathwise AD through
the netting-set engine vs (a) the equity forward's Black-Scholes CVA
closed form differentiated by AD, (b) same-seed finite differences of the
profile engine (common random numbers make these near-exact), and (c)
exact linearity/structure identities."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from montecarlo.engine.exposure import (CSA, netting_set_profile,
                                            swap_value_fn, xva_greeks)
from montecarlo.processes import GBM, Vasicek

S0, RF, SIGMA, TMAT = 100.0, 0.03, 0.25, 1.0
STEPS, PATHS, SEED = 16, 1 << 14, 11
LAM, REC = 0.02, 0.4
# 5% off the par forward: the t=0 mark is then strictly negative, keeping
# every max-kink off the exact evaluation point.
K_FWD = 1.05 * S0 * float(np.exp(RF * TMAT))


def _fwd_trade(k, r, t_mat):
    return lambda s, t: s - k * jnp.exp(-r * (t_mat - t))


def _build_equity(p):
    model = GBM.create(p["s0"], RF, p["sigma"], TMAT / STEPS,
                       dtype=jnp.float64)
    return model, (_fwd_trade(K_FWD, RF, TMAT),), RF


def _cva_closed_form(s0, sigma, lam):
    """(1-R) sum_k BS_call(s0, K e^{-r(T-t_k)}, t_k) dPD_k — exactly the
    engine's discretization (depe_k = e^{-r t_k} E[(S_k - K')^+] = the
    undiscounted-forward Black-Scholes call at maturity t_k)."""
    ndtr = jax.scipy.stats.norm.cdf
    dt = TMAT / STEPS
    t = jnp.arange(1, STEPS + 1, dtype=jnp.float64) * dt
    kp = K_FWD * jnp.exp(-RF * (TMAT - t))
    sig_rt = sigma * jnp.sqrt(t)
    d1 = (jnp.log(s0 / kp) + (RF + 0.5 * sigma * sigma) * t) / sig_rt
    call = s0 * ndtr(d1) - kp * jnp.exp(-RF * t) * ndtr(d1 - sig_rt)
    surv = jnp.exp(-lam * jnp.arange(0, STEPS + 1, dtype=jnp.float64) * dt)
    return (1.0 - REC) * jnp.sum(call * (surv[:-1] - surv[1:]))


def test_equity_forward_cva_greeks_vs_black_scholes():
    """d CVA / d {s0, sigma, hazard} from the MC engine agree with AD of
    the closed form within MC tolerance (the estimator is unbiased and its
    greeks converge at the same rate)."""
    res = xva_greeks(_build_equity,
                     {"s0": S0, "sigma": SIGMA, "hazard_rate": LAM},
                     PATHS, STEPS, T=TMAT, seed=SEED, recovery=REC,
                     outputs=("cva",))
    g = res["greeks"]["cva"]
    grads_cf = jax.grad(_cva_closed_form, argnums=(0, 1, 2))(
        jnp.float64(S0), jnp.float64(SIGMA), jnp.float64(LAM))
    want = dict(zip(("s0", "sigma", "hazard_rate"), map(float, grads_cf)))
    # Value sanity first: the level matches the closed form.
    cva_cf = float(_cva_closed_form(S0, SIGMA, LAM))
    assert abs(float(res["values"]["cva"]) - cva_cf) < 0.05 * cva_cf
    for k in ("s0", "sigma", "hazard_rate"):
        got = float(g[k])
        assert abs(got - want[k]) < 0.06 * abs(want[k]) + 1e-9, (k, got,
                                                                 want[k])


def _build_rates(p):
    model = Vasicek.create(p.get("r0", 0.03), 0.6, 0.04,
                           p.get("sigma", 0.012), 2.0 / 32,
                           dtype=jnp.float64)
    pay_times = np.arange(1, 5) * 0.5
    v1 = swap_value_fn(model, 0.035, pay_times, 0.5)
    v2 = swap_value_fn(model, 0.040, pay_times[:2], 0.5)
    return model, (v1, lambda r, t: -0.5 * v2(r, t)), None


_RATES_KW = dict(T=2.0, seed=7, hazard_rate=0.02, recovery=0.4,
                 own_hazard_rate=0.01, funding_spread=0.004,
                 im_spread=0.003, kva_cost=0.10)


def test_rates_book_greeks_match_same_seed_finite_differences():
    """Common random numbers: the AD greeks are the exact derivatives of
    THIS seed's estimator, so same-seed central differences reproduce them
    to O(h^2) — a sharp correctness check on the whole chain (simulation,
    swap marking through the Vasicek closed form, pathwise discounting,
    netted IM, KVA's running max)."""
    res = xva_greeks(_build_rates, {"r0": 0.03, "sigma": 0.012}, 4096, 32,
                     outputs=("cva", "fva", "mva", "kva"), **_RATES_KW)

    def level(r0, sigma):
        model, trades, _ = _build_rates({"r0": jnp.float64(r0),
                                         "sigma": jnp.float64(sigma)})
        prof = netting_set_profile(model, trades, 4096, 32, **_RATES_KW)
        return {k: float(prof[k]) for k in ("cva", "fva", "mva", "kva")}

    h = 1e-5
    for pname, args_lo, args_hi in (
            ("r0", (0.03 - h, 0.012), (0.03 + h, 0.012)),
            ("sigma", (0.03, 0.012 - h), (0.03, 0.012 + h))):
        lo, hi = level(*args_lo), level(*args_hi)
        for out in ("cva", "fva", "mva", "kva"):
            fd = (hi[out] - lo[out]) / (2 * h)
            ad = float(res["greeks"][out][pname])
            assert abs(ad - fd) < 2e-3 * max(abs(fd), 1e-6) + 1e-8, (
                pname, out, ad, fd)


def test_credit_linearity_identities():
    """FVA is linear in the funding spread and MVA in the IM spread:
    d out / d spread * spread == out exactly (one AD pass proves both)."""
    res = xva_greeks(_build_rates, {"funding_spread": 0.004,
                                    "im_spread": 0.003},
                     2048, 32, outputs=("fva", "mva"), **{
                         **_RATES_KW, "seed": 3})
    fva = float(res["values"]["fva"])
    mva = float(res["values"]["mva"])
    np.testing.assert_allclose(
        float(res["greeks"]["fva"]["funding_spread"]) * 0.004, fva,
        rtol=1e-12)
    np.testing.assert_allclose(
        float(res["greeks"]["mva"]["im_spread"]) * 0.003, mva, rtol=1e-12)
    # Spreads do not cross-contaminate.
    assert float(res["greeks"]["fva"]["im_spread"]) == 0.0
    assert float(res["greeks"]["mva"]["funding_spread"]) == 0.0


def test_mta_deadband_warns():
    with pytest.warns(UserWarning, match="MTA deadband"):
        xva_greeks(_build_rates, {"r0": 0.03}, 512, 32,
                   csa=CSA(threshold=0.001, mta=0.0005, mpor=4 * 2.0 / 32),
                   outputs=("cva",), **_RATES_KW)


def test_csa_collateralized_greeks_finite_and_fd_consistent():
    """Threshold-only CSA (mta=0): collateral is kink-only, so pathwise AD
    stays valid — check against same-seed finite differences."""
    csa = CSA(threshold=0.002, own_threshold=0.002, mta=0.0,
              mpor=4 * 2.0 / 32)
    res = xva_greeks(_build_rates, {"r0": 0.03}, 4096, 32, csa=csa,
                     outputs=("cva",), **_RATES_KW)

    def level(r0):
        model, trades, _ = _build_rates({"r0": jnp.float64(r0),
                                         "sigma": jnp.float64(0.012)})
        prof = netting_set_profile(model, trades, 4096, 32, csa=csa,
                                   **_RATES_KW)
        return float(prof["cva"])

    h = 1e-5
    fd = (level(0.03 + h) - level(0.03 - h)) / (2 * h)
    ad = float(res["greeks"]["cva"]["r0"])
    assert np.isfinite(ad)
    assert abs(ad - fd) < 5e-3 * max(abs(fd), 1e-6) + 1e-8, (ad, fd)


def test_cli_xva_greeks(capsys):
    import json

    from montecarlo import cli

    rc = cli.main(["xva", "--portfolio", "--no-csa", "--paths", "2048",
                   "--steps", "32", "--greeks"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "greeks" in out
    assert set(out["greeks"]["cva"]) == {"r0", "sigma", "hazard_rate"}
    # CVA of a net-long payer book rises with the hazard rate.
    assert out["greeks"]["cva"]["hazard_rate"] > 0
