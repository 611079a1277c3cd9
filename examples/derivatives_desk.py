#!/usr/bin/env python
"""Derivatives-desk tour: the surfaces beyond the reference app.

Run: python examples/derivatives_desk.py [--cpu]

Covers: fixed income (bonds, bond options, Bermudan swaptions, duration by
autodiff), multilevel Monte Carlo, jump models vs their characteristic-
function prices, SABR smile calibration, rough Bergomi, variance swaps,
counterparty exposure and xVA (CVA/DVA/FVA/MVA), Heston-SLV, multi-asset
Bermudan max-calls vs the published brackets, American Greeks by policy
freezing, and worst-of autocallables.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

if "--cpu" in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax
import jax.numpy as jnp

# Some fixed-income pieces default to float64 accumulators.
jax.config.update("jax_enable_x64", True)


def main():
    print(f"platform: {jax.devices()[0].platform}\n")

    # --- fixed income -------------------------------------------------------
    from montecarlo.engine import (bond_option_mc, cir_zcb,
                                       vasicek_bond_option, vasicek_zcb,
                                       zcb_price_mc)
    from montecarlo.processes import CIR, Vasicek

    vas = Vasicek.create(0.03, 0.8, 0.05, 0.015, 2.0 / 128)
    zcb = zcb_price_mc(vas, 2.0, 128, 1 << 15, seed=3)
    print(f"Vasicek 2y ZCB   MC {float(zcb['price']):.6f}  "
          f"closed form {vasicek_zcb(0.03, 0.8, 0.05, 0.015, 2.0):.6f}")
    cir = CIR.create(0.03, 0.8, 0.05, 0.015, 2.0 / 128)
    zcb_c = zcb_price_mc(cir, 2.0, 128, 1 << 15, seed=3)
    print(f"CIR 2y ZCB       MC {float(zcb_c['price']):.6f}  "
          f"closed form {cir_zcb(0.03, 0.8, 0.05, 0.015, 2.0):.6f}")
    k_atm = (vasicek_zcb(0.03, .8, .05, .015, 3.0)
             / vasicek_zcb(0.03, .8, .05, .015, 1.0))  # ATM forward
    opt = bond_option_mc(Vasicek.create(0.03, 0.8, 0.05, 0.015, 1.0 / 64),
                         1.0, 3.0, k_atm, 64, 1 << 15, seed=5)
    print(f"1y option on 3y bond  MC {float(opt['price']):.6f}  Jamshidian "
          f"{vasicek_bond_option(0.03, .8, .05, .015, 1., 3., k_atm):.6f}")

    from montecarlo.engine import bermudan_swaption_lsm
    berm = bermudan_swaption_lsm(
        Vasicek.create(0.03, 0.5, 0.04, 0.012, 0.25 / 16, dtype=jnp.float64),
        0.036, n_paths=1 << 14, steps_per_period=16, n_periods=8,
        n_exercise=4, seed=7)
    print(f"Bermudan payer swaption (4 rights): "
          f"{float(berm['price']):.6f} ± {float(berm['std_err']):.1e}")

    # --- multilevel Monte Carlo --------------------------------------------
    import math

    from montecarlo.engine import european_call
    from montecarlo.engine.mlmc import mlmc_estimate
    from montecarlo.processes import EulerGBM

    res = mlmc_estimate(
        lambda n: EulerGBM.create(100., 0.05, 0.2, 1.0 / n),
        lambda s: european_call(s, 100.), target_rmse=0.02, seed=3,
        n0_steps=4, discount=math.exp(-0.05))
    print(f"\nMLMC call: {res['price']:.4f} (rmse<= {res['rmse_est']:.3f}, "
          f"{res['n_levels']} levels, "
          f"{res['single_level_cost_est'] / res['cost_path_steps']:.1f}x "
          f"cheaper than single-level)")

    # --- jumps vs characteristic functions ----------------------------------
    from montecarlo.engine import mc_estimate, simulate
    from montecarlo.engine.cf_pricing import cf_call_price, kou_log_cf
    from montecarlo.processes import Kou

    kou = Kou.create(100., 0.03, 0.2, 1.0, 0.4, 10., 5., 1 / 252)
    s_t = simulate(kou, 1 << 16, 252, seed=7)
    est = mc_estimate(european_call(s_t, 105.), math.exp(-0.03))
    cf = float(cf_call_price(kou_log_cf(100., .03, .2, 1., .4, 10., 5., 1.),
                             100., 105., 1.0, 0.03))
    print(f"Kou call:  MC {float(est['price']):.4f} vs CF {cf:.4f}")

    # --- SABR smile calibration ----------------------------------------------
    from montecarlo.processes import calibrate_sabr, sabr_hagan_iv

    ks = np.linspace(80., 125., 10)
    market = np.asarray(sabr_hagan_iv(100., jnp.asarray(ks), 1.0,
                                      0.2 * 100. ** 0.3, 0.7, 0.35, -0.4))
    fit = calibrate_sabr(ks, market, f0=100., T=1.0, beta=0.7)
    print(f"SABR fit:  nu {fit['nu']:.3f} rho {fit['rho']:.3f} "
          f"(rmse {fit['rmse_vol']:.1e} vols)")

    # --- rough Bergomi --------------------------------------------------------
    from montecarlo.processes import RoughBergomi, rbergomi_simulate

    rb = RoughBergomi.create(s0=100., xi0=0.04, eta=1.5, rho=-0.7, h=0.1,
                             n_steps=64, T=0.5)
    s_rb = rbergomi_simulate(rb, 1 << 15, seed=11)
    est_rb = mc_estimate(european_call(s_rb, 100.))
    print(f"rBergomi (H=0.1) ATM call: {float(est_rb['price']):.4f} "
          f"± {float(est_rb['std_err']):.4f}")

    # --- variance swap + counterparty exposure -------------------------------
    from montecarlo.engine import (exposure_profile, swap_value_fn,
                                       variance_swap_strike_mc)
    from montecarlo.processes import Heston

    hest = Heston.create(s0=100., v0=0.09, mu=0., kappa=2., theta=0.04,
                         xi=0.3, rho=-0.5, dt=1 / 256)
    vs = variance_swap_strike_mc(hest, 1 << 15, 256, T=1.0, seed=5)
    print(f"\nVariance-swap strike (Heston): {float(vs['strike']):.4f} "
          f"(closed form 0.0614)")

    vfn = swap_value_fn(vas, 0.035, np.arange(1, 5) * 0.5, 0.5)
    prof = exposure_profile(vas, vfn, 1 << 13, 64, T=2.0, seed=7,
                            hazard_rate=0.01, own_hazard_rate=0.005,
                            funding_spread=0.005, im_spread=0.002,
                            dtype=jnp.float32)
    print(f"Swap EPE peak {float(max(prof['epe'])):.5f}, "
          f"CVA {float(prof['cva']):.2e} DVA {float(prof['dva']):.2e} "
          f"FVA {float(prof['fva']):.2e} MVA {float(prof['mva']):.2e}")

    # --- continuous barrier via Brownian bridge ------------------------------
    from montecarlo.engine import (barrier_survival_up, mc_estimate,
                                       simulate_functionals)
    from montecarlo.processes import GBM

    gbm = GBM.create(100., 0.03, 0.2, 1.0 / 64)
    out = simulate_functionals(
        gbm, 1 << 16, 64, seed=3,
        functionals={"surv": barrier_survival_up(125., 0.2, 1.0 / 64)})
    ko = mc_estimate(european_call(out["terminal"], 100.) * out["surv"],
                     math.exp(-0.03))
    ki = mc_estimate(european_call(out["terminal"], 100.)
                     * (1.0 - out["surv"]), math.exp(-0.03))
    print(f"\nUp-and-out 125 call (continuous barrier, 64 steps): "
          f"{float(ko['price']):.4f};  knock-in from the SAME run: "
          f"{float(ki['price']):.4f}")

    # --- second-order Greeks (one forward-over-reverse pass) -----------------
    from montecarlo.engine.greeks import (second_order_greeks,
                                              smoothed_call)

    p, g, h = second_order_greeks(gbm, smoothed_call(105., 1.5), 1 << 16,
                                  64, seed=11, fields=("s0", "sigma"),
                                  discount=math.exp(-0.03))
    print(f"Call ladder: delta {float(g[0]):.4f} vega {float(g[1]):.2f} "
          f"gamma {float(h[0, 0]):.4f} vanna {float(h[0, 1]):.3f} "
          f"volga {float(h[1, 1]):.2f}")

    # --- stress report (common random numbers) -------------------------------
    from montecarlo.api.stress import stress_report

    rep = stress_report(gbm, lambda s: jnp.maximum(s - 105., 0.0),
                        1 << 15, 64, seed=3, discount=math.exp(-0.03))
    crash = rep["scenarios"]["crash"]
    print(f"Stress: base {rep['base_price']:.3f}, crash (spot -30%, vol "
          f"+100%) P&L {crash['pnl']:+.3f}")

    # --- device-Sobol QMC with honest replicated error bars ------------------
    from montecarlo.engine import rqmc_estimate

    qmc = rqmc_estimate(gbm, lambda s: european_call(s, 105.), 1 << 16, 64,
                        seed=5, n_replicates=8, discount=math.exp(-0.03))
    print(f"QMC call (device Sobol, 8 scrambles): "
          f"{float(qmc['price']):.4f} ± {float(qmc['std_err']):.5f} "
          f"(honest replicated bar; the iid formula would read ~30x wider)")

    # --- multi-asset Bermudan max-call (Andersen-Broadie 2004) ---------------
    from montecarlo.engine import (andersen_broadie_bound_multi,
                                       lsm_policy_multi, max_call)
    from montecarlo.processes import MultiGBM

    m2 = MultiGBM.create(s0=[100.] * 2, mu=[0.05 - 0.10] * 2,
                         sigma=[0.2] * 2, corr=np.eye(2), dt=1.0 / 3.0)
    pay_mc = lambda p: max_call(p, 100.)
    res_mc, pol = lsm_policy_multi(m2, pay_mc, 1 << 16, 9, seed=11,
                                   rate=0.05, dt=1.0 / 3.0, degree=3,
                                   value_degree=3)
    ub = andersen_broadie_bound_multi(m2, pay_mc, pol, 1024, 128, 9,
                                      seed=11, rate=0.05, dt=1.0 / 3.0,
                                      degree=3, value_degree=3)
    print(f"\n2-asset Bermudan max-call: [{float(res_mc['price']):.3f}, "
          f"{float(ub['upper']):.3f}] (published 13.902)")

    # --- American Greeks by policy freezing ----------------------------------
    from montecarlo.engine import (american_price_and_greeks,
                                       lsm_exercise_policy)

    gbm_am = GBM.create(36., 0.06, 0.2, 1.0 / 50)
    put = lambda s: jnp.maximum(40. - s, 0.0)
    pol_am = lsm_exercise_policy(gbm_am, put, 1 << 16, 50, seed=3,
                                 rate=0.06, dt=1.0 / 50, degree=3)
    pr, gr = american_price_and_greeks(gbm_am, put, pol_am, 1 << 16, 50,
                                       seed=3, rate=0.06, dt=1.0 / 50,
                                       degree=3)
    print(f"American put 36/40: {float(pr):.4f}, delta {float(gr.s0):.4f} "
          f"vega {float(gr.sigma):.2f} (policy-frozen pathwise)")

    # --- worst-of autocallable -----------------------------------------------
    from montecarlo.engine import (simulate_functionals,
                                       worst_of_autocallable)

    corr = np.full((3, 3), 0.6)
    np.fill_diagonal(corr, 1.0)
    m3 = MultiGBM.create(s0=[100.] * 3, mu=[0.03] * 3, sigma=[0.25] * 3,
                         corr=corr, dt=1.0 / 64)
    note = simulate_functionals(
        m3, 1 << 15, 64, seed=13,
        functionals={"ac": worst_of_autocallable(16, 1.0, 0.02,
                                                 0.03 / 64, 0.7,
                                                 [100.] * 3)})
    ac = mc_estimate(note["ac"], 1.0)
    print(f"3-asset worst-of Phoenix note: {float(ac['price']):.4f} "
          f"± {float(ac['std_err']):.4f} of notional")


if __name__ == "__main__":
    main()
