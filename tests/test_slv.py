"""Stochastic-local-vol (`processes/slv.py`): degenerate exactness of the
particle-calibrated leverage, vanilla repricing of a Heston-generated
surface under DIFFERENT mixing dynamics (the Gyongy consistency the model
exists for), and the smile-dynamics separation from pure local vol."""

import numpy as np
import jax.numpy as jnp

from montecarlo.engine import european_call, mc_estimate, simulate
from montecarlo.engine.heston_analytic import HestonParams, heston_call_cf
from montecarlo.engine.implied_vol import implied_vol_call
from montecarlo.processes.dupire import local_vol_fn_from_ivs
from montecarlo.processes.local_vol import LocalVolGBM
from montecarlo.processes.slv import calibrate_slv

S0, RATE = 100.0, 0.03
STRIKES = np.linspace(70.0, 140.0, 15)
MATS = np.array([0.25, 0.5, 1.0, 1.5, 2.0])


def test_degenerate_leverage_equals_local_vol():
    """xi=0, kappa=0, v0=1: v_t == 1 for every particle, so the
    regularized conditional expectation is exactly 1 and the calibrated
    leverage must equal sigma_LV on every knot of every step."""
    n_steps = 64
    lv = LocalVolGBM.create(
        S0, RATE, 1.0 / n_steps, n_steps,
        lambda t, s: np.full_like(s, 0.2) * (1.0 + 0.1 * t),
        x_min=-0.8, x_max=0.8)
    slv = calibrate_slv(lv, v0=1.0, kappa=0.0, theta=1.0, xi=0.0, rho=0.0,
                        n_steps=n_steps, n_particles=1 << 13, seed=3)
    rows_lv = np.stack([np.asarray(lv._row(t, jnp.float32))
                        for t in range(n_steps)])
    np.testing.assert_allclose(np.asarray(slv.lev_rows), rows_lv,
                               atol=1e-6)


def _heston_surface():
    hp = HestonParams(v0=jnp.float32(0.04), kappa=jnp.float32(1.5),
                      theta=jnp.float32(0.05), xi=jnp.float32(0.4),
                      rho=jnp.float32(-0.5))
    ivs = np.zeros((MATS.size, STRIKES.size))
    for j, T in enumerate(MATS):
        prices = np.asarray(heston_call_cf(S0, jnp.asarray(STRIKES),
                                           float(T), RATE, hp))
        ivs[j] = np.asarray(implied_vol_call(jnp.asarray(prices), S0,
                                             jnp.asarray(STRIKES), RATE,
                                             float(T)))
    return hp, ivs


def test_slv_reprices_target_surface():
    """Calibrated SLV with mixing dynamics DIFFERENT from the surface's
    generator (xi 0.8 vs 0.4, rho -0.6 vs -0.5) must still reprice the
    vanillas — that is the leverage function's entire job."""
    hp, ivs = _heston_surface()
    vol_fn = local_vol_fn_from_ivs(STRIKES, MATS, ivs, s0=S0, rate=RATE)
    n_steps = 128
    lv = LocalVolGBM.create(S0, RATE, 1.0 / n_steps, n_steps, vol_fn,
                            x_min=-0.8, x_max=0.8)
    slv = calibrate_slv(lv, v0=0.04, kappa=1.5, theta=0.05, xi=0.8,
                        rho=-0.6, n_steps=n_steps, n_particles=1 << 17,
                        seed=5)
    term = simulate(slv, 1 << 17, n_steps, seed=5)
    for k in (85.0, 100.0, 115.0):
        est = mc_estimate(european_call(term, k), np.exp(-RATE * 1.0))
        cf = float(heston_call_cf(S0, float(k), 1.0, RATE, hp))
        err = abs(float(est["price"]) - cf)
        tol = 4 * float(est["std_err"]) + 0.0075 * cf + 0.03
        assert err < tol, (k, float(est["price"]), cf, err, tol)


def test_slv_smile_dynamics_differ_from_local_vol():
    """Vanillas agree, exotics don't: a forward-start call (sensitive to
    the FORWARD smile, which local vol flattens and stochastic vol
    preserves) must separate the two calibrated-to-the-same-surface
    models by more than MC noise."""
    _, ivs = _heston_surface()
    vol_fn = local_vol_fn_from_ivs(STRIKES, MATS, ivs, s0=S0, rate=RATE)
    n_steps = 128  # 2 years
    dt = 2.0 / n_steps
    lv = LocalVolGBM.create(S0, RATE, dt, n_steps, vol_fn,
                            x_min=-0.8, x_max=0.8)
    slv = calibrate_slv(lv, v0=0.04, kappa=1.5, theta=0.05, xi=0.9,
                        rho=-0.6, n_steps=n_steps, n_particles=1 << 16,
                        seed=9)
    t1 = n_steps // 2
    prices_lv = simulate(lv, 1 << 16, n_steps, seed=11, mode="paths")
    prices_slv = simulate(slv, 1 << 16, n_steps, seed=11, mode="paths")
    disc = np.exp(-RATE * 2.0)

    def fwd_start(paths):
        # ATM forward-start call on the 1y->2y return, strike 1.
        ratio = paths[-1] / paths[t1]
        return mc_estimate(jnp.maximum(ratio - 1.0, 0.0), disc)

    a = fwd_start(prices_lv)
    b = fwd_start(prices_slv)
    gap = abs(float(a["price"]) - float(b["price"]))
    noise = 4 * (float(a["std_err"]) + float(b["std_err"]))
    assert gap > noise, (float(a["price"]), float(b["price"]), gap, noise)


def test_cli_price_slv(capsys):
    """CLI round-trip: the demo-surface SLV prices a 6m call in the right
    neighborhood (ATM iv 0.2 with a -0.1 skew)."""
    import json

    from montecarlo import cli

    rc = cli.main(["price", "--process", "slv", "--paths", "16384",
                   "--steps", "32", "--strike", "100", "--maturity", "0.5"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # BS(S0=100, K=100, r=3%, iv~=0.2, T=0.5) ~= 6.4; wide MC band.
    assert 5.5 < out["price"] < 7.5, out


def test_bad_smooth_bins_rejected():
    import pytest

    lv = LocalVolGBM.create(S0, RATE, 0.01, 8,
                            lambda t, s: np.full_like(s, 0.2))
    with pytest.raises(ValueError):
        calibrate_slv(lv, v0=0.04, kappa=1.0, theta=0.04, xi=0.3, rho=0.0,
                      n_steps=8, smooth_bins=4)


def _demo_slv(n_steps=64, xi=0.8):
    lv = LocalVolGBM.create(
        S0, RATE, 1.0 / n_steps, n_steps,
        lambda t, s: 0.2 - 0.1 * np.log(np.maximum(s, 1e-9) / S0),
        x_min=-0.9, x_max=0.9)
    return calibrate_slv(lv, v0=0.04, kappa=2.0, theta=0.04, xi=xi,
                         rho=-0.6, n_steps=n_steps, n_particles=1 << 14,
                         seed=3)


def test_slv_knots_fused_matches_scan():
    """SLVKnots is fused-kernel eligible: the Pallas kernel (interpret
    mode) must match the scan engine ULP-tight (same draws, same step
    algebra; the knot blend + table reads introduce FMA-contraction
    differences only)."""
    from montecarlo.engine.dispatch import _FUSABLE
    from montecarlo.ops.fused_engine import fused_terminal_pallas
    from montecarlo.processes import slv_to_kernel

    proc = slv_to_kernel(_demo_slv(), n_time_knots=8)
    assert isinstance(proc, _FUSABLE)
    n = 128 * 32
    ref = np.asarray(simulate(proc, n, 17, seed=5))
    ker = np.asarray(fused_terminal_pallas(proc, n, 17, seed=5,
                                           block=512, interpret=True))
    np.testing.assert_allclose(ker, ref, rtol=2e-6)


def test_slv_knots_reprices_like_exact_rows():
    """The hat-blended (piecewise-linear-in-time) leverage must price
    inside the MC noise of the exact per-step rows — the approximation
    slv_to_kernel documents."""
    from montecarlo.processes import slv_to_kernel

    slv = _demo_slv(n_steps=64)
    knots = slv_to_kernel(slv, n_time_knots=16)
    disc = float(np.exp(-RATE))
    a = mc_estimate(european_call(
        simulate(slv, 1 << 15, 64, seed=11), 100.0), disc)
    b = mc_estimate(european_call(
        simulate(knots, 1 << 15, 64, seed=11), 100.0), disc)
    diff = abs(float(a["price"]) - float(b["price"]))
    assert diff < 2 * float(a["std_err"]) + 0.02, (a, b)


def test_slv_exact_rows_fused_matches_scan():
    """The exact-rows SLV itself is fused-kernel eligible (its (steps, 128)
    leverage table is a KernelTable inside the kernel): kernel (interpret
    mode) vs scan engine, ULP-tight.  The tolerance stays at 5e-6 (the
    leverage interpolation and step chain are contraction candidates;
    on the card the two engines agreed bitwise)."""
    from montecarlo.engine.dispatch import _FUSABLE
    from montecarlo.ops.fused_engine import fused_terminal_pallas

    proc = _demo_slv(n_steps=17)
    assert isinstance(proc, _FUSABLE)
    n = 128 * 32
    ref = np.asarray(simulate(proc, n, 17, seed=5))
    ker = np.asarray(fused_terminal_pallas(proc, n, 17, seed=5,
                                           block=512, interpret=True))
    np.testing.assert_allclose(ker, ref, rtol=5e-6)
