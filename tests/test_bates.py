"""Bates (Heston + jumps): CF-oracle parity, degenerate limits, and
fused-engine bitwise parity."""

import jax.numpy as jnp
import numpy as np

from montecarlo.engine import european_call, mc_estimate, simulate
from montecarlo.engine.cf_pricing import cf_call_price
from montecarlo.ops.fused_engine import fused_terminal_pallas
from montecarlo.processes import Bates, Heston, bates_log_cf

S0, R, STRIKE, T = 100.0, 0.03, 105.0, 1.0
PARAMS = dict(v0=0.04, kappa=2.0, theta=0.04, xi=0.5, rho=-0.7)
JUMPS = dict(lam=0.5, jump_mean=-0.08, jump_std=0.15)


def test_bates_matches_cf_price():
    n_steps = 256
    proc = Bates.create(s0=S0, mu=R, dt=T / n_steps, dtype=jnp.float64,
                        **PARAMS, **JUMPS)
    term = simulate(proc, 1 << 16, n_steps, seed=3, dtype=jnp.float64)
    est = mc_estimate(european_call(term, STRIKE), float(np.exp(-R * T)))
    phi = bates_log_cf(S0, R, T=T, **PARAMS, **JUMPS)
    cf = float(cf_call_price(phi, S0, STRIKE, T, R))
    # Euler bias + MC noise vs the continuous CF price.
    assert abs(float(est["price"]) - cf) < 5 * float(est["std_err"]) + 0.08, (
        float(est["price"]), cf)
    # Jumps with negative mean must raise the OTM put wing / price vs pure
    # Heston at the same diffusion parameters (risk compensation shifts
    # drift, but the smile fattens): compare CF prices well OTM.
    from montecarlo.engine.heston_analytic import (HestonParams,
                                                      heston_call_cf)
    hp = HestonParams(**{k: jnp.asarray(v) for k, v in PARAMS.items()})
    put_wing_bates = float(cf_call_price(phi, S0, 70.0, T, R))
    put_wing_heston = float(heston_call_cf(S0, 70.0, T, R, hp))
    # Deep-ITM call = forward parity + embedded K=70 put; negative-mean
    # jumps FATTEN that put, so the Bates wing must exceed pure Heston
    # (a no-op jump factor would leave them equal and fail here).
    assert put_wing_bates > put_wing_heston + 0.01, (put_wing_bates,
                                                     put_wing_heston)


def test_bates_degenerates_to_heston():
    """lam -> 0 reproduces Heston exactly (identical normal stream)."""
    n_steps = 64
    bates = Bates.create(s0=S0, mu=R, dt=T / n_steps, dtype=jnp.float64,
                         lam=0.0, jump_mean=-0.05, jump_std=0.1, **PARAMS)
    heston = Heston.create(s0=S0, mu=R, dt=T / n_steps, dtype=jnp.float64,
                           **PARAMS)
    tb = np.asarray(simulate(bates, 4096, n_steps, seed=5,
                             dtype=jnp.float64))
    th = np.asarray(simulate(heston, 4096, n_steps, seed=5,
                             dtype=jnp.float64))
    # Different draw indexing (3/step vs 2/step) -> same LAW, not same
    # stream; compare distributions.
    assert abs(tb.mean() - th.mean()) < 4 * th.std() / np.sqrt(4096)
    assert abs(tb.std() - th.std()) < 0.1 * th.std()


def test_bates_fused_matches_scan_ulp():
    """Fused vs scan: the Bates drift chain picks up different FMA
    contraction between the two compilations (same ULP budget as the
    short-rate processes, DEVNOTES) — tolerance 2e-6, not bitwise."""
    n = 128 * 128
    proc = Bates.create(s0=S0, mu=R, dt=1 / 252, **PARAMS, **JUMPS)
    ref = np.asarray(simulate(proc, n, 16, seed=7))
    ker = np.asarray(fused_terminal_pallas(proc, n, 16, seed=7,
                                           block=256, interpret=True))
    np.testing.assert_allclose(ker, ref, rtol=2e-6)
