"""SABR: martingale forward, Hagan smile parity, skew sign, fused parity."""

import numpy as np
import jax.numpy as jnp

from montecarlo.engine import simulate
from montecarlo.engine.implied_vol import implied_vol_call
from montecarlo.ops.fused_engine import fused_terminal_pallas
from montecarlo.processes.sabr import SABR, sabr_hagan_iv

F0, ALPHA, BETA, NU, RHO, T = 100.0, 0.2, 0.7, 0.3, -0.3, 1.0
N_STEPS = 128


def _sabr(dtype=jnp.float32):
    # beta=0.7 => alpha has units F^(1-beta); scale to ~20% lognormal ATM.
    return SABR.create(f0=F0, alpha=ALPHA * F0 ** (1 - BETA), beta=BETA,
                       nu=NU, rho=RHO, dt=T / N_STEPS, dtype=dtype)


def test_forward_is_martingale():
    n = 1 << 17
    f_t = np.asarray(simulate(_sabr(), n, N_STEPS, seed=2))
    se = f_t.std() / np.sqrt(n)
    assert abs(f_t.mean() - F0) < 5 * se


def test_smile_matches_hagan():
    """MC-implied Black vols across the smile vs the Hagan expansion.

    Tolerance covers the MC error plus the O(nu^2 T) Hagan approximation
    error and the forward-leg Euler bias at 128 steps (~a few vol bps at
    these parameters) — tight enough to catch any real coupling/exponent
    error, which shifts vols by hundreds of bps."""
    n = 1 << 18
    f_t = np.asarray(simulate(_sabr(), n, N_STEPS, seed=7))
    strikes = np.array([85.0, 100.0, 115.0])
    alpha_eff = ALPHA * F0 ** (1 - BETA)
    for k in strikes:
        price = np.maximum(f_t - k, 0.0).mean()  # r=0: Black == BS on F
        iv_mc = float(implied_vol_call(price, F0, k, 0.0, T))
        iv_hagan = float(sabr_hagan_iv(F0, k, T, alpha_eff, BETA, NU, RHO))
        assert abs(iv_mc - iv_hagan) < 0.006, (k, iv_mc, iv_hagan)


def test_negative_rho_skews_down():
    n = 1 << 17
    f_t = np.asarray(simulate(_sabr(), n, N_STEPS, seed=5))
    iv = {}
    for k in (85.0, 115.0):
        price = np.maximum(f_t - k, 0.0).mean()
        iv[k] = float(implied_vol_call(price, F0, k, 0.0, T))
    assert iv[85.0] > iv[115.0] + 0.005


def test_lognormal_limit_matches_black_scholes():
    """beta=1, nu tiny: SABR degenerates to (Euler) GBM — the call price
    must approach Black-Scholes."""
    from montecarlo.engine import black_scholes_call

    proc = SABR.create(f0=F0, alpha=0.2, beta=1.0, nu=1e-6, rho=0.0,
                       dt=T / 256)
    n = 1 << 17
    f_t = np.asarray(simulate(proc, n, 256, seed=9))
    price = np.maximum(f_t - 100.0, 0.0).mean()
    se = np.maximum(f_t - 100.0, 0.0).std() / np.sqrt(n)
    bs = float(black_scholes_call(F0, 100.0, 0.0, 0.2, T))
    assert abs(price - bs) < 4 * se + 0.05, (price, bs)


def test_sabr_fused_kernel_parity():
    n = 128 * 128
    ref = np.asarray(simulate(_sabr(), n, 17, seed=5))
    ker = np.asarray(fused_terminal_pallas(_sabr(), n, 17, seed=5,
                                           block=256, interpret=True))
    np.testing.assert_array_equal(ker, ref)


def test_vol_leg_exact_lognormal():
    """The sigma leg is stepped exactly: its terminal distribution is
    lognormal with Var[log sigma_T] = nu^2 T for any step count."""
    proc = _sabr(jnp.float64)
    n = 1 << 15
    ids = jnp.arange(n, dtype=jnp.uint32)
    state = proc.init_state(ids, jnp.float64)
    import jax

    def body(s, t):
        eps = proc.draws(3, 0, ids, t, jnp.float64)
        return proc.step(s, eps, t), None

    state, _ = jax.lax.scan(body, state,
                            jnp.arange(N_STEPS, dtype=jnp.int32))
    log_sig = np.log(np.asarray(state.sigma) / (ALPHA * F0 ** (1 - BETA)))
    assert abs(log_sig.mean() + 0.5 * NU**2 * T) < 5 * NU / np.sqrt(n)
    assert abs(log_sig.var() - NU**2 * T) < 0.05 * NU**2 * T
