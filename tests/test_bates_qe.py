"""Bates QE-M (processes/bates_qe.py): per-step martingale exactness with
jumps on, the coarse-step accuracy win over Euler Bates vs the exact
Bates CF, draw-stream contracts, and the lam->0 Heston-QE limit."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from montecarlo.engine.cf_pricing import cf_call_price
from montecarlo.engine.simulate import simulate
from montecarlo.ops.fused_engine import fused_terminal_pallas
from montecarlo.processes import Bates, BatesQE, bates_log_cf

# Feller-violating variance leg + meaningful jumps.
P = dict(s0=100.0, v0=0.04, mu=0.0, kappa=0.5, theta=0.04, xi=1.0,
         rho=-0.9, lam=1.0, jump_mean=-0.05, jump_std=0.1)
T = 1.0


def _qe(steps, dtype=jnp.float64, **over):
    return BatesQE.create(dt=T / steps, dtype=dtype, **{**P, **over})


def _terminal(proc, n, steps, seed=7, dtype=jnp.float64):
    ids = jnp.arange(n, dtype=jnp.uint32)
    st = proc.init_state(ids, dtype)

    def body(c, t):
        return proc.step(c, proc.draws(seed, 0, ids, t, dtype), t), None

    st, _ = jax.lax.scan(body, st, jnp.arange(steps))
    return st


def test_martingale_with_jumps_on():
    """Both legs are exactly compensated (QE-M drift + lam*mbar*dt), so
    e^{-mu T} E[S_T] = s0 at MC resolution even at 4 coarse steps."""
    n, steps = 1 << 18, 4
    proc = _qe(steps, mu=0.03)
    s = np.asarray(proc.prices(_terminal(proc, n, steps))) \
        * np.exp(-0.03 * T)
    assert abs(s.mean() - P["s0"]) <= 4.0 * s.std() / np.sqrt(n)


def test_coarse_step_call_beats_euler_vs_cf_oracle():
    """8 steps/year: QE-Bates matches the exact Bates CF at MC
    resolution; Euler Bates carries the Euler-Heston variance bias."""
    cf = float(cf_call_price(
        bates_log_cf(P["s0"], 0.0, v0=P["v0"], kappa=P["kappa"],
                     theta=P["theta"], xi=P["xi"], rho=P["rho"],
                     lam=P["lam"], jump_mean=P["jump_mean"],
                     jump_std=P["jump_std"], T=T),
        P["s0"], 100.0, T, 0.0))
    n, steps = 1 << 18, 8
    k = 100.0

    def price(proc):
        pay = np.maximum(
            np.asarray(proc.prices(_terminal(proc, n, steps))) - k, 0.0)
        return pay.mean(), pay.std() / np.sqrt(n)

    qe, se_qe = price(_qe(steps))
    eu, se_eu = price(Bates.create(dt=T / steps, dtype=jnp.float64, **P))
    assert abs(qe - cf) <= 4.0 * se_qe
    assert eu - cf > 10.0 * se_eu


def test_lam_zero_reduces_to_heston_qe_price():
    """With lam=0 the jump leg vanishes; the price must agree with
    HestonQE's at MC resolution (different draw layout, same law)."""
    from montecarlo.processes import HestonQE

    n, steps = 1 << 17, 8
    k = 100.0
    bq = _qe(steps, lam=0.0)
    hq = HestonQE.create(dt=T / steps, dtype=jnp.float64,
                         **{kk: P[kk] for kk in
                            ("s0", "v0", "mu", "kappa", "theta", "xi",
                             "rho")})

    def price(proc):
        pay = np.maximum(
            np.asarray(proc.prices(_terminal(proc, n, steps))) - k, 0.0)
        return pay.mean(), pay.std() / np.sqrt(n)

    a, se_a = price(bq)
    b, se_b = price(hq)
    assert abs(a - b) <= 4.0 * np.hypot(se_a, se_b)


def test_draws_pair_bitwise_matches_draws():
    proc = _qe(16, dtype=jnp.float32)
    ids = jnp.arange(256, dtype=jnp.uint32)
    for j in (0, 5):
        a, b = proc.draws_pair(5, 9, ids, j, jnp.float32)
        want_a = proc.draws(5, 9, ids, 2 * j, jnp.float32)
        want_b = proc.draws(5, 9, ids, 2 * j + 1, jnp.float32)
        for got, want in zip(a + b, want_a + want_b):
            np.testing.assert_array_equal(np.asarray(got),
                                          np.asarray(want))


def test_fused_kernel_parity_ulp():
    """Cross-engine agreement at f32 ULP level (NOT bitwise — the QE
    drift chain's contraction is program-dependent; see
    tests/test_heston_qe.py and DEVNOTES)."""
    proc = _qe(16, dtype=jnp.float32)
    n = 128 * 128
    ref = np.asarray(simulate(proc, n, 16, seed=5))
    ker = np.asarray(fused_terminal_pallas(proc, n, 16, seed=5,
                                           block=128, interpret=True))
    np.testing.assert_allclose(ker, ref, rtol=1e-5, atol=0.0)


def test_create_validation():
    with pytest.raises(ValueError, match="xi"):
        BatesQE.create(dt=0.1, **{**P, "xi": 0.0})
    with pytest.raises(ValueError, match="kappa"):
        BatesQE.create(dt=0.1, **{**P, "kappa": -1.0})


def test_cli_price_prints_cf_oracle(capsys):
    import json

    from montecarlo import cli

    assert cli.main(["price", "--process", "bates-qe", "--paths", "16384",
                     "--steps", "16", "--strike", "100", "--rate", "0.0",
                     "--v0", "0.04", "--kappa", "0.5", "--theta", "0.04",
                     "--xi", "1.0", "--rho", "-0.9"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "cf_price" in out
    assert abs(out["price"] - out["cf_price"]) <= 6.0 * out["std_err"]
