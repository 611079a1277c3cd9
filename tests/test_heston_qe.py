"""Heston QE-M scheme (processes/heston_qe.py): exact conditional variance
moments in BOTH branches, the martingale correction, the coarse-step
accuracy win over full-truncation Euler vs the CF oracle, draw-stream
contracts, and fused-kernel parity."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from montecarlo.engine.heston_analytic import HestonParams, heston_call_cf
from montecarlo.engine.simulate import simulate
from montecarlo.ops.fused_engine import fused_terminal_pallas
from montecarlo.processes import Heston, HestonQE

# Andersen (2008) case-like: Feller strongly violated
# (2 kappa theta = 0.04 << xi^2 = 1), where Euler bias is worst.
P = dict(s0=100.0, v0=0.04, mu=0.0, kappa=0.5, theta=0.04, xi=1.0,
         rho=-0.9)
T = 1.0


def _qe(steps, dtype=jnp.float64, **over):
    return HestonQE.create(dt=T / steps, dtype=dtype, **{**P, **over})


def _terminal(proc, n, steps, seed=7, dtype=jnp.float64):
    ids = jnp.arange(n, dtype=jnp.uint32)
    st = proc.init_state(ids, dtype)

    def body(c, t):
        return proc.step(c, proc.draws(seed, 0, ids, t, dtype), t), None

    st, _ = jax.lax.scan(body, st, jnp.arange(steps))
    return st


def test_variance_transition_matches_exact_cir_moments():
    """Both QE branches are built to match the EXACT CIR conditional mean
    and variance — checked by sampling one transition from a fixed v0 in
    each regime (v0=theta lands exponential, psi~2.9; v0=0.5 lands
    quadratic, psi~0.26, for these parameters at dt=1/8)."""
    steps = 8
    proc = _qe(steps)
    n = 1 << 18
    ids = jnp.arange(n, dtype=jnp.uint32)
    dt = T / steps
    e = np.exp(-P["kappa"] * dt)
    for v0, branch in ((P["theta"], "exponential"), (0.5, "quadratic")):
        m = P["theta"] + (v0 - P["theta"]) * e
        s2 = (v0 * P["xi"] ** 2 * e * (1 - e) / P["kappa"]
              + P["theta"] * P["xi"] ** 2 * (1 - e) ** 2
              / (2 * P["kappa"]))
        psi = s2 / m**2
        assert (psi <= 1.5) == (branch == "quadratic")
        st = proc.init_state(ids, jnp.float64)._replace(
            v=jnp.full((n,), v0, jnp.float64))
        nxt = proc.step(st, proc.draws(11, 0, ids, 0, jnp.float64), 0)
        v1 = np.asarray(nxt.v)
        assert v1.min() >= 0.0
        assert abs(v1.mean() - m) <= 5.0 * np.sqrt(s2 / n), branch
        # SE of the sample variance ~ s2 * sqrt((kurt + 2)/n); the
        # exponential branch's point mass pushes kurtosis toward ~9.
        assert abs(v1.var() - s2) <= 6.0 * s2 * np.sqrt(11.0 / n), branch


def test_martingale_correction_is_exact():
    """QE-M's whole point: E[S_T] e^{-mu T} = s0 to MC error even at very
    coarse steps (the uncorrected scheme drifts by O(dt))."""
    n, steps = 1 << 18, 4
    proc = _qe(steps, mu=0.03)
    st = _terminal(proc, n, steps)
    s = np.asarray(proc.prices(st)) * np.exp(-0.03 * T)
    assert abs(s.mean() - P["s0"]) <= 4.0 * s.std() / np.sqrt(n)


def test_coarse_step_call_beats_euler_vs_cf_oracle():
    """At 8 steps/year on the Feller-violating surface the QE price is
    statistically indistinguishable from the CF oracle while
    full-truncation Euler is biased by ~half the option value (measured
    +2.14 on a 4.40 call, >200 sigma) — the scheme's reason to exist."""
    cf = float(heston_call_cf(
        P["s0"], 100.0, T, 0.0,
        HestonParams(v0=P["v0"], kappa=P["kappa"], theta=P["theta"],
                     xi=P["xi"], rho=P["rho"])))
    n, steps = 1 << 18, 8
    k = 100.0

    def price(proc):
        st = _terminal(proc, n, steps)
        pay = np.maximum(np.asarray(proc.prices(st)) - k, 0.0)
        return pay.mean(), pay.std() / np.sqrt(n)

    qe, se_qe = price(_qe(steps))
    eu, se_eu = price(Heston.create(dt=T / steps, dtype=jnp.float64, **P))
    assert abs(qe - cf) <= 4.0 * se_qe
    assert eu - cf > 20.0 * se_eu  # Euler's coarse-step bias is real


def test_draws_pair_bitwise_matches_draws():
    proc = _qe(16, dtype=jnp.float32)
    ids = jnp.arange(256, dtype=jnp.uint32)
    for j in (0, 3):
        a, b = proc.draws_pair(5, 9, ids, j, jnp.float32)
        want_a = proc.draws(5, 9, ids, 2 * j, jnp.float32)
        want_b = proc.draws(5, 9, ids, 2 * j + 1, jnp.float32)
        for got, want in zip(a + b, want_a + want_b):
            np.testing.assert_array_equal(np.asarray(got),
                                          np.asarray(want))


def test_antithetic_is_unbiased_and_reduces_variance():
    from montecarlo.samplers import AntitheticSampler

    proc = _qe(16, dtype=jnp.float32)
    n = 1 << 16
    plain = np.asarray(simulate(proc, n, 16, seed=3))
    anti = np.asarray(simulate(proc, n, 16, seed=3,
                               sampler=AntitheticSampler()))
    k = 100.0
    pp = np.maximum(plain - k, 0.0)
    pa = np.maximum(anti - k, 0.0).reshape(2, -1).mean(axis=0)
    se_p = pp.std() / np.sqrt(n)
    se_a = pa.std() / np.sqrt(n // 2)
    assert abs(pa.mean() - pp.mean()) <= 4.0 * np.hypot(se_p, se_a)
    assert se_a < se_p  # mirrored normal + reflected uniform anticorrelate


def test_fused_kernel_parity():
    """Scan vs fused kernel agree to float32 ULP level, NOT bitwise: the
    QE step's five-term drift chain offers many mul->add contraction
    sites, and this stack compiles with --xla_allow_excess_precision=true,
    so the two programs contract differently at the last ULP (measured:
    every individual term IS bitwise; only the summation flips — the
    cross-engine instance of DEVNOTES "Per-path step math is only
    width-stable at a FIXED compile width").  Within one engine results
    remain exactly reproducible, which is what the determinism contract
    pins; cross-engine agreement is bounded here instead."""
    proc = _qe(16, dtype=jnp.float32)
    n = 128 * 128
    ref = np.asarray(simulate(proc, n, 16, seed=5))
    ker = np.asarray(fused_terminal_pallas(proc, n, 16, seed=5,
                                           block=128, interpret=True))
    np.testing.assert_allclose(ker, ref, rtol=1e-5, atol=0.0)
    assert np.mean(ker != ref) < 0.25  # ULP flips on a minority of paths


def test_create_validation():
    with pytest.raises(ValueError, match="xi"):
        HestonQE.create(dt=0.1, **{**P, "xi": 0.0})
    with pytest.raises(ValueError, match="kappa"):
        HestonQE.create(dt=0.1, **{**P, "kappa": -1.0})


def test_cli_price_and_american(capsys):
    import json

    from montecarlo import cli

    args = ["price", "--process", "heston-qe", "--paths", "16384",
            "--steps", "16", "--strike", "100", "--rate", "0.0",
            "--v0", "0.04", "--kappa", "0.5", "--theta", "0.04",
            "--xi", "1.0", "--rho", "-0.9"]
    assert cli.main(args) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cf = float(heston_call_cf(
        100.0, 100.0, 1.0, 0.0,
        HestonParams(v0=0.04, kappa=0.5, theta=0.04, xi=1.0, rho=-0.9)))
    assert abs(out["price"] - cf) <= 4.0 * out["std_err"]
    # The SV-aware LSM accepts the QE state (it carries v like Heston's).
    assert cli.main(args + ["--payoff", "put", "--american",
                            "--paths", "4096"]) == 0
    am = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert am["price"] >= 0.0
