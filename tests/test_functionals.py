"""Path functionals, exotic payoffs, implied vol."""

import numpy as np
import jax.numpy as jnp

from montecarlo.engine import simulate
from montecarlo.engine.functionals import (
    ARITH_MEAN,
    GEO_MEAN,
    RUNNING_MAX,
    RUNNING_MIN,
    asian_call,
    down_and_out_call,
    geometric_asian_call_closed_form,
    lookback_call_floating,
    simulate_functionals,
    up_and_out_call,
)
from montecarlo.engine.implied_vol import implied_vol_call
from montecarlo.engine.payoffs import black_scholes_call
from montecarlo.processes import GBM

S0, R, SIGMA, STRIKE = 100.0, 0.03, 0.2, 100.0
N_STEPS = 64
T = N_STEPS / 252.0


def _gbm():
    return GBM.create(s0=S0, mu=R, sigma=SIGMA, dt=1 / 252)


def test_functionals_match_materialized_paths():
    n = 4096
    out = simulate_functionals(
        _gbm(), n, N_STEPS, seed=5,
        functionals={"avg": ARITH_MEAN, "geo": GEO_MEAN,
                     "max": RUNNING_MAX, "min": RUNNING_MIN})
    paths = np.asarray(simulate(_gbm(), n, N_STEPS, seed=5, mode="paths"))
    np.testing.assert_array_equal(np.asarray(out["terminal"]), paths[-1])
    np.testing.assert_allclose(np.asarray(out["avg"]), paths.mean(axis=0),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(out["geo"]),
                               np.exp(np.log(paths).mean(axis=0)), rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(out["max"]), paths.max(axis=0))
    np.testing.assert_array_equal(np.asarray(out["min"]), paths.min(axis=0))


def test_geometric_asian_matches_closed_form():
    n = 1 << 17
    out = simulate_functionals(_gbm(), n, N_STEPS, seed=9,
                               functionals={"geo": GEO_MEAN})
    payoff = np.asarray(asian_call(out["geo"], STRIKE)) * np.exp(-R * T)
    price, se = payoff.mean(), payoff.std() / np.sqrt(n)
    analytic = geometric_asian_call_closed_form(S0, STRIKE, R, SIGMA, T,
                                                N_STEPS)
    assert abs(price - analytic) < 4 * se, (price, analytic, se)


def test_barrier_payoffs_sane():
    n = 1 << 15
    out = simulate_functionals(
        _gbm(), n, N_STEPS, seed=3,
        functionals={"max": RUNNING_MAX, "min": RUNNING_MIN})
    vanilla = np.asarray(jnp.maximum(out["terminal"] - STRIKE, 0.0))
    uo = np.asarray(up_and_out_call(out["terminal"], out["max"], STRIKE,
                                    barrier=115.0))
    do = np.asarray(down_and_out_call(out["terminal"], out["min"], STRIKE,
                                      barrier=90.0))
    # Knocked-out payoffs are dominated by the vanilla, and the barriers
    # actually bite.
    assert np.all(uo <= vanilla + 1e-6) and uo.mean() < vanilla.mean()
    assert np.all(do <= vanilla + 1e-6) and do.mean() < vanilla.mean()
    # Up-and-out pays zero precisely on breached paths.
    assert np.all(uo[np.asarray(out["max"]) >= 115.0] == 0.0)
    lb = np.asarray(lookback_call_floating(out["terminal"], out["min"]))
    assert np.all(lb >= -1e-5)
    assert lb.mean() > vanilla.mean()  # floating lookback dominates ATM call


def test_implied_vol_roundtrip():
    sigmas = np.array([0.1, 0.2, 0.35, 0.6])
    strikes = np.array([80.0, 100.0, 120.0, 95.0])
    prices = np.asarray(black_scholes_call(S0, strikes, R, sigmas, 1.0))
    iv = np.asarray(implied_vol_call(prices, S0, strikes, R, 1.0))
    np.testing.assert_allclose(iv, sigmas, atol=1e-6)


def test_implied_vol_rejects_arbitrage():
    iv = implied_vol_call(jnp.asarray([0.0, 150.0]), S0, 100.0, R, 1.0)
    assert np.all(np.isnan(np.asarray(iv)))


def test_implied_vol_batches_over_strike():
    """Scalar price with a batched strike axis must broadcast (the Newton
    carry used to be seeded at price.shape and crash; review finding r2)."""
    from montecarlo.engine import black_scholes_call
    from montecarlo.engine.implied_vol import implied_vol_call

    strikes = jnp.asarray([90.0, 100.0, 110.0])
    prices = black_scholes_call(100.0, strikes, 0.03, 0.25, 1.0)
    # batched prices, scalar everything else
    ivs = np.asarray(implied_vol_call(prices, 100.0, strikes, 0.03, 1.0))
    np.testing.assert_allclose(ivs, 0.25, atol=1e-6)
    # scalar price, batched strike: one price cannot match all strikes,
    # but the solver must run (shape = common broadcast), not crash.
    out = np.asarray(implied_vol_call(float(prices[1]), 100.0, strikes,
                                      0.03, 1.0))
    assert out.shape == (3,)
    np.testing.assert_allclose(out[1], 0.25, atol=1e-6)


def test_cliquet_sum_uncapped_matches_closed_form():
    """With no collar, E[sum of period returns] = n_periods*(e^{mu*P*dt}-1)
    under GBM, and the capped leg is bounded by n*cap and below the
    uncapped leg (Jensen-free pathwise bounds)."""
    from montecarlo.engine import cliquet_sum, simulate_functionals
    from montecarlo.processes import GBM

    mu, dt, period, n_steps = 0.06, 1 / 48, 12, 48  # 4 quarterly resets
    proc = GBM.create(s0=100.0, mu=mu, sigma=0.25, dt=dt,
                      dtype=jnp.float64)
    out = simulate_functionals(
        proc, 1 << 16, n_steps, seed=3, dtype=jnp.float64,
        functionals={
            "free": cliquet_sum(period, -10.0, 10.0),
            "capped": cliquet_sum(period, -0.02, 0.03)})
    free = np.asarray(out["free"])
    capped = np.asarray(out["capped"])
    n_periods = n_steps // period
    expect = n_periods * (np.exp(mu * period * dt) - 1.0)
    se = free.std() / np.sqrt(free.size)
    assert abs(free.mean() - expect) < 5 * se + 1e-4, (free.mean(), expect)
    assert capped.max() <= n_periods * 0.03 + 1e-12
    assert capped.min() >= n_periods * -0.02 - 1e-12


def test_autocallable_limits_and_price():
    """Degenerate limits pin the autocallable: trigger below any path ->
    calls at the first observation; trigger unreachable + barrier
    unbreachable -> pure discounted notional; and the generic price sits
    between the PDI-floor and the always-call ceiling."""
    from montecarlo.engine import autocallable, simulate_functionals
    from montecarlo.processes import GBM

    r, dt, period, n_steps = 0.03, 1 / 48, 12, 48
    proc = GBM.create(s0=100.0, mu=r, sigma=0.25, dt=dt, dtype=jnp.float64)

    def price(trigger, coupon, barrier):
        out = simulate_functionals(
            proc, 1 << 15, n_steps, seed=9, dtype=jnp.float64,
            functionals={"ac": autocallable(period, trigger, coupon,
                                            r * dt, barrier, 100.0)})
        return float(np.mean(np.asarray(out["ac"])))

    # Always calls at t=period with one coupon.
    always = price(trigger=0.0, coupon=0.05, barrier=0.0)
    np.testing.assert_allclose(always,
                               1.05 * np.exp(-r * period * dt), rtol=1e-12)
    # Never calls, never breaches: pure zero-coupon notional.
    zcb = price(trigger=1e9, coupon=0.05, barrier=0.0)
    np.testing.assert_allclose(zcb, np.exp(-r * n_steps * dt), rtol=1e-12)
    # Realistic note: price between the at-risk floor and par + coupons.
    p = price(trigger=100.0, coupon=0.02, barrier=70.0)
    assert zcb * 0.5 < p < 1.0 + 4 * 0.02
    # Lower PDI barrier (less capital risk) can only help the holder.
    assert p <= price(trigger=100.0, coupon=0.02, barrier=50.0) + 1e-9


def test_autocallable_pdi_capped_at_notional():
    """A breached path that recovers above s0 still pays at most notional
    (the capital leg is short a PUT, not long the stock; review r2)."""
    from montecarlo.engine import autocallable

    f = autocallable(period=2, trigger=150.0, coupon=0.05, r_dt=0.0,
                     pdi_barrier=80.0, s0=100.0)
    path = [100.0, 70.0, 90.0, 120.0, 130.0]  # breach at t=1, recover
    acc = f.init(jnp.asarray([path[0]]))
    for t, s in enumerate(path[1:], start=1):
        acc = f.update(acc, jnp.asarray([s]), jnp.asarray(t))
    val = float(f.finalize(acc, 4.0)[0])
    assert val == 1.0  # min(S_T/s0, 1) with S_T = 130 > s0
    # And n_steps not a multiple of the period is rejected loudly.
    import pytest

    with pytest.raises(ValueError, match="multiple"):
        f.finalize(acc, 5.0)


def test_worst_of_autocallable_degenerates_to_single():
    """A = 1 worst-of == the single-asset autocallable on identical paths
    (MultiGBM with one asset draws the same stream as GBM)."""
    import numpy as np

    from montecarlo.engine import (autocallable, simulate_functionals,
                                       worst_of_autocallable)
    from montecarlo.processes import GBM, MultiGBM

    s0, r, sig = 100.0, 0.03, 0.25
    period, n_obs = 16, 4
    n_steps = period * n_obs
    dt = 1.0 / n_steps
    g = GBM.create(s0=s0, mu=r, sigma=sig, dt=dt)
    m = MultiGBM.create(s0=[s0], mu=[r], sigma=[sig], corr=np.eye(1),
                        dt=dt)
    single = simulate_functionals(
        g, 1 << 14, n_steps, seed=9,
        functionals={"ac": autocallable(period, 1.0 * s0, 0.02, r * dt,
                                        0.7 * s0, s0)})
    worst = simulate_functionals(
        m, 1 << 14, n_steps, seed=9,
        functionals={"ac": worst_of_autocallable(period, 1.0, 0.02,
                                                 r * dt, 0.7, [s0])})
    np.testing.assert_allclose(np.asarray(worst["ac"]),
                               np.asarray(single["ac"]), atol=1e-6)


def test_worst_of_autocallable_orderings():
    """Economic orderings: more assets -> cheaper note (worse worst), and
    near-perfect correlation -> the single-asset price."""
    import numpy as np

    from montecarlo.engine import (mc_estimate, simulate_functionals,
                                       worst_of_autocallable)
    from montecarlo.processes import MultiGBM

    s0, r, sig = 100.0, 0.03, 0.25
    period, n_obs = 16, 4
    n_steps = period * n_obs
    dt = 1.0 / n_steps

    def price(a, corr_val, seed=11):
        corr = np.full((a, a), corr_val)
        np.fill_diagonal(corr, 1.0)
        proc = MultiGBM.create(s0=[s0] * a, mu=[r] * a, sigma=[sig] * a,
                               corr=corr, dt=dt)
        out = simulate_functionals(
            proc, 1 << 15, n_steps, seed=seed,
            functionals={"ac": worst_of_autocallable(
                period, 1.0, 0.02, r * dt, 0.7, [s0] * a)})
        est = mc_estimate(out["ac"], 1.0)
        return float(est["price"]), float(est["std_err"])

    p1, se1 = price(1, 0.0)
    p3, se3 = price(3, 0.3)
    p3_hi, se3_hi = price(3, 0.999)
    assert p3 < p1 - 4 * (se1 + se3), (p1, p3)
    assert abs(p3_hi - p1) < 4 * (se1 + se3_hi) + 0.003, (p1, p3_hi)


def test_cli_note_autocall_and_cliquet(capsys):
    import json

    from montecarlo import cli

    rc = cli.main(["note", "--n-assets", "3", "--paths", "8192",
                   "--steps", "64", "--observations", "4"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0.5 < out["autocall_note"] < 1.2, out
    rc = cli.main(["note", "--type", "cliquet", "--paths", "8192",
                   "--steps", "64", "--observations", "4"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0.0 <= out["cliquet_leg"] < 0.2, out


def test_autocallable_traced_finalize_clear_error():
    """Finalizing with a traced step count must fail with the contract
    (static n_steps required), not an inscrutable ConcretizationTypeError
    from int(tracer)."""
    import jax
    import pytest

    from montecarlo.engine.functionals import autocallable

    fn = autocallable(period=4, trigger=1.0, coupon=0.02, r_dt=0.0,
                      pdi_barrier=0.7, s0=1.0)
    acc = fn.init(jnp.ones((8,)))
    with pytest.raises(TypeError, match="static"):
        jax.jit(lambda n: fn.finalize(acc, n))(8)
