"""Longstaff-Schwartz American pricing vs a binomial-tree oracle."""

import numpy as np

from montecarlo.engine import black_scholes_call, black_scholes_put
from montecarlo.engine.american import binomial_american_put, lsm_price
from montecarlo.processes import GBM
import jax.numpy as jnp

R, SIGMA, T = 0.06, 0.2, 1.0
N_EX = 50  # exercise dates (Longstaff-Schwartz 2001 setup)


def _gbm(s0):
    return GBM.create(s0=s0, mu=R, sigma=SIGMA, dt=T / N_EX)


def test_american_put_matches_binomial():
    for s0 in (36.0, 40.0, 44.0):
        out = lsm_price(
            _gbm(s0), lambda s: jnp.maximum(40.0 - s, 0.0),
            1 << 17, N_EX, seed=11, rate=R, dt=T / N_EX, degree=3)
        tree = binomial_american_put(s0, 40.0, R, SIGMA, T, n_steps=1000)
        err = abs(float(out["price"]) - tree)
        assert err < 4 * float(out["std_err"]) + 0.05, (s0, float(out["price"]), tree)


def test_american_put_dominates_european():
    s0 = 36.0
    out = lsm_price(_gbm(s0), lambda s: jnp.maximum(40.0 - s, 0.0),
                    1 << 16, N_EX, seed=3, rate=R, dt=T / N_EX)
    euro = float(black_scholes_put(s0, 40.0, R, SIGMA, T))
    assert float(out["price"]) > euro + 0.1  # early exercise premium


def test_american_call_no_dividends_equals_european():
    """Without dividends, early exercise of a call is never optimal."""
    s0 = 100.0
    out = lsm_price(_gbm(s0), lambda s: jnp.maximum(s - 105.0, 0.0),
                    1 << 16, N_EX, seed=5, rate=R, dt=T / N_EX)
    euro = float(black_scholes_call(s0, 105.0, R, SIGMA, T))
    assert abs(float(out["price"]) - euro) < 4 * float(out["std_err"]) + 0.03


def test_andersen_broadie_brackets_binomial():
    """LSM (low-biased) and the AB dual (high-biased) must bracket the CRR
    binomial price, and the gap must be tight for a good policy."""
    import jax.numpy as jnp

    from montecarlo.engine.american import (
        andersen_broadie_bound,
        binomial_american_put,
        lsm_policy,
    )
    from montecarlo.processes import GBM

    s0, strike, r, sigma, T = 100.0, 105.0, 0.05, 0.2, 0.5
    steps = 32
    dt = T / steps
    proc = GBM.create(s0=s0, mu=r, sigma=sigma, dt=dt)
    payoff = lambda s: jnp.maximum(strike - s, 0.0)

    lsm, policy = lsm_policy(proc, payoff, 1 << 15, steps, seed=5,
                             rate=r, dt=dt, degree=3)
    ab = andersen_broadie_bound(proc, payoff, policy, 2048, 512, steps,
                                seed=99, rate=r, dt=dt, degree=3)
    exact = binomial_american_put(s0, strike, r, sigma, T, n_steps=2000)

    lo, lo_se = float(lsm["price"]), float(lsm["std_err"])
    hi, hi_se = float(ab["upper"]), float(ab["std_err"])
    assert lo - 4 * lo_se < exact, (lo, exact)
    assert hi + 4 * hi_se > exact, (hi, exact)
    assert lo < hi + 4 * (lo_se + hi_se)
    # Tight bracket: ~0.1 duality gap for the degree-7 value surrogate at
    # n_inner=512 (the dual's positive bias shrinks with inner samples).
    assert hi - lo < 0.2, (lo, hi, exact)


def test_andersen_broadie_upper_is_above_european():
    """Sanity: the American upper bound dominates the European value."""
    import jax.numpy as jnp

    from montecarlo.engine.american import (
        andersen_broadie_bound, lsm_policy)
    from montecarlo.engine.payoffs import black_scholes_put
    from montecarlo.processes import GBM

    s0, strike, r, sigma, T = 100.0, 110.0, 0.05, 0.25, 1.0
    steps = 16
    dt = T / steps
    proc = GBM.create(s0=s0, mu=r, sigma=sigma, dt=dt)
    payoff = lambda s: jnp.maximum(strike - s, 0.0)
    _, policy = lsm_policy(proc, payoff, 1 << 14, steps, seed=2,
                           rate=r, dt=dt, degree=3)
    ab = andersen_broadie_bound(proc, payoff, policy, 2048, 32, steps,
                                seed=3, rate=r, dt=dt, degree=3)
    euro = float(black_scholes_put(s0, strike, r, sigma, T))
    assert float(ab["upper"]) + 4 * float(ab["std_err"]) > euro


def test_andersen_broadie_same_seed_as_policy_stays_upper():
    """The dual's outer paths live on a dedicated stream, so even passing
    the SAME seed as lsm_policy cannot evaluate the surrogate in-sample
    (code-review finding: stream-0 reuse made the 'upper bound' train-set
    biased and silently below the true price)."""
    import jax.numpy as jnp

    from montecarlo.engine.american import (
        andersen_broadie_bound,
        binomial_american_put,
        lsm_policy,
    )
    from montecarlo.processes import GBM

    s0, strike, r, sigma, T = 100.0, 105.0, 0.05, 0.2, 0.5
    steps = 32
    dt = T / steps
    proc = GBM.create(s0=s0, mu=r, sigma=sigma, dt=dt)
    payoff = lambda s: jnp.maximum(strike - s, 0.0)
    _, policy = lsm_policy(proc, payoff, 1 << 15, steps, seed=5,
                           rate=r, dt=dt, degree=3)
    ab = andersen_broadie_bound(proc, payoff, policy, 2048, 256, steps,
                                seed=5, rate=r, dt=dt, degree=3)  # same seed
    exact = binomial_american_put(s0, strike, r, sigma, T, n_steps=2000)
    assert float(ab["upper"]) + 4 * float(ab["std_err"]) > exact


def test_lsm_is_process_generic_heston():
    """LSM works for any process in the protocol: under Heston the American
    put must dominate the European (CF-priced) and stay below strike."""
    import jax.numpy as jnp

    from montecarlo.engine.heston_analytic import HestonParams, heston_call_cf
    from montecarlo.processes import Heston

    s0, k, r, T, n_steps = 100.0, 100.0, 0.05, 0.5, 50
    hp = dict(v0=0.04, kappa=1.5, theta=0.04, xi=0.5, rho=-0.6)
    proc = Heston.create(s0=s0, mu=r, dt=T / n_steps, **hp)
    res = lsm_price(proc, lambda s: jnp.maximum(k - s, 0.0), 1 << 15,
                    n_steps, seed=5, rate=r, dt=T / n_steps, degree=3)
    # European put via CF call + parity
    call = float(heston_call_cf(s0, k, T, r, HestonParams(
        hp["v0"], hp["kappa"], hp["theta"], hp["xi"], hp["rho"])))
    euro_put = call - s0 + k * np.exp(-r * T)
    price, se = float(res["price"]), float(res["std_err"])
    assert price > euro_put - 3 * se - 0.02, (price, euro_put)
    assert price < k
    # the early-exercise premium should be visibly positive at these params
    assert price > euro_put + 0.01, (price, euro_put)


def test_american_asian_lsm_properties():
    """American-Asian via LSM on (spot, running-average): European parity
    at exercise_from=T, monotonicity in exercise rights, early-exercise
    premium for the put, and vanilla degeneracy."""
    from montecarlo.engine import (ARITH_MEAN, mc_estimate,
                                       simulate_functionals)
    from montecarlo.engine.american import lsm_price_path_dependent

    n, steps = 1 << 14, 32
    dt = T / steps
    proc = GBM.create(s0=100.0, mu=R, sigma=SIGMA, dt=dt)
    k = 100.0

    def asian_put(s, a):
        return jnp.maximum(k - a, 0.0)

    # European parity: no early exercise reproduces the plain discounted
    # Asian payoff on the same draws exactly (same streams, same average).
    euro_lsm = lsm_price_path_dependent(
        proc, asian_put, ARITH_MEAN, n, steps, seed=3, rate=R, dt=dt,
        exercise_from=steps)
    out = simulate_functionals(proc, n, steps, seed=3,
                               functionals={"avg": ARITH_MEAN})
    euro = mc_estimate(jnp.maximum(k - out["avg"], 0.0),
                       float(np.exp(-R * T)))
    np.testing.assert_allclose(float(euro_lsm["price"]),
                               float(euro["price"]), rtol=1e-5)

    # More exercise rights can only add value (same paths, same policy
    # family) — allow LSM regression noise.
    amer = lsm_price_path_dependent(proc, asian_put, ARITH_MEAN, n, steps,
                                    seed=3, rate=R, dt=dt)
    half = lsm_price_path_dependent(proc, asian_put, ARITH_MEAN, n, steps,
                                    seed=3, rate=R, dt=dt,
                                    exercise_from=steps // 2)
    se = float(euro["std_err"])
    assert float(amer["price"]) >= float(half["price"]) - 2 * se
    assert float(half["price"]) >= float(euro_lsm["price"]) - 2 * se
    # The average-strike put carries a real early-exercise premium at r=6%.
    assert float(amer["price"]) > float(euro_lsm["price"]) + se

    # Degenerate: a payoff ignoring the functional reproduces vanilla
    # American LSM (within regression-basis noise).
    vanilla = lsm_price(proc, lambda s: jnp.maximum(k - s, 0.0), n, steps,
                        seed=3, rate=R, dt=dt, degree=3)
    via_pd = lsm_price_path_dependent(
        proc, lambda s, a: jnp.maximum(k - s, 0.0), ARITH_MEAN, n, steps,
        seed=3, rate=R, dt=dt, degree=2)
    assert abs(float(via_pd["price"]) - float(vanilla["price"])) < (
        4 * (float(vanilla["std_err"]) + float(via_pd["std_err"])) + 0.05)
