"""Short-rate model calibration to swaption quotes.

Completes the calibration family (Heston/SABR/Levy fit implied-vol
surfaces through their differentiable pricers — `engine.levy_calibration`
pattern) for the rates asset class: Vasicek (kappa, theta, sigma) fitted
to a grid of European payer-swaption prices by Adam on exact gradients
through a fully traced Jamshidian pricer.

The pricer is the batched jnp twin of
`engine.bermudan.vasicek_swaption_jamshidian` (host brentq) — the
critical rate r* is a vectorized, clipped Newton iteration (the par gap
is a smooth monotone exponential sum), so the whole quote surface is one
differentiable program; the two agree to ~1e-12 (tested), and the demo
calibration recovers generating parameters from a cold start.

Hull-White note: theta(t) is fitted EXACTLY to the discount curve by
construction (`HullWhite.from_forward_curve`); what a desk calibrates to
swaptions is (a, sigma), for which the Vasicek machinery here is the
constant-theta specialization — same bond-option decomposition.

LMM (round 5): the standard two-stage market-model calibration —
`bootstrap_lmm_vols` inverts a co-terminal CAP strip into the per-tenor
vol term structure (exact: caplets are Black closed forms under the
lognormal LMM), then `calibrate_lmm_corr_to_swaptions` pins the
forward-correlation decay to European swaption premia through the
Rebonato frozen-weight map.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from montecarlo.engine.rates import (vasicek_bond_from_rate,
                                         vasicek_bond_option_from_rate)


def vasicek_swaption_prices(r0, kappa, theta, sigma, expiries, pay_dts,
                            strikes, n_periods, *, max_periods=None):
    """European payer-swaption prices for a batch of quotes, jnp + AD.

    Per quote i: exercise at ``expiries[i]`` into a payer swap with
    ``n_periods[i]`` payments every ``pay_dts[i]`` at fixed
    ``strikes[i]``.  Ragged payment counts are padded to ``max_periods``
    and masked.  Returns a (Q,) price vector; every input may be traced
    (the calibrator differentiates w.r.t. kappa/theta/sigma THROUGH the
    Newton critical rate).
    """
    dt_ = jax.dtypes.canonicalize_dtype(jnp.float64)  # f32 without x64
    expiries = jnp.asarray(expiries, dt_)
    pay_dts = jnp.asarray(pay_dts, dt_)
    strikes = jnp.asarray(strikes, dt_)
    n_per = jnp.asarray(n_periods, jnp.int32)
    q = expiries.shape[0]
    pmax = int(max_periods if max_periods is not None
               else int(jnp.max(n_per)))
    j = jnp.arange(pmax)
    mask = (j[None, :] < n_per[:, None]).astype(dt_)   # (Q, P)
    taus = (j + 1.0)[None, :] * pay_dts[:, None]               # from T0
    coup = strikes[:, None] * pay_dts[:, None] * mask
    last = jnp.maximum(n_per - 1, 0)
    coup = coup.at[jnp.arange(q), last].add(1.0)

    kap = jnp.asarray(kappa, dt_)
    b_tau = (1.0 - jnp.exp(-kap * taus)) / kap

    def gap_and_slope(r):
        p = vasicek_bond_from_rate(r[:, None], kappa, theta, sigma,
                                   taus) * mask
        f = jnp.sum(coup * p, axis=1) - 1.0
        fp = -jnp.sum(coup * b_tau * p, axis=1)
        return f, fp

    def newton(_, r):
        f, fp = gap_and_slope(r)
        return jnp.clip(r - f / jnp.minimum(fp, -1e-12), -2.0, 3.0)

    r_star = jax.lax.fori_loop(
        0, 40, newton, jnp.full((q,), jnp.asarray(theta, dt_)))
    ks = vasicek_bond_from_rate(r_star[:, None], kappa, theta, sigma, taus)
    puts = vasicek_bond_option_from_rate(
        jnp.asarray(r0, dt_), kappa, theta, sigma,
        expiries[:, None], expiries[:, None] + taus, ks, call=False)
    return jnp.sum(coup * puts * mask, axis=1)


def _constrain(raw):
    return {"kappa": jax.nn.softplus(raw[0]),
            "theta": raw[1] * 0.05,
            "sigma": jax.nn.softplus(raw[2]) * 0.02}


@partial(jax.jit, static_argnames=("n_iters", "max_periods", "lr"))
def _calibrate(r0, expiries, pay_dts, strikes, n_periods, prices, raw0,
               n_iters: int, lr: float, max_periods: int):
    import optax

    def loss_fn(raw):
        p = _constrain(raw)
        model = vasicek_swaption_prices(
            r0, p["kappa"], p["theta"], p["sigma"], expiries, pay_dts,
            strikes, n_periods, max_periods=max_periods)
        # Relative price error: quotes span expiries/tenors over orders
        # of magnitude, and premia are strictly positive.
        return jnp.mean(jnp.square(model / prices - 1.0))

    opt = optax.adam(lr)
    grad_fn = jax.value_and_grad(loss_fn)

    def step(carry, _):
        raw, opt_state = carry
        loss, g = grad_fn(raw)
        updates, opt_state = opt.update(g, opt_state)
        return (optax.apply_updates(raw, updates), opt_state), loss

    (raw, _), losses = jax.lax.scan(step, (raw0, opt.init(raw0)), None,
                                    length=n_iters)
    return raw, losses


def calibrate_vasicek_to_swaptions(expiries, pay_dts, strikes, n_periods,
                                   prices, *, r0, n_iters: int = 1500,
                                   lr: float = 0.05) -> dict:
    """Fit Vasicek (kappa, theta, sigma) to payer-swaption quotes.

    ``prices`` are premia per unit notional; ``r0`` is the observed short
    rate (not fitted).  Returns the constrained parameters plus
    ``rmse_rel`` — the residual RELATIVE price RMSE (one parameter triple
    prices every expiry x tenor, so on a real surface the residual is the
    one-factor model error itself, exactly the Levy-calibration
    honesty convention).
    """
    dt_ = jax.dtypes.canonicalize_dtype(jnp.float64)  # f32 without x64
    expiries = jnp.asarray(expiries, dt_)
    pay_dts = jnp.asarray(pay_dts, dt_)
    strikes = jnp.asarray(strikes, dt_)
    n_periods_arr = jnp.asarray(n_periods, jnp.int32)
    prices = jnp.asarray(prices, dt_)
    pmax = int(max(int(n) for n in n_periods))
    raw0 = jnp.asarray([0.3, 1.0, 0.5], dt_)
    raw, losses = _calibrate(jnp.asarray(r0, dt_), expiries, pay_dts, strikes,
                             n_periods_arr, prices, raw0, n_iters, lr,
                             pmax)
    out = {k: float(v) for k, v in _constrain(raw).items()}
    out["rmse_rel"] = float(jnp.sqrt(losses[-1]))
    return out


def _black76_np(f, k, sd):
    """Undiscounted Black-76 call (host f64; vector in any argument)."""
    import numpy as np
    from scipy.stats import norm

    f = np.asarray(f, np.float64)
    sd = np.asarray(sd, np.float64)
    with np.errstate(divide="ignore"):
        d1 = np.where(sd > 0, (np.log(f / k) + 0.5 * sd * sd)
                      / np.where(sd > 0, sd, 1.0), np.inf)
    return np.where(sd > 0, f * norm.cdf(d1) - k * norm.cdf(d1 - sd),
                    np.maximum(f - k, 0.0))


def _caplet_total_sds(f0, delta, strike, cap_prices):
    """Invert a co-terminal cap strip into per-caplet TOTAL stddevs
    (bisection on the monotone Black map; shared by both bootstraps)."""
    import numpy as np

    f0 = np.asarray(f0, np.float64)
    k_fwd = f0.shape[0]
    cap_prices = np.asarray(cap_prices, np.float64)
    if cap_prices.shape != (k_fwd - 1,):
        raise ValueError(f"need {k_fwd - 1} co-terminal cap quotes "
                         f"(resets 1..{k_fwd - 1}); got "
                         f"{cap_prices.shape}")
    caplets = np.diff(np.concatenate([[0.0], cap_prices]))
    if np.any(caplets <= 0.0):
        raise ValueError("cap strip is not strictly increasing — caplet "
                         "premia must be positive")
    dlt = float(delta)
    p = np.cumprod(1.0 / (1.0 + dlt * f0))
    sds = np.zeros(k_fwd)
    for k in range(1, k_fwd):
        undisc = caplets[k - 1] / (dlt * p[k])
        if undisc >= f0[k]:
            raise ValueError(f"caplet {k} price {caplets[k - 1]:.6g} "
                             "exceeds its undiscounted forward bound")
        lo_sd, hi_sd = 0.0, 1e2
        for _ in range(200):  # bisection: exact to f64 on a monotone map
            mid = 0.5 * (lo_sd + hi_sd)
            if _black76_np(f0[k], strike, mid) < undisc:
                lo_sd = mid
            else:
                hi_sd = mid
        sds[k] = 0.5 * (lo_sd + hi_sd)
    return sds


def bootstrap_lmm_ttm_vols(f0, delta, strike, cap_prices):
    """Bootstrap the TIME-HOMOGENEOUS vol table ``vol_ttm`` (forward k's
    vol during the period ``m = k - t - 1`` resets away is ``ttm[m]``,
    the `processes.lmm.LMM(vol_ttm=...)` structure) from a co-terminal
    cap strip: caplet k's total variance is
    ``delta * sum_{m < k} ttm[m]^2``, so consecutive differences pin each
    ``ttm[m]`` exactly.  Raises if the quoted caplet variance term
    structure is not increasing (no time-homogeneous fit exists)."""
    import numpy as np

    sds = _caplet_total_sds(f0, delta, strike, cap_prices)
    v = np.square(sds)
    dv = np.diff(v)
    if np.any(dv <= 0.0):
        raise ValueError(
            "caplet total variances are not increasing — no "
            "time-homogeneous vol table reproduces this strip "
            "(use the per-forward bootstrap_lmm_vols instead)")
    k_fwd = len(sds)
    ttm = np.zeros(k_fwd)
    ttm[0] = sds[1] / np.sqrt(float(delta))
    ttm[1:k_fwd - 1] = np.sqrt(dv[1:] / float(delta))
    ttm[k_fwd - 1] = ttm[k_fwd - 2]  # never observed by any quoted caplet
    return ttm


def bootstrap_lmm_vols(f0, delta, strike, cap_prices):
    """Bootstrap the LMM vol term structure from a CAP strip — the
    industry-standard construction: quotes are co-terminal caps on resets
    1..n (cap n covers caplets 1..n), so caplet k's price is the exact
    difference ``cap_k - cap_{k-1}`` and sigma_k inverts its Black
    closed form (EXACT under the lognormal LMM — `processes/lmm.py`
    caplet oracle) by bisection on the monotone total-stddev map.

    ``f0``: (K,) initial forwards; ``cap_prices``: (K-1,) premia of the
    caps ending at resets 1..K-1 (caplet 0 is deterministic and never
    quoted).  Returns (K,) sigmas with ``sigma_0`` copied from
    ``sigma_1`` (it never enters any price).  Raises on a non-increasing
    strip (caplet premia are strictly positive) or an unattainable
    caplet price (above the undiscounted forward bound).
    """
    import numpy as np

    sds = _caplet_total_sds(f0, delta, strike, cap_prices)
    k_fwd = len(sds)
    sigmas = np.zeros(k_fwd)
    sigmas[1:] = sds[1:] / np.sqrt(float(delta)
                                   * np.arange(1, k_fwd))
    sigmas[0] = sigmas[1]
    return sigmas


def calibrate_lmm_corr_to_swaptions(f0, sigma, delta, quotes, *,
                                    beta_hi: float = 3.0) -> dict:
    """Fit the forward-correlation decay ``beta``
    (``rho_jk = exp(-beta |T_j - T_k|)``) to European swaption premia
    through the Rebonato frozen-weight vol map — the industry-standard
    two-stage LMM calibration: caplets pin the per-tenor vols
    (:func:`bootstrap_lmm_vols`), swaptions pin the correlation (a
    swaption's Rebonato variance is strictly DECREASING in beta, so the
    1-D golden-section fit is well-posed).

    ``quotes``: iterable of ``(start_idx, end_idx, strike, price)``.
    Returns ``{"corr_beta", "rmse_rel"}``.
    """
    import numpy as np

    from montecarlo.processes.lmm import (LMM, lmm_swaption_rebonato)

    def loss(beta):
        m = LMM.create(f0, sigma, delta, corr_beta=float(beta))
        errs = [lmm_swaption_rebonato(m, int(s), int(e), float(k_)) / px
                - 1.0 for s, e, k_, px in quotes]
        return float(np.mean(np.square(errs)))

    # Golden-section on [0, beta_hi] (unimodal: each Rebonato variance is
    # monotone in beta, the squared relative errors sum to a unimodal
    # objective for consistent quotes).
    gr = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = 0.0, float(beta_hi)
    c, d = b - gr * (b - a), a + gr * (b - a)
    fc, fd = loss(c), loss(d)
    for _ in range(80):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc = loss(c)
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd = loss(d)
    beta = 0.5 * (a + b)
    return {"corr_beta": float(beta),
            "rmse_rel": float(np.sqrt(loss(beta)))}


__all__ = ["bootstrap_lmm_ttm_vols", "bootstrap_lmm_vols",
           "calibrate_lmm_corr_to_swaptions",
           "calibrate_vasicek_to_swaptions", "vasicek_swaption_prices"]
