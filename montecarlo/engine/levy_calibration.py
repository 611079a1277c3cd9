"""Calibrate the CF-priced model families — pure-jump Levy (VG, NIG) and
jump-diffusions (Merton, Kou) — to implied-vol surfaces.

Same recipe as `heston_analytic.calibrate_heston_to_ivs` (the pattern
desks actually use): the loss lives in **implied-vol space** —
differentiating through the CF pricer AND the vectorized Newton BS
inversion — so wings and short maturities get their natural weight, and
the optimizer is plain Adam on exact gradients inside one `lax.scan`
program (one XLA compile per fit, any surface size).

Unlike Heston there is no time-inhomogeneity to exploit: VG/NIG are Levy,
so one parameter triple prices EVERY maturity — a whole surface is a
meaningful (over-determined) fit, and the residual RMSE *is* the model
error, not noise.

Constraint handling maps raw optimizer coordinates to the models' open
parameter domains so every iterate is valid:

- VG (sigma, theta, nu): softplus scales for sigma/nu, free theta; the
  martingale-correction argument ``1 - theta*nu - sigma^2*nu/2`` is
  floored at 1e-4 inside the CF (same trick as the Heston IV clamp) so a
  far-from-data iterate degrades smoothly instead of NaNing the scan.
- NIG (alpha, beta, delta): ``alpha = max(|beta|, |beta+1|) + gap`` with
  ``gap = softplus`` — the constraints alpha > |beta| and
  alpha > |beta+1| hold by construction.

Beyond-reference capability (the reference has no derivatives layer at
all); completes the calibration family: Heston (`heston_analytic`),
SABR (`processes/sabr.py`), and now the Levy models those modules price.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from montecarlo.engine.cf_pricing import cf_call_price_impl
from montecarlo.engine.implied_vol import implied_vol_call

_N_QUAD = 96  # matches the Heston calibrator's quadrature


def _vg_constrain(raw):
    return {"sigma": jax.nn.softplus(raw[0]) * 0.2,
            "theta": raw[1] * 0.2,
            "nu": jax.nn.softplus(raw[2]) * 0.2 + 1e-3}


def _vg_phi(p, s0, r, T):
    sigma, theta, nu = p["sigma"], p["theta"], p["nu"]
    # Floor the martingale-correction argument: iterates that wander past
    # the E[S_t] < inf boundary price smoothly (and badly) instead of
    # NaNing the whole scan.  vg_log_cf itself (the validated oracle) has
    # no such clamp; re-derive the CF here with the guard.
    base_m = jnp.maximum(1.0 - theta * nu - 0.5 * sigma * sigma * nu, 1e-4)
    omega = jnp.log(base_m) / nu
    drift = jnp.log(s0) + (r + omega) * T

    def phi(us):
        iu = 1j * us
        base = 1.0 - iu * theta * nu + 0.5 * sigma * sigma * nu * us * us
        return jnp.exp(iu * drift - (T / nu) * jnp.log(base))
    return phi


def _nig_constrain(raw):
    beta = raw[1] * 5.0
    gap = jax.nn.softplus(raw[0]) * 5.0 + 0.1
    return {"alpha": jnp.maximum(jnp.abs(beta), jnp.abs(beta + 1.0)) + gap,
            "beta": beta,
            "delta": jax.nn.softplus(raw[2]) * 0.5 + 1e-3}


def _nig_phi(p, s0, r, T):
    alpha, beta, delta = p["alpha"], p["beta"], p["delta"]
    gamma = jnp.sqrt(alpha * alpha - beta * beta)
    omega = delta * (jnp.sqrt(alpha * alpha - (beta + 1.0) ** 2) - gamma)
    drift = jnp.log(s0) + (r + omega) * T

    def phi(us):
        iu = 1j * us
        root = jnp.sqrt(alpha * alpha - (beta + iu) ** 2)
        return jnp.exp(iu * drift + delta * T * (gamma - root))
    return phi


def _merton_constrain(raw):
    return {"sigma": jax.nn.softplus(raw[0]) * 0.2,
            "lam": jax.nn.softplus(raw[1]),
            "jump_mean": raw[2] * 0.2,
            "jump_std": jax.nn.softplus(raw[3]) * 0.2 + 1e-3}


def _merton_phi(p, s0, r, T):
    from montecarlo.engine.cf_pricing import merton_log_cf

    return merton_log_cf(s0, r, p["sigma"], p["lam"], p["jump_mean"],
                         p["jump_std"], T)


def _kou_constrain(raw):
    return {"sigma": jax.nn.softplus(raw[0]) * 0.2,
            "lam": jax.nn.softplus(raw[1]),
            "p_up": jax.nn.sigmoid(raw[2]),
            "eta1": 1.0 + jax.nn.softplus(raw[3]) * 10.0,  # > 1: finite m
            "eta2": jax.nn.softplus(raw[4]) * 10.0 + 1e-2}


def _kou_phi(p, s0, r, T):
    from montecarlo.engine.cf_pricing import kou_log_cf

    return kou_log_cf(s0, r, p["sigma"], p["lam"], p["p_up"], p["eta1"],
                      p["eta2"], T)


# Raw starts are plain tuples (converted at call time): module import must
# not touch the device backend.
_FAMILIES = {"vg": (_vg_constrain, _vg_phi, (0.5, -0.5, 0.5)),
             "nig": (_nig_constrain, _nig_phi, (1.0, -0.5, 0.5)),
             "merton": (_merton_constrain, _merton_phi,
                        (0.5, 0.0, -0.3, 0.5)),
             "kou": (_kou_constrain, _kou_phi,
                     (0.5, 0.0, -0.4, 0.0, 0.0))}


@partial(jax.jit, static_argnames=("family", "n_iters"))
def _calibrate_iv(family, strikes, maturities, ivs, s0, r, raw0,
                  n_iters: int, lr: float):
    import optax

    constrain, make_phi, _ = _FAMILIES[family]
    lower = jnp.maximum(s0 - strikes * jnp.exp(-r * maturities), 0.0)

    def loss_fn(raw):
        p = constrain(raw)
        model = cf_call_price_impl(make_phi(p, s0, r, maturities), s0,
                                   strikes, maturities, r, n_quad=_N_QUAD)
        # Clamp into the no-arbitrage band so the Newton IV inversion
        # never NaNs while the optimizer is far from the data.
        model = jnp.clip(model, lower + 1e-6, s0 * (1.0 - 1e-6))
        model_iv = implied_vol_call(model, s0, strikes, r, maturities)
        return jnp.mean(jnp.square(model_iv - ivs))

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


def calibrate_levy_to_ivs(family: str, strikes, maturities, ivs, *, s0, r,
                          n_iters: int = 1500, lr: float = 0.03) -> dict:
    """Fit a CF-priced family ("vg", "nig", "merton", "kou") to a market
    implied-vol surface.

    Returns the constrained parameters plus ``rmse_vol`` (the residual IV
    RMSE — these are all Levy/exponential-Levy models, so one parameter
    set prices every maturity and the residual on a multi-expiry surface
    measures model error, not noise)."""
    if family not in _FAMILIES:
        raise ValueError(f"unknown Levy family {family!r} "
                         f"(have {sorted(_FAMILIES)})")
    constrain, _, raw0 = _FAMILIES[family]
    raw0 = jnp.asarray(raw0, jnp.float32)
    strikes = jnp.asarray(strikes, jnp.float32)
    maturities = jnp.asarray(maturities, jnp.float32)
    ivs = jnp.asarray(ivs, jnp.float32)
    raw, losses = _calibrate_iv(family, strikes, maturities, ivs,
                                jnp.float32(s0), jnp.float32(r), raw0,
                                n_iters, lr)
    out = {k: float(v) for k, v in constrain(raw).items()}
    out["rmse_vol"] = float(jnp.sqrt(losses[-1]))
    return out


__all__ = ["calibrate_levy_to_ivs"]
