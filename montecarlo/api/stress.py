"""Stress / scenario grids: reprice a payoff over parameter bump ladders.

The desk risk report the reference cannot express: a spot x vol (or any
scalar-field) bump matrix repriced in ONE compiled program — `vmap` over
the bumped process pytrees, common random numbers across every scenario
(same counter-based draws), so scenario P&L differences carry no MC noise
from independent sampling.  The whole grid batches through XLA; no
per-scenario dispatch.

Beyond-reference capability; the closest reference analog is the single
'expected range' readout of its MC tab (reference app.py:944-1000).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from montecarlo.engine.simulate import simulate


def _bumped_price(process, payoff_fn, fields, ba, bb, n_paths, n_steps,
                  seed, stream, dtype, discount):
    """Reprice one scenario: fields[0] *= 1+ba, fields[1] *= 1+bb."""
    fa = getattr(process, fields[0])
    fb = getattr(process, fields[1])
    proc = process._replace(**{
        fields[0]: fa * (1.0 + ba).astype(jnp.asarray(fa).dtype),
        fields[1]: fb * (1.0 + bb).astype(jnp.asarray(fb).dtype)})
    terminal = simulate(proc, n_paths, n_steps, seed=seed,
                        stream=stream, dtype=dtype)
    return jnp.asarray(discount, dtype) * jnp.mean(payoff_fn(terminal))


@partial(jax.jit, static_argnames=("payoff_fn", "n_paths", "n_steps",
                                   "seed", "stream", "fields", "dtype"))
def _price_surface(process, payoff_fn, n_paths: int, n_steps: int,
                   bumps_a, bumps_b, seed: int, fields: tuple, discount,
                   stream: int, dtype):
    """2-D outer-product bump grid, vmapped both ways."""
    bumps_a = jnp.asarray(bumps_a, dtype)
    bumps_b = jnp.asarray(bumps_b, dtype)
    price_one = partial(_bumped_price, process, payoff_fn, fields,
                        n_paths=n_paths, n_steps=n_steps, seed=seed,
                        stream=stream, dtype=dtype, discount=discount)
    return jax.vmap(lambda ba: jax.vmap(lambda bb: price_one(ba, bb))(
        bumps_b))(bumps_a)


@partial(jax.jit, static_argnames=("payoff_fn", "n_paths", "n_steps",
                                   "seed", "stream", "fields", "dtype"))
def _price_pairs(process, payoff_fn, n_paths: int, n_steps: int,
                 bumps_a, bumps_b, seed: int, fields: tuple, discount,
                 stream: int, dtype):
    """Paired scenarios (bumps_a[i], bumps_b[i]) — the named-report shape.
    Module-level jit so repeated reports reuse the compiled program instead
    of retracing a per-call closure."""
    bumps_a = jnp.asarray(bumps_a, dtype)
    bumps_b = jnp.asarray(bumps_b, dtype)
    price_one = partial(_bumped_price, process, payoff_fn, fields,
                        n_paths=n_paths, n_steps=n_steps, seed=seed,
                        stream=stream, dtype=dtype, discount=discount)
    return jax.vmap(price_one)(bumps_a, bumps_b)


def stress_grid(process, payoff_fn, n_paths: int, n_steps: int, *,
                bumps_a, bumps_b, seed: int,
                fields: tuple = ("s0", "sigma"), discount=1.0,
                stream: int = 0, dtype=jnp.float32):
    """Price surface over a 2-D grid of *relative* bumps to two fields.

    Args:
      bumps_a / bumps_b: 1-D arrays of relative bumps (0.0 = base) applied
        multiplicatively to ``fields[0]`` / ``fields[1]``.

    Returns dict with ``prices[(len(a), len(b))]``, the bumped axes, and
    ``pnl`` relative to the (0, 0)-nearest base scenario — all under common
    random numbers, so the P&L matrix is smooth in the bumps.  The base
    subtraction happens host-side from the returned grid: selecting the
    base *inside* the jit lets XLA rematerialize that scenario's reduction
    in a different fusion, leaving ~1-ulp phantom base P&L.
    """
    prices = _price_surface(process, payoff_fn, n_paths, n_steps,
                            bumps_a, bumps_b, seed, tuple(fields), discount,
                            stream, dtype)
    prices = np.asarray(prices)
    ia = int(np.argmin(np.abs(np.asarray(bumps_a))))
    ib = int(np.argmin(np.abs(np.asarray(bumps_b))))
    base = prices[ia, ib]
    return {"prices": prices, "pnl": prices - base, "base_price": base,
            "bumps_a": np.asarray(bumps_a), "bumps_b": np.asarray(bumps_b)}


def ladder(lo: float, hi: float, n: int) -> np.ndarray:
    """Symmetric-ish bump ladder including the base scenario 0.0 exactly
    (linspace leaves ~1e-17 residue at the center; the base scenario must
    bump by literal zero so base P&L is identically 0)."""
    g = np.linspace(lo, hi, n)
    g[np.isclose(g, 0.0, atol=1e-12)] = 0.0
    if not (g == 0.0).any():
        g = np.sort(np.append(g, 0.0))
    return g


def standard_scenarios() -> dict:
    """Named stress scenarios (relative spot, relative vol) in the spirit of
    exchange SPAN / CCAR-style ladders."""
    return {
        "base": (0.0, 0.0),
        "spot_down_20": (-0.20, 0.0),
        "spot_down_10": (-0.10, 0.0),
        "spot_up_10": (0.10, 0.0),
        "spot_up_20": (0.20, 0.0),
        "vol_up_50": (0.0, 0.50),
        "vol_down_30": (0.0, -0.30),
        "crash": (-0.30, 1.00),
        "melt_up": (0.20, 0.40),
    }


def stress_report(process, payoff_fn, n_paths: int, n_steps: int, *,
                  seed: int, fields: tuple = ("s0", "sigma"),
                  discount=1.0, scenarios: dict | None = None,
                  stream: int = 0, dtype=jnp.float32) -> dict:
    """Named-scenario P&L: one vmapped reprice over `standard_scenarios`."""
    scen = scenarios if scenarios is not None else standard_scenarios()
    if not scen:
        return {"scenarios": {}, "base_price": float("nan")}
    names = list(scen)
    ba = np.asarray([scen[k][0] for k in names])
    bb = np.asarray([scen[k][1] for k in names])

    prices = np.asarray(_price_pairs(process, payoff_fn, n_paths, n_steps,
                                     ba, bb, seed, tuple(fields), discount,
                                     stream, dtype))
    base = prices[names.index("base")] if "base" in names else prices[0]
    return {"scenarios": {k: {"price": float(p), "pnl": float(p - base)}
                          for k, p in zip(names, prices)},
            "base_price": float(base)}
