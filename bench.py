#!/usr/bin/env python
"""Benchmark: GBM path-steps/sec on one GPU through the engine dispatch.

Runs `engine.dispatch.terminal_prices` (the fused path kernel on the GPU)
at 2^20 paths x 1024 steps and prints ONE JSON line.  Needs a GPU: on any
other platform it exits non-zero without a result.

Methodology: REPS dispatches (different seeds) chained by a data dependency
inside a single jit and fenced with `block_until_ready` — device-side
throughput without per-call dispatch overhead.  The same terminal prices
also price a 1-year European call (maturity folded into dt) as a
Black-Scholes sanity gate.

``--sharded [--mesh N]``: the full sharded estimator (shard_map -> kernel
-> payoff -> block stats -> all_gather -> fixed-tree merge) on an N-card
mesh; fails when fewer than N cards exist.

Run: ``python bench.py`` (one card), ``python bench.py --sharded --mesh 4``.
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp

from montecarlo import device
from montecarlo.utils.compile_cache import enable_persistent_cache

N_PATHS, N_STEPS, REPS = 1 << 20, 1024, 8


def _result(metric: str, value: float, **extra) -> str:
    d = device.describe()
    return json.dumps({"metric": metric, "value": value,
                       "unit": "path_steps/s", **extra,
                       "platform": d["platform"], "device_kind": d["kind"],
                       "device_count": d["count"], "card": d["card"]})


def _check_call_price(price: float, payoff_std: float, n: int) -> None:
    """Black-Scholes sanity gate — guards against benchmarking garbage."""
    from montecarlo.engine.payoffs import black_scholes_call

    se = payoff_std / n ** 0.5
    bs = float(black_scholes_call(100.0, 105.0, 0.03, 0.2, 1.0))
    assert abs(price - bs) < 5 * se + 1e-3, (price, bs, se)


def sharded_main(mesh_devices: int = 1) -> None:
    """Aggregate mesh throughput of `sharded_mc_estimate` ("value" is the
    whole mesh; divide by N for per card)."""
    from montecarlo.parallel import make_mesh, sharded_mc_estimate
    from montecarlo.processes import GBM

    if len(jax.devices()) < mesh_devices:
        raise SystemExit(f"--mesh {mesh_devices} needs {mesh_devices} "
                         f"cards; {len(jax.devices())} found")
    n_paths = mesh_devices * N_PATHS
    mesh = make_mesh(mesh_devices, devices=jax.devices()[:mesh_devices])
    proc = GBM.create(s0=100.0, mu=0.03, sigma=0.2, dt=1.0 / N_STEPS)
    payoff = lambda s: jnp.maximum(s - 105.0, 0.0)

    @jax.jit
    def bench(_seed0):
        def body(i, acc):
            est = sharded_mc_estimate(
                proc, payoff, n_paths, N_STEPS, seed=7, mesh=mesh,
                path_offset=i * n_paths)
            return acc + est["price"]
        return jax.lax.fori_loop(0, REPS, body, jnp.float32(0.0))

    jax.block_until_ready(bench(jnp.int32(1)))  # compile + warm
    t0 = time.perf_counter()
    total = float(jax.block_until_ready(bench(jnp.int32(2))))
    dt = (time.perf_counter() - t0) / REPS
    # Mean of REPS undiscounted estimates; each is over n_paths paths.
    _check_call_price(total / REPS * float(jnp.exp(-0.03)), 12.0,
                      REPS * n_paths)
    print(_result("sharded_gbm_path_steps_per_sec_mesh",
                  n_paths * N_STEPS / dt, mesh_devices=mesh_devices))


def main() -> None:
    from montecarlo.engine.dispatch import terminal_prices
    from montecarlo.processes import GBM

    # Maturity T=1y folded into dt so the benchmark workload is also the
    # sanity-check workload.
    proc = GBM.create(s0=100.0, mu=0.03, sigma=0.2, dt=1.0 / N_STEPS)
    strike = jnp.float32(105.0)
    discount = jnp.float32(jnp.exp(-0.03))

    @jax.jit
    def bench(seed0):
        def body(i, acc):
            terminal = terminal_prices(proc, N_PATHS, N_STEPS,
                                       seed=seed0 + i)
            return acc + terminal[0]
        return jax.lax.fori_loop(0, REPS, body, jnp.float32(0.0))

    @jax.jit
    def sanity(seed0):
        payoff = jnp.maximum(
            terminal_prices(proc, N_PATHS, N_STEPS, seed=seed0) - strike,
            0.0)
        return discount * jnp.mean(payoff), discount * jnp.std(payoff)

    jax.block_until_ready(bench(jnp.int32(1)))  # compile + warm
    t0 = time.perf_counter()
    jax.block_until_ready(bench(jnp.int32(1000)))
    dt = (time.perf_counter() - t0) / REPS

    price, payoff_std = map(float, sanity(jnp.int32(7)))
    _check_call_price(price, payoff_std, N_PATHS)
    print(_result("gbm_path_steps_per_sec_per_card", N_PATHS * N_STEPS / dt,
                  engine=device.path_engine()))


if __name__ == "__main__":
    try:
        device.require_gpu()
    except device.UnsupportedPlatform as e:
        raise SystemExit(f"bench.py: {e}")
    enable_persistent_cache()
    if "--sharded" in sys.argv:
        n = 1
        if "--mesh" in sys.argv:
            n = int(sys.argv[sys.argv.index("--mesh") + 1])
        sharded_main(n)
    else:
        main()
