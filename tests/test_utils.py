"""Profiling utilities."""

import numpy as np
import jax.numpy as jnp

from montecarlo.utils import Timer, throughput_path_steps
from montecarlo.engine import simulate
from montecarlo.processes import GBM


def test_timer_sections_and_summary():
    t = Timer()
    with t.section("a"):
        _ = sum(range(1000))
    out = t.timed("b", lambda: jnp.ones(16) * 2)
    assert float(out[0]) == 2.0
    s = t.summary()
    assert s["a"]["count"] == 1 and s["b"]["count"] == 1
    assert s["b"]["total_s"] >= 0


def test_throughput_harness_runs():
    proc = GBM.create(s0=100.0, mu=0.03, sigma=0.2, dt=1 / 252)

    # Harness needs a seed-varying callable; keep the dependency via seed.
    def fn2(n_paths, n_steps, *, seed):
        return simulate(proc, n_paths, n_steps, seed=3, stream=0) + 0 * seed

    rate = throughput_path_steps(fn2, 2048, 8, reps=2, warmup=1)
    assert rate > 0

