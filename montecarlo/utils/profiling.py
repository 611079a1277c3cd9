"""Tracing and profiling hooks.

The reference's only observability is a string progress callback rendered to
Streamlit placeholders (reference app.py:446, 521, 587, 670, 1204-1205) and
it globally suppresses warnings (app.py:15).  Here:

- the progress-callback protocol is kept (every long-running API takes
  ``progress_callback``);
- `trace` wraps a region in a `jax.profiler` trace (view with TensorBoard
  or Perfetto);
- `timed` / `Timer` give wall-clock step timing with `block_until_ready`
  fencing so device work is actually measured (async dispatch otherwise
  returns before the device finishes);
- warnings are never suppressed.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a region: ``with trace('/tmp/profile'): run()``."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclass
class Timer:
    """Named wall-clock accumulator with device fencing."""

    times: Dict[str, List[float]] = field(default_factory=dict)

    @contextlib.contextmanager
    def section(self, name: str, result=None):
        """Time a block.  Fencing: pass ``result=`` for values that exist
        at entry, or append device values produced INSIDE the block to the
        yielded list — they are fenced before the clock stops.  With
        neither, only host time is measured (async dispatch lies about
        device work; use :meth:`timed` for the one-call fenced form).
        """
        holder: list = []
        t0 = time.perf_counter()
        try:
            yield holder
        finally:
            if result is not None:
                jax.block_until_ready(result)
            if holder:
                jax.block_until_ready(holder)
            self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def timed(self, name: str, fn, *args, **kwargs):
        """Run fn, fence its result, record the elapsed time, return it."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        self.times.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, ts in self.times.items():
            out[name] = {
                "count": len(ts),
                "total_s": sum(ts),
                "mean_s": sum(ts) / len(ts),
                "min_s": min(ts),
            }
        return out


def throughput_path_steps(fn, n_paths: int, n_steps: int, *, reps: int = 4,
                          warmup: int = 1, **kwargs) -> float:
    """Path-steps/sec of a terminal-simulation callable.

    Chains ``reps`` invocations (distinct seeds) inside one jit with a data
    dependency and times a single fenced call — the honest methodology for
    remote/async devices (see bench.py).
    """
    import functools
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=())
    def chained(seed0):
        def body(i, acc):
            out = fn(n_paths, n_steps, seed=seed0 + i, **kwargs)
            return acc + out[0]
        return jax.lax.fori_loop(0, reps, body, jnp.float32(0.0))

    for w in range(warmup):
        jax.block_until_ready(chained(jnp.int32(w)))
    t0 = time.perf_counter()
    jax.block_until_ready(chained(jnp.int32(1000)))
    dt = (time.perf_counter() - t0) / reps
    return n_paths * n_steps / dt
