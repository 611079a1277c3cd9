"""Streaming per-step percentile curves — O(T x bins) memory, any path count.

The reference's Monte Carlo chart needs per-time-step percentile bands
(reference app.py:643-645), which it gets by materializing the full
``paths[(n_days+1, n_sims)]`` array.  At pod-scale path counts that array is
impossible; this module accumulates a *histogram sketch per time step*
inside the `lax.scan` instead, so memory is O(n_steps x bins) regardless of
the number of paths — SURVEY.md §5's 'long-context' tension resolved the
streaming way.

Sketch counts are exact integer adds, so per-step sketches from different
path shards merge exactly (`psum`) and the result is mesh-shape invariant.
"""

from __future__ import annotations

from functools import partial
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from montecarlo.engine.simulate import path_ids_for
from montecarlo.parallel.mesh import PATHS_AXIS
from montecarlo.samplers import PlainSampler
from montecarlo.stats.quantiles import histogram_counts
from montecarlo.stats.risk import PATH_PERCENTILES


@partial(jax.jit, static_argnames=("n_paths", "n_steps", "seed", "stream",
                                   "bins", "dtype"))
def path_histograms(process, n_paths: int, n_steps: int, *, seed: int,
                    lo, hi, bins: int = 1024, stream: int = 0,
                    sampler=None, dtype=jnp.float32, path_offset=0):
    """(n_steps + 1, bins) histogram counts of prices at every time step.

    Row 0 is the spot distribution (a point mass).  Values outside [lo, hi)
    clamp into the edge bins (percentile queries inside the range are
    unaffected).  ``lo``/``hi`` are traced operands — callers derive them
    from the data, so making them static would recompile the whole scan on
    every run.
    """
    if sampler is None:
        sampler = PlainSampler()
    ids = path_ids_for(n_paths, path_offset)
    state0 = process.init_state(ids, dtype)
    width = (hi - lo) / bins

    def hist(prices):
        idx = jnp.clip(jnp.floor((prices - lo) / width).astype(jnp.int32),
                       0, bins - 1)
        return histogram_counts(idx, bins, jnp.int32)

    def body(state, t):
        eps = sampler.draws(process, seed, stream, ids, t, dtype)
        new_state = process.step(state, eps, t)
        return new_state, hist(process.prices(new_state))

    _, rows = jax.lax.scan(body, state0,
                           jnp.arange(n_steps, dtype=jnp.int32))
    first = hist(process.prices(state0))[None]
    return jnp.concatenate([first, rows], axis=0)


def percentiles_from_histograms(hists, lo: float, hi: float,
                                levels=PATH_PERCENTILES) -> Dict[str, np.ndarray]:
    """Per-step percentile curves from (T+1, bins) counts — the reference's
    ``path_percentiles`` dict shape (app.py:643-645), within one bin width."""
    hists = np.asarray(hists)
    t_plus_1, bins = hists.shape
    width = (hi - lo) / bins
    cdf = np.cumsum(hists, axis=1)
    total = cdf[:, -1:]
    out = {}
    for q in levels:
        target = (q / 100.0) * total[:, 0]
        k = np.minimum(np.argmax(cdf >= target[:, None], axis=1), bins - 1)
        cdf_left = np.where(k > 0, cdf[np.arange(t_plus_1),
                                       np.maximum(k - 1, 0)], 0.0)
        in_bin = np.maximum(hists[np.arange(t_plus_1), k], 1e-12)
        frac = np.clip((target - cdf_left) / in_bin, 0.0, 1.0)
        out[f"p{q}"] = lo + (k + frac) * width
    return out


def sharded_path_percentiles(process, n_paths: int, n_steps: int, *,
                             seed: int, mesh, lo: float, hi: float,
                             bins: int = 1024, stream: int = 0,
                             dtype=jnp.float32,
                             axis: str = PATHS_AXIS) -> Dict[str, np.ndarray]:
    """Mesh-sharded per-step percentile curves (psum-merged histograms)."""
    from jax.sharding import PartitionSpec as P

    n_shards = mesh.shape[axis]
    if n_paths % n_shards:
        raise ValueError(f"n_paths={n_paths} not divisible by {n_shards}")
    local_n = n_paths // n_shards

    def shard_fn(proc):
        offset = jax.lax.axis_index(axis) * local_n
        h = path_histograms(proc, local_n, n_steps, seed=seed, lo=lo, hi=hi,
                            bins=bins, stream=stream, dtype=dtype,
                            path_offset=offset)
        return jax.lax.psum(h, axis)

    spec_in = jax.tree.map(lambda _: P(), process)
    hists = jax.jit(jax.shard_map(shard_fn, mesh=mesh, in_specs=(spec_in,),
                                  out_specs=P(), check_vma=False))(process)
    return percentiles_from_histograms(hists, lo, hi)
