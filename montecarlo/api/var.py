"""Pod-scale portfolio VaR/CVaR (BASELINE.json config 5).

10^9+-path risk runs: paths shard over the mesh, terminal values stream into
a psum-merged histogram sketch plus exact block moments — O(bins) memory per
device regardless of path count.  The sketch range is auto-calibrated with a
small pilot run so the interesting quantiles land well inside the grid.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from montecarlo.engine.simulate import simulate
from montecarlo.engine.streaming import streaming_estimate, risk_from_state
from montecarlo.parallel.sharded import sharded_terminal_sketch
from montecarlo.stats.welford import std_error


def _pilot_range(process, n_steps: int, seed: int, margin: float = 0.5):
    pilot = np.asarray(simulate(process, 4096, n_steps, seed=seed,
                                stream=999))
    lo, hi = float(pilot.min()), float(pilot.max())
    span = hi - lo
    return lo - margin * span, hi + margin * span


#: Out-of-range fraction above which the auto-ranged sketch re-runs with a
#: widened grid.  A 4096-path pilot cannot see deep jump tails
#: (Merton/Kou/Bates): at 10^9-path scale, events far beyond the pilot's
#: range land in the under/overflow counters and CVaR would approximate that
#: mass at the grid edge (stats.quantiles reads tail mass at vmin/vmax).
_OOB_RERANGE_THRESHOLD = 1e-6


def _oob_fraction(sketch) -> float:
    total = max(float(sketch.total), 1.0)
    return (float(sketch.underflow) + float(sketch.overflow)) / total


def _widened_range(lo, hi, sketch=None, vmin=None, vmax=None):
    """Grid covering every observed value: the sketch tracks the EXACT
    global min/max, so one re-run is guaranteed in-range (counter-based
    draws make the re-run bitwise-free of RNG state)."""
    if sketch is not None:
        vmin, vmax = sketch.vmin, sketch.vmax
    new_lo = min(float(lo), float(vmin))
    new_hi = max(float(hi), float(vmax))
    eps = 1e-3 * max(new_hi - new_lo, 1e-12)
    return new_lo - eps, new_hi + eps


def _warn_oob(sketch, context: str) -> None:
    import warnings

    frac = _oob_fraction(sketch)
    if frac > _OOB_RERANGE_THRESHOLD:
        warnings.warn(
            f"{context}: {frac:.2e} of terminal values fell outside the "
            f"explicit sketch range [{float(sketch.lo)}, "
            f"{float(sketch.hi)}] (observed range "
            f"[{float(sketch.vmin)}, {float(sketch.vmax)}]); tail "
            "quantiles/CVaR are approximated at the grid edge — widen "
            "lo/hi or let the range auto-calibrate",
            stacklevel=3)


def portfolio_var(process, n_paths: int, n_days: int, current_value: float,
                  *, seed: int = 0, sampler=None, mesh=None,
                  bins: int = 8192,
                  lo: Optional[float] = None, hi: Optional[float] = None,
                  chunk_paths: Optional[int] = None,
                  block_size: int = 4096,
                  checkpoint_path: Optional[str] = None,
                  progress_callback=None) -> dict:
    """VaR/CVaR/percentile bands at arbitrary path counts.

    - With ``mesh`` and no chunking need (``n_paths`` fits per-device), one
      fused sharded pass (`sharded_terminal_sketch`): collectives are a psum
      of integer bin counts and an all_gather of tiny block moments.
    - Otherwise streams chunks (optionally sharded) with checkpoint/resume.

    Returns the reference's risk keys (percentiles, expected_return/vol,
    prob_profit, var_95, cvar_95; app.py:647-657) plus ``std_err`` and
    ``n_paths``.

    **Which error dominates when.**  The VaR estimate carries two error
    sources, both reported: ``var_95_std_err`` (sampling, shrinks as
    1/sqrt(n_paths)) and ``var_95_grid_err`` (the sketch's deterministic
    resolution — one bin width, fixed by ``bins`` and the lo/hi span;
    ``cvar_95_grid_err`` adds the bin-midpoint term).  They cross at
    roughly ``n ~ q(1-q) / (f(x_q) * width)^2`` paths — with the default
    auto-ranged 8192-bin grid that is around 10^8-10^9 paths for a
    diffusion's p5; past it, adding paths no longer improves the estimate
    and `risk_dict` warns to raise ``bins`` (or narrow lo/hi) instead.
    """
    auto_ranged = lo is None and hi is None
    if lo is None or hi is None:
        auto_lo, auto_hi = _pilot_range(process, n_days, seed)
        lo = auto_lo if lo is None else lo
        hi = auto_hi if hi is None else hi

    if mesh is not None and chunk_paths is None:
        from montecarlo.engine.streaming import risk_dict

        for _ in range(2):
            sketch, moments = sharded_terminal_sketch(
                process, n_paths, n_days, seed=seed, mesh=mesh, lo=lo,
                hi=hi, bins=bins, block_size=block_size, sampler=sampler)
            if (auto_ranged
                    and _oob_fraction(sketch) > _OOB_RERANGE_THRESHOLD):
                # Pilot under-ranged a fat tail (jump processes): re-run on
                # the exact observed range — free of RNG state, and the
                # second pass cannot under-range (vmin/vmax are exact).
                lo, hi = _widened_range(lo, hi, sketch)
                continue
            break
        if not auto_ranged:
            _warn_oob(sketch, "portfolio_var")
        mean = float(moments.mean)
        std = float(jnp.sqrt(moments.m2 / jnp.maximum(moments.count, 1)))
        return risk_dict(sketch, mean=mean, std=std,
                         std_err=float(std_error(moments)),
                         count=int(float(moments.count)),
                         current_price=current_value)

    chunk = chunk_paths or min(n_paths, 1 << 20)
    for _ in range(2):
        state = streaming_estimate(
            process, n_paths, n_days, seed=seed, chunk_paths=chunk,
            block_size=block_size, lo=lo, hi=hi, bins=bins, mesh=mesh,
            sampler=sampler, checkpoint_path=checkpoint_path,
            progress_callback=progress_callback)
        if (auto_ranged and checkpoint_path is None
                and _oob_fraction(state.sketch) > _OOB_RERANGE_THRESHOLD):
            # Checkpointed runs are NOT auto-re-ranged: the checkpoint
            # encodes the grid, and a silent second grid would collide
            # with resume-from-checkpoint semantics.
            lo, hi = _widened_range(lo, hi, state.sketch)
            continue
        break
    if not (auto_ranged and checkpoint_path is None):
        _warn_oob(state.sketch, "portfolio_var")
    return risk_from_state(state, current_value)


def portfolio_var_on_device(process, n_paths: int, n_days: int,
                            current_value: float, *, seed: int = 0,
                            sampler=None,
                            bins: int = 8192, lo: Optional[float] = None,
                            hi: Optional[float] = None,
                            chunk_paths: int = 1 << 24) -> dict:
    """Billion-path VaR as ONE device program: a `lax.fori_loop` over
    fused-kernel chunks accumulating the histogram sketch and moments
    on-chip — a single host round-trip regardless of path count.  No
    checkpointing (use `portfolio_var` for resumable runs).

    ``sampler``: the standard draw-provider seam (QMC included — a
    `samplers.SobolSampler.for_process` table covers the GARCH bootstrap
    / jump uniform slots via the mixed-slot protocol); the per-chunk
    gathers index the table by global path id, so the table must cover
    ``n_paths`` rows.  The reported error bars keep the iid formulas —
    under QMC they are conservative (see `engine.exposure
    .netting_set_profile_rqmc` for honest replicate-spread bars).
    """
    import functools

    from montecarlo.engine.dispatch import terminal_prices
    from montecarlo.stats.quantiles import HistogramSketch

    if n_paths % chunk_paths:
        raise ValueError("n_paths must be a multiple of chunk_paths")
    auto_ranged = lo is None and hi is None
    if lo is None or hi is None:
        auto_lo, auto_hi = _pilot_range(process, n_days, seed)
        lo = auto_lo if lo is None else lo
        hi = auto_hi if hi is None else hi
    n_chunks = n_paths // chunk_paths

    @functools.partial(jax.jit, static_argnames=())
    def run(seed0, lo_t, hi_t):
        # lo/hi ride as operands so an auto-re-ranged second pass reuses
        # the compiled program (a closure would recompile).
        width = (hi_t - lo_t) / bins

        def body(i, carry):
            counts, uf, of, vmin, vmax, total, mean, m2 = carry
            term = terminal_prices(process, chunk_paths, n_days, seed=seed0,
                                   sampler=sampler,
                                   path_offset=i * chunk_paths)
            raw = jnp.floor((term - lo_t) / width).astype(jnp.int32)
            under = raw < 0
            over = raw >= bins
            in_range = ~(under | over)
            # Out-of-range terminals are COUNTED (under/overflow), not
            # clipped into the edge bins — clipping would place truncated
            # tail mass at the edge-bin midpoint, silently understating
            # VaR/CVaR, and zeroed counters would hide that it happened
            # (same semantics as stats.quantiles.sketch_add).
            idx = jnp.where(in_range, jnp.clip(raw, 0, bins - 1), 0)
            # int32 counts: exact to 2^31 (f32 would silently saturate
            # precision at 2^24 per bin).
            from montecarlo.stats.quantiles import histogram_counts

            batch = histogram_counts(idx, bins, jnp.int32)
            n_oob = jnp.sum(~in_range, dtype=jnp.int32)
            batch = batch.at[0].add(-n_oob)
            counts = counts + batch
            uf = uf + jnp.sum(under, dtype=jnp.int32)
            of = of + jnp.sum(over, dtype=jnp.int32)
            vmin = jnp.minimum(vmin, jnp.min(term))
            vmax = jnp.maximum(vmax, jnp.max(term))
            # Chan merge of the chunk moments into the running state.
            c_n = jnp.float32(chunk_paths)
            c_mean = jnp.mean(term)
            c_m2 = jnp.sum(jnp.square(term - c_mean))
            n_new = total + c_n
            delta = c_mean - mean
            mean_new = mean + delta * c_n / n_new
            m2_new = m2 + c_m2 + jnp.square(delta) * total * c_n / n_new
            return counts, uf, of, vmin, vmax, n_new, mean_new, m2_new

        init = (jnp.zeros((bins,), jnp.int32), jnp.int32(0), jnp.int32(0),
                jnp.float32(jnp.inf), jnp.float32(-jnp.inf),
                jnp.float32(0.0), jnp.float32(0.0), jnp.float32(0.0))
        return jax.lax.fori_loop(0, n_chunks, body, init)

    for _ in range(2):
        counts, uf, of, vmin, vmax, total, mean, m2 = run(
            jnp.int32(seed), jnp.float32(lo), jnp.float32(hi))
        oob = (float(uf) + float(of)) / max(float(total), 1.0)
        if auto_ranged and oob > _OOB_RERANGE_THRESHOLD:
            lo, hi = _widened_range(lo, hi, vmin=vmin, vmax=vmax)
            continue
        break
    counts_np = np.asarray(counts).astype(np.float64)
    total_f, mean_f, m2_f = float(total), float(mean), float(m2)

    sketch = HistogramSketch(
        lo=jnp.asarray(float(lo)), hi=jnp.asarray(float(hi)),
        counts=jnp.asarray(counts_np), total=jnp.asarray(total_f),
        underflow=jnp.asarray(float(uf)), overflow=jnp.asarray(float(of)),
        vmin=jnp.asarray(float(vmin)), vmax=jnp.asarray(float(vmax)))
    from montecarlo.engine.streaming import risk_dict

    if not auto_ranged:
        _warn_oob(sketch, "portfolio_var_on_device")
    std = float(np.sqrt(m2_f / max(total_f, 1.0)))
    return risk_dict(sketch, mean=mean_f, std=std,
                     std_err=std / np.sqrt(max(total_f, 1.0)),
                     count=int(total_f), current_price=current_value)
