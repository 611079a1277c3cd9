"""Streaming estimation with checkpoint/resume — the pod-scale path.

The reference materializes every path in memory and has no persistence at
all (its only cache is an in-memory 1h memo of fetched data, reference
app.py:887).  This module runs arbitrarily large path counts in fixed-size
chunks and keeps only O(blocks + sketch) state:

- per-block Welford moment states (block = ``DEFAULT_BLOCK`` consecutive
  global paths) — kept, not merged, so the final fixed-tree reduce is
  *identical* whether the run happened in one shot, in chunks, across
  resumes, or on different mesh shapes;
- a mergeable histogram sketch of terminal values for quantiles/VaR/CVaR;
- the RNG needs no state: counters are derived from global path ids, so a
  resumed run regenerates exactly the paths it would have had (seed-
  deterministic re-execution — failed shards are replayable for free;
  exercised by fault injection in `tests/test_fault_injection.py`: a
  lost chunk is re-executed from nothing but its path-id range and the
  repaired estimate is bitwise the uninterrupted run's, for both the
  moment/sketch stream and the netting chunk roots).

Checkpoints are a single .npz (atomic rename); `resume=True` picks up a
partial estimate mid-flight and the result is bitwise identical to the
uninterrupted run.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from montecarlo.engine.dispatch import terminal_prices
from montecarlo.stats.quantiles import (
    HistogramSketch,
    sketch_cdf,
    sketch_quantile,
    sketch_quantile_std_err,
    sketch_tail_mean_below,
)
from montecarlo.stats.welford import (
    MomentState,
    moments_from_array,
    moments_reduce,
    std_error,
    tree_sum,
)

# One constant shared with the sharded estimators: streamed/resumed and
# sharded runs must partition paths into the SAME fixed blocks or the
# bitwise-reproducibility contract (DEVNOTES) silently breaks.
from montecarlo.parallel.sharded import DEFAULT_BLOCK  # noqa: E402


def _orbax():
    """orbax.checkpoint, imported only on the directory-checkpoint route
    (``.npz`` checkpoints need nothing beyond numpy)."""
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise ImportError(
            "directory checkpoints need orbax (`pip install orbax-"
            "checkpoint`); pass a path ending in .npz to checkpoint without "
            "it") from e
    return ocp


@dataclass
class StreamingState:
    """Host-side accumulated state (all numpy; trivially serializable)."""

    seed: int
    n_steps: int
    block_size: int
    paths_done: int
    block_count: np.ndarray   # (n_blocks,)
    block_mean: np.ndarray
    block_m2: np.ndarray
    sketch: HistogramSketch   # numpy-leaved

    def save(self, path: str) -> None:
        """Checkpoint to ``path``: atomic .npz for ``*.npz`` paths (simple,
        single-file), orbax otherwise (directory; async-capable, the JAX
        ecosystem's standard checkpoint format)."""
        if path.endswith(".npz"):
            # mkstemp (not the race-prone mktemp): the temp file exists from
            # creation, so concurrent writers cannot collide on the name.
            fd, tmp = tempfile.mkstemp(
                suffix=".npz", dir=os.path.dirname(os.path.abspath(path)))
            try:
                with os.fdopen(fd, "wb") as fh:
                    np.savez(
                        fh, seed=self.seed, n_steps=self.n_steps,
                        block_size=self.block_size,
                        paths_done=self.paths_done,
                        block_count=self.block_count,
                        block_mean=self.block_mean,
                        block_m2=self.block_m2,
                        **{f"sk_{k}": np.asarray(v)
                           for k, v in self.sketch._asdict().items()},
                    )
                os.replace(tmp, path)
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise
            return
        ocp = _orbax()

        tree = {
            "seed": self.seed, "n_steps": self.n_steps,
            "block_size": self.block_size, "paths_done": self.paths_done,
            "block_count": self.block_count, "block_mean": self.block_mean,
            "block_m2": self.block_m2,
            "sketch": {k: np.asarray(v)
                       for k, v in self.sketch._asdict().items()},
        }
        # Synchronous checkpointer: the save must be durable before the
        # next chunk runs (StandardCheckpointer is async under the hood and
        # may never finalize if the process moves on).
        with ocp.Checkpointer(ocp.StandardCheckpointHandler()) as ck:
            ck.save(os.path.abspath(path), args=ocp.args.StandardSave(tree),
                    force=True)

    @classmethod
    def load(cls, path: str) -> "StreamingState":
        if path.endswith(".npz"):
            z = np.load(path)
            sketch = HistogramSketch(**{k: z[f"sk_{k}"]
                                        for k in HistogramSketch._fields})
            return cls(
                seed=int(z["seed"]), n_steps=int(z["n_steps"]),
                block_size=int(z["block_size"]),
                paths_done=int(z["paths_done"]),
                block_count=z["block_count"], block_mean=z["block_mean"],
                block_m2=z["block_m2"], sketch=sketch,
            )
        ocp = _orbax()

        with ocp.Checkpointer(ocp.StandardCheckpointHandler()) as ck:
            t = ck.restore(os.path.abspath(path))
        sketch = HistogramSketch(
            **{k: np.asarray(t["sketch"][k])
               for k in HistogramSketch._fields})
        return cls(
            seed=int(t["seed"]), n_steps=int(t["n_steps"]),
            block_size=int(t["block_size"]),
            paths_done=int(t["paths_done"]),
            block_count=np.asarray(t["block_count"]),
            block_mean=np.asarray(t["block_mean"]),
            block_m2=np.asarray(t["block_m2"]), sketch=sketch,
        )

    def moments(self) -> MomentState:
        return moments_reduce(MomentState(
            jnp.asarray(self.block_count), jnp.asarray(self.block_mean),
            jnp.asarray(self.block_m2)))


def streaming_estimate(
    process, total_paths: int, n_steps: int, *, seed: int,
    payoff_fn: Optional[Callable] = None, chunk_paths: int = 1 << 20,
    block_size: int = DEFAULT_BLOCK, lo: float = 0.0, hi: float = 1000.0,
    bins: int = 4096, dtype=jnp.float32, sampler=None,
    checkpoint_path: Optional[str] = None, resume: bool = True,
    checkpoint_every: int = 1, target_std_err: Optional[float] = None,
    mesh=None, progress_callback=None,
) -> StreamingState:
    """Estimate over ``total_paths`` in chunks, checkpointing along the way.

    ``payoff_fn`` feeds the moment accumulator (defaults to the terminal
    value itself); the sketch always ingests terminal values.  Stops early
    at a chunk boundary once ``target_std_err`` is reached (the driver
    metric's 'wall-clock to std-err 1e-3' mode).
    """
    if total_paths % chunk_paths or chunk_paths % block_size:
        raise ValueError("total_paths % chunk_paths % block_size != 0")
    payoff_fn = payoff_fn or (lambda s: s)

    state = None
    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        state = StreamingState.load(checkpoint_path)
        if (state.seed, state.n_steps, state.block_size) != (
                seed, n_steps, block_size):
            raise ValueError("checkpoint does not match this run's config")
        if (state.sketch.counts.shape[0] != bins
                or float(state.sketch.lo) != float(lo)
                or float(state.sketch.hi) != float(hi)):
            raise ValueError(
                "checkpoint sketch grid (lo/hi/bins) does not match this "
                "run — merged quantiles would be silently wrong")
        if state.paths_done % chunk_paths:
            raise ValueError(
                f"resumed paths_done={state.paths_done} is not a multiple "
                f"of chunk_paths={chunk_paths}; resume with the original "
                "chunk size (or a divisor of paths_done)")
    if state is None:
        # Host-side np.float64 count carrier: exact adds to 2^53 regardless
        # of jax_enable_x64 (a jnp f64 sketch silently truncates to f32
        # without x64 — the 2^24-count wrongness this layer must never have).
        z64 = np.float64(0.0)
        state = StreamingState(
            seed=seed, n_steps=n_steps, block_size=block_size, paths_done=0,
            block_count=np.zeros((0,)), block_mean=np.zeros((0,)),
            block_m2=np.zeros((0,)),
            sketch=HistogramSketch(
                lo=np.float64(lo), hi=np.float64(hi),
                counts=np.zeros((bins,), np.float64), total=z64,
                underflow=z64, overflow=z64,
                vmin=np.float64(np.inf), vmax=np.float64(-np.inf)),
        )

    chunk_idx = state.paths_done // chunk_paths
    while state.paths_done < total_paths:
        offset = state.paths_done
        if mesh is not None:
            from montecarlo.parallel.sharded import sharded_terminal
            terminal = sharded_terminal(process, chunk_paths, n_steps,
                                        seed=seed, mesh=mesh, sampler=sampler,
                                        dtype=dtype, path_offset=offset)
            # Gather before accumulating: block statistics must be computed
            # with a device-layout-independent reduction order so chunked /
            # sharded / one-shot runs stay bitwise identical.  (The fully
            # on-device pod path is sharded_mc_estimate /
            # sharded_terminal_sketch, which all_gather per-block stats
            # instead.)
            terminal = jnp.asarray(np.asarray(terminal))
        else:
            terminal = terminal_prices(process, chunk_paths, n_steps,
                                       seed=seed, sampler=sampler,
                                       dtype=dtype, path_offset=offset)
        payoffs = payoff_fn(terminal)
        blocks = moments_from_array(
            jnp.reshape(payoffs, (-1, block_size)), axis=-1)
        state.block_count = np.concatenate(
            [state.block_count, np.asarray(blocks.count, np.float64)])
        state.block_mean = np.concatenate(
            [state.block_mean, np.asarray(blocks.mean, np.float64)])
        state.block_m2 = np.concatenate(
            [state.block_m2, np.asarray(blocks.m2, np.float64)])
        # Chunk binning + merge on host in np.float64: the f64 grid bins
        # identically whether x64 is on or off, and f64 count adds are exact
        # to 2^53 (a jnp f64 sketch would silently truncate to f32 without
        # x64 — the 2^24-count wrongness this layer must never have).  The
        # fully on-device pod path is sharded_terminal_sketch (int32 psum).
        term64 = np.asarray(terminal, np.float64)
        width = (np.float64(hi) - np.float64(lo)) / bins
        idx = np.floor((term64 - np.float64(lo)) / width).astype(np.int64)
        under = int(np.sum(idx < 0))
        over = int(np.sum(idx >= bins))
        cnts = np.bincount(idx[(idx >= 0) & (idx < bins)],
                           minlength=bins).astype(np.float64)
        s = state.sketch
        state.sketch = HistogramSketch(
            lo=s.lo, hi=s.hi,
            counts=s.counts + cnts,
            total=s.total + np.float64(term64.size),
            underflow=s.underflow + np.float64(under),
            overflow=s.overflow + np.float64(over),
            vmin=np.minimum(s.vmin, term64.min()),
            vmax=np.maximum(s.vmax, term64.max()),
        )
        state.paths_done += chunk_paths
        chunk_idx += 1

        if checkpoint_path and chunk_idx % checkpoint_every == 0:
            state.save(checkpoint_path)
        se = float(std_error(state.moments()))
        if progress_callback:
            progress_callback(state.paths_done, total_paths, se)
        if target_std_err is not None and se <= target_std_err:
            break

    if checkpoint_path:
        state.save(checkpoint_path)
    return state


def risk_from_state(state: StreamingState, current_price: float, *,
                    moments_are_prices: bool = True) -> dict:
    """The reference's risk statistics (app.py:647-657) from streamed state —
    sketch-based quantiles instead of exact sort (error <= one bin width).

    The sketch always holds terminal *prices*; the moment state holds
    whatever ``payoff_fn`` the stream ran with.  If the stream used a
    non-identity payoff, pass ``moments_are_prices=False`` — the price
    moments then come from the sketch (bin midpoints) so expected
    return/vol stay price-consistent, and the payoff moments are reported
    separately as ``payoff_mean``/``payoff_std_err``.
    """
    m = state.moments()
    s0 = float(current_price)
    # Explicit dtype: device reads use the widest float available so the
    # host f64 state doesn't trip implicit-downcast warnings without x64.
    vdt = jnp.result_type(float)
    sk = HistogramSketch(*(jnp.asarray(np.asarray(v, vdt))
                           for v in state.sketch))
    if moments_are_prices:
        mean = float(m.mean)
        std = float(jnp.sqrt(m.m2 / jnp.maximum(m.count, 1)))
    else:
        # Price mean/std from the sketch (bin-midpoint approximation) —
        # the moment state carries payoff values, not prices.
        bins = sk.counts.shape[0]
        width = (sk.hi - sk.lo) / bins
        mids = sk.lo + (jnp.arange(bins, dtype=vdt) + 0.5) * width
        w = sk.counts.astype(vdt)
        tot = jnp.maximum(jnp.sum(w), 1.0)
        mean = float(jnp.sum(w * mids) / tot)
        std = float(jnp.sqrt(jnp.maximum(
            jnp.sum(w * jnp.square(mids - mean)) / tot, 0.0)))
    out = risk_dict(sk, mean=mean, std=std, std_err=float(std_error(m)),
                    count=int(float(m.count)), current_price=s0)
    if not moments_are_prices:
        out["payoff_mean"] = float(m.mean)
        out["payoff_std_err"] = float(std_error(m))
        # std_err above refers to the payoff stream; make that explicit.
    return out


def risk_dict(sk: HistogramSketch, *, mean: float, std: float,
              std_err: float, count: int, current_price: float) -> dict:
    """Assemble the reference risk keys (app.py:647-657) from a sketch plus
    price moments — THE one place these formulas live (risk_from_state and
    both api/var.py branches all delegate here)."""
    import warnings

    s0 = float(current_price)
    p = {f"p{q}": float(sketch_quantile(sk, float(q)))
         for q in (1, 5, 10, 25, 50, 75, 90, 95, 99)}
    tail_mean = float(sketch_tail_mean_below(sk, p["p5"]))
    # Deterministic grid resolution of the sketch: every quantile is exact
    # only up to one bin width (stats.quantiles docstring), and CVaR adds
    # the bin-midpoint approximation (<= width/2) on top of the threshold's
    # own one-width uncertainty.  Reported in the same percent-of-spot
    # units as var_95_std_err so the two error sources compare directly:
    # at small path counts the sampling bar dominates; past roughly
    # n ~ q(1-q)/(f(x_q) * width)^2 paths the GRID floor dominates and more
    # paths stop helping — raise ``bins`` (or tighten lo/hi) instead.
    bins = sk.counts.shape[0]
    width = float(sk.hi - sk.lo) / bins
    var_grid_err = width / s0 * 100.0
    cvar_grid_err = 1.5 * width / s0 * 100.0
    var_std_err = float(sketch_quantile_std_err(sk, 5.0)) / s0 * 100.0
    if var_std_err < var_grid_err:
        warnings.warn(
            f"VaR sampling std-err ({var_std_err:.3g}% of spot) is below "
            f"the sketch's deterministic grid resolution "
            f"({var_grid_err:.3g}% = one bin width): the estimate is "
            "grid-limited — increase bins (or narrow the lo/hi range) "
            "rather than adding paths", stacklevel=3)
    return {
        "percentiles": p,
        "expected_return": (mean / s0 - 1.0) * 100.0,
        "expected_vol": std / s0 * 100.0,
        "prob_profit": 100.0 * (1.0 - float(sketch_cdf(sk, s0))),
        "var_95": (s0 - p["p5"]) / s0 * 100.0,
        "var_95_std_err": var_std_err,
        "var_95_grid_err": var_grid_err,
        "cvar_95": (s0 - tail_mean) / s0 * 100.0,
        "cvar_95_grid_err": cvar_grid_err,
        "std_err": std_err,
        "n_paths": count,
        # Fraction of samples outside the sketch grid: > 0 means tail
        # quantiles/CVaR approximate that mass at the grid edge.  The
        # api.var entry points auto-re-range when this is material; a
        # nonzero value here means an explicit lo/hi clipped the tail.
        "sketch_oob_fraction":
            (float(sk.underflow) + float(sk.overflow))
            / max(float(sk.total), 1.0),
    }



# ---------------------------------------------------------------------------
# Streaming netting-set xVA (checkpoint/resume for exposure profiles)
# ---------------------------------------------------------------------------

def _amc_fit_streaming(model, spec, *, total_paths, chunk_paths, block_size,
                       n_steps, dt, seed, flat_rate, dtype, sampler, multi):
    """The AMC (Longstaff-Schwartz) regression fit as a MULTI-SWEEP
    stream — the piece that lets `streaming_netting_profile` carry
    Bermudan (regression-marked) trades.

    The backward policy fit needs global cross-path Gram solves per
    exercise date, which a single chunked pass cannot provide.  But the
    counter-based RNG makes chunks replayable for free, so the fit runs
    as ``2 * (n_exercise - 1) + 2`` full sweeps over the chunk stream:
    per exercise date (backward) one sweep for the standardization sums
    and one for the fused [Gram|rhs] partials — with each chunk's
    ``(tau, cash)`` backward state re-derived block-locally from the
    already-frozen later-date policies (`parallel.sharded._amc_replay`)
    — then two more sweeps for all exposure dates' conditional-value
    regressions.

    Bitwise contract (tested): the per-block partials come from the
    SAME fixed single-block bodies as `parallel.sharded._amc_fit_sharded`
    (`_amc_sums3_blocks` / `_amc_gram_blocks`) over the SAME
    `_sim_disc_block` paths with the same barrier boundaries, and every
    closing reduction sees the identical global (n_blocks, ...) array —
    so the fitted ``m/sd/beta/ok`` and policy constants equal the
    sharded fit's bitwise, and the marked profiles match the sharded
    engine exactly like plain books do.

    Accumulated state is O(n_blocks) tiny partial rows per sweep (3 and
    ``(degree+1)^2 + degree + 1`` floats per block) — the same payload
    the sharded engine all-gathers, never per-path arrays.
    """
    from montecarlo.engine.amc import _slope_ok
    from montecarlo.parallel.sharded import (_amc_gram_blocks,
                                                 _amc_replay,
                                                 _amc_sums3_blocks,
                                                 _amc_z_rows_ms,
                                                 _sim_disc_block)

    degree = spec.degree
    k_terms = degree + 1
    n_chunks = total_paths // chunk_paths
    bpc = chunk_paths // block_size
    n_dates = n_steps + 1
    n_ex = len(spec.ex_dates)
    for e in list(spec.ex_dates) + list(spec.resets):
        k = int(round(float(e) / dt))
        if float(e) <= n_steps * dt + 1e-9 and abs(k * dt - float(e)) > 1e-9:
            raise ValueError(
                f"AMC exercise/reset date {e} does not lie on the exposure "
                f"grid (dt={dt}); choose n_steps so resets are grid rows")
    k_ex = [int(round(float(e) / dt)) for e in spec.ex_dates]
    sign = jnp.asarray(spec.sign, dtype)

    def chunk_arrays(model_, off0, sampler_):
        # Mirrors the sharded shard_fn's AMC pre-pass exactly: one
        # lax.map of `_sim_disc_block` over the chunk's fixed-width
        # blocks, stage boundaries pinned by optimization_barrier (the
        # same compilation-stability argument as there).
        offs = (jnp.asarray(off0, jnp.uint32)
                + jnp.arange(bpc, dtype=jnp.uint32)
                * jnp.uint32(block_size))
        paths_all, disc_all = jax.lax.map(
            partial(_sim_disc_block, model_, n_steps=n_steps, dt=dt,
                    seed=seed, flat_rate=flat_rate, dtype=dtype,
                    block_size=block_size, sampler=sampler_), offs)
        paths_all, disc_all = jax.lax.optimization_barrier(
            (paths_all, disc_all))
        z_all = None
        if multi:
            z_all = jax.lax.optimization_barrier(
                _amc_z_rows_ms(paths_all, spec, dt=dt, n_steps=n_steps,
                               dtype=dtype))
        return paths_all, disc_all, z_all

    def reg_at(paths_all, z_all, j):
        """(regressor rows, exercise value) at exercise date j —
        verbatim the sharded fit's backward-step head."""
        if z_all is not None:
            r_j = z_all[:, k_ex[j]]
            return r_j, r_j
        r_j = paths_all[:, k_ex[j]]
        return r_j, sign * spec.swap(r_j,
                                     jnp.asarray(spec.ex_dates[j], dtype))

    @partial(jax.jit, static_argnames=("j",))
    def k_pol_sums3(model_, off0, sampler_, pol_beta, pol_m, pol_sd, *, j):
        paths_all, disc_all, z_all = chunk_arrays(model_, off0, sampler_)
        _amc_replay(paths_all, disc_all, spec, pol_beta, pol_m, pol_sd,
                    dt=dt, n_steps=n_steps, dtype=dtype, z_all=z_all,
                    j_stop=j + 1)
        r_j, ex_val = reg_at(paths_all, z_all, j)
        return _amc_sums3_blocks((ex_val > 0).astype(dtype), r_j)

    @partial(jax.jit, static_argnames=("j",))
    def k_pol_gram(model_, off0, sampler_, pol_beta, pol_m, pol_sd,
                   m_j, sd_j, *, j):
        paths_all, disc_all, z_all = chunk_arrays(model_, off0, sampler_)
        _tau, cash = _amc_replay(paths_all, disc_all, spec, pol_beta,
                                 pol_m, pol_sd, dt=dt, n_steps=n_steps,
                                 dtype=dtype, z_all=z_all, j_stop=j + 1)
        r_j, ex_val = reg_at(paths_all, z_all, j)
        y = cash / jnp.maximum(disc_all[:, k_ex[j]], 1e-300)
        return _amc_gram_blocks((ex_val > 0).astype(dtype), r_j, y,
                                m_j, sd_j, degree, dtype)

    dates = jnp.arange(n_dates)

    @jax.jit
    def k_date_sums3(model_, off0, sampler_, pol_beta, pol_m, pol_sd):
        paths_all, disc_all, z_all = chunk_arrays(model_, off0, sampler_)
        tau, _cash = _amc_replay(paths_all, disc_all, spec, pol_beta,
                                 pol_m, pol_sd, dt=dt, n_steps=n_steps,
                                 dtype=dtype, z_all=z_all, j_stop=0)
        reg_all = z_all if z_all is not None else paths_all

        def date_sums(k):
            return _amc_sums3_blocks((tau > k).astype(dtype),
                                     reg_all[:, k])

        return jax.lax.map(date_sums, dates)         # (T+1, bpc, 3)

    @jax.jit
    def k_date_gram(model_, off0, sampler_, pol_beta, pol_m, pol_sd,
                    m_k, sd_k):
        paths_all, disc_all, z_all = chunk_arrays(model_, off0, sampler_)
        tau, cash = _amc_replay(paths_all, disc_all, spec, pol_beta,
                                pol_m, pol_sd, dt=dt, n_steps=n_steps,
                                dtype=dtype, z_all=z_all, j_stop=0)
        reg_all = z_all if z_all is not None else paths_all

        def date_gram(k):
            y = cash / jnp.maximum(disc_all[:, k], 1e-300)
            return _amc_gram_blocks((tau > k).astype(dtype), reg_all[:, k],
                                    y, m_k[k], sd_k[k], degree, dtype)

        return jax.lax.map(date_gram, dates)         # (T+1, bpc, k²+k)

    # Closing reductions: the concatenated chunk partials are the SAME
    # global (n_blocks, ...) array the sharded fit's all-gather produces,
    # reduced by the same fixed pairwise `tree_sum` behind the same
    # optimization_barrier boundary (jnp.sum's re-association is
    # program-dependent — it flipped the per-date gram closings' last
    # ULP between these programs and the shard programs) — and the
    # scalar algebra below is verbatim `_amc_fit_sharded.fit` / its
    # per-date tail.
    @jax.jit
    def close_sums3(parts):
        sums = tree_sum(jax.lax.optimization_barrier(parts), axis=0)
        wsum = jnp.maximum(sums[0], 1.0)
        m = sums[1] / wsum
        sd = jnp.sqrt(jnp.maximum(sums[2] / wsum - m * m, 0.0) + 1e-12)
        return wsum, m, sd

    @jax.jit
    def close_gram(parts, wsum):
        fused = tree_sum(jax.lax.optimization_barrier(parts),
                         axis=0) / wsum
        a = (fused[:k_terms ** 2].reshape(k_terms, k_terms)
             + 1e-8 * jnp.eye(k_terms, dtype=dtype))
        return jnp.linalg.solve(a, fused[k_terms ** 2:])

    @jax.jit
    def close_date_sums3(parts):
        sums = tree_sum(jax.lax.optimization_barrier(parts), axis=1)
        wsum_k = jnp.maximum(sums[:, 0], 1.0)
        m_k = sums[:, 1] / wsum_k
        var_k = jnp.maximum(sums[:, 2] / wsum_k - m_k * m_k, 0.0)
        sd_k = jnp.sqrt(var_k + 1e-12)
        ok_k = _slope_ok(var_k, sums[:, 2] / wsum_k, dtype, one_pass=True)
        return wsum_k, m_k, sd_k, ok_k

    @jax.jit
    def close_date_gram(parts, wsum_k):
        fused = (tree_sum(jax.lax.optimization_barrier(parts), axis=1)
                 / wsum_k[:, None])
        a = (fused[:, :k_terms ** 2].reshape(n_dates, k_terms, k_terms)
             + 1e-8 * jnp.eye(k_terms, dtype=dtype)[None])
        return jax.vmap(jnp.linalg.solve)(a, fused[:, k_terms ** 2:])

    def sweep(kernel, *extra, axis, j=None):
        parts = []
        for c in range(n_chunks):
            out = (kernel(model, c * chunk_paths, sampler, *extra, j=j)
                   if j is not None
                   else kernel(model, c * chunk_paths, sampler, *extra))
            parts.append(np.asarray(out))
        return jnp.asarray(np.concatenate(parts, axis=axis))

    n_pol = max(n_ex - 1, 0)
    pol_beta = jnp.zeros((n_pol, k_terms), dtype)
    pol_m = jnp.zeros((n_pol,), dtype)
    pol_sd = jnp.ones((n_pol,), dtype)
    for j in range(n_ex - 2, -1, -1):
        wsum, m_j, sd_j = close_sums3(
            sweep(k_pol_sums3, pol_beta, pol_m, pol_sd, axis=0, j=j))
        beta_j = close_gram(
            sweep(k_pol_gram, pol_beta, pol_m, pol_sd, m_j, sd_j,
                  axis=0, j=j), wsum)
        pol_beta = pol_beta.at[j].set(beta_j)
        pol_m = pol_m.at[j].set(m_j)
        pol_sd = pol_sd.at[j].set(sd_j)

    wsum_k, m_k, sd_k, ok_k = close_date_sums3(
        sweep(k_date_sums3, pol_beta, pol_m, pol_sd, axis=1))
    beta = close_date_gram(
        sweep(k_date_gram, pol_beta, pol_m, pol_sd, m_k, sd_k, axis=1),
        wsum_k)
    return {"m": m_k, "sd": sd_k, "beta": beta, "ok": ok_k,
            "pol_beta": pol_beta, "pol_m": pol_m, "pol_sd": pol_sd}


@dataclass
class NettingStreamState:
    """Host-side accumulated netting state (numpy; .npz-serializable).

    Per-chunk SUBTREE ROOTS instead of raw per-block states: a chunk of
    2^k blocks is merged to one (Q, T+1) MomentState on device, and
    `moments_reduce` pairs adjacent states level by level, so for a
    power-of-two blocks-per-chunk the chunk roots are exactly the full
    tree's internal nodes — the final reduce over roots is BITWISE the
    flat tree over all blocks (the same decomposition the multi-slice
    mesh relies on, `parallel.sharded._check_two_level_tree`).  State is
    O(chunks * Q * dates), not O(blocks * Q * dates) — the difference
    between 30 KB and gigabytes at 10^9 paths.
    """

    seed: int
    n_steps: int
    block_size: int
    chunk_paths: int
    T: float                  # maturity — pins the time grid (dt = T/n)
    paths_done: int
    root_count: np.ndarray    # (chunks_done, Q, T+1) f64
    root_mean: np.ndarray
    root_m2: np.ndarray
    hist: np.ndarray          # (T+1, bins) int64 — exact adds
    overflow: np.ndarray      # (T+1,) int64 — mass above the grid
    hi_edges: np.ndarray      # (T+1,) f64 — grid set by the pilot chunk

    def save(self, path: str) -> None:
        if not path.endswith(".npz"):
            raise ValueError("netting streaming checkpoints are single "
                             ".npz files (atomic rename); got " + path)
        fd, tmp = tempfile.mkstemp(
            suffix=".npz", dir=os.path.dirname(os.path.abspath(path)))
        try:
            with os.fdopen(fd, "wb") as fh:
                np.savez(fh, seed=self.seed, n_steps=self.n_steps,
                         block_size=self.block_size,
                         chunk_paths=self.chunk_paths, T=self.T,
                         paths_done=self.paths_done,
                         root_count=self.root_count,
                         root_mean=self.root_mean, root_m2=self.root_m2,
                         hist=self.hist, overflow=self.overflow,
                         hi_edges=self.hi_edges)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    @classmethod
    def load(cls, path: str) -> "NettingStreamState":
        z = np.load(path)
        return cls(seed=int(z["seed"]), n_steps=int(z["n_steps"]),
                   block_size=int(z["block_size"]),
                   chunk_paths=int(z["chunk_paths"]), T=float(z["T"]),
                   paths_done=int(z["paths_done"]),
                   root_count=z["root_count"], root_mean=z["root_mean"],
                   root_m2=z["root_m2"], hist=z["hist"],
                   overflow=z["overflow"], hi_edges=z["hi_edges"])


def streaming_netting_profile(
    model, trades, total_paths: int, n_steps: int, *, T: float, seed: int,
    chunk_paths: int = 1 << 18, csa=None, quantile: float = 0.95,
    pfe_bins: int = 4096, hazard_rate: float = 0.0, recovery: float = 0.4,
    own_hazard_rate: float = 0.0, own_recovery: float = 0.4,
    funding_spread: float = 0.0, im_spread: float = 0.0,
    im_quantile: float = 0.99, im_mpor: float = 10.0 / 252.0,
    kva_cost: float = 0.0,
    kva_capital_ratio: float = 0.112, flat_rate=None, sampler=None,
    dtype=jnp.float64,
    block_size: int = DEFAULT_BLOCK,
    checkpoint_path: Optional[str] = None,
    resume: bool = True, checkpoint_every: int = 1,
    progress_callback=None,
) -> dict:
    """Netting-set exposure + xVA over ``total_paths`` in chunks, with
    checkpoint/resume — the third leg of the netting engine family
    (unsharded / sharded / streaming), all mapping the SAME
    `parallel.sharded.netting_block_stats` fixed-width block program.

    Contracts (tested):
      - a resumed run is bitwise identical to the uninterrupted
        streaming run (counters derive from global path ids; chunk
        subtree roots make the merge chunking-independent);
      - every per-date mean (epe/ene/eepe/uncollateralized) is BITWISE
        identical to `sharded_netting_profile` at the same (block_size,
        n_paths) — the chunk roots are internal nodes of the same fixed
        tree (requires blocks-per-chunk to be a power of two,
        validated); the xVA scalars agree to ~1 ULP (the closing
        sum-reductions compile in different programs, and XLA's
        contraction choice is program-dependent — within either engine
        they remain exactly reproducible);
      - ``pfe`` is a sketch quantile on a grid seeded by the pilot chunk
        (4x its max exposure) that AUTO-RE-RANGES by per-date grid
        DOUBLING: a chunk whose max exposure clears a date's grid doubles
        that date's ``hi`` until it fits, folding the accumulated int64
        counts exactly (a doubled grid's bin j is the sum of old bins
        2j and 2j+1 — integer adds, no mass lost).  The doubling
        decision is a deterministic function of the checkpointed grid
        and the counter-generated chunk stream, so resume stays bitwise
        (tested through a doubling event); ``pfe_overflow`` is
        structurally zero for runs started in this version and is kept
        for checkpoints written before auto-re-ranging (the quantile
        still warns and reports the grid top if legacy overflow mass
        covers the rank).  The reported ``pfe_grid_err`` reflects the
        final (possibly coarsened) width.

    Returns `sharded_netting_profile`'s record plus ``pfe_overflow`` and
    ``paths_done`` (``im``/``mva`` included — the delta-normal IM rows
    ride the same block stats).

    AMC (regression-marked / Bermudan) trades stream too: the global
    regression fit runs first as ``2 * (n_exercise - 1) + 2`` extra
    sweeps over the chunk stream (:func:`_amc_fit_streaming` — counters
    make re-simulation free), then every chunk re-derives its per-path
    exercise states from the frozen policy constants alone
    (`parallel.sharded._amc_replay`) and marks block-locally.  The fit
    is a deterministic function of the run config, so resume simply
    re-runs it (bitwise; nothing fit-related is checkpointed) and the
    marked profiles stay bitwise equal to `sharded_netting_profile`'s —
    tested.  Only WWR (``wwr_beta``) remains sharded-only: its Newton
    survival calibration interleaves a global reduction with per-path
    state at EVERY date, which a chunked stream cannot replay in O(1)
    sweeps.
    """
    from montecarlo.engine.exposure import (SimulationMarkedTrade,
                                                _credit_funding_scalars)
    from montecarlo.parallel.sharded import (_amc_replay, _amc_z_rows_ms,
                                                 _sim_disc_block,
                                                 netting_block_stats)
    from montecarlo.stats.quantiles import histogram_counts

    amc_items = tuple(ti for ti, t in enumerate(trades)
                      if isinstance(t, SimulationMarkedTrade))
    if amc_items:
        from montecarlo.engine.amc import AMCSwaptionSpecMS
        from montecarlo.engine.exposure import is_multistate

        multi = is_multistate(model)
        for ti in amc_items:
            spec_ = getattr(trades[ti], "spec", None)
            if spec_ is None:
                raise TypeError(
                    "the sharded/streaming netting engines mark AMC trades "
                    "through their structured spec — construct them via "
                    "engine.amc.bermudan_swaption_amc_trade (a bare "
                    "SimulationMarkedTrade closure cannot be decomposed "
                    "into the distributed regression fit)")
            if multi != isinstance(spec_, AMCSwaptionSpecMS):
                raise TypeError(
                    "AMC spec/underlying mismatch: multi-state books need "
                    "the AMCSwaptionSpecMS form (engine.amc."
                    "bermudan_swaption_amc_trade_g2pp / _lmm), scalar "
                    "short-rate books the scalar "
                    "bermudan_swaption_amc_trade")
    if total_paths % chunk_paths or chunk_paths % block_size:
        raise ValueError("total_paths % chunk_paths % block_size != 0")
    bpc = chunk_paths // block_size
    if bpc & (bpc - 1):
        raise ValueError(
            f"blocks per chunk must be a power of two for the chunk-root "
            f"merge to equal the flat fixed tree bitwise; got {bpc} "
            "(adjust chunk_paths or block_size)")
    if pfe_bins % 2:
        raise ValueError(f"pfe_bins must be even (grid doubling folds bin "
                         f"pairs); got {pfe_bins}")
    dt = T / n_steps
    n_dates = n_steps + 1
    sets = (("_set", tuple(trades), csa),)
    n_q = 9 + len(trades)
    block_fn = partial(netting_block_stats, sets=sets, n_steps=n_steps,
                       dt=dt, seed=seed, flat_rate=flat_rate, dtype=dtype,
                       block_size=block_size)

    amc_fit_ops = None
    if amc_items:
        # The global regression fit, streamed (multi-sweep; deterministic
        # from the run config, so resume just re-runs it — bitwise).
        amc_fit_ops = {
            ti: _amc_fit_streaming(
                model, trades[ti].spec, total_paths=total_paths,
                chunk_paths=chunk_paths, block_size=block_size,
                n_steps=n_steps, dt=dt, seed=seed, flat_rate=flat_rate,
                dtype=dtype, sampler=sampler, multi=multi)
            for ti in amc_items}

    if amc_items:
        @jax.jit
        def sim_fn(model_, off0, im_q, im_m, sampler_):
            # Mirrors the sharded shard_fn's AMC marking stage verbatim
            # (pre-simulated blocks behind a barrier, per-item tau, then
            # `block_with_paths`) so the chunk's block stats are bitwise
            # the sharded engine's; the only difference is that tau is
            # REPLAYED from the frozen policy instead of read out of an
            # in-program fit — same expressions, same values (tested).
            offs = (jnp.asarray(off0, jnp.uint32)
                    + jnp.arange(bpc, dtype=jnp.uint32)
                    * jnp.uint32(block_size))
            paths_all, disc_all = jax.lax.map(
                partial(_sim_disc_block, model_, n_steps=n_steps, dt=dt,
                        seed=seed, flat_rate=flat_rate, dtype=dtype,
                        block_size=block_size, sampler=sampler_), offs)
            paths_all, disc_all = jax.lax.optimization_barrier(
                (paths_all, disc_all))
            taus = []
            for ti in amc_items:
                spec_k = trades[ti].spec
                z_all = (jax.lax.optimization_barrier(
                            _amc_z_rows_ms(paths_all, spec_k, dt=dt,
                                           n_steps=n_steps, dtype=dtype))
                         if multi else None)
                op = amc_fit_ops[ti]
                tau_k, _ = _amc_replay(paths_all, disc_all, spec_k,
                                       op["pol_beta"], op["pol_m"],
                                       op["pol_sd"], dt=dt,
                                       n_steps=n_steps, dtype=dtype,
                                       z_all=z_all, j_stop=0)
                taus.append(tau_k)

            def block_with_paths(args):
                off_b, paths_b, disc_b = args[0], args[1], args[2]
                ops = {(0, ti): {**{f: amc_fit_ops[ti][f]
                                    for f in ("m", "sd", "beta", "ok")},
                                 "tau": args[3 + i]}
                       for i, ti in enumerate(amc_items)}
                return block_fn(model_, off_b, im_quantile=im_q,
                                im_mpor=im_m, sampler=sampler_,
                                paths_disc=(paths_b, disc_b), amc_ops=ops)

            stats, pos = jax.lax.map(
                block_with_paths, (offs, paths_all, disc_all, *taus))
            root = moments_reduce(stats)                # (Q, T+1) leaves
            pos = jnp.moveaxis(pos, 0, 2).reshape(n_dates, chunk_paths)
            return root, pos
    else:
        @jax.jit
        def sim_fn(model_, off0, im_q, im_m, sampler_):
            # im_quantile/im_mpor as runtime OPERANDS, exactly like the
            # sharded engine's shared dict: trace-time constants here
            # would let XLA constant-fold ndtri/exp with host libm while
            # the sharded twin computes them at runtime — a 1-ULP
            # divergence in the IM rows that broke the bitwise
            # streaming==sharded contract (caught by
            # test_streaming_netting).
            offs = (jnp.asarray(off0, jnp.uint32)
                    + jnp.arange(bpc, dtype=jnp.uint32)
                    * jnp.uint32(block_size))
            stats, pos = jax.lax.map(
                lambda off: block_fn(model_, off, im_quantile=im_q,
                                     im_mpor=im_m, sampler=sampler_), offs)
            root = moments_reduce(stats)                # (Q, T+1) leaves
            pos = jnp.moveaxis(pos, 0, 2).reshape(n_dates, chunk_paths)
            return root, pos

    im_ops = (jnp.asarray(im_quantile, dtype), jnp.asarray(im_mpor, dtype))

    @jax.jit
    def hist_fn(pos, hi_edges):
        width = jnp.asarray(hi_edges, dtype) / pfe_bins
        # Clamp in FLOAT before the int cast: casting a scaled exposure
        # beyond int32 range is platform-dependent (it can land on
        # INT_MIN and silently dodge the >= pfe_bins overflow test —
        # exactly the tiny-grid resume scenario the overflow counter
        # exists for).  pos >= 0, so only the top needs the clamp.
        idx = jnp.minimum(pos / width[:, None],
                          jnp.asarray(pfe_bins, dtype)).astype(jnp.int32)
        over = jnp.sum(idx >= pfe_bins, axis=1, dtype=jnp.int32)
        # Out-of-grid mass lands in one pad cell past the real bins and
        # is discarded — only `over` reports it.
        cell = jnp.where(
            idx >= pfe_bins, n_dates * pfe_bins,
            idx + (jnp.arange(n_dates, dtype=jnp.int32)
                   * pfe_bins)[:, None])
        counts = histogram_counts(cell, n_dates * pfe_bins + 1,
                                  jnp.int32)
        return counts[:n_dates * pfe_bins].reshape(n_dates, pfe_bins), over

    state = None
    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        state = NettingStreamState.load(checkpoint_path)
        if (state.seed, state.n_steps, state.block_size,
                state.chunk_paths, state.T) != (seed, n_steps, block_size,
                                                chunk_paths, float(T)):
            raise ValueError("checkpoint does not match this run's config")
        if state.root_mean.shape[1:] != (n_q, n_dates) \
                or state.hist.shape != (n_dates, pfe_bins):
            raise ValueError("checkpoint book/grid shape does not match")
    pilot = None
    if state is None:
        # Pilot: simulate chunk 0 once to size the real grid at 4x its
        # max exposure (headroom for later chunks; excess shows up as
        # counted overflow, never silent).  The simulated chunk is
        # REUSED as the main loop's first chunk — only the cheap
        # histogram pass runs twice, not the simulate+mark work.
        pilot = sim_fn(model, 0, *im_ops, sampler)
        hi = np.asarray(jnp.max(pilot[1], axis=1), np.float64) * 4.0
        hi = np.where(hi > 0, hi, 1.0)
        state = NettingStreamState(
            seed=seed, n_steps=n_steps, block_size=block_size,
            chunk_paths=chunk_paths, T=float(T), paths_done=0,
            root_count=np.zeros((0, n_q, n_dates)),
            root_mean=np.zeros((0, n_q, n_dates)),
            root_m2=np.zeros((0, n_q, n_dates)),
            hist=np.zeros((n_dates, pfe_bins), np.int64),
            overflow=np.zeros((n_dates,), np.int64), hi_edges=hi)

    while state.paths_done < total_paths:
        if pilot is not None and state.paths_done == 0:
            root, pos = pilot
            pilot = None
        else:
            root, pos = sim_fn(model, state.paths_done, *im_ops, sampler)
        # Auto-re-ranging by deterministic grid DOUBLING: if this chunk's
        # max exposure clears a date's grid, double that date's hi until
        # it fits strictly, folding the accumulated int64 counts exactly
        # (bin j of the doubled grid is old bins 2j + 2j+1).  Doubling
        # depends only on the checkpointed grid and the counter-generated
        # chunk stream, so interrupted and uninterrupted runs make the
        # same decisions — resume stays bitwise.
        # (The 1e-6 margin keeps the top path strictly inside the grid
        # after the f32-binning round-trip in hist_fn — a max within a few
        # ULPs of hi could otherwise round up into the overflow cell.)
        m = np.asarray(jnp.max(pos, axis=1), np.float64) * (1.0 + 1e-6)
        if np.any(m >= state.hi_edges):
            k = np.zeros(n_dates, np.int64)
            while np.any(m >= state.hi_edges * np.exp2(k)):
                k += m >= state.hi_edges * np.exp2(k)
            for d in np.nonzero(k)[0]:
                h = state.hist[d]
                for _ in range(int(k[d])):
                    h = np.concatenate([
                        h[0::2] + h[1::2],
                        np.zeros(pfe_bins // 2, np.int64)])
                state.hist[d] = h
            state.hi_edges = state.hi_edges * np.exp2(k)
        counts, over = hist_fn(pos, jnp.asarray(state.hi_edges, dtype))
        state.root_count = np.concatenate(
            [state.root_count, np.asarray(root.count, np.float64)[None]])
        state.root_mean = np.concatenate(
            [state.root_mean, np.asarray(root.mean, np.float64)[None]])
        state.root_m2 = np.concatenate(
            [state.root_m2, np.asarray(root.m2, np.float64)[None]])
        state.hist += np.asarray(counts, np.int64)
        state.overflow += np.asarray(over, np.int64)
        state.paths_done += chunk_paths
        done_chunks = state.paths_done // chunk_paths
        if checkpoint_path and done_chunks % checkpoint_every == 0:
            state.save(checkpoint_path)
        if progress_callback:
            progress_callback(state.paths_done, total_paths)
    if checkpoint_path:
        state.save(checkpoint_path)

    # Cast the f64-stored roots back to the run dtype before the final
    # reduce: an f32 run's roots round-trip f64 exactly, and the upper
    # tree must merge at the SAME precision as the sharded engine's for
    # the bitwise-equality contract.
    means = np.asarray(moments_reduce(MomentState(
        jnp.asarray(state.root_count, dtype),
        jnp.asarray(state.root_mean, dtype),
        jnp.asarray(state.root_m2, dtype))).mean)          # (Q, T+1)
    epe, ene, epe_u, ene_u = means[0], means[1], means[4], means[5]
    im = means[7]
    times = jnp.arange(n_dates, dtype=dtype) * dt

    # Scalar tail at the run dtype, COMPILED: the same shared algebra on
    # means that are bitwise the sharded engine's — and the reductions
    # must also compile (an eager op-by-op tail picked a different
    # sum-contraction than the sharded engine's jitted tail and flipped
    # the scalars' last ULP).
    @jax.jit
    def _tail(m):
        eepe_ = jax.lax.associative_scan(jnp.maximum, m[0])
        sc, aux = _credit_funding_scalars(
            m[2], m[3], m[9:], eepe_, m[6], times, dt, n_steps,
            hazard_rate=hazard_rate, recovery=recovery,
            own_hazard_rate=own_hazard_rate, own_recovery=own_recovery,
            funding_spread=funding_spread, kva_cost=kva_cost,
            kva_capital_ratio=kva_capital_ratio, dtype=dtype)
        sc["mva"] = (jnp.asarray(im_spread, dtype)
                     * jnp.sum(m[8] * aux["alive"] * aux["trap"]))
        return eepe_, sc

    eepe, scalars = _tail(jnp.asarray(means, dtype))

    # PFE sketch quantile on the accumulated int64 counts (host numpy):
    # same crossing-bin interpolation as the sharded engine.
    width = state.hi_edges / pfe_bins
    rank = quantile * state.paths_done
    cum = np.cumsum(state.hist.astype(np.float64), axis=1)
    in_grid = cum[:, -1]
    bin_idx = np.argmax(cum >= rank, axis=1)
    cum_before = np.where(bin_idx > 0,
                          np.take_along_axis(
                              cum, np.maximum(bin_idx - 1, 0)[:, None],
                              1)[:, 0], 0.0)
    in_bin = np.maximum(np.take_along_axis(
        state.hist, bin_idx[:, None], 1)[:, 0], 1)
    frac = np.clip((rank - cum_before) / in_bin, 0.0, 1.0)
    pfe = (bin_idx + frac) * width
    beyond = rank > in_grid
    if np.any(beyond):
        import warnings

        warnings.warn(
            f"PFE q={quantile} lies ABOVE the pilot-sized grid on "
            f"{int(beyond.sum())}/{n_dates} dates (overflow mass "
            f"{int(state.overflow.max())} paths at worst) — reported as "
            "the grid top; rerun with a larger pilot chunk or more "
            "pfe_bins headroom", stacklevel=2)
        pfe = np.where(beyond, state.hi_edges, pfe)

    return {"times": times, "epe": jnp.asarray(epe),
            "ene": jnp.asarray(ene), "pfe": jnp.asarray(pfe),
            "pfe_grid_err": jnp.asarray(width),
            "pfe_overflow": jnp.asarray(state.overflow),
            "eepe": eepe, "epe_uncollateralized": jnp.asarray(epe_u),
            "ene_uncollateralized": jnp.asarray(ene_u),
            "im": jnp.asarray(im),
            "paths_done": state.paths_done, **scalars}
