"""Fault injection: the shard-replay claim, exercised.

`engine.streaming` (module docstring) claims counter-based RNG makes a
failed shard "replayable for free": counters derive from global path ids,
so a worker that died mid-chunk can be re-executed from nothing but its
path-offset range and the run config, and the repaired estimate is
BITWISE the uninterrupted run.  These tests actually lose a chunk and
repair it — for both `streaming_estimate` (moment blocks + sketch) and
`streaming_netting_profile` (chunk subtree roots), plus the
kill-mid-chunk end-to-end resume variant where the lost work was never
checkpointed.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from montecarlo.engine.dispatch import terminal_prices
from montecarlo.engine.exposure import CSA, swap_value_fn
from montecarlo.engine.streaming import (streaming_estimate,
                                             streaming_netting_profile)
from montecarlo.processes import GBM, Vasicek
from montecarlo.stats.welford import moments_from_array, moments_reduce

TOTAL, CHUNK, BLOCK = 8192, 2048, 256
N_STEPS, SEED = 16, 9


def _process():
    return GBM.create(100.0, 0.05, 0.2, 1.0 / N_STEPS, dtype=jnp.float32)


def test_lost_chunk_replayed_from_counters_streaming_estimate():
    """Lose chunk 1 of 4 (zero its block stats — a dead worker whose
    results never arrived), re-execute it from nothing but its path-id
    range, and verify (a) the replayed per-block stats are bitwise the
    uninterrupted run's rows, and (b) the repaired final estimate is
    bitwise the uninterrupted estimate."""
    proc = _process()
    ref = streaming_estimate(proc, TOTAL, N_STEPS, seed=SEED,
                             chunk_paths=CHUNK, block_size=BLOCK,
                             lo=0.0, hi=400.0)
    bpc = CHUNK // BLOCK
    lost = slice(1 * bpc, 2 * bpc)              # chunk 1's block rows

    # Simulate the loss.
    broken_mean = ref.block_mean.copy()
    broken_m2 = ref.block_m2.copy()
    broken_mean[lost] = 0.0
    broken_m2[lost] = 0.0

    # Replay from counters alone: same (seed, path offset) -> same paths.
    terminal = terminal_prices(proc, CHUNK, N_STEPS, seed=SEED,
                               dtype=jnp.float32,
                               path_offset=1 * CHUNK)
    blocks = moments_from_array(jnp.reshape(terminal, (-1, BLOCK)),
                                axis=-1)
    np.testing.assert_array_equal(np.asarray(blocks.mean, np.float64),
                                  ref.block_mean[lost])
    np.testing.assert_array_equal(np.asarray(blocks.m2, np.float64),
                                  ref.block_m2[lost])

    # Splice the replay in; the fixed-tree reduce must be bitwise whole.
    broken_mean[lost] = np.asarray(blocks.mean, np.float64)
    broken_m2[lost] = np.asarray(blocks.m2, np.float64)
    repaired = ref.__class__(
        seed=ref.seed, n_steps=ref.n_steps, block_size=ref.block_size,
        paths_done=ref.paths_done, block_count=ref.block_count,
        block_mean=broken_mean, block_m2=broken_m2, sketch=ref.sketch)
    a, b = repaired.moments(), ref.moments()
    assert float(a.mean) == float(b.mean)
    assert float(a.m2) == float(b.m2)


def _netting_book():
    model = Vasicek.create(0.03, 0.6, 0.04, 0.012, 2.0 / N_STEPS,
                           dtype=jnp.float64)
    pay = np.arange(1, 5) * 0.5
    return model, (swap_value_fn(model, 0.035, pay, 0.5),
                   lambda r, t: -0.5 * swap_value_fn(
                       model, 0.04, pay[:2], 0.5)(r, t))


_NKW = dict(T=2.0, seed=SEED, hazard_rate=0.02, funding_spread=0.004,
            csa=CSA(threshold=0.002, mpor=8.0 / N_STEPS), pfe_bins=64)


def test_lost_chunk_replayed_from_counters_netting(tmp_path):
    """Same repair for the netting engine: a chunk subtree root
    recomputed from its path-id range alone is bitwise the checkpointed
    root, and the repaired checkpoint resumes to the uninterrupted
    profile."""
    from functools import partial

    from montecarlo.engine.streaming import NettingStreamState
    from montecarlo.parallel.sharded import netting_block_stats

    model, trades = _netting_book()
    ck = str(tmp_path / "net.npz")
    ref = streaming_netting_profile(model, trades, TOTAL, N_STEPS,
                                    chunk_paths=CHUNK, block_size=BLOCK,
                                    checkpoint_path=ck, **_NKW)
    state = NettingStreamState.load(ck)
    assert state.root_mean.shape[0] == TOTAL // CHUNK

    # Replay chunk 2's root from counters: the identical per-block unit
    # (`netting_block_stats`) over its offsets, reduced the same way.
    bpc = CHUNK // BLOCK
    dt = 2.0 / N_STEPS
    block_fn = partial(netting_block_stats,
                       sets=(("_set", tuple(trades), _NKW["csa"]),),
                       n_steps=N_STEPS, dt=dt, seed=SEED, flat_rate=None,
                       dtype=jnp.float64, block_size=BLOCK)

    @jax.jit
    def chunk_root(model_, off0, im_q, im_m):
        # im args as runtime OPERANDS, matching the engine's sim_fn: as
        # trace-time constants XLA would fold ndtri/exp with host libm
        # and the replayed IM rows would be 1 ULP off the stored root.
        offs = (jnp.asarray(off0, jnp.uint32)
                + jnp.arange(bpc, dtype=jnp.uint32) * jnp.uint32(BLOCK))
        stats, _pos = jax.lax.map(
            lambda off: block_fn(model_, off, im_quantile=im_q,
                                 im_mpor=im_m), offs)
        return moments_reduce(stats)

    root = chunk_root(model, 2 * CHUNK, jnp.float64(0.99),
                      jnp.float64(10.0 / 252.0))
    np.testing.assert_array_equal(np.asarray(root.mean, np.float64),
                                  state.root_mean[2])
    np.testing.assert_array_equal(np.asarray(root.m2, np.float64),
                                  state.root_m2[2])

    # Repair path: zero the lost chunk's root (dead worker), splice the
    # replayed one in, and confirm the engine rebuilds the reference
    # record bitwise from the repaired checkpoint.
    state.root_mean[2] = 0.0
    state.root_m2[2] = 0.0
    state.root_mean[2] = np.asarray(root.mean, np.float64)
    state.root_m2[2] = np.asarray(root.m2, np.float64)
    state.save(ck)
    again = streaming_netting_profile(model, trades, TOTAL, N_STEPS,
                                      chunk_paths=CHUNK, block_size=BLOCK,
                                      checkpoint_path=ck, **_NKW)
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(again[k]),
                                      err_msg=k)


def test_kill_mid_chunk_without_checkpoint_of_lost_work(tmp_path):
    """End-to-end: the worker dies during chunk 2 BEFORE checkpointing it
    (checkpoint_every=2 means chunk 1's work is also on disk only as part
    of the chunk-0/1 save) — resume re-executes everything lost from
    counters; the final record is bitwise the uninterrupted run's."""
    model, trades = _netting_book()
    ck = str(tmp_path / "net.npz")
    calls = []

    def die_during_third_chunk(done, total):
        calls.append(done)
        if len(calls) == 3:
            raise RuntimeError("worker lost")  # chunk 2 done, NOT saved

    with pytest.raises(RuntimeError):
        streaming_netting_profile(model, trades, TOTAL, N_STEPS,
                                  chunk_paths=CHUNK, block_size=BLOCK,
                                  checkpoint_path=ck, checkpoint_every=2,
                                  progress_callback=die_during_third_chunk,
                                  **_NKW)
    resumed = streaming_netting_profile(model, trades, TOTAL, N_STEPS,
                                        chunk_paths=CHUNK,
                                        block_size=BLOCK,
                                        checkpoint_path=ck,
                                        checkpoint_every=2, **_NKW)
    oneshot = streaming_netting_profile(model, trades, TOTAL, N_STEPS,
                                        chunk_paths=CHUNK,
                                        block_size=BLOCK, **_NKW)
    assert resumed["paths_done"] == TOTAL
    for k, v in oneshot.items():
        np.testing.assert_array_equal(np.asarray(v),
                                      np.asarray(resumed[k]), err_msg=k)
