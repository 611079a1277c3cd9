"""The reference path-simulation engine: `lax.scan` over time.

This is the *semantics-defining* engine: pure JAX, runs on any backend, and
every fast path (the fused Pallas kernel in :mod:`montecarlo.ops`) must
agree with it bitwise (or to stated FMA-contraction ULPs).  Time is sequential (the GARCH/Heston variance
recurrences forbid parallelizing it — reference app.py:633); parallelism is
over paths.

Modes (mirroring the reference's two uses of its path array):
- ``"terminal"`` — return only terminal prices (pricing, VaR): O(paths) memory.
- ``"paths"``    — return the full (n_steps+1, n_paths) price array, exactly
  the reference's ``paths`` layout (app.py:612-613), for path-percentile
  charts at small scale.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from montecarlo.rng.threefry import key_from_seed_dynamic
from montecarlo.samplers import PlainSampler


def check_sampler(sampler, process, n_steps: int) -> None:
    """Trace-time guards for sampler/process compatibility.

    (a) A sampler with a finite dimension table must cover every
    (step, draw) dimension: `sv[dim]` past the table is a clamping
    out-of-bounds gather — later steps silently REUSE the last dimension's
    point, giving dependent increments and a biased estimate.
    (b) Samplers that substitute standard NORMALS for every draw (all the
    Sobol variants) are valid only for all-normal processes: feeding a
    normal into a slot a process consumes as a uniform (Merton/Kou/Bates
    jump counts, the GARCH bootstrap index) silently corrupts the
    distribution — e.g. a standard normal exceeds the ~0.996 zero-jump
    CDF threshold ~16% of the time, so ~16% of steps got K_MAX jumps.
    """
    if sampler is None:
        return
    if getattr(sampler, "normals_only", False):
        from montecarlo.processes.base import NormalDrawsMixin

        if not isinstance(process, NormalDrawsMixin):
            raise ValueError(
                f"{type(sampler).__name__} substitutes standard normals "
                f"for every draw, but {type(process).__name__} consumes "
                "non-normal draws (jump-count uniforms / bootstrap "
                "indices) — use plain or antithetic sampling for this "
                "process")
    validate = getattr(sampler, "validate", None)
    if validate is not None:
        validate(process, n_steps)


def path_ids_for(n_paths: int, path_offset=0):
    """Global path ids for a contiguous block starting at ``path_offset``.

    ``path_offset`` may be traced (e.g. ``axis_index * local_n`` inside a
    `shard_map`), which is how a shard reproduces exactly the paths it would
    own inside an unsharded run.
    """
    offset = jnp.asarray(path_offset).astype(jnp.uint32)
    return offset + jnp.arange(n_paths, dtype=jnp.uint32)


def simulate(process, n_paths: int, n_steps: int, *, seed,
             stream=0, sampler=None, mode: str = "terminal",
             dtype=jnp.float32, path_offset=0, remat: bool = False,
             observe=None):
    """Simulate ``n_paths`` paths for ``n_steps`` steps.

    Args:
      process: a process pytree (see :mod:`montecarlo.processes.base`).
      sampler: a draw provider (default plain MC).
      seed: python int (full 64-bit seed space) or a traced value.  Seeds
        are folded into Threefry key words HERE (``key_from_seed_dynamic``)
        and passed to the jitted core as *operands* — switching seeds never
        recompiles, and a traced seed (e.g. a per-replicate RQMC shift
        inside a `lax.scan`) traces through.  Stream derivation everywhere
        in the framework is by XOR, which commutes with the key fold, so
        the draw streams are bitwise identical to keying inside the trace.
      path_offset: the global id of the first path — the sharding hook: a
        shard simulating paths [o, o+n) passes ``path_offset=o`` and gets the
        identical paths it would have produced inside a bigger unsharded run.
      remat: checkpoint the scan body — reverse-mode differentiation
        (pathwise Greeks) then recomputes each step's draws/state instead of
        storing all T intermediate states: O(paths) residual memory instead
        of O(paths * steps).  Counter-based draws make the recomputation
        free of RNG state.
      observe: optional static ``observe(process, state) -> array`` used in
        place of ``process.prices`` for every output row — how multi-state
        underlyings (G2++'s (x, y), the hybrid's (S, r, integral)) expose
        their full state to the exposure engines without changing their
        pricing observable.  An (n_paths, C) observation yields
        (n_steps+1, n_paths, C) paths.

    Returns:
      ``mode="terminal"`` -> (n_paths,) (or (n_paths, n_assets)) prices at T.
      ``mode="paths"``    -> (n_steps+1, n_paths[, n_assets]) prices, row 0 = spot.
    """
    k0, k1 = key_from_seed_dynamic(seed, stream)
    return _simulate(process, n_paths, n_steps, seed=k0, stream=k1,
                     sampler=sampler, mode=mode, dtype=dtype,
                     path_offset=path_offset, remat=remat, observe=observe)


@partial(jax.jit, static_argnames=("n_paths", "n_steps", "mode", "dtype",
                                   "remat", "observe"))
def _simulate(process, n_paths: int, n_steps: int, *, seed, stream,
              sampler=None, mode: str = "terminal",
              dtype=jnp.float32, path_offset=0, remat: bool = False,
              observe=None):
    if sampler is None:
        sampler = PlainSampler()
    check_sampler(sampler, process, n_steps)
    obs = observe or (lambda p, s: p.prices(s))
    ids = path_ids_for(n_paths, path_offset)
    state0 = process.init_state(ids, dtype)

    def body(state, t):
        eps = sampler.draws(process, seed, stream, ids, t, dtype)
        new_state = process.step(state, eps, t)
        out = obs(process, new_state) if mode == "paths" else None
        return new_state, out

    if remat:
        body = jax.checkpoint(body)
    final_state, outs = jax.lax.scan(body, state0,
                                     jnp.arange(n_steps, dtype=jnp.int32))
    if mode == "paths":
        first = obs(process, state0)[None]
        return jnp.concatenate([first, outs], axis=0)
    return obs(process, final_state)


def replay_paths(process, path_ids, n_steps: int, *, seed,
                 stream=0, sampler=None, mode: str = "terminal",
                 dtype=jnp.float32):
    """Re-simulate an *arbitrary set* of global path ids, bit-exactly.

    The failure-recovery primitive: counter-based draws mean any subset of a
    run (a failed shard, a suspicious outlier path, an audit sample) can be
    regenerated independently, with no saved RNG state — pass the global ids
    and the original seed.  Matches `simulate`'s values elementwise.
    Seeds fold to key words host-side exactly as in :func:`simulate`.
    """
    k0, k1 = key_from_seed_dynamic(seed, stream)
    return _replay_paths(process, path_ids, n_steps, seed=k0, stream=k1,
                         sampler=sampler, mode=mode, dtype=dtype)


@partial(jax.jit, static_argnames=("n_steps", "mode", "dtype"))
def _replay_paths(process, path_ids, n_steps: int, *, seed,
                  stream, sampler=None, mode: str = "terminal",
                  dtype=jnp.float32):
    if sampler is None:
        sampler = PlainSampler()
    check_sampler(sampler, process, n_steps)
    ids = jnp.asarray(path_ids, jnp.uint32)
    state0 = process.init_state(ids, dtype)

    def body(state, t):
        eps = sampler.draws(process, seed, stream, ids, t, dtype)
        new_state = process.step(state, eps, t)
        out = process.prices(new_state) if mode == "paths" else None
        return new_state, out

    final_state, outs = jax.lax.scan(body, state0,
                                     jnp.arange(n_steps, dtype=jnp.int32))
    if mode == "paths":
        first = process.prices(state0)[None]
        return jnp.concatenate([first, outs], axis=0)
    return process.prices(final_state)
