"""Generic fused path kernel — any scalar-state process, Pallas through Triton.

The `lax.scan` engine (:mod:`montecarlo.engine.simulate`) runs one XLA
loop iteration per time step, and every iteration reads and writes the whole
path state in device memory.  This kernel runs the exact same
``process.draws`` / ``process.step`` / ``process.prices`` methods, but inside
one program per 1-D block of paths: the time loop is a ``fori_loop`` inside
the program and the state pytree stays in registers for the whole loop; the
Threefry cipher is integer register work.  Only the result leaves the chip's
registers: terminal prices, finalized path functionals, or per-row payoff
moments.

Mechanics:
- the process pytree (and an optional device-Sobol sampler) is flattened;
  every leaf is passed flat.  A scalar leaf is loaded once per program; an
  array leaf stays a ref behind :class:`KernelTable`, so the process reads it
  with indexed loads (the GARCH shock table, curve entries, the SLV leverage
  rows, Sobol direction numbers) — the same ``table[i]`` expression that is
  a gather in the scan engine;
- two SDE steps run per loop iteration: both steps of a pair share one
  Threefry call (draw convention ``c1 = t >> 1``, ``draws_pair``);
- draw streams are keyed by global path id -> identical to the scan engine
  and invariant to the block size, the path offset and the mesh;
- a path count that is not a multiple of the block is padded up to whole
  blocks and the extra paths are dropped (they have their own global ids,
  so the kept paths are unchanged).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from montecarlo.rng.threefry import key_from_seed_dynamic

#: Paths per program.  A power of two (Triton block shapes must be);
#: 2^20 paths make 4096 programs, enough to fill the card's 132 SMs.
BLOCK = 256
#: Warps per program (32 threads each): 256 paths over 128 threads keeps
#: two paths per thread, so each thread's state and cipher temporaries
#: stay in registers.
NUM_WARPS = 4
#: Paths per in-kernel payoff-moment row.  Fixed (not the program block),
#: so block moments never depend on the block size — the determinism
#: contract's fixed-block rule.
MOMENT_ROW = 128


def _tree_where(cond, a, b):
    return jax.tree.map(lambda x, y: jnp.where(cond, x, y), a, b)


class KernelTable:
    """Ref view of a process's array leaf inside the kernel.

    Indexing mirrors a jnp array of the leaf's original shape: a full index
    is one indexed load (a scalar for scalar indices, a gather for index
    arrays); a partial index with leading indices returns the sub-table view
    (``self.mu_t[a][ti]``, ``self.sv[dim][k]``).  Flat offsets are clamped to
    the table like XLA clamps a gather, so a masked odd step reading one
    entry past a curve never leaves the buffer.
    """

    def __init__(self, ref, shape, offset=0, dtype=None):
        self._ref = ref
        self.shape = tuple(shape)
        self._offset = offset
        self._dtype = dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self):
        return self._dtype or self._ref.dtype

    def astype(self, dtype):
        return KernelTable(self._ref, self.shape, self._offset, dtype)

    def __getitem__(self, idx):
        idx = idx if isinstance(idx, tuple) else (idx,)
        if len(idx) > self.ndim:
            raise IndexError(f"{len(idx)} indices for a {self.ndim}-D table")
        flat = self._offset
        stride = 1
        strides = []
        for n in reversed(self.shape):
            strides.append(stride)
            stride *= n
        strides = strides[::-1]
        for i, n, s in zip(idx, self.shape, strides):
            if isinstance(i, int):
                flat = flat + (i + n if i < 0 else i) * s
            else:
                flat = flat + jnp.asarray(i).astype(jnp.int32) * s
        if len(idx) < self.ndim:
            return KernelTable(self._ref, self.shape[len(idx):], flat,
                               self._dtype)
        size = self._ref.shape[0]
        flat = (min(max(flat, 0), size - 1) if isinstance(flat, int)
                else jnp.clip(flat, 0, size - 1))
        v = self._ref[flat]
        return v if self._dtype is None else v.astype(self._dtype)


def _flatten(tree):
    """Kernel inputs for a process (or (process, sampler)) pytree: every
    leaf flattened to 1-D (scalars to one element)."""
    leaves, treedef = jax.tree.flatten(tree)
    shapes = [tuple(jnp.shape(l)) for l in leaves]
    inputs = [jnp.reshape(jnp.asarray(l), (-1,)) for l in leaves]
    return inputs, treedef, shapes


def _rebuild(leaf_refs, shapes):
    return [r[0] if shape == () else KernelTable(r, shape)
            for r, shape in zip(leaf_refs, shapes)]


def _scalar_row(seed, stream, path_offset):
    k0, k1 = key_from_seed_dynamic(seed, stream)
    return jnp.stack([
        jnp.asarray(path_offset).astype(jnp.int32),
        k0.astype(jnp.int32),  # bit-preserving reinterpret
        k1.astype(jnp.int32),
    ])


def block_path_ids(block_idx, block: int, path_offset):
    """Global path ids of program ``block_idx``: the flat `jnp.arange`
    ordering of the scan engine, ``offset + block_idx * block + i``."""
    lane = jax.lax.broadcasted_iota(jnp.int32, (block,), 0)
    base = (jnp.asarray(path_offset).astype(jnp.uint32)
            + jnp.asarray(block_idx).astype(jnp.uint32) * jnp.uint32(block))
    return base + lane.astype(jnp.uint32)


def _make_kernel(treedef, shapes, n_steps: int, block: int, antithetic: bool,
                 has_sampler: bool, payoff_fn=None, functionals=None):
    """One program: the whole time loop for ``block`` paths.

    Output refs: terminal prices (``payoff_fn`` and ``functionals`` None);
    per-row payoff (mean, m2) (``payoff_fn``); or terminal prices followed
    by each finalized functional (``functionals``).
    """
    n_leaves = len(shapes)

    def kernel(*refs):
        leaves = _rebuild(refs[:n_leaves], shapes)
        scalar_ref = refs[n_leaves]
        out_refs = refs[n_leaves + 1:]
        obj = jax.tree.unflatten(treedef, leaves)
        proc, smp = obj if has_sampler else (obj, None)

        ids = block_path_ids(pl.program_id(0), block, scalar_ref[0])
        k0 = scalar_ref[1].astype(jnp.uint32)
        k1 = scalar_ref[2].astype(jnp.uint32)
        if antithetic:
            # Path 2k+1 mirrors path 2k (same global pair ids as the
            # AntitheticSampler in the scan engine).
            draw_ids = ids >> jnp.uint32(1)
            odd = (ids & jnp.uint32(1)) == 1
        else:
            draw_ids = ids

        def get_draws(j):
            if smp is not None:
                # Device Sobol: one call per step — the pair-sharing of
                # the Threefry cipher does not apply.
                return (smp.draws(proc, k0, k1, draw_ids, 2 * j,
                                  jnp.float32),
                        smp.draws(proc, k0, k1, draw_ids, 2 * j + 1,
                                  jnp.float32))
            eps0, eps1 = proc.draws_pair(k0, k1, draw_ids, j, jnp.float32)
            if antithetic:
                m0, m1 = proc.antithetic(eps0), proc.antithetic(eps1)
                eps0 = tuple(jnp.where(odd, m, e) for m, e in zip(m0, eps0))
                eps1 = tuple(jnp.where(odd, m, e) for m, e in zip(m1, eps1))
            return eps0, eps1

        state0 = proc.init_state(ids, jnp.float32)
        n_pairs = (n_steps + 1) // 2

        if functionals is None:
            def body(j, state):
                eps0, eps1 = get_draws(j)
                t1 = 2 * j + 1
                state = proc.step(state, eps0, 2 * j)
                stepped = proc.step(state, eps1, t1)
                return _tree_where(t1 < n_steps, stepped, state)

            final = jax.lax.fori_loop(jnp.int32(0), jnp.int32(n_pairs),
                                      body, state0)
            prices = proc.prices(final)
            if payoff_fn is None:
                out_refs[0][...] = prices
            else:
                # Payoff + per-row moments inside the program: the write
                # shrinks from the terminal array to two floats per row.
                pay = jnp.reshape(payoff_fn(prices),
                                  (block // MOMENT_ROW, MOMENT_ROW))
                mean_rows = jnp.mean(pay, axis=1)
                d = pay - mean_rows[:, None]
                out_refs[0][...] = mean_rows
                out_refs[1][...] = jnp.sum(d * d, axis=1)
            return

        from montecarlo.engine.functionals import functional_observables

        accs0 = tuple(f.init(o) for f, o in zip(
            functionals, functional_observables(proc, state0, functionals)))

        def fbody(j, carry):
            state, accs = carry
            eps0, eps1 = get_draws(j)
            t0, t1 = 2 * j, 2 * j + 1
            # Step t0 is always a real step (n_pairs = ceil(n_steps/2)).
            state = proc.step(state, eps0, t0)
            obs0 = functional_observables(proc, state, functionals)
            accs = tuple(f.update(a, o, t0 + 1)
                         for f, a, o in zip(functionals, accs, obs0))
            stepped = proc.step(state, eps1, t1)
            obs1 = functional_observables(proc, stepped, functionals)
            live = t1 < n_steps
            new_accs = tuple(f.update(a, o, t1 + 1)
                             for f, a, o in zip(functionals, accs, obs1))
            accs = tuple(_tree_where(live, na, a)
                         for na, a in zip(new_accs, accs))
            return _tree_where(live, stepped, state), accs

        final, accs = jax.lax.fori_loop(jnp.int32(0), jnp.int32(n_pairs),
                                        fbody, (state0, accs0))
        out_refs[0][...] = proc.prices(final)
        for k, (f, a) in enumerate(zip(functionals, accs)):
            out_refs[k + 1][...] = f.finalize(a, float(n_steps))

    return kernel


def _check(process, sampler, antithetic: bool, n_steps: int, block: int):
    if block < MOMENT_ROW or block & (block - 1):
        raise ValueError(f"block={block} must be a power of two >= "
                         f"{MOMENT_ROW}")
    if sampler is not None and antithetic:
        raise ValueError("antithetic composes with the default draws only")
    if sampler is not None:
        from montecarlo.engine.simulate import check_sampler

        check_sampler(sampler, process, n_steps)


def _call(kernel, tree_inputs, scalars, num_blocks: int, out_block: int,
          n_out: int, interpret: bool):
    return pl.pallas_call(
        kernel,
        grid=(num_blocks,),
        in_specs=[pl.BlockSpec() for _ in range(len(tree_inputs) + 1)],
        out_specs=[pl.BlockSpec((out_block,), lambda i: (i,))] * n_out,
        out_shape=[jax.ShapeDtypeStruct((num_blocks * out_block,),
                                        jnp.float32)] * n_out,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        interpret=interpret,
        name="fused_path_kernel",
    )(*tree_inputs, scalars)


@functools.partial(jax.jit, static_argnames=(
    "n_paths", "n_steps", "block", "interpret", "antithetic"))
def fused_terminal_pallas(process, n_paths: int, n_steps: int, *, seed,
                          stream=0, path_offset=0, block: int = BLOCK,
                          interpret: bool = False, antithetic: bool = False,
                          sampler=None):
    """Terminal prices for any scalar-state process via one fused kernel.

    Same draw streams as ``simulate(process, ..., mode="terminal")`` (with
    ``sampler=AntitheticSampler()`` when ``antithetic=True``), and bitwise
    reproducible across block sizes, path offsets and mesh shapes.

    ``sampler``: a device-Sobol sampler — its direction numbers ride as
    kernel tables next to the process leaves.
    """
    _check(process, sampler, antithetic, n_steps, block)
    num_blocks = -(-n_paths // block)
    tree = (process, sampler) if sampler is not None else process
    inputs, treedef, shapes = _flatten(tree)
    kernel = _make_kernel(treedef, shapes, n_steps, block, antithetic,
                          sampler is not None)
    (out,) = _call(kernel, inputs, _scalar_row(seed, stream, path_offset),
                   num_blocks, block, 1, interpret)
    return out[:n_paths]


@functools.partial(jax.jit, static_argnames=(
    "n_paths", "n_steps", "block", "interpret", "antithetic",
    "functional_items"))
def fused_functionals_pallas(process, n_paths: int, n_steps: int, *, seed,
                             functional_items, stream=0, path_offset=0,
                             block: int = BLOCK, interpret: bool = False,
                             antithetic: bool = False, sampler=None) -> dict:
    """Terminal prices plus named path functionals via one fused kernel.

    ``functional_items``: tuple of (name, PathFunctional) pairs (hashable —
    use the module-level functional constants / factories once).  Bitwise
    identical to ``engine.functionals.simulate_functionals`` (same update
    order: spot folded by init, one update per step).
    """
    _check(process, sampler, antithetic, n_steps, block)
    num_blocks = -(-n_paths // block)
    names = [k for k, _ in functional_items]
    fns = tuple(f for _, f in functional_items)
    tree = (process, sampler) if sampler is not None else process
    inputs, treedef, shapes = _flatten(tree)
    kernel = _make_kernel(treedef, shapes, n_steps, block, antithetic,
                          sampler is not None, functionals=fns)
    outs = _call(kernel, inputs, _scalar_row(seed, stream, path_offset),
                 num_blocks, block, 1 + len(fns), interpret)
    result = {"terminal": outs[0][:n_paths]}
    for name, arr in zip(names, outs[1:]):
        result[name] = arr[:n_paths]
    return result


@functools.partial(jax.jit, static_argnames=(
    "payoff_fn", "n_paths", "n_steps", "block", "stats_block",
    "interpret", "antithetic"))
def fused_block_moments_pallas(process, payoff_fn, n_paths: int,
                               n_steps: int, *, seed, stream=0,
                               path_offset=0, block: int = BLOCK,
                               stats_block: int = 4096,
                               interpret: bool = False,
                               antithetic: bool = False, sampler=None):
    """Per-block payoff moments with the terminal array never written.

    Each program applies ``payoff_fn`` to its terminal prices and writes one
    (mean, m2) pair per :data:`MOMENT_ROW` paths; the rows are then
    tree-merged into the fixed ``stats_block``-path block states.

    Returns a :class:`MomentState` with leaves shaped
    ``(n_paths // stats_block,)`` — same block contract as
    ``parallel.sharded.block_moments`` (fixed block size, global-id-aligned,
    mesh-shape invariant), but the in-kernel row reduction uses its own
    (deterministic) float ordering, so values differ from the materializing
    path by float round-off, never statistically.
    """
    from montecarlo.stats.welford import MomentState, moments_merge

    _check(process, sampler, antithetic, n_steps, block)
    if n_paths % block != 0:
        raise ValueError(f"n_paths={n_paths} must be a multiple of "
                         f"block={block}")
    if stats_block % MOMENT_ROW != 0 or n_paths % stats_block != 0:
        raise ValueError(
            f"stats_block={stats_block} must divide n_paths={n_paths} and "
            f"be a multiple of {MOMENT_ROW}")
    num_blocks = n_paths // block
    tree = (process, sampler) if sampler is not None else process
    inputs, treedef, shapes = _flatten(tree)
    kernel = _make_kernel(treedef, shapes, n_steps, block, antithetic,
                          sampler is not None, payoff_fn=payoff_fn)
    mean, m2 = _call(kernel, inputs, _scalar_row(seed, stream, path_offset),
                     num_blocks, block // MOMENT_ROW, 2, interpret)

    # Tree-merge the per-row states into fixed stats blocks (a fixed inner
    # pairwise tree over the global-id-ordered rows — shard-invariant).
    n_stat = n_paths // stats_block
    rows_per_stat = stats_block // MOMENT_ROW
    states = MomentState(
        count=jnp.full((n_stat, rows_per_stat), jnp.float32(MOMENT_ROW)),
        mean=mean.reshape(n_stat, rows_per_stat),
        m2=m2.reshape(n_stat, rows_per_stat))
    k = rows_per_stat
    while k > 1:
        half = k // 2
        a = jax.tree.map(lambda v: v[:, 0:2 * half:2], states)
        b = jax.tree.map(lambda v: v[:, 1:2 * half:2], states)
        merged = moments_merge(a, b)
        if k % 2:
            merged = jax.tree.map(
                lambda m, v: jnp.concatenate([m, v[:, 2 * half:]], axis=1),
                merged, states)
        states = merged
        k = states.count.shape[1]
    return MomentState(count=states.count[:, 0], mean=states.mean[:, 0],
                       m2=states.m2[:, 0])
