"""Generic fused path kernel (Pallas through Triton) vs the scan engine,
in interpret mode."""

import numpy as np
import pytest

from montecarlo.engine import simulate
from montecarlo.ops.fused_engine import fused_terminal_pallas
from montecarlo.processes import GBM, GARCHBootstrap, Heston

N = 128 * 128


def _procs():
    return {
        "gbm": GBM.create(s0=100.0, mu=0.03, sigma=0.2, dt=1 / 252),
        "heston": Heston.create(s0=100.0, v0=0.04, mu=0.03, kappa=2.0,
                                theta=0.04, xi=0.5, rho=-0.7, dt=1 / 252),
        "garch": GARCHBootstrap.create(
            np.random.default_rng(0).normal(0, 0.02, 1260),
            s0=100.0, var0=4e-4),
    }


@pytest.mark.parametrize("name", ["gbm", "heston", "garch"])
@pytest.mark.parametrize("n_steps", [1, 16, 17])
def test_fused_matches_scan_engine_bitwise(name, n_steps):
    proc = _procs()[name]
    ref = np.asarray(simulate(proc, N, n_steps, seed=5))
    ker = np.asarray(fused_terminal_pallas(proc, N, n_steps, seed=5,
                                           block=256, interpret=True))
    if name == "heston":
        # The grouped step increment ((mu - v/2)dt + sqrt(v dt) z) gives
        # XLA an FMA-contraction choice it resolves differently between
        # the two compilations on ~0.3% of elements — Heston joins the
        # rate processes in the ULP-tight class (DEVNOTES rtol=2e-6).
        np.testing.assert_allclose(ker, ref, rtol=2e-6)
    else:
        np.testing.assert_array_equal(ker, ref)


def test_fused_path_offset_invariance():
    proc = _procs()["garch"]
    full = np.asarray(fused_terminal_pallas(proc, N, 8, seed=3,
                                            block=128, interpret=True))
    halves = [np.asarray(fused_terminal_pallas(
        proc, N // 2, 8, seed=3, path_offset=o, block=128,
        interpret=True)) for o in (0, N // 2)]
    np.testing.assert_array_equal(full, np.concatenate(halves))


def test_draws_pair_matches_draws():
    import jax.numpy as jnp

    for name, proc in _procs().items():
        ids = jnp.arange(256, dtype=jnp.uint32)
        for j in (0, 3):
            e0, e1 = proc.draws_pair(7, 0, ids, j)
            d0 = proc.draws(7, 0, ids, 2 * j)
            d1 = proc.draws(7, 0, ids, 2 * j + 1)
            for a, b in zip(e0 + e1, d0 + d1):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                              err_msg=name)


def test_fused_antithetic_matches_scan_sampler():
    from montecarlo.samplers import AntitheticSampler

    proc = _procs()["gbm"]
    ref = np.asarray(simulate(proc, N, 9, seed=5,
                              sampler=AntitheticSampler()))
    ker = np.asarray(fused_terminal_pallas(proc, N, 9, seed=5,
                                           block=256, interpret=True,
                                           antithetic=True))
    np.testing.assert_array_equal(ker, ref)


def test_basket_fused_matches_multigbm():
    """BasketGBM (tuple state, unrolled Cholesky) vs MultiGBM (matmul)."""
    import jax.numpy as jnp

    from montecarlo.processes import BasketGBM, MultiGBM

    corr = np.array([[1.0, 0.5, 0.2], [0.5, 1.0, 0.4], [0.2, 0.4, 1.0]])
    kw = dict(s0=[100.0, 50.0, 75.0], mu=[0.03, 0.02, 0.04],
              sigma=[0.2, 0.3, 0.25], corr=corr, dt=1 / 252)
    w = np.array([0.5, 0.3, 0.2])
    basket = BasketGBM.create(weights=w, **kw)
    multi = MultiGBM.create(**kw)

    n, T = 128 * 128, 16
    b_scan = np.asarray(simulate(basket, n, T, seed=5))
    m_term = np.asarray(simulate(multi, n, T, seed=5))
    np.testing.assert_allclose(b_scan, m_term @ w, rtol=2e-5)

    b_fused = np.asarray(fused_terminal_pallas(basket, n, T, seed=5,
                                               block=256,
                                               interpret=True))
    np.testing.assert_array_equal(b_fused, b_scan)


class TestFusedBlockMoments:
    """Payoff+stats fused output (the terminal array is never written)."""

    def _proc(self):
        from montecarlo.processes import GBM
        return GBM.create(s0=100.0, mu=0.03, sigma=0.2, dt=1.0 / 252.0)

    def test_matches_materializing_path(self):
        import jax.numpy as jnp
        from montecarlo.engine.simulate import simulate
        from montecarlo.ops.fused_engine import fused_block_moments_pallas
        from montecarlo.stats.welford import (moments_from_array,
                                                  moments_reduce, std_error)

        proc = self._proc()
        payoff = lambda s: jnp.maximum(s - 105.0, 0.0)
        n = 32768
        blocks = fused_block_moments_pallas(
            proc, payoff, n, 16, seed=9, block=128, interpret=True)
        assert blocks.count.shape == (n // 4096,)
        assert float(jnp.sum(blocks.count)) == n

        terminal = simulate(proc, n, 16, seed=9)
        ref = moments_from_array(jnp.reshape(payoff(terminal), (-1, 4096)),
                                 axis=-1)
        # Same draws, different (deterministic) reduction order: equality to
        # float tolerance, not bitwise.
        import numpy as np
        np.testing.assert_allclose(np.asarray(blocks.mean),
                                   np.asarray(ref.mean), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(blocks.m2),
                                   np.asarray(ref.m2), rtol=1e-4)
        tot_a, tot_b = moments_reduce(blocks), moments_reduce(ref)
        assert abs(float(tot_a.mean) - float(tot_b.mean)) < 1e-5
        assert abs(float(std_error(tot_a)) - float(std_error(tot_b))) < 1e-7

    def test_block_states_offset_invariant(self):
        """Block states depend only on global path ids: computing the second
        half via path_offset yields the same states as the full run."""
        import jax.numpy as jnp
        import numpy as np
        from montecarlo.ops.fused_engine import fused_block_moments_pallas

        proc = self._proc()
        payoff = lambda s: jnp.maximum(s - 105.0, 0.0)
        full = fused_block_moments_pallas(
            proc, payoff, 16384, 8, seed=4, block=128, interpret=True)
        half2 = fused_block_moments_pallas(
            proc, payoff, 8192, 8, seed=4, path_offset=8192, block=128,
            interpret=True)
        for a, b in zip(full, half2):
            np.testing.assert_array_equal(np.asarray(a)[2:], np.asarray(b))

    def test_antithetic_mode(self):
        import jax.numpy as jnp
        from montecarlo.ops.fused_engine import fused_block_moments_pallas
        from montecarlo.engine.simulate import simulate
        from montecarlo.samplers import AntitheticSampler
        from montecarlo.stats.welford import moments_reduce

        proc = self._proc()
        payoff = lambda s: s  # identity: antithetic pairs cancel variance
        blocks = fused_block_moments_pallas(
            proc, payoff, 16384, 8, seed=4, block=128, interpret=True,
            antithetic=True)
        tot = moments_reduce(blocks)
        term = simulate(proc, 16384, 8, seed=4, sampler=AntitheticSampler())
        assert abs(float(tot.mean) - float(jnp.mean(term))) < 1e-5


# --- the Triton program's shape rules (interpret mode) ----------------------

@pytest.mark.parametrize("block", [128, 256, 512, 1024])
def test_block_sizes_bitwise_equal_scan(block):
    """Any power-of-two block gives the scan engine's paths bitwise."""
    proc = _procs()["garch"]
    ref = np.asarray(simulate(proc, 4096, 6, seed=2))
    ker = np.asarray(fused_terminal_pallas(proc, 4096, 6, seed=2,
                                           block=block, interpret=True))
    np.testing.assert_array_equal(ker, ref)


@pytest.mark.parametrize("n_paths", [1, 255, 257, 1000])
def test_path_count_padding(n_paths):
    """Path counts that are not a whole number of blocks are padded up and
    cut back; the kept paths are the scan engine's paths."""
    proc = _procs()["gbm"]
    ref = np.asarray(simulate(proc, n_paths, 5, seed=4))
    ker = np.asarray(fused_terminal_pallas(proc, n_paths, 5, seed=4,
                                           block=256, interpret=True))
    assert ker.shape == (n_paths,)
    np.testing.assert_array_equal(ker, ref)


@pytest.mark.parametrize("block", [0, 64, 192, 300])
def test_block_must_be_power_of_two(block):
    with pytest.raises(ValueError, match="power of two"):
        fused_terminal_pallas(_procs()["gbm"], 1024, 4, seed=0, block=block,
                              interpret=True)


def test_block_moments_independent_of_block_size():
    """Moments reduce per fixed 128-path row, so the block states do not
    depend on the program's block size (determinism contract)."""
    import jax.numpy as jnp

    from montecarlo.ops.fused_engine import fused_block_moments_pallas

    payoff = lambda s: jnp.maximum(s - 100.0, 0.0)
    runs = [fused_block_moments_pallas(_procs()["heston"], payoff, 8192, 6,
                                       seed=1, block=b, interpret=True)
            for b in (128, 512)]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("shape,index", [
    ((10,), 3),
    ((10,), -1),
    ((10,), 25),                  # clamped like an XLA gather
    ((4, 5), (2, 3)),
    ((4, 5), (3, 7)),             # column past the row: clamped flat
    ((3, 4, 5), (1, 2, 3)),
])
def test_kernel_table_matches_array_indexing(shape, index):
    """KernelTable (an array leaf inside the kernel) reads what indexing
    the flat array in row-major order reads, clamped to the buffer."""
    from montecarlo.ops.fused_engine import KernelTable

    arr = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    table = KernelTable(arr.reshape(-1), shape)
    idx = index if isinstance(index, tuple) else (index,)
    flat = sum(i * int(np.prod(shape[k + 1:])) for k, i in enumerate(idx))
    if len(idx) == 1 and idx[0] < 0:
        flat = idx[0] + shape[0]
    expected = arr.reshape(-1)[min(max(flat, 0), arr.size - 1)]
    assert float(table[index]) == float(expected)


def test_kernel_table_sub_view_and_gather():
    import jax.numpy as jnp

    from montecarlo.ops.fused_engine import KernelTable

    arr = np.arange(24, dtype=np.float32).reshape(4, 6)
    table = KernelTable(arr.reshape(-1), arr.shape).astype(jnp.float32)
    row = table[2]
    assert row.shape == (6,) and row.ndim == 1
    idx = jnp.asarray([0, 5, 3], jnp.int32)
    np.testing.assert_array_equal(np.asarray(row[idx]), arr[2, [0, 5, 3]])
    np.testing.assert_array_equal(np.asarray(table[1, idx]),
                                  arr[1, [0, 5, 3]])
