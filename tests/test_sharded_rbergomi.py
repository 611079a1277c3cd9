"""Pod-scale rough Bergomi: the own-simulator sampler under the
fixed-block sharding contract."""

import numpy as np
import jax.numpy as jnp

from montecarlo.parallel import make_mesh, sharded_rbergomi_estimate
from montecarlo.processes.rough_bergomi import (RoughBergomi,
                                                    rbergomi_simulate)

N_PATHS, BLOCK, T_STEPS = 4096, 512, 32


def _model():
    return RoughBergomi.create(100.0, 0.235 ** 2, 1.9, -0.9, 0.07,
                               n_steps=T_STEPS, T=1.0)


def _payoff(s):
    return jnp.maximum(s - 100.0, 0.0)


def _est(n_dev, **kw):
    return sharded_rbergomi_estimate(_model(), _payoff, N_PATHS, seed=5,
                                     mesh=make_mesh(n_dev, **kw),
                                     block_size=BLOCK)


def test_bitwise_mesh_shape_invariance():
    base = _est(1)
    for n_dev in (2, 4, 8):
        got = _est(n_dev)
        assert float(base["price"]) == float(got["price"]), n_dev
        assert float(base["std_err"]) == float(got["std_err"]), n_dev


def test_multi_slice_matches_flat():
    flat = _est(8)
    two = sharded_rbergomi_estimate(
        _model(), _payoff, N_PATHS, seed=5,
        mesh=make_mesh(n_path_shards=4, n_slices=2), block_size=BLOCK)
    assert float(flat["price"]) == float(two["price"])
    assert float(flat["std_err"]) == float(two["std_err"])


def test_matches_unsharded_sampler():
    """The sharded estimate agrees with a flat-width unsharded run to
    accumulation tolerance (the per-path values come from different
    compile widths, so bitwise equality is not the contract here —
    the mesh-shape invariance above is)."""
    est = _est(4)
    s_t = rbergomi_simulate(_model(), N_PATHS, seed=5)
    want = float(jnp.mean(_payoff(s_t)))
    got = float(est["price"])
    assert abs(got - want) < 1e-4 * max(abs(want), 1.0), (got, want)
    assert int(est["n_paths"]) == N_PATHS
    assert float(est["std_err"]) > 0
