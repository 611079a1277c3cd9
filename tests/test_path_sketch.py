"""Streaming per-step percentile curves vs exact materialized paths."""

import numpy as np

from montecarlo.engine import simulate
from montecarlo.engine.path_sketch import (
    path_histograms,
    percentiles_from_histograms,
    sharded_path_percentiles,
)
from montecarlo.parallel import make_mesh
from montecarlo.processes import GBM
from montecarlo.stats import path_percentiles

N, T = 1 << 14, 20
LO, HI, BINS = 50.0, 200.0, 2048


def _gbm():
    return GBM.create(s0=100.0, mu=0.03, sigma=0.25, dt=1 / 252)


def test_streaming_percentiles_match_exact():
    paths = simulate(_gbm(), N, T, seed=5, mode="paths")
    exact = path_percentiles(paths)
    hists = path_histograms(_gbm(), N, T, seed=5, lo=LO, hi=HI, bins=BINS)
    approx = percentiles_from_histograms(np.asarray(hists), LO, HI)
    assert np.asarray(hists).shape == (T + 1, BINS)
    np.testing.assert_allclose(np.asarray(hists).sum(axis=1), N)
    width = (HI - LO) / BINS
    for key, curve in exact.items():
        np.testing.assert_allclose(approx[key], np.asarray(curve),
                                   atol=2 * width, err_msg=key)


def test_sharded_path_percentiles_match_local():
    mesh = make_mesh(8)
    sharded = sharded_path_percentiles(_gbm(), N, T, seed=5, mesh=mesh,
                                       lo=LO, hi=HI, bins=512)
    hists = path_histograms(_gbm(), N, T, seed=5, lo=LO, hi=HI, bins=512)
    local = percentiles_from_histograms(np.asarray(hists), LO, HI)
    for key in local:
        np.testing.assert_array_equal(sharded[key], local[key])
