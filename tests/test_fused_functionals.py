"""Fused-kernel path functionals: bitwise parity with the scan engine."""

import numpy as np
import jax.numpy as jnp
import pytest

from montecarlo.engine.functionals import (
    ARITH_MEAN,
    GEO_MEAN,
    RUNNING_MAX,
    RUNNING_MIN,
    _simulate_functionals,
    trapezoid_integral,
)
from montecarlo.ops.fused_engine import fused_functionals_pallas
from montecarlo.processes import GBM, Heston, Vasicek
from montecarlo.samplers import AntitheticSampler

N = 128 * 128
STEPS = 17  # odd on purpose: exercises the half-pair tail


def _gbm():
    return GBM.create(s0=100.0, mu=0.03, sigma=0.2, dt=1 / 252)


FUNCS = (("avg", ARITH_MEAN), ("mx", RUNNING_MAX), ("mn", RUNNING_MIN),
         ("geo", GEO_MEAN))


@pytest.mark.parametrize("steps", [STEPS, 16])
def test_bitwise_parity_gbm(steps):
    ref = _simulate_functionals(_gbm(), N, steps, 5, 0, None, jnp.float32,
                                0, FUNCS)
    ker = fused_functionals_pallas(_gbm(), N, steps, seed=5,
                                   functional_items=FUNCS, interpret=True)
    for k in ("terminal", "avg", "mx", "mn", "geo"):
        np.testing.assert_array_equal(np.asarray(ker[k]),
                                      np.asarray(ref[k]), err_msg=k)


def test_bitwise_parity_heston():
    proc = Heston.create(s0=100.0, v0=0.04, mu=0.03, kappa=2.0, theta=0.04,
                         xi=0.5, rho=-0.7, dt=1 / 252)
    funcs = (("avg", ARITH_MEAN), ("mx", RUNNING_MAX))
    ref = _simulate_functionals(proc, N, STEPS, 7, 0, None, jnp.float32, 0,
                                funcs)
    ker = fused_functionals_pallas(proc, N, STEPS, seed=7,
                                   functional_items=funcs, interpret=True)
    for k in ("terminal", "avg", "mx"):
        # Heston is in the ULP-tight class since the grouped-increment
        # rounding fix: the group gives XLA an FMA-contraction choice it
        # resolves differently between the two compilations (DEVNOTES).
        np.testing.assert_allclose(np.asarray(ker[k]),
                                   np.asarray(ref[k]), rtol=2e-6,
                                   err_msg=k)


def test_tuple_accumulator_trapezoid_vasicek():
    """The discount integral carries a (sum, prev) tuple accumulator.

    Rate-process steps hit different FMA-contraction choices between the
    two compilations (see DEVNOTES), so parity here is ULP-tight rather
    than bitwise — still far below any draw-stream or accumulator bug.
    """
    proc = Vasicek.create(0.03, 0.8, 0.05, 0.015, 1 / 64)
    funcs = (("I", trapezoid_integral(1 / 64)),)
    ref = _simulate_functionals(proc, N, STEPS, 9, 0, None, jnp.float32, 0,
                                funcs)
    ker = fused_functionals_pallas(proc, N, STEPS, seed=9,
                                   functional_items=funcs, interpret=True)
    np.testing.assert_allclose(np.asarray(ker["I"]), np.asarray(ref["I"]),
                               rtol=2e-6, atol=2e-8)


def test_antithetic_parity():
    funcs = (("avg", ARITH_MEAN),)
    ref = _simulate_functionals(_gbm(), N, STEPS, 11, 0,
                                AntitheticSampler(), jnp.float32, 0, funcs)
    ker = fused_functionals_pallas(_gbm(), N, STEPS, seed=11,
                                   functional_items=funcs, interpret=True,
                                   antithetic=True)
    np.testing.assert_array_equal(np.asarray(ker["avg"]),
                                  np.asarray(ref["avg"]))


def test_path_offset_invariance():
    funcs = (("avg", ARITH_MEAN),)
    full = fused_functionals_pallas(_gbm(), 2 * N, STEPS, seed=13,
                                    functional_items=funcs, interpret=True)
    back = fused_functionals_pallas(_gbm(), N, STEPS, seed=13,
                                    functional_items=funcs, interpret=True,
                                    path_offset=N)
    np.testing.assert_array_equal(np.asarray(full["avg"])[N:],
                                  np.asarray(back["avg"]))
