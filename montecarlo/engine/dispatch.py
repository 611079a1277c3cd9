"""Engine dispatch: pick the engine for a terminal run.

- On the GPU (:func:`montecarlo.device.path_engine` says ``"triton"``),
  scalar-state processes (everything in _FUSABLE: GBM/GARCH/Heston (Euler +
  QE)/Bates/jump/Levy (NIG, VG)/rate/local-vol/term-structure families)
  with plain, antithetic, or device-Sobol sampling run the fused path
  kernel (:mod:`montecarlo.ops.fused_engine`).
- Everything else (the CPU, paths mode, other samplers, multi-asset
  states, f64 runs) runs the `lax.scan` engine — the two produce identical
  draw streams, and bitwise-identical paths in interpret mode.
"""

from __future__ import annotations

import jax.numpy as jnp

from montecarlo import device
from montecarlo.engine.simulate import simulate
from montecarlo.ops.fused_engine import (BLOCK, MOMENT_ROW,
                                         fused_block_moments_pallas,
                                         fused_terminal_pallas)
from montecarlo.processes.garch import GARCHBootstrap
from montecarlo.processes.gbm import GBM
from montecarlo.processes.heston import Heston
from montecarlo.processes.heston_qe import HestonQE
from montecarlo.processes.basket import BasketGBM
from montecarlo.processes.bates import Bates
from montecarlo.processes.bates_qe import BatesQE
from montecarlo.processes.merton import Merton
from montecarlo.processes.ccc_garch import CCCGarch
from montecarlo.processes.dcc_garch import DCCGarch
from montecarlo.processes.local_vol import LocalVolGBM
from montecarlo.processes.slv import SLV, SLVKnots
from montecarlo.processes.term_gbm import TermStructureGBM
from montecarlo.processes.euler_gbm import EulerGBM
from montecarlo.processes.kou import Kou
from montecarlo.processes.nig import NIG
from montecarlo.processes.vg import VarianceGamma
from montecarlo.processes.g2pp import G2PP
from montecarlo.processes.shortrate import CIR, HullWhite, Vasicek
from montecarlo.processes.sabr import SABR
from montecarlo.processes.term_basket import TermBasketGBM
from montecarlo.rng.sobol import SobolDeviceSampler
from montecarlo.samplers import AntitheticSampler, PlainSampler

_FUSABLE = (GBM, GARCHBootstrap, Heston, HestonQE, BasketGBM, Bates,
            BatesQE, Merton, CCCGarch,
            DCCGarch, LocalVolGBM, TermStructureGBM, EulerGBM, Kou, NIG,
            VarianceGamma, Vasicek, CIR, HullWhite, G2PP, SABR,
            TermBasketGBM, SLVKnots, SLV)


def _fusable_sampler(sampler, process, n_steps: int) -> bool:
    """Samplers the fused kernel can run: default Threefry (None or an
    explicit PlainSampler — identical pass-through streams, so the CLI's
    `--sampler plain` default rides the kernel too), antithetic mirroring,
    or device Sobol (whose table must cover every dimension)."""
    if (sampler is None or isinstance(sampler, (PlainSampler,
                                                AntitheticSampler))):
        return True
    return (isinstance(sampler, SobolDeviceSampler)
            and sampler.n_dims >= n_steps * process.n_draws)


def _kernel_sampler(sampler):
    return sampler if isinstance(sampler, SobolDeviceSampler) else None


def _fused_eligible(process, sampler, n_steps: int, dtype) -> bool:
    """THE fused-kernel eligibility gate, shared by terminal_prices,
    payoff_block_moments, and simulate_functionals (one place, or the
    entry points silently diverge).  True runs the fused kernel, False
    the scan engine.  The kernel pins f32 and int32/uint32 throughout, so
    it also runs with jax_enable_x64 on.
    """
    if device.path_engine() != "triton":
        return False
    if dtype != jnp.float32 or not isinstance(process, _FUSABLE):
        return False
    return _fusable_sampler(sampler, process, n_steps)


def terminal_prices(process, n_paths: int, n_steps: int, *, seed,
                    stream=0, sampler=None, dtype=jnp.float32,
                    path_offset=0, prefer_fused: bool = True):
    """Terminal prices via the fused kernel when eligible, else the scan
    engine.  Identical draw streams either way."""
    if prefer_fused and _fused_eligible(process, sampler, n_steps, dtype):
        return fused_terminal_pallas(
            process, n_paths, n_steps, seed=seed, stream=stream,
            path_offset=path_offset,
            antithetic=isinstance(sampler, AntitheticSampler),
            sampler=_kernel_sampler(sampler))
    return simulate(process, n_paths, n_steps, seed=seed, stream=stream,
                    sampler=sampler, dtype=dtype, path_offset=path_offset)


def payoff_block_moments(process, payoff_fn, n_paths: int, n_steps: int, *,
                         seed, stream=0, sampler=None, path_offset=0,
                         stats_block: int = 4096,
                         prefer_fused: bool = True):
    """Per-block payoff moments, never materializing terminals when fused.

    When the fused kernel runs (see :func:`_fused_eligible`) and the path
    count is a whole number of kernel blocks and stats blocks, this runs
    the payoff+stats kernel (`ops.fused_engine.fused_block_moments_pallas`):
    two floats per 128 paths are written instead of the terminal prices.
    Otherwise: terminal simulation + `moments_from_array` (the
    bitwise-deterministic block contract).
    """
    from montecarlo.stats.welford import moments_from_array

    if (prefer_fused and n_paths % BLOCK == 0
            and n_paths % stats_block == 0 and stats_block % MOMENT_ROW == 0
            and _fused_eligible(process, sampler, n_steps, jnp.float32)):
        return fused_block_moments_pallas(
            process, payoff_fn, n_paths, n_steps, seed=seed, stream=stream,
            path_offset=path_offset, stats_block=stats_block,
            antithetic=isinstance(sampler, AntitheticSampler),
            sampler=_kernel_sampler(sampler))
    terminal = simulate(process, n_paths, n_steps, seed=seed, stream=stream,
                        sampler=sampler, path_offset=path_offset)
    payoffs = payoff_fn(terminal)
    if n_paths % stats_block:
        # Path count not block-aligned: one state over the whole chunk
        # (any chunk size works, like the pre-fused estimator did).
        return moments_from_array(payoffs[None, :], axis=-1)
    return moments_from_array(
        jnp.reshape(payoffs, (-1, stats_block)), axis=-1)
