"""Streaming (checkpoint/resume) netting-set xVA: the resume==one-shot
contract, bitwise agreement with the sharded engine's fixed tree, and the
pilot-grid PFE honesty (overflow tracked, never silent)."""

import numpy as np
import pytest
import jax.numpy as jnp

from montecarlo.engine.exposure import CSA, swap_value_fn
from montecarlo.engine.streaming import streaming_netting_profile
from montecarlo.parallel import make_mesh, sharded_netting_profile
from montecarlo.processes import Vasicek

T, N_STEPS = 2.0, 16
TOTAL, CHUNK, BLOCK = 8192, 2048, 256          # 8 blocks/chunk (pow2)
_KW = dict(T=T, seed=7, hazard_rate=0.02, recovery=0.4,
           own_hazard_rate=0.01, funding_spread=0.004, kva_cost=0.10,
           csa=CSA(threshold=0.002, mpor=4 * T / N_STEPS), pfe_bins=64)


def _book():
    model = Vasicek.create(0.03, 0.6, 0.04, 0.012, T / N_STEPS,
                           dtype=jnp.float64)
    pay = np.arange(1, 5) * 0.5
    return model, (swap_value_fn(model, 0.035, pay, 0.5),
                   lambda r, t: -0.5 * swap_value_fn(
                       model, 0.04, pay[:2], 0.5)(r, t))


def _stream(**over):
    model, trades = _book()
    kw = {**_KW, **over}
    return streaming_netting_profile(model, trades, TOTAL, N_STEPS,
                                     chunk_paths=CHUNK, block_size=BLOCK,
                                     **kw)


def test_resume_is_bitwise_one_shot(tmp_path):
    """Kill after the first chunk, resume from the checkpoint: every
    array and scalar is bitwise the uninterrupted streaming run's."""
    ck = str(tmp_path / "net.npz")
    model, trades = _book()

    calls = []

    def stop_after_first(done, total):
        calls.append(done)
        if len(calls) == 1:
            raise KeyboardInterrupt  # simulated kill mid-run

    with pytest.raises(KeyboardInterrupt):
        streaming_netting_profile(model, trades, TOTAL, N_STEPS,
                                  chunk_paths=CHUNK, block_size=BLOCK,
                                  checkpoint_path=ck,
                                  progress_callback=stop_after_first,
                                  **_KW)
    resumed = streaming_netting_profile(model, trades, TOTAL, N_STEPS,
                                        chunk_paths=CHUNK,
                                        block_size=BLOCK,
                                        checkpoint_path=ck, **_KW)
    oneshot = _stream()
    assert resumed["paths_done"] == TOTAL
    for k, v in oneshot.items():
        np.testing.assert_array_equal(np.asarray(v),
                                      np.asarray(resumed[k]), err_msg=k)


def test_means_bitwise_match_sharded_scalars_to_a_ulp():
    """Chunk subtree roots are internal nodes of the flat fixed tree
    (power-of-two blocks per chunk), so every per-date mean equals
    `sharded_netting_profile` BITWISE (the IM profile included — round 5
    lifted IM/MVA into the shared block stats); the closing scalar
    reductions compile in different programs and may differ by ~1 ULP;
    PFE only within its grid error (the grids differ: pilot vs global
    pmax)."""
    model, trades = _book()
    got = _stream(im_spread=0.003)
    want = sharded_netting_profile(model, trades, TOTAL, N_STEPS,
                                   mesh=make_mesh(4), block_size=BLOCK,
                                   im_spread=0.003, **_KW)
    for k in ("epe", "ene", "eepe", "epe_uncollateralized",
              "ene_uncollateralized", "im"):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    for k in ("cva", "dva", "cva_no_netting", "fca", "fba", "kva", "mva"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=5e-16, atol=0, err_msg=k)
    assert float(got["mva"]) > 0
    # bcva/fva are DIFFERENCES of the above — cancellation turns the
    # inputs' 1-ULP wiggle into a large relative (not absolute) error,
    # so anchor their tolerance to the minuends' ULP.
    for k, a_, b_ in (("bcva", "cva", "dva"), ("fva", "fca", "fba")):
        tol = 4.0 * np.spacing(max(abs(float(want[a_])),
                                   abs(float(want[b_]))))
        assert abs(float(got[k]) - float(want[k])) <= tol, k
    gap = np.abs(np.asarray(got["pfe"]) - np.asarray(want["pfe"]))
    err = (np.asarray(got["pfe_grid_err"])
           + np.asarray(want["pfe_grid_err"]))
    assert np.all(gap <= err + 1e-12)
    assert np.all(np.asarray(got["pfe_overflow"]) == 0)  # 4x headroom held


def _tiny_grid_checkpoint(path):
    """A fresh checkpoint whose PFE grid is microscopic — the
    drifting-exposure-scale scenario: every real exposure clears it."""
    from montecarlo.engine import streaming as sm

    n_q, n_dates = 9 + len(_book()[1]), N_STEPS + 1
    sm.NettingStreamState(
        seed=7, n_steps=N_STEPS, block_size=BLOCK, chunk_paths=CHUNK,
        T=T, paths_done=0,
        root_count=np.zeros((0, n_q, n_dates)),
        root_mean=np.zeros((0, n_q, n_dates)),
        root_m2=np.zeros((0, n_q, n_dates)),
        hist=np.zeros((n_dates, _KW["pfe_bins"]), np.int64),
        overflow=np.zeros((n_dates,), np.int64),
        hi_edges=np.full((n_dates,), 1e-9)).save(path)


def test_tiny_grid_recovers_by_doubling(tmp_path):
    """A grid that is orders of magnitude too small RECOVERS: each chunk
    whose max exposure clears it doubles the grid (folding accumulated
    counts exactly), so overflow stays zero and the PFE matches the
    healthy pilot-sized run within the two runs' combined grid error —
    the round-4 behavior (warn + report the grid top) only remains for
    legacy checkpoints that already lost mass to overflow."""
    ck = str(tmp_path / "tiny.npz")
    model, trades = _book()
    _tiny_grid_checkpoint(ck)
    res = streaming_netting_profile(model, trades, TOTAL, N_STEPS,
                                    chunk_paths=CHUNK, block_size=BLOCK,
                                    checkpoint_path=ck, **_KW)
    assert np.all(np.asarray(res["pfe_overflow"]) == 0)
    healthy = _stream()
    assert np.all(np.asarray(healthy["pfe_overflow"]) == 0)
    gap = np.abs(np.asarray(res["pfe"]) - np.asarray(healthy["pfe"]))
    err = (np.asarray(res["pfe_grid_err"])
           + np.asarray(healthy["pfe_grid_err"]))
    assert np.all(gap <= err + 1e-12)
    # The doubled grid is coarser than 1e-9/bins by construction.
    assert np.all(np.asarray(res["pfe_grid_err"])
                  >= 1e-9 / _KW["pfe_bins"])
    # Means are untouched by the PFE grid machinery.
    np.testing.assert_array_equal(np.asarray(res["epe"]),
                                  np.asarray(healthy["epe"]))


def test_doubling_preserves_resume_bitwise(tmp_path):
    """Kill after the first chunk OF A RUN THAT DOUBLES ITS GRID, resume:
    bitwise the uninterrupted run from the same initial checkpoint — the
    doubling decision is a deterministic function of the checkpointed
    grid and the chunk stream."""
    model, trades = _book()
    ck_a, ck_b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    _tiny_grid_checkpoint(ck_a)
    _tiny_grid_checkpoint(ck_b)
    oneshot = streaming_netting_profile(model, trades, TOTAL, N_STEPS,
                                        chunk_paths=CHUNK,
                                        block_size=BLOCK,
                                        checkpoint_path=ck_a, **_KW)

    calls = []

    def stop_after_first(done, total):
        calls.append(done)
        if len(calls) == 1:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        streaming_netting_profile(model, trades, TOTAL, N_STEPS,
                                  chunk_paths=CHUNK, block_size=BLOCK,
                                  checkpoint_path=ck_b,
                                  progress_callback=stop_after_first,
                                  **_KW)
    resumed = streaming_netting_profile(model, trades, TOTAL, N_STEPS,
                                        chunk_paths=CHUNK,
                                        block_size=BLOCK,
                                        checkpoint_path=ck_b, **_KW)
    for k, v in oneshot.items():
        np.testing.assert_array_equal(np.asarray(v),
                                      np.asarray(resumed[k]), err_msg=k)


def test_validation_errors():
    model, trades = _book()
    with pytest.raises(ValueError, match="power of two"):
        streaming_netting_profile(model, trades, 7680, N_STEPS,
                                  chunk_paths=1536, block_size=256, **_KW)
    with pytest.raises(ValueError, match="even"):
        streaming_netting_profile(model, trades, TOTAL, N_STEPS,
                                  chunk_paths=CHUNK, block_size=BLOCK,
                                  **{**_KW, "pfe_bins": 63})
    with pytest.raises(ValueError, match="!= 0"):
        streaming_netting_profile(model, trades, 8000, N_STEPS,
                                  chunk_paths=CHUNK, block_size=BLOCK,
                                  **_KW)


def test_cli_xva_checkpoint(capsys, tmp_path):
    import json

    from montecarlo import cli

    ck = str(tmp_path / "cli_net.npz")
    argv = ["xva", "--portfolio", "--no-csa", "--paths", "4096",
            "--steps", "16", "--checkpoint", ck]
    assert cli.main(argv) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["paths_done"] == 4096 and first["pfe_overflow_max"] == 0
    # Resume on a finished checkpoint reproduces the record exactly.
    assert cli.main(argv) == 0
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again == first
    with pytest.raises(SystemExit, match="unsharded"):
        cli.main(argv + ["--mesh", "2"])


def test_checkpoint_config_mismatch_rejected(tmp_path):
    ck = str(tmp_path / "net.npz")
    model, trades = _book()
    streaming_netting_profile(model, trades, TOTAL, N_STEPS,
                              chunk_paths=CHUNK, block_size=BLOCK,
                              checkpoint_path=ck, **_KW)
    with pytest.raises(ValueError, match="config"):
        streaming_netting_profile(model, trades, TOTAL, N_STEPS,
                                  chunk_paths=CHUNK // 2,
                                  block_size=BLOCK, checkpoint_path=ck,
                                  **_KW)
    # A different maturity is a different simulation (dt = T/n): resume
    # must refuse rather than splice two time grids into one profile.
    with pytest.raises(ValueError, match="config"):
        streaming_netting_profile(model, trades, TOTAL, N_STEPS,
                                  chunk_paths=CHUNK, block_size=BLOCK,
                                  checkpoint_path=ck,
                                  **{**_KW, "T": 1.5 * T})
