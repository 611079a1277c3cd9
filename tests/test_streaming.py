"""Streaming estimator: resume == one-shot bitwise, checkpointing, early stop."""

import os

import numpy as np
import pytest

from montecarlo.engine.streaming import (
    StreamingState,
    risk_from_state,
    streaming_estimate,
)
from montecarlo.parallel import make_mesh
from montecarlo.processes import GBM

N_STEPS = 16
CHUNK = 4096
TOTAL = 4 * CHUNK
BLOCK = 1024


def _gbm():
    return GBM.create(s0=100.0, mu=0.03, sigma=0.2, dt=1 / 252)


def _run(**kw):
    return streaming_estimate(_gbm(), TOTAL, N_STEPS, seed=5,
                              chunk_paths=CHUNK, block_size=BLOCK,
                              lo=40.0, hi=260.0, bins=512, **kw)


def test_oneshot_equals_chunked_bitwise():
    chunked = _run()
    oneshot = streaming_estimate(_gbm(), TOTAL, N_STEPS, seed=5,
                                 chunk_paths=TOTAL, block_size=BLOCK,
                                 lo=40.0, hi=260.0, bins=512)
    m_a, m_b = chunked.moments(), oneshot.moments()
    assert float(m_a.mean) == float(m_b.mean)
    assert float(m_a.m2) == float(m_b.m2)
    np.testing.assert_array_equal(np.asarray(chunked.sketch.counts),
                                  np.asarray(oneshot.sketch.counts))


def test_resume_equals_uninterrupted(tmp_path):
    ckpt = str(tmp_path / "est.npz")
    # Interrupted run: stop after 2 chunks via target_std_err=0 trick is
    # wrong — instead run half the total, checkpointing.
    half = streaming_estimate(_gbm(), TOTAL // 2, N_STEPS, seed=5,
                              chunk_paths=CHUNK, block_size=BLOCK,
                              lo=40.0, hi=260.0, bins=512,
                              checkpoint_path=ckpt)
    assert half.paths_done == TOTAL // 2
    assert os.path.exists(ckpt)
    # Resume to completion.
    resumed = _run(checkpoint_path=ckpt, resume=True)
    assert resumed.paths_done == TOTAL
    uninterrupted = _run()
    assert float(resumed.moments().mean) == float(
        uninterrupted.moments().mean)
    np.testing.assert_array_equal(np.asarray(resumed.sketch.counts),
                                  np.asarray(uninterrupted.sketch.counts))


def test_checkpoint_roundtrip(tmp_path):
    ckpt = str(tmp_path / "s.npz")
    state = _run(checkpoint_path=ckpt)
    loaded = StreamingState.load(ckpt)
    assert loaded.paths_done == state.paths_done
    assert float(loaded.moments().mean) == float(state.moments().mean)


def test_checkpoint_config_mismatch_raises(tmp_path):
    ckpt = str(tmp_path / "s.npz")
    _run(checkpoint_path=ckpt)
    with pytest.raises(ValueError):
        streaming_estimate(_gbm(), TOTAL, N_STEPS, seed=6,  # wrong seed
                           chunk_paths=CHUNK, block_size=BLOCK,
                           lo=40.0, hi=260.0, bins=512,
                           checkpoint_path=ckpt, resume=True)


def test_early_stop_at_target_std_err():
    state = _run(target_std_err=1.0)  # loose target -> stops after 1 chunk
    assert state.paths_done == CHUNK


def test_sharded_streaming_matches_local():
    mesh = make_mesh(8)
    sharded = _run(mesh=mesh)
    local = _run()
    assert float(sharded.moments().mean) == float(local.moments().mean)
    np.testing.assert_array_equal(np.asarray(sharded.sketch.counts),
                                  np.asarray(local.sketch.counts))


def test_risk_from_state_contract():
    state = _run()
    out = risk_from_state(state, 100.0)
    for key in ("percentiles", "expected_return", "expected_vol",
                "prob_profit", "var_95", "cvar_95", "std_err", "n_paths"):
        assert key in out
    assert out["n_paths"] == TOTAL
    # Sketch quantiles close to exact ones from a direct simulation.
    from montecarlo.engine import simulate
    terminal = np.asarray(simulate(_gbm(), TOTAL, N_STEPS, seed=5))
    for q in (5, 50, 95):
        exact = np.percentile(terminal, q)
        approx = out["percentiles"][f"p{q}"]
        assert abs(approx - exact) < 3 * (260.0 - 40.0) / 512
    assert abs(out["prob_profit"] - (terminal > 100).mean() * 100) < 1.0


def test_portfolio_var_sharded_vs_streaming():
    from montecarlo.api import portfolio_var

    mesh = make_mesh(8)
    a = portfolio_var(_gbm(), TOTAL, N_STEPS, 100.0, seed=5, mesh=mesh,
                      bins=512, block_size=BLOCK)
    b = portfolio_var(_gbm(), TOTAL, N_STEPS, 100.0, seed=5, bins=512,
                      block_size=BLOCK, chunk_paths=CHUNK)
    assert a["n_paths"] == b["n_paths"] == TOTAL
    # Sharded sketch runs in f32, streaming in f64: agreement is bounded by
    # interpolation round-off, well under a bin width.
    bin_w = (a["percentiles"]["p99"] - a["percentiles"]["p1"]) / 50
    for q in (5, 50, 95):
        assert abs(a["percentiles"][f"p{q}"]
                   - b["percentiles"][f"p{q}"]) < 0.5 * bin_w
    assert abs(a["var_95"] - b["var_95"]) < 1.0
    assert abs(a["prob_profit"] - b["prob_profit"]) < 0.5
    assert abs(a["expected_return"] - b["expected_return"]) < 1e-3


def test_price_to_tolerance_on_device_loop():
    import jax.numpy as jnp

    from montecarlo.engine import (
        black_scholes_call,
        european_call,
        price_to_tolerance,
    )

    proc = _gbm()
    out = price_to_tolerance(
        proc, lambda s: european_call(s, 105.0), target_std_err=0.002,
        seed=3, chunk_paths=1 << 13, n_steps=N_STEPS,
        discount=float(np.exp(-0.03 * N_STEPS / 252)), max_chunks=512)
    se = float(out["std_err"])
    assert se <= 0.002
    assert int(float(out["n_chunks"])) >= 2  # needed more than one chunk
    bs = float(black_scholes_call(100.0, 105.0, 0.03, 0.2, N_STEPS / 252))
    assert abs(float(out["price"]) - bs) < 5 * se
    assert int(float(out["n_paths"])) == int(float(out["n_chunks"])) * (1 << 13)


def test_portfolio_var_on_device_matches_streaming():
    from montecarlo.api import portfolio_var
    from montecarlo.api.var import portfolio_var_on_device

    a = portfolio_var_on_device(_gbm(), TOTAL, N_STEPS, 100.0, seed=5,
                                bins=512, chunk_paths=CHUNK)
    b = portfolio_var(_gbm(), TOTAL, N_STEPS, 100.0, seed=5, bins=512,
                      block_size=BLOCK, chunk_paths=CHUNK)
    assert a["n_paths"] == b["n_paths"] == TOTAL
    bin_w = (a["percentiles"]["p99"] - a["percentiles"]["p1"]) / 50
    for q in (5, 50, 95):
        assert abs(a["percentiles"][f"p{q}"]
                   - b["percentiles"][f"p{q}"]) < bin_w
    assert abs(a["expected_return"] - b["expected_return"]) < 1e-3


def test_resume_rejects_mismatched_sketch_grid(tmp_path):
    ckpt = str(tmp_path / "grid.npz")
    _run(checkpoint_path=ckpt)
    with pytest.raises(ValueError):
        streaming_estimate(_gbm(), TOTAL, N_STEPS, seed=5,
                           chunk_paths=CHUNK, block_size=BLOCK,
                           lo=40.0, hi=300.0, bins=512,  # different grid
                           checkpoint_path=ckpt, resume=True)


def test_resume_rejects_misaligned_chunk(tmp_path):
    ckpt = str(tmp_path / "chunk.npz")
    streaming_estimate(_gbm(), CHUNK, N_STEPS, seed=5, chunk_paths=CHUNK,
                       block_size=BLOCK, lo=40.0, hi=260.0, bins=512,
                       checkpoint_path=ckpt)
    with pytest.raises(ValueError):
        streaming_estimate(_gbm(), 4 * CHUNK, N_STEPS, seed=5,
                           chunk_paths=CHUNK + BLOCK,  # misaligned
                           block_size=BLOCK, lo=40.0, hi=260.0, bins=512,
                           checkpoint_path=ckpt, resume=True)


def test_orbax_checkpoint_resume_equals_npz(tmp_path):
    """Non-.npz checkpoint paths use the orbax backend; resume must be
    bitwise identical to the npz path and to the uninterrupted run."""
    ck_orbax = str(tmp_path / "orbax_ckpt")
    half = streaming_estimate(_gbm(), TOTAL // 2, N_STEPS, seed=5,
                              chunk_paths=CHUNK, block_size=BLOCK,
                              lo=40.0, hi=260.0, bins=512,
                              checkpoint_path=ck_orbax)
    assert half.paths_done == TOTAL // 2
    assert os.path.isdir(ck_orbax)  # orbax checkpoints are directories

    loaded = StreamingState.load(ck_orbax)
    assert loaded.paths_done == half.paths_done
    np.testing.assert_array_equal(loaded.block_mean, half.block_mean)
    np.testing.assert_array_equal(np.asarray(loaded.sketch.counts),
                                  np.asarray(half.sketch.counts))

    resumed = _run(checkpoint_path=ck_orbax, resume=True)
    uninterrupted = _run()
    assert resumed.paths_done == TOTAL
    assert float(resumed.moments().mean) == float(
        uninterrupted.moments().mean)
    np.testing.assert_array_equal(np.asarray(resumed.sketch.counts),
                                  np.asarray(uninterrupted.sketch.counts))


def test_var_auto_reranges_fat_jump_tail():
    """A Merton run whose 4096-path pilot range misses the deep jump tail
    must auto-re-range (counter-based draws make the second pass free of
    RNG state) and report CVaR within sketch tolerance of the exact value
    — previously the tail mass was approximated at the grid edge and only
    a counter recorded it (round-2 verdict weak #7)."""
    from montecarlo.api.var import (_pilot_range,
                                        portfolio_var_on_device)
    from montecarlo.engine import simulate
    from montecarlo.processes import Merton

    proc = Merton.create(s0=100.0, mu=0.03, sigma=0.15, lam=0.002,
                         jump_mean=-2.5, jump_std=0.3, dt=1 / 252)
    n, days, seed, bins = 1 << 16, 8, 5, 2048
    terminal = np.asarray(simulate(proc, n, days, seed=seed))
    # Preconditions that make the test non-vacuous: the pilot's margined
    # range misses real tail mass (the deep down-jumps).
    lo_pilot, _ = _pilot_range(proc, days, seed)
    frac_missed = (terminal < lo_pilot).mean()
    assert frac_missed > 1e-6, frac_missed

    res = portfolio_var_on_device(proc, n, days, 100.0, seed=seed,
                                  bins=bins, chunk_paths=1 << 14)
    # Re-ranged grid covers everything: nothing left outside.
    assert res["sketch_oob_fraction"] == 0.0
    # CVaR within sketch resolution of the exact tail mean (the widened
    # grid is ~2x the pilot span; allow a few bins of quantization).
    p5 = np.percentile(terminal, 5.0)
    exact_cvar = (100.0 - terminal[terminal <= p5].mean())
    span = terminal.max() - terminal.min()
    tol = 5 * (1.5 * span / bins)
    assert abs(res["cvar_95"] - exact_cvar) < tol, (res["cvar_95"],
                                                    exact_cvar)
    # Explicit (user-pinned) ranges are respected but warn when they clip.
    import warnings

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res_pinned = portfolio_var_on_device(
            proc, n, days, 100.0, seed=seed, bins=bins,
            chunk_paths=1 << 14, lo=float(lo_pilot),
            hi=float(terminal.max() + 1.0))
    assert res_pinned["sketch_oob_fraction"] > 1e-6
    assert any("outside the explicit sketch range" in str(x.message)
               for x in w), [str(x.message) for x in w]


def test_grid_error_brackets_exact_sort_var():
    """The reported deterministic grid error (one bin width) must bracket
    the exact-sort VaR on a deliberately coarse grid, and a path count
    whose sampling bar has shrunk below the grid floor must warn that the
    estimate is grid-limited."""
    from montecarlo.api import portfolio_var
    from montecarlo.engine.dispatch import terminal_prices

    n = 1 << 22
    with pytest.warns(UserWarning, match="grid"):
        res = portfolio_var(_gbm(), n, N_STEPS, 100.0, seed=5,
                            lo=40.0, hi=260.0, bins=64,
                            chunk_paths=1 << 20)
    assert res["var_95_std_err"] < res["var_95_grid_err"]
    # Exact-sort oracle on the SAME terminals (counter-based draws make the
    # chunked stream bitwise-equal to one shot).
    term = np.asarray(terminal_prices(_gbm(), n, N_STEPS, seed=5))
    var_exact = (100.0 - np.percentile(term, 5.0))  # percent of spot=100
    assert abs(res["var_95"] - var_exact) <= res["var_95_grid_err"], (
        res["var_95"], var_exact, res["var_95_grid_err"])
    # CVaR bracket under its propagated grid error.
    p5 = np.percentile(term, 5.0)
    cvar_exact = 100.0 - term[term <= p5].mean()
    assert abs(res["cvar_95"] - cvar_exact) <= res["cvar_95_grid_err"], (
        res["cvar_95"], cvar_exact, res["cvar_95_grid_err"])


def test_npz_checkpoint_needs_no_orbax(tmp_path, monkeypatch):
    """Without orbax, the .npz route still saves and restores."""
    import sys

    for mod in [m for m in sys.modules if m.startswith("orbax")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "orbax", None)
    ckpt = str(tmp_path / "s.npz")
    state = _run(checkpoint_path=ckpt)
    assert StreamingState.load(ckpt).paths_done == state.paths_done


def test_directory_checkpoint_without_orbax_says_so(tmp_path, monkeypatch):
    import sys

    import pytest

    for mod in [m for m in sys.modules if m.startswith("orbax")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "orbax", None)
    with pytest.raises(ImportError, match=r"orbax.*\.npz"):
        StreamingState.load(str(tmp_path / "ckpt_dir"))
