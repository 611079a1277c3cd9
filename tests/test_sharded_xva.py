"""Pod-scale netting-set xVA: `sharded_netting_profile` vs the unsharded
engine and the bitwise mesh-shape-invariance contract."""

import numpy as np
import jax.numpy as jnp

from montecarlo.engine.exposure import CSA, netting_set_profile, \
    swap_value_fn
from montecarlo.parallel import make_mesh, sharded_netting_profile
from montecarlo.processes import GBM, Vasicek

R0, KAPPA, THETA, SIG = 0.03, 0.6, 0.04, 0.012
T, N_STEPS = 2.0, 32
N_PATHS, BLOCK = 4096, 256


def _rates_book():
    model = Vasicek.create(R0, KAPPA, THETA, SIG, T / N_STEPS,
                           dtype=jnp.float64)
    pay_times = np.arange(1, 5) * 0.5
    v1 = swap_value_fn(model, 0.035, pay_times, 0.5)
    v2 = swap_value_fn(model, 0.04, pay_times[:2], 0.5)
    return model, (v1, lambda r, t: -0.5 * v2(r, t))


_KW = dict(T=T, seed=7, hazard_rate=0.02, recovery=0.4,
           own_hazard_rate=0.01, funding_spread=0.004, kva_cost=0.10,
           csa=CSA(threshold=0.002, mta=0.0005, mpor=4 * T / N_STEPS))

# Coarse PFE grid so the one-bin-width bracket against the exact
# (order-statistic-interpolated) quantile is meaningful at 4096 paths —
# same convention as test_streaming's VaR grid-error bracket.
_PFE_BINS = 64


def _sharded(n_dev, **over):
    model, trades = _rates_book()
    kw = {**_KW, **over}
    return sharded_netting_profile(model, trades, N_PATHS, N_STEPS,
                                   mesh=make_mesh(n_dev),
                                   block_size=BLOCK, pfe_bins=_PFE_BINS,
                                   **kw)


def test_bitwise_mesh_shape_invariance():
    """Every profile array and scalar is bitwise identical on 1/2/4/8-device
    meshes — the framework's signature reproducibility contract."""
    base = _sharded(1)
    for n_dev in (2, 4, 8):
        prof = _sharded(n_dev)
        for k, v in base.items():
            np.testing.assert_array_equal(
                np.asarray(v), np.asarray(prof[k]), err_msg=f"{k}@{n_dev}")


def test_matches_unsharded_profile():
    """Means/xVA agree with `netting_set_profile` to fp-reassociation noise;
    PFE agrees within its reported grid error (the sketch's honesty bar)."""
    model, trades = _rates_book()
    want = netting_set_profile(model, trades, N_PATHS, N_STEPS, **_KW)
    got = _sharded(4)
    for k in ("epe", "ene", "eepe", "epe_uncollateralized",
              "ene_uncollateralized", "im"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=1e-11, atol=1e-14, err_msg=k)
    for k in ("cva", "dva", "bcva", "cva_no_netting", "fca", "fba", "fva",
              "kva", "mva"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-10, atol=1e-15, err_msg=k)
    assert float(got["kva"]) > 0.0
    # PFE: sketch quantile within one bin width of the exact quantile.
    gap = np.abs(np.asarray(got["pfe"]) - np.asarray(want["pfe"]))
    assert np.all(gap <= np.asarray(got["pfe_grid_err"]) + 1e-12), gap.max()


def test_zero_threshold_instant_collateral_under_mesh():
    """The pinned CSA limit survives sharding: H=0/MTA=0/MPoR=0 collateral
    kills the collateralized exposure on every mesh shape."""
    prof = _sharded(4, csa=CSA(threshold=0.0, own_threshold=0.0,
                               mta=0.0, mpor=0.0))
    assert np.all(np.asarray(prof["epe"]) == 0.0)
    assert float(prof["cva"]) == 0.0
    assert np.asarray(prof["epe_uncollateralized"]).max() > 0.0


def test_equity_flat_rate_book():
    """Equity underlying (GBM forwards, flat discounting) parity with the
    unsharded profile."""
    t_end, steps, n = 1.0, 16, 2048
    model = GBM.create(100.0, 0.03, 0.25, t_end / steps, dtype=jnp.float64)
    k = 100.0 * np.exp(0.03 * t_end)

    def fwd(strike):
        return lambda s, t: s - strike * jnp.exp(-0.03 * (t_end - t))

    trades = (fwd(0.95 * k), lambda s, t: -0.4 * fwd(1.05 * k)(s, t))
    kw = dict(T=t_end, seed=3, hazard_rate=0.02, flat_rate=0.03)
    want = netting_set_profile(model, trades, n, steps, **kw)
    got = sharded_netting_profile(model, trades, n, steps,
                                  mesh=make_mesh(8), block_size=128,
                                  pfe_bins=_PFE_BINS, **kw)
    np.testing.assert_allclose(np.asarray(got["epe"]),
                               np.asarray(want["epe"]), rtol=1e-11)
    np.testing.assert_allclose(float(got["cva"]), float(want["cva"]),
                               rtol=1e-10)
    gap = np.abs(np.asarray(got["pfe"]) - np.asarray(want["pfe"]))
    assert np.all(gap <= np.asarray(got["pfe_grid_err"]) + 1e-12)


def test_multi_slice_two_level_matches_flat():
    """A ("slices", "paths") 2x4 mesh (DCN two-level reduction) is bitwise
    equal to the flat 8-device mesh."""
    model, trades = _rates_book()
    flat = sharded_netting_profile(model, trades, N_PATHS, N_STEPS,
                                   mesh=make_mesh(8), block_size=BLOCK,
                                   pfe_bins=_PFE_BINS, **_KW)
    two = sharded_netting_profile(model, trades, N_PATHS, N_STEPS,
                                  mesh=make_mesh(n_path_shards=4,
                                                 n_slices=2),
                                  block_size=BLOCK, pfe_bins=_PFE_BINS,
                                  **_KW)
    for k, v in flat.items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(two[k]),
                                      err_msg=k)


def test_cli_xva_portfolio_mesh(capsys):
    import json

    from montecarlo import cli

    rc = cli.main(["xva", "--portfolio", "--paths", "4096", "--steps", "50",
                   "--mesh", "2", "--threshold", "0.005"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mesh"] == 2 and out["peak_pfe_grid_err"] > 0
    assert 0.0 <= out["cva"] <= out["cva_no_netting"]

    # --mesh + --wwr-beta/--im-spread now runs the sharded WWR/IM passes
    # (round 5: the exclusion list is empty).  --no-csa: the default CSA
    # at this grid rounds to a zero-step lag and kills all exposure.
    rc = cli.main(["xva", "--portfolio", "--no-csa", "--paths", "4096",
                   "--steps", "50", "--mesh", "2", "--wwr-beta", "1.0",
                   "--im-spread", "0.003"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["cva_wwr"] > out["cva"] >= 0 and out["mva"] > 0
    assert out["peak_im"] > 0


def test_sharded_wwr_and_im_bitwise_and_match_unsharded():
    """The round-4 exclusions, emptied: wwr_beta and im_spread through the
    SHARDED engine — bitwise mesh-shape-invariant (the Newton calibration
    runs replicated on gathered fixed-block sums) and matching the
    unsharded engine to fp-reassociation noise."""
    model, trades = _rates_book()
    kw = {**_KW, "wwr_beta": 1.5, "im_spread": 0.003}
    want = netting_set_profile(model, trades, N_PATHS, N_STEPS, **kw)
    got = {n: _sharded(n, **kw) for n in (1, 2, 8)}
    for k, v in got[1].items():
        for n in (2, 8):
            np.testing.assert_array_equal(np.asarray(v),
                                          np.asarray(got[n][k]),
                                          err_msg=f"{k}@{n}")
    for k in ("im", "survival_wwr"):
        np.testing.assert_allclose(np.asarray(got[8][k]),
                                   np.asarray(want[k]), rtol=1e-9,
                                   atol=1e-15, err_msg=k)
    for k in ("cva_wwr", "mva"):
        np.testing.assert_allclose(float(got[8][k]), float(want[k]),
                                   rtol=1e-9, atol=1e-18, err_msg=k)
    # WWR direction survives sharding: payer swap exposure rises with r,
    # beta > 0 is wrong-way.
    assert float(got[8]["cva_wwr"]) > float(got[8]["cva"])


def test_sharded_wwr_beta_zero_reduces_to_cva():
    """beta = 0 keeps the Newton calibration deterministic: cva_wwr must
    collapse to the flat-hazard cva (same contract as the unsharded
    engine's pinned limit)."""
    prof = _sharded(4, wwr_beta=0.0, with_wwr=True)
    cva, cva_wwr = float(prof["cva"]), float(prof["cva_wwr"])
    assert abs(cva_wwr - cva) < 1e-12 * max(abs(cva), 1e-30), (cva, cva_wwr)
    np.testing.assert_allclose(np.asarray(prof["survival_wwr"]),
                               np.exp(-_KW["hazard_rate"]
                                      * np.asarray(prof["times"])),
                               rtol=1e-9)


def _build_greeks(p):
    model = Vasicek.create(p.get("r0", R0), KAPPA, THETA,
                           p.get("sigma", SIG), T / N_STEPS,
                           dtype=jnp.float64)
    pay_times = np.arange(1, 5) * 0.5
    v1 = swap_value_fn(model, 0.035, pay_times, 0.5)
    v2 = swap_value_fn(model, 0.04, pay_times[:2], 0.5)
    return model, (v1, lambda r, t: -0.5 * v2(r, t)), None


def test_sharded_greeks_bitwise_mesh_invariant_and_match_unsharded():
    """Pod-scale xVA greeks: tangents ride the same fixed-block contract
    as the level profile, so values AND greeks are bitwise identical
    across mesh shapes; the unsharded engine agrees to reassociation
    noise."""
    from montecarlo.engine.exposure import xva_greeks
    from montecarlo.parallel import sharded_xva_greeks

    kwg = dict(T=T, seed=7, hazard_rate=0.02, recovery=0.4,
               own_hazard_rate=0.01, funding_spread=0.004, kva_cost=0.10,
               csa=CSA(threshold=0.002, mta=0.0, mpor=4 * T / N_STEPS))
    params = {"r0": R0, "sigma": SIG}
    outs = ("cva", "fva", "kva")
    res = {n: sharded_xva_greeks(_build_greeks, params, N_PATHS, N_STEPS,
                                 mesh=make_mesh(n), block_size=BLOCK,
                                 pfe_bins=_PFE_BINS, outputs=outs, **kwg)
           for n in (1, 4)}
    for out in outs:
        assert float(res[1]["values"][out]) == float(res[4]["values"][out])
        for pname in params:
            a = float(res[1]["greeks"][out][pname])
            b = float(res[4]["greeks"][out][pname])
            assert a == b, (out, pname, a, b)
    want = xva_greeks(_build_greeks, params, N_PATHS, N_STEPS,
                      outputs=outs, **kwg)
    for out in outs:
        np.testing.assert_allclose(float(res[4]["values"][out]),
                                   float(want["values"][out]), rtol=1e-9,
                                   err_msg=out)
        for pname in params:
            np.testing.assert_allclose(
                float(res[4]["greeks"][out][pname]),
                float(want["greeks"][out][pname]), rtol=1e-6, atol=1e-12,
                err_msg=f"{out}/{pname}")


# ---------------------------------------------------------------------------
# Pod-scale multi-counterparty portfolio
# ---------------------------------------------------------------------------

def _portfolio_sets():
    model, (v1, v2) = _rates_book()
    return model, {
        "cpty_a": dict(trades=(v1,), csa=_KW["csa"], hazard_rate=0.02),
        "cpty_b": dict(trades=(v2,), hazard_rate=0.03, kva_cost=0.10),
    }


def test_sharded_portfolio_single_set_bitwise_netting_profile():
    """A one-set sharded portfolio is bitwise identical to
    `sharded_netting_profile` — both are the same `_sharded_portfolio_core`
    program, so the equality is structural, and this test pins it."""
    from montecarlo.parallel import sharded_portfolio_xva

    model, trades = _rates_book()
    kw = dict(T=T, seed=7, mesh=make_mesh(4), block_size=BLOCK,
              pfe_bins=_PFE_BINS)
    prof = sharded_netting_profile(model, trades, N_PATHS, N_STEPS,
                                   csa=_KW["csa"], hazard_rate=0.02,
                                   kva_cost=0.10, funding_spread=0.004,
                                   **kw)
    port = sharded_portfolio_xva(
        model, {"only": dict(trades=trades, csa=_KW["csa"],
                             hazard_rate=0.02, kva_cost=0.10)},
        N_PATHS, N_STEPS, funding_spread=0.004, **kw)
    for k in prof:
        np.testing.assert_array_equal(
            np.asarray(prof[k]), np.asarray(port["sets"]["only"][k]),
            err_msg=k)


def test_sharded_portfolio_mesh_invariant_and_matches_unsharded():
    """Two netting sets on one sharded simulation: every per-set profile
    and scalar is bitwise mesh-shape-invariant; scalars agree with the
    unsharded `portfolio_xva` to fp-reassociation noise; totals are
    exactly additive."""
    from montecarlo.engine.exposure import portfolio_xva
    from montecarlo.parallel import sharded_portfolio_xva

    model, sets = _portfolio_sets()
    kw = dict(T=T, seed=7, block_size=BLOCK, pfe_bins=_PFE_BINS,
              funding_spread=0.004)
    res = {n: sharded_portfolio_xva(model, sets, N_PATHS, N_STEPS,
                                    mesh=make_mesh(n), **kw)
           for n in (1, 8)}
    for nm in sets:
        for k, v in res[1]["sets"][nm].items():
            np.testing.assert_array_equal(
                np.asarray(v), np.asarray(res[8]["sets"][nm][k]),
                err_msg=f"{nm}/{k}")
    want = portfolio_xva(model, sets, N_PATHS, N_STEPS, T=T, seed=7,
                         funding_spread=0.004)
    for nm in sets:
        for k in ("cva", "dva", "cva_no_netting", "fca", "fba", "kva"):
            np.testing.assert_allclose(
                float(res[8]["sets"][nm][k]),
                float(want["sets"][nm][k]), rtol=1e-10, atol=1e-15,
                err_msg=f"{nm}/{k}")
        # PFE: sketch quantile within its reported grid error of the
        # unsharded exact-sort quantile.
        gap = np.abs(np.asarray(res[8]["sets"][nm]["pfe"])
                     - np.asarray(want["sets"][nm]["pfe"]))
        err = np.asarray(res[8]["sets"][nm]["pfe_grid_err"])
        assert np.all(gap <= err + 1e-12), (nm, gap.max())
    for k in ("cva", "fva", "kva"):
        tot = sum(float(res[8]["sets"][nm][k]) for nm in sets)
        assert float(res[8]["portfolio"][k]) == tot, k


def test_sharded_portfolio_wwr_and_im_per_set():
    """Per-set wwr_beta/im_spread through the sharded portfolio (round 5:
    nothing left on the exclusion list): bitwise mesh invariance with
    mixed per-set terms, and parity with the unsharded portfolio."""
    from montecarlo.engine.exposure import portfolio_xva
    from montecarlo.parallel import sharded_portfolio_xva

    model, (v1, v2) = _rates_book()
    sets = {"a": dict(trades=(v1,), hazard_rate=0.02, wwr_beta=1.0,
                      im_spread=0.003),
            "b": dict(trades=(v2,), hazard_rate=0.03)}
    kw = dict(T=T, seed=7, funding_spread=0.004)
    res = {n: sharded_portfolio_xva(model, sets, N_PATHS, N_STEPS,
                                    mesh=make_mesh(n), block_size=BLOCK,
                                    pfe_bins=_PFE_BINS, **kw)
           for n in (1, 8)}
    for nm in sets:
        for k, v in res[1]["sets"][nm].items():
            np.testing.assert_array_equal(
                np.asarray(v), np.asarray(res[8]["sets"][nm][k]),
                err_msg=f"{nm}/{k}")
    want = portfolio_xva(model, sets, N_PATHS, N_STEPS, **kw)
    for nm, keys in (("a", ("cva", "cva_wwr", "mva")), ("b", ("cva",))):
        for k in keys:
            np.testing.assert_allclose(
                float(res[8]["sets"][nm][k]), float(want["sets"][nm][k]),
                rtol=1e-9, atol=1e-18, err_msg=f"{nm}/{k}")
    assert float(res[8]["portfolio"]["mva"]) == float(
        res[8]["sets"]["a"]["mva"]) + float(res[8]["sets"]["b"]["mva"])


def _build_greeks_f32(p):
    model = Vasicek.create(p["r0"], KAPPA, THETA, p["sigma"], 0.05,
                           dtype=jnp.float32)
    return model, (swap_value_fn(model, 0.035, [0.4, 0.8], 0.4),), None


def test_sharded_greeks_f32_mesh8_bitwise():
    """Regression: the jax.linearize tangent-only replay compiled with
    mesh-shape-dependent FMA contraction — the f32 fva/sigma tangent
    flipped a few ULPs between 1- and 8-device meshes (caught by the
    driver dryrun, invisible to the f64 mesh-1/4 test above).  The
    per-parameter jvp form must keep values AND greeks bitwise."""
    from montecarlo.parallel import sharded_xva_greeks

    kwg = dict(T=0.8, seed=5, outputs=("cva", "fva"), hazard_rate=0.02,
               funding_spread=0.004, block_size=256, pfe_bins=64,
               dtype=jnp.float32)
    params = {"r0": jnp.float32(R0), "sigma": jnp.float32(SIG)}
    res = {n: sharded_xva_greeks(_build_greeks_f32, params, 4096, 16,
                                 mesh=make_mesh(n), **kwg)
           for n in (1, 8)}
    for out in ("cva", "fva"):
        assert (float(res[1]["values"][out])
                == float(res[8]["values"][out])), out
        for pname in params:
            a = float(res[1]["greeks"][out][pname])
            b = float(res[8]["greeks"][out][pname])
            assert a == b, (out, pname, a, b)


def test_cli_xva_portfolio_mesh_greeks(capsys):
    import json

    from montecarlo import cli

    rc = cli.main(["xva", "--portfolio", "--paths", "4096", "--steps",
                   "32", "--mesh", "2", "--no-csa", "--greeks",
                   "--kva-cost", "0.1"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["state_param"] == "r0"
    assert set(out["greeks"]) == {"cva", "dva", "bcva", "fva", "mva",
                                  "kva"}
    assert out["greeks"]["cva"]["hazard_rate"] > 0
