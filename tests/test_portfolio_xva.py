"""Multi-counterparty portfolio xVA (`engine.exposure.portfolio_xva`):
one simulation, per-counterparty netting, exact consistency with the
single-set engine, and the lost-offset inequality."""

import numpy as np
import pytest
import jax.numpy as jnp

from montecarlo.engine.exposure import (CSA, netting_set_profile,
                                            portfolio_xva, swap_value_fn)
from montecarlo.processes import Vasicek

R0, KAPPA, THETA, SIG = 0.03, 0.6, 0.04, 0.012
T, N_STEPS, N = 2.0, 32, 2048


def _model():
    return Vasicek.create(R0, KAPPA, THETA, SIG, T / N_STEPS,
                          dtype=jnp.float64)


def _swaps(model):
    pay = np.arange(1, 5) * 0.5
    v1 = swap_value_fn(model, 0.035, pay, 0.5)
    v2 = swap_value_fn(model, 0.04, pay[:2], 0.5)
    return v1, lambda r, t: -0.5 * v2(r, t)


def test_single_set_portfolio_bitwise_matches_netting_engine():
    model = _model()
    v1, v2 = _swaps(model)
    kw = dict(T=T, seed=7, own_hazard_rate=0.01, funding_spread=0.004)
    spec = dict(trades=(v1, v2), csa=CSA(threshold=0.002, mpor=4 * T / 32),
                hazard_rate=0.02, kva_cost=0.10, im_spread=0.003)
    port = portfolio_xva(model, {"only": spec}, N, N_STEPS, **kw)
    want = netting_set_profile(model, spec["trades"], N, N_STEPS,
                               csa=spec["csa"], hazard_rate=0.02,
                               kva_cost=0.10, im_spread=0.003, **kw)
    got = port["sets"]["only"]
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(got[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(np.asarray(port["portfolio"]["cva"]),
                                  np.asarray(want["cva"]))


def test_split_counterparties_additive_and_lose_the_offset():
    """Per-set results equal the standalone engine on the same seed
    (exactly — same paths, same formulas), totals add, and splitting a
    perfectly offsetting pair across two counterparties resurrects the
    CVA that single-set netting killed."""
    model = _model()
    v1, _ = _swaps(model)
    neg = lambda r, t: -v1(r, t)
    kw = dict(T=T, seed=7)
    one_set = netting_set_profile(model, (v1, neg), N, N_STEPS,
                                  hazard_rate=0.02, **kw)
    assert float(one_set["cva"]) == 0.0
    port = portfolio_xva(model, {
        "a": dict(trades=(v1,), hazard_rate=0.02),
        "b": dict(trades=(neg,), hazard_rate=0.03),
    }, N, N_STEPS, **kw)
    cva_a = float(port["sets"]["a"]["cva"])
    cva_b = float(port["sets"]["b"]["cva"])
    assert cva_a > 0 and cva_b > 0
    np.testing.assert_allclose(float(port["portfolio"]["cva"]),
                               cva_a + cva_b, rtol=1e-12)
    # Per-set == standalone engine on the same seed, bit for bit.
    solo_a = netting_set_profile(model, (v1,), N, N_STEPS,
                                 hazard_rate=0.02, **kw)
    assert float(solo_a["cva"]) == cva_a


def test_unknown_spec_key_rejected():
    model = _model()
    v1, _ = _swaps(model)
    with pytest.raises(ValueError, match="unknown keys"):
        portfolio_xva(model, {"a": dict(trades=(v1,), hazard=0.02)},
                      256, N_STEPS, T=T, seed=1)


def test_cli_counterparties(capsys):
    import json

    from montecarlo import cli

    rc = cli.main(["xva", "--portfolio", "--no-csa", "--paths", "2048",
                   "--steps", "40", "--counterparties", "2",
                   "--kva-cost", "0.1"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["counterparties"] == 2
    np.testing.assert_allclose(out["cva_total"],
                               out["cva_cpty_a"] + out["cva_cpty_b"],
                               atol=2e-6)
    assert out["kva_total"] > 0


def test_cli_counterparties_mesh(capsys):
    import json

    import pytest

    from montecarlo import cli

    rc = cli.main(["xva", "--portfolio", "--no-csa", "--paths", "2048",
                   "--steps", "40", "--counterparties", "2", "--mesh", "2",
                   "--kva-cost", "0.1"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mesh"] == 2 and out["counterparties"] == 2
    assert out["peak_pfe_grid_err"] > 0
    np.testing.assert_allclose(out["cva_total"],
                               out["cva_cpty_a"] + out["cva_cpty_b"],
                               atol=2e-6)
    assert "mva_total" in out  # round 5: IM/MVA rides the sharded engine
    # --im-spread under the mesh now runs: per-set MVA is reported.
    rc = cli.main(["xva", "--portfolio", "--no-csa", "--paths", "2048",
                   "--steps", "40", "--counterparties", "2", "--mesh", "2",
                   "--im-spread", "0.01"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mva_total"] > 0
    # Streaming checkpoints cover the single-set engine only — the
    # multi-counterparty branch must refuse rather than silently skip
    # the requested checkpointing.
    with pytest.raises(SystemExit, match="SINGLE netting set"):
        cli.main(["xva", "--portfolio", "--paths", "2048", "--steps",
                  "40", "--counterparties", "2", "--checkpoint",
                  "never_created.npz"])
