"""CLI `price` combination-matrix smoke: every --process x --payoff x
--sampler pairing either prices finitely or is REJECTED with a clean,
actionable message — the dispatch/validation surface of the CLI's
highest-branching command, swept at tiny shapes.

The sweep covers the three faces of the cube (all processes x samplers at
payoff=call, all payoffs x samplers on gbm, all processes x payoffs with
the plain sampler) — every pairwise interaction, which is where all the
rejection logic lives, without the full 480-combo cross product (this file
alone compiles a few hundred tiny XLA:CPU programs; see DEVNOTES
"XLA:CPU native-stack instability" for why it gets its own pytest
process in run_tests.sh).
"""

import json

import pytest

from montecarlo import cli

PROCESSES = ["gbm", "cev", "heston", "heston-qe", "bates", "bates-qe",
             "merton", "kou", "nig", "vg", "sabr", "rbergomi", "slv",
             "hybrid"]
PAYOFFS = ["call", "put", "digital", "asian", "lookback", "up-and-out",
           "up-and-in", "max-call"]
SAMPLERS = ["plain", "antithetic", "sobol", "sobol-device", "sobol-bridge"]

FACES = sorted(
    {(p, "call", s) for p in PROCESSES for s in SAMPLERS}
    | {("gbm", pay, s) for pay in PAYOFFS for s in SAMPLERS}
    | {(p, pay, "plain") for p in PROCESSES for pay in PAYOFFS}
)


def _run(argv, capsys):
    """rc 0 + finite JSON price, or a clean SystemExit rejection."""
    try:
        rc = cli.main(argv)
    except SystemExit as e:
        msg = str(e)
        assert len(msg) > 10 and "Traceback" not in msg, (argv, msg)
        return None
    assert rc == 0, argv
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["price"] == out["price"], (argv, out)  # not NaN
    assert abs(out["price"]) < 1e6, (argv, out)
    # MLMC reports per-level path counts instead of a single n_paths.
    assert out.get("n_paths", 1) > 0, (argv, out)
    return out


@pytest.mark.parametrize("process,payoff,sampler", FACES,
                         ids=lambda v: str(v))
def test_price_matrix(process, payoff, sampler, capsys):
    _run(["price", "--process", process, "--payoff", payoff,
          "--sampler", sampler, "--paths", "256", "--steps", "8",
          "--maturity", "0.25"], capsys)


@pytest.mark.parametrize("flag", ["--american", "--mlmc", "--bridge"])
@pytest.mark.parametrize("process", ["gbm", "heston", "kou"])
def test_price_mode_flags(flag, process, capsys):
    """The mode flags across a diffusion, a stochastic-vol, and a jump
    process: priced or cleanly rejected (e.g. --mlmc supports gbm/heston
    only; --bridge needs gbm; --american needs call/put/asian)."""
    argv = ["price", "--process", process, "--paths", "256", "--steps",
            "8", "--maturity", "0.25", flag]
    if flag == "--bridge":
        argv += ["--payoff", "up-and-out"]
    out = _run(argv, capsys)
    if flag == "--mlmc" and process in ("gbm", "heston"):
        assert out is not None
    if flag == "--american" and process != "kou":
        assert out is not None


def test_target_se_combinations(capsys):
    """--target-se: accepted for plain/sobol-device vanilla; everything
    else rejected with the contract spelled out."""
    out = _run(["price", "--target-se", "0.05", "--paths", "256",
                "--steps", "8", "--maturity", "0.25"], capsys)
    assert out is not None and out["std_err"] <= 0.05 * 1.05
    assert _run(["price", "--target-se", "0.05", "--sampler", "antithetic",
                 "--steps", "8"], capsys) is None
    assert _run(["price", "--target-se", "0.05", "--payoff", "asian",
                 "--steps", "8"], capsys) is None
    assert _run(["price", "--target-se", "0.05", "--american",
                 "--steps", "8"], capsys) is None
