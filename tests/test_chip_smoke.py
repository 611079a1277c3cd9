"""`chip_smoke.py`'s phases at tiny sizes on the CPU (the fused kernel in
interpret mode), and — marked ``gpu`` — the kernel compiled for the card."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def test_phase_price_tiny():
    chip_smoke.phase_price(n_paths=4096, n_steps=16, target_se=0.05)


def test_phase_garch_tiny():
    chip_smoke.phase_garch(n_sims=4096, n_days=5, ui_sims=500, ui_days=10,
                           n_oracle_reps=8)


def test_phase_kernel_tiny():
    chip_smoke.phase_kernel(n_paths=512, n_steps=8, n_small=512,
                            small_steps=6,
                            processes=("gbm", "garch", "heston", "nig"),
                            target_se=0.05, ptt_chunk=4096, rqmc_chunk=1024,
                            interpret=True)


def test_phase_var_tiny():
    chip_smoke.phase_var(n_paths=1 << 14, n_days=5, exact_paths=1 << 13,
                         chunk_paths=1 << 13)


def test_phase_precision_tiny():
    chip_smoke.phase_precision(lsm_paths=1 << 12, lsm_steps=10, n_assets=8,
                               basket_paths=256, basket_steps=8)


def test_phase_four_cards_on_virtual_devices():
    """The four-card phase on four of the suite's virtual CPU devices."""
    chip_smoke.phase_four_cards(
        mc_paths=1 << 14, mc_steps=16, sketch_paths=1 << 14, sketch_days=5,
        lsm_paths=1 << 13, lsm_steps=10, xva_paths=1 << 12, xva_steps=8,
        block=1024, xva_block=256)


def test_catalogue_covers_every_fusable_process():
    from montecarlo.engine.dispatch import _FUSABLE

    cat = chip_smoke.fusable_catalogue(n_curve_steps=8)
    missing = [c.__name__ for c in _FUSABLE
               if not any(isinstance(p, c) for p in cat.values())]
    assert not missing


def test_failed_check_raises(capsys):
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke.check("demo", "off by one", 2.0, 1.0, 0.5, "demo")
    assert '"ok": false' in capsys.readouterr().out


@pytest.mark.gpu
def test_kernel_parity_on_gpu(gpu):
    """Every fusable process compiled for the card against the scan
    engine."""
    chip_smoke.phase_kernel(n_paths=1 << 16, n_steps=64, n_small=1 << 14,
                            small_steps=32, target_se=0.01)
