"""The driver contract: entry() compiles single-chip; dryrun_multichip(8)
builds a real mesh and executes one sharded step end to end.

Regression: dryrun_multichip used to *assert* 8 devices instead of
bootstrapping a virtual CPU mesh, failing on a one-device machine.  Under
pytest the conftest already provides 8 virtual devices, so _ensure_devices
must be a no-op here; its bootstrap branch is covered by running
__graft_entry__ standalone.
"""

import jax

import __graft_entry__ as g


def test_entry_compiles_and_runs():
    fn, args = g.entry()
    price, std_err = jax.jit(fn)(*args)
    assert float(std_err) > 0
    # 1-year-ish ATM-ish call on S0=100: sane price band
    assert 0.0 < float(price) < 50.0


def test_dryrun_multichip_8():
    g.dryrun_multichip(8)


def test_ensure_devices_noop_when_enough():
    before = jax.devices()
    g._ensure_devices(8)
    assert jax.devices() == before
