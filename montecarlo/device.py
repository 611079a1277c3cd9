"""The one device capability query.

Every choice that depends on the machine asks here, and nowhere else:

- ``gpu`` (NVIDIA, through JAX's CUDA plugin): fusable path simulations run
  the fused path kernel (:mod:`montecarlo.ops.fused_engine`, Pallas through
  Triton); everything else runs the `lax.scan` engine.
- ``cpu``: the `lax.scan` engine for everything (the test platform).

Any other platform is an error, not a default.
"""

from __future__ import annotations

import subprocess

import jax

PLATFORMS = ("gpu", "cpu")

#: Path engines by platform: what `engine.dispatch` runs for a fusable
#: process.
PATH_ENGINE = {"gpu": "triton", "cpu": "scan"}


class UnsupportedPlatform(RuntimeError):
    """JAX's first device is on a platform this program was not built for."""


def platform() -> str:
    """Platform of JAX's first device: ``"gpu"`` or ``"cpu"``."""
    p = jax.devices()[0].platform
    if p not in PLATFORMS:
        raise UnsupportedPlatform(
            f"JAX's first device is on platform {p!r}; this program runs on "
            f"{' or '.join(PLATFORMS)}")
    return p


def path_engine() -> str:
    """``"triton"`` (the fused path kernel) on the GPU, ``"scan"`` on the
    CPU."""
    return PATH_ENGINE[platform()]


def require_gpu() -> None:
    """Raise unless JAX's first device is a GPU (measurement paths: a
    number taken anywhere else is not a device number)."""
    p = platform()
    if p != "gpu":
        raise UnsupportedPlatform(
            f"this measurement needs a GPU; JAX's first device is {p!r}")


def describe() -> dict:
    """The device fields every result line carries."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card_name_and_power_limit()}


def card_name_and_power_limit() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints them.

    Runs nvidia-smi as a child process (which never imports JAX, so it
    does not open the card a second time); "not available" where there is
    no nvidia-smi.
    """
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "not available"
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else "not available"
