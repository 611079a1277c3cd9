"""The device capability query, the compile-cache location, and the
measurement scripts' refusal to run without a GPU."""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest

from montecarlo import device
from montecarlo.engine import dispatch
from montecarlo.processes import GBM, MultiGBM
from montecarlo.samplers import AntitheticSampler, PlainSampler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fake_devices(monkeypatch, platform, kind="fake"):
    monkeypatch.setattr(
        jax, "devices",
        lambda *a: [SimpleNamespace(platform=platform, device_kind=kind)])


@pytest.mark.parametrize("platform,engine", [("gpu", "triton"),
                                             ("cpu", "scan")])
def test_path_engine_per_platform(monkeypatch, platform, engine):
    _fake_devices(monkeypatch, platform)
    assert device.platform() == platform
    assert device.path_engine() == engine


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_unknown_platform_raises(monkeypatch, platform):
    _fake_devices(monkeypatch, platform)
    with pytest.raises(device.UnsupportedPlatform, match=platform):
        device.platform()
    with pytest.raises(device.UnsupportedPlatform):
        dispatch.terminal_prices(
            GBM.create(s0=100.0, mu=0.0, sigma=0.2, dt=0.01), 256, 2,
            seed=0)


def test_require_gpu(monkeypatch):
    _fake_devices(monkeypatch, "cpu")
    with pytest.raises(device.UnsupportedPlatform, match="needs a GPU"):
        device.require_gpu()
    _fake_devices(monkeypatch, "gpu")
    device.require_gpu()


def test_describe_names_platform_kind_count_and_card(monkeypatch):
    _fake_devices(monkeypatch, "gpu", kind="NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(device, "card_name_and_power_limit",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    assert device.describe() == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
        "card": "NVIDIA H100 80GB HBM3, 700.00 W"}


def test_card_query_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    assert device.card_name_and_power_limit() == "not available"


_GBM = GBM.create(s0=100.0, mu=0.03, sigma=0.2, dt=1 / 252)


@pytest.mark.parametrize("case,expected", [
    ("gbm_default", True),
    ("gbm_plain", True),
    ("gbm_antithetic", True),
    ("gbm_f64_dtype", False),
    ("multi_gbm", False),
])
def test_kernel_or_scan_choice_on_gpu(monkeypatch, case, expected):
    """What the dispatch runs when the query says GPU (x32 mode)."""
    _fake_devices(monkeypatch, "gpu")
    proc, sampler, dtype = _GBM, None, jnp.float32
    if case == "gbm_plain":
        sampler = PlainSampler()
    elif case == "gbm_antithetic":
        sampler = AntitheticSampler()
    elif case == "gbm_f64_dtype":
        dtype = jnp.float64
    elif case == "multi_gbm":
        proc = MultiGBM.create(s0=[100.0, 90.0], mu=[0.0, 0.0],
                               sigma=[0.2, 0.3],
                               corr=[[1.0, 0.3], [0.3, 1.0]], dt=0.01)
    with jax.enable_x64(False):
        assert dispatch._fused_eligible(proc, sampler, 16, dtype) is expected


def test_cpu_chooses_scan_and_x64_keeps_the_kernel(monkeypatch):
    _fake_devices(monkeypatch, "cpu")
    assert not dispatch._fused_eligible(_GBM, None, 16, jnp.float32)
    _fake_devices(monkeypatch, "gpu")
    with jax.enable_x64(True):
        assert dispatch._fused_eligible(_GBM, None, 16, jnp.float32)


# --- compile cache ----------------------------------------------------------

def test_cache_dir_without_env_is_the_checkout(monkeypatch):
    from montecarlo.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == os.path.join(REPO, ".jax_cache")


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    from montecarlo.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_enable_sets_checkout_dir_only_without_env(monkeypatch, tmp_path):
    from montecarlo.utils import compile_cache

    set_calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: set_calls.__setitem__(k, v))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_persistent_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in set_calls
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    d = compile_cache.enable_persistent_cache()
    assert set_calls["jax_compilation_cache_dir"] == d
    assert d == os.path.join(REPO, ".jax_cache")


def test_cache_dir_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cache_lands_in_env_dir(tmp_path):
    """A fresh process with the env var set writes its compiled programs
    there (CPU, tiny program)."""
    code = ("import jax, jax.numpy as jnp\n"
            "from montecarlo.utils.compile_cache import "
            "enable_persistent_cache\n"
            "enable_persistent_cache()\n"
            "jax.config.update('jax_persistent_cache_min_compile_time_secs',"
            " 0.0)\n"
            "jax.jit(lambda x: x * 2 + 1)(jnp.ones(8)).block_until_ready()\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=300)
    assert any(tmp_path.iterdir())


# --- measurement scripts refuse a CPU-only run ------------------------------

@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_script_refuses_cpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"value"' not in r.stdout
    assert "GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    the script fails and prints no result."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
