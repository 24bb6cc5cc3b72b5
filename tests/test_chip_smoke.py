"""chip_smoke.py and the device policy in config.py, on the CPU.

``main()`` always checks for a GPU, so here it must refuse to run and
print nothing.  The phases are called directly at toy sizes: this checks
their control flow and comparisons, not any device number.
"""

import os
import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from navierstokes_tpu import config  # noqa: E402
from navierstokes_tpu.parallel.sharded import device_mesh  # noqa: E402


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_refuses_a_cpu_device(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(argv)
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_require_gpu_returns_gpu_devices(monkeypatch):
    fake = [types.SimpleNamespace(platform="gpu", device_kind="H100")] * 4
    monkeypatch.setattr(jax, "devices", lambda *a: fake)
    assert chip_smoke.require_gpu() == fake


def test_device_policy_on_a_gpu_backend(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert config.on_accelerator()
    # x64 is on in the test session: the GPU keeps float64 on the device
    assert config.default_dtype() == jnp.float64
    monkeypatch.setattr(config, "x64_enabled", lambda: False)
    assert config.default_dtype() == jnp.float32
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert not config.on_accelerator()


def test_accurate_matmuls_set_only_on_an_accelerator(monkeypatch):
    before = jax.config.jax_default_matmul_precision
    monkeypatch.setattr(config, "_matmul_precision_set", False)
    try:
        config.ensure_accurate_matmuls()          # CPU: leaves it alone
        assert jax.config.jax_default_matmul_precision == before
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        config.ensure_accurate_matmuls()
        assert jax.config.jax_default_matmul_precision == "highest"
    finally:
        jax.config.update("jax_default_matmul_precision", before)


def test_compile_cache_honours_the_environment(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config.use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = config.use_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_check_raises_outside_tolerance():
    chip_smoke.check("inside", 1e-7, 1e-6)
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke.check("outside", 1e-5, 1e-6)
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke.check("nan", float("nan"), 1.0)


def test_phases_taylor_green():
    u = chip_smoke.phase_tg_spectral(n=32, n_steps=4)
    chip_smoke.phase_tg_banded(u, n=32, n_steps=4)


def test_phase_dfg():
    chip_smoke.phase_dfg(resolution=1.0, n_steps=5, n_check=3)


def test_phase_stationary():
    chip_smoke.phase_stationary(n=8)


def test_phase_band():
    chip_smoke.phase_band(sizes=(16,), reps=3, cg_n=16)


@pytest.fixture(scope="module")
def mesh4():
    return device_mesh(4)


def test_four_halo(mesh4):
    chip_smoke.four_halo(mesh4, nx=16, ny=4, n_steps=4)


def test_four_spectral(mesh4):
    chip_smoke.four_spectral(mesh4, n=16, n_steps=4)


def test_four_stationary(mesh4):
    chip_smoke.four_stationary(mesh4, n=8)


def test_assert_spread_rejects_replication(mesh4):
    from jax.sharding import NamedSharding, PartitionSpec as P

    devices = list(mesh4.devices.flat)
    spread = jax.device_put(jnp.arange(16.0),
                            NamedSharding(mesh4, P(mesh4.axis_names[0])))
    chip_smoke._assert_spread([spread], devices, "sharded")
    replicated = jax.device_put(jnp.arange(16.0), NamedSharding(mesh4, P()))
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke._assert_spread([replicated], devices, "replicated")
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke._assert_spread([jnp.arange(16.0)], devices, "device 0")
    assert np.isfinite(float(spread.sum()))
