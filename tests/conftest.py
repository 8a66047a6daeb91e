"""Test env: force JAX onto a virtual 8-device CPU mesh before any jax import.

This is the multi-device simulation strategy from SURVEY.md §4: sharding
and gather logic are validated on `--xla_force_host_platform_device_count=8`
without accelerator hardware.
"""
import os
import tempfile

# Hermetic route selection: production routing reads AOT warm-stamp files
# beside the compile cache (tpubz/cache.py), so the same test would pass or
# fail depending on whether an earlier run had warmed the checkout's cache.
# Point the cache at a fresh per-session dir so every probe starts cold and
# tests that need a specific route pin it explicitly.
os.environ["JAX_COMPILATION_CACHE_DIR"] = tempfile.mkdtemp(
    prefix="tpubz_test_cache_"
)

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# hybrid CPU-steal off by default in tests so device-path tests genuinely
# exercise the device route; hybrid tests enable it explicitly
os.environ.setdefault("TPUBZ_HYBRID_CPU", "0")

import numpy as np
import pytest
import subprocess


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(autouse=True)
def _fresh_rigprofile(tmp_path, monkeypatch):
    """Per-test rig-profile isolation: the stream scheduler TRAINS the
    measured rig profile at the end of every stream, so without isolation an
    earlier test's (CPU-backend, wedge-simulated, ...) measurements would
    leak into a later test's routing decisions — the same non-hermeticity
    the per-session cache directory above solves for the AOT stamps."""
    from tpubz.stream import rigprofile

    profile_file = str(tmp_path / "rig_profile.json")
    monkeypatch.setattr(rigprofile, "_path", lambda: profile_file)
    rigprofile.reset_memo()
    yield
    rigprofile.reset_memo()


def _run(cmd, data):
    p = subprocess.run(cmd, input=data, capture_output=True)
    if p.returncode != 0:
        raise RuntimeError(f"{cmd} failed: {p.stderr.decode()[:300]}")
    return p.stdout


@pytest.fixture(scope="session")
def sys_bzip2():
    def f(data: bytes, level: int = 9) -> bytes:
        return _run(["bzip2", "-c", f"-{level}"], data)

    return f


@pytest.fixture(scope="session")
def sys_bunzip2():
    def f(data: bytes) -> bytes:
        return _run(["bunzip2", "-c"], data)

    return f
