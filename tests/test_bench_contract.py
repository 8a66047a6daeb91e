"""bench.py driver contract: importable, one JSON line with required keys."""
import json
import os
import subprocess
import sys


def test_bench_prints_one_json_line():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["TPUBZ_BENCH_MB"] = "1"
    p = subprocess.run(
        [sys.executable, "bench.py"],
        capture_output=True,
        timeout=560,
        env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert p.returncode == 0, p.stderr.decode()[-500:]
    lines = [l for l in p.stdout.decode().splitlines() if l.strip()]
    assert len(lines) == 1, lines
    result = json.loads(lines[0])
    for key in ("metric", "value", "unit", "device", "card"):
        assert key in result, key
    assert "vs_baseline" not in result
    assert result["device"]["platform"] == "cpu"
    assert result["device"]["count"] >= 1
    assert result["roundtrip_ok"] is True


def test_bench_guard_contract():
    """tools/bench_guard.py (the 24MB hybrid-not-a-liability guard) must
    run, print one JSON line, and pass on the CPU backend at a small size:
    with the 'device' also a CPU engine, hybrid ~= CPU-only, so a failure
    here means the arbitration itself regressed (straggler economics)."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # conftest pins TPUBZ_HYBRID_CPU=0 for in-process tests; the guard must
    # see the production default (pool on, device-is-host detection active)
    env.pop("TPUBZ_HYBRID_CPU", None)
    p = subprocess.run(
        [
            sys.executable,
            "tools/bench_guard.py",
            "--mb", "3",
            "--level", "1",
            # 3 trials: the first hybrid pass may spend the per-process
            # device re-probe (expensive when the 'device' is the CPU
            # backend); the median is the steady state
            "--trials", "3",
            "--tolerance", "0.7",  # CPU-vs-CPU on a bursty 4-core VM
        ],
        capture_output=True,
        timeout=560,
        env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert p.returncode == 0, (p.stdout.decode()[-300:], p.stderr.decode()[-500:])
    lines = [l for l in p.stdout.decode().splitlines() if l.strip()]
    result = json.loads(lines[-1])
    assert result["ok"] is True
    assert result["hybrid_MBps"] > 0 and result["cpu_only_MBps"] > 0


def test_real_corpus_deterministic_prefix():
    """build_real_corpus assembles the audited >=128 MiB real-file corpus
    and every requested size is a prefix of it (the category interleave
    keeps prefixes representative); rebuilds are byte-identical (cache
    keyed by sha256 in the manifest)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench

    r = bench.build_real_corpus(2)
    if r is None:
        import pytest

        pytest.skip("image lacks real-file material")
    blob, prov = r
    assert len(blob) == 2 << 20
    assert prov["kind"] == "real-files"
    assert prov["sha256"]
    assert set(prov["categories"]) == {"binary", "source", "headers", "text"}
    blob4, prov4 = bench.build_real_corpus(4)
    assert prov4["sha256"] == prov["sha256"]  # same underlying assembly
    assert blob4[: len(blob)] == blob  # prefix property
