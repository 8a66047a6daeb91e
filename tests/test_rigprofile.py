"""Rig profile: measured routing replaces baked-in per-rig constants.

The round-2 scheduler hardcoded one relay rig's measurements (bwt-only
stage, 3x-core knee, host-refine default). The profile persists what THIS
rig measures and the stage selector derives the route from it; these tests
pin the selector's economics and the train/persist loop.
"""
import json
import os

import numpy as np
import pytest

from tpubz.stream import rigprofile


@pytest.fixture(autouse=True)
def fresh_profile(tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    rigprofile.reset_memo()
    yield
    rigprofile.reset_memo()


def test_update_persists_and_emas():
    rigprofile.update(cpu_block_s=0.10, dev_cadence_s={"bwt": 0.03})
    p = rigprofile.load()
    assert p["cpu_block_s"] == pytest.approx(0.10)
    assert p["dev_cadence_s"]["bwt"] == pytest.approx(0.03)
    # second sample folds in with EMA weight, not replacement
    rigprofile.update(cpu_block_s=0.20)
    p = rigprofile.load()
    assert 0.10 < p["cpu_block_s"] < 0.20
    # zero/None samples are ignored (no data collected that stream)
    before = rigprofile.load()
    rigprofile.update(cpu_block_s=0.0, dev_cadence_s={"full": 0.0})
    after = rigprofile.load()
    assert after["cpu_block_s"] == before["cpu_block_s"]
    assert "full" not in after["dev_cadence_s"]
    # and the file survives a fresh memo (new process simulation)
    rigprofile.reset_memo()
    assert rigprofile.load()["cpu_block_s"] == after["cpu_block_s"]


def test_choose_stage_needs_both_routes_measured():
    assert rigprofile.choose_stage({}, workers=8, eff_cores=4) is None
    p = {"dev_cadence_s": {"bwt": 0.03}, "host_leg_s": {"bwt": 0.02}}
    assert rigprofile.choose_stage(p, workers=8, eff_cores=4) is None


def test_choose_stage_relay_rig_picks_bwt():
    """The round-2 relay economics: host cores are the contended resource
    (hybrid pool on, CPU engine fast), so the route whose host leg displaces
    fewer CPU blocks per device block wins — bwt (chip 33ms + host 32ms
    vs full chain chip 61ms + host 15ms, H=95ms)."""
    p = {
        "cpu_block_s": 0.095,
        "dev_cadence_s": {"bwt": 0.033, "full": 0.061},
        "host_leg_s": {"bwt": 0.032, "full": 0.015},
    }
    assert rigprofile.choose_stage(p, workers=12, eff_cores=4) == "bwt"


def test_choose_stage_throttled_host_picks_full_chain():
    """Fast link + throttled host (no CPU pool): the host legs are the
    bottleneck, so the route that offloads MTF/RLE2 onto the chip wins —
    the full device chain."""
    p = {
        "cpu_block_s": 0.8,  # throttled host: a CPU block costs 800ms
        "dev_cadence_s": {"bwt": 0.021, "full": 0.041},
        "host_leg_s": {"bwt": 0.30, "full": 0.10},  # throttled host legs
    }
    # no hybrid pool: device-only economics, 1 effective emitter
    assert rigprofile.choose_stage(p, workers=0, eff_cores=1) == "full"
    # even with a pool, at these leg costs a bwt device block displaces
    # nearly half a CPU block of host time while full displaces an eighth
    assert rigprofile.choose_stage(p, workers=4, eff_cores=4) == "full"


def test_stream_trains_profile(rng, monkeypatch):
    """A device-path stream must persist its measurements: cpu_block_s from
    the hybrid workers and host_leg_s/dev_cadence_s for the chosen stage."""
    monkeypatch.setenv("TPUBZ_MIN_DEVICE_BLOCKS", "1")
    monkeypatch.setenv("TPUBZ_HYBRID_CPU", "4")
    import tpubz.stream.api as api
    from tpubz.block import encode as E

    monkeypatch.setattr(E, "_split_ok", True)
    monkeypatch.setattr(api, "_cpu_ema_g", [0.0])
    api._dev_done_g.clear()
    d = b"rig profile training corpus " * 9000 + bytes(
        rng.integers(0, 256, 150000, dtype=np.uint8)
    )
    out = api.compress(d, 1)
    from tpubz.hostref.stream import compress as oracle

    assert out == oracle(d, 1)
    rigprofile.reset_memo()
    p = rigprofile.load()
    assert p.get("cpu_block_s", 0) > 0 or p.get("host_leg_s", {}).get(
        "bwt", 0
    ) > 0


def test_short_stream_latency_does_not_pollute_gap_trained_cadence(
    rng, monkeypatch
):
    """A short hybrid stream drains its 1-2 device blocks at the tail, so
    its only device signal is unpipelined dispatch->emit latency — a 5-10x
    overestimate of pipelined cadence. Such a stream must NOT worsen a
    gap-trained cadence: before this guard, every bench stream EMA'd the
    profile's bwt cadence toward its own latency (measured 0.083 -> 0.275 s
    across one run) and each stream made the next one distrust a healthy
    device."""
    monkeypatch.setenv("TPUBZ_MIN_DEVICE_BLOCKS", "1")
    monkeypatch.setenv("TPUBZ_HYBRID_CPU", "4")
    import tpubz.stream.api as api
    from tpubz.block import encode as E

    monkeypatch.setattr(E, "_split_ok", True)
    monkeypatch.setattr(api, "_cpu_ema_g", [0.0])
    api._dev_done_g.clear()
    # a healthy, gap-trained cadence from a previous pipelined stream
    rigprofile.update(
        cpu_block_s=0.10,
        dev_cadence_s={"bwt": 0.045},
        host_leg_s={"bwt": 0.02},
    )
    d = b"short stream cadence guard corpus " * 8000 + bytes(
        rng.integers(0, 256, 120000, dtype=np.uint8)
    )
    out = api.compress(d, 1)
    from tpubz.hostref.stream import compress as oracle

    assert out == oracle(d, 1)
    rigprofile.reset_memo()
    p = rigprofile.load()
    # the cadence may improve (live gaps) but must not degrade from
    # latency-only evidence on a strike-free stream
    assert p["dev_cadence_s"]["bwt"] <= 0.045 + 1e-9


def test_first_contact_still_trains_cadence_from_latency(rng, monkeypatch):
    """The latency gate must not break first contact: a rig whose profile
    has never measured this stage records the latency median (the only
    signal a one-probe-block stream produces) so a dreadful device stops
    being re-probed every stream."""
    monkeypatch.setenv("TPUBZ_MIN_DEVICE_BLOCKS", "1")
    monkeypatch.setenv("TPUBZ_HYBRID_CPU", "4")
    import tpubz.stream.api as api
    from tpubz.block import encode as E

    monkeypatch.setattr(E, "_split_ok", True)
    monkeypatch.setattr(api, "_cpu_ema_g", [0.0])
    api._dev_done_g.clear()
    d = b"first contact corpus " * 8000
    out = api.compress(d, 1)
    from tpubz.hostref.stream import compress as oracle

    assert out == oracle(d, 1)
    rigprofile.reset_memo()
    p = rigprofile.load()
    # some device signal was persisted for the stage the stream chose
    # (gap-trained if it pipelined, else the latency fallback)
    assert (p.get("dev_cadence_s") or {}).get("bwt", 0) > 0


def test_stage_auto_reads_profile(rng, monkeypatch):
    """With TPUBZ_DEVICE_STAGE unset (auto), the stream consults the
    profile's measured economics; a throttled-host profile must route the
    stream through the full device chain (observed via the transform calls
    it makes)."""
    monkeypatch.setenv("TPUBZ_MIN_DEVICE_BLOCKS", "1")
    monkeypatch.setenv("TPUBZ_HYBRID_CPU", "0")
    import tpubz.stream.api as api
    from tpubz.block import encode as E
    from tpubz.block.encode import DeviceBlockEncoder

    monkeypatch.setattr(api, "DEVICE_STAGE", "auto")
    monkeypatch.setattr(E, "_split_ok", True)
    monkeypatch.setattr(E, "_lean_ok", True)
    rigprofile.update(
        cpu_block_s=0.8,
        dev_cadence_s={"bwt": 0.021, "full": 0.041},
        host_leg_s={"bwt": 0.30, "full": 0.10},
    )
    calls = {"bwt": 0, "full": 0}
    orig_bwt = DeviceBlockEncoder.transform_bwt
    orig_full = DeviceBlockEncoder.transform

    def spy_bwt(self, blk):
        calls["bwt"] += 1
        return orig_bwt(self, blk)

    def spy_full(self, blk, **kw):
        calls["full"] += 1
        return orig_full(self, blk, **kw)

    monkeypatch.setattr(DeviceBlockEncoder, "transform_bwt", spy_bwt)
    monkeypatch.setattr(DeviceBlockEncoder, "transform", spy_full)
    d = b"stage auto corpus " * 8000
    out = api.compress(d, 1)
    from tpubz.hostref.stream import compress as oracle

    assert out == oracle(d, 1)
    assert calls["full"] > 0 and calls["bwt"] == 0
