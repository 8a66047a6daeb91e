"""chip_smoke.py's stream phase on the CPU: every entry point at level 1 on
a small corpus, byte-identical to compress_cpu, each hybrid-off run with
every block on the (CPU) device."""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_stream_phase_level1_small_corpus(capsys):
    chip_smoke.phase_stream(mb=1, level=1, low_level=1)
    out = capsys.readouterr().out
    assert out.count("== compress_cpu -1") == 7
    assert "round trip ok" in out
    assert "tpubz.decompress -1: == corpus" in out


def test_route_pins_and_restores(monkeypatch):
    """_route sets exactly the pinned variables and restores the caller's
    environment and stage afterwards."""
    from tpubz.stream import api

    monkeypatch.setenv("TPUBZ_HYBRID_CPU", "0")
    monkeypatch.delenv("TPUBZ_SPLIT", raising=False)
    before = api.DEVICE_STAGE
    with chip_smoke._route(chip_smoke.BWT_ONLY):
        assert os.environ["TPUBZ_SPLIT"] == "1"
        assert api.DEVICE_STAGE == "bwt"
    with chip_smoke._route({}):
        assert "TPUBZ_HYBRID_CPU" not in os.environ
    assert os.environ["TPUBZ_HYBRID_CPU"] == "0"
    assert "TPUBZ_SPLIT" not in os.environ
    assert api.DEVICE_STAGE == before
