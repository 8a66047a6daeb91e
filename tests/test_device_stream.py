"""Device-path stream API: byte-identical to the host reference, and the
sharded/dry-run entry points execute on a virtual 8-device CPU mesh."""
import numpy as np
import pytest

from tpubz.hostref.stream import compress as host_compress, decompress


@pytest.mark.slow
def test_device_stream_byte_identical(rng, monkeypatch):
    # these cases are single-block on purpose; force them onto the device
    # path (by default tiny streams route to the CPU engine)
    monkeypatch.setenv("TPUBZ_MIN_DEVICE_BLOCKS", "1")
    from tpubz.stream.api import compress as dev_compress

    cases = [
        b"the quick brown fox jumps over the lazy dog\n" * 200,
        bytes(rng.integers(0, 256, 20000, dtype=np.uint8)),
        b"a" * 30000,
    ]
    for d in cases:
        c_dev = dev_compress(d, 1)
        assert c_dev == host_compress(d, 1)
        assert decompress(c_dev) == d


def test_dryrun_multichip_8():
    import sys, pathlib

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(8)


@pytest.mark.slow
def test_device_stream_byte_identical_level9_multiblock(rng):
    """Level-9 multi-block byte-identity: the shapes the bench runs are the
    shapes the tests prove. ~2.5MB mixed
    input -> 3 blocks at -9, through the full device path (transforms +
    device refinement + device payload packing)."""
    from tpubz.stream.api import compress as dev_compress

    d = (
        b"the quick brown fox jumps over the lazy dog\n" * 8000
        + bytes(rng.integers(0, 256, 1_000_000, dtype=np.uint8))
        + b"a" * 400_000
        + bytes(rng.integers(0, 16, 800_000, dtype=np.uint8))
    )
    c_dev = dev_compress(d, 9)
    assert c_dev == host_compress(d, 9)
    assert decompress(c_dev) == d


def test_devrefine_emit_matches_host_emit(rng):
    """encode_block_devrefine (device argmin/rfreq + device payload pack)
    must produce the same bytes as emit_block (native refine + host pack)
    for the same transform output."""
    from tpubz.block.encode import DeviceBlockEncoder, materialize

    enc = DeviceBlockEncoder(1)
    cases = [
        bytes(rng.integers(0, 256, 50_000, dtype=np.uint8)),
        b"abcd" * 20_000,
        bytes(rng.integers(0, 6, 99_000, dtype=np.uint8)),
    ]
    for d in cases:
        arr = np.frombuffer(d, np.uint8)
        t = enc.transform(arr)
        host_acc = DeviceBlockEncoder.emit_block(*materialize(t), crc=0x12345678)
        dev_acc = enc.encode_block_devrefine(t, crc=0x12345678)
        from tpubz.hostref.bitio import pack_bits

        assert pack_bits(*dev_acc.arrays()) == pack_bits(*host_acc.arrays())


@pytest.mark.slow
def test_lean_fused_graph_matches_full(rng, monkeypatch):
    """The lean host-refine fused graph (_stage_full_lean: no device
    freqs/hist, sort-based hi sidecar, host EOB re-stamp + bincount) must
    materialize to exactly the full graph's (key, syms, rle2_len, freqs,
    used) — including on inputs that produce rank-255 literals (symbol 256),
    which exercise the sidecar reconstruction."""
    from tpubz.block import encode as E

    monkeypatch.setattr(E, "_lean_ok", True)
    monkeypatch.setattr(E, "_full_ok", True)
    monkeypatch.setattr(E, "_split_ok", False)
    enc = E.DeviceBlockEncoder(1)
    cases = [
        rng.integers(0, 256, 80_000, dtype=np.uint8),
        np.tile(np.arange(256, dtype=np.uint8), 200),  # hits symbol 256
        np.frombuffer(b"abracadabra " * 5_000, np.uint8).copy(),
        np.zeros(1, np.uint8),
    ]
    for arr in cases:
        lean = E.materialize(enc.transform(arr, lean=True))
        full = E.materialize(enc.transform(arr, lean=False))
        assert lean[0] == full[0] and lean[2] == full[2]
        np.testing.assert_array_equal(
            lean[1][: lean[2]], full[1][: full[2]]
        )
        np.testing.assert_array_equal(lean[3], np.asarray(full[3]))
        np.testing.assert_array_equal(np.asarray(lean[4]), np.asarray(full[4]))


@pytest.mark.slow
def test_lean_stream_byte_identical(rng, monkeypatch):
    """Production host-refine stream through the lean fused graph: bytes
    must match the host reference exactly."""
    from tpubz.block import encode as E
    from tpubz.stream import api

    monkeypatch.setattr(E, "_lean_ok", True)
    d = (
        bytes(np.tile(np.arange(256, dtype=np.uint8), 300))
        + b"lorem ipsum dolor sit amet\n" * 8_000
        + bytes(rng.integers(0, 256, 120_000, dtype=np.uint8))
    )
    c_dev = api.compress(d, 1)
    assert c_dev == host_compress(d, 1)
    assert decompress(c_dev) == d


@pytest.mark.slow
def test_split_lean_route_matches_full(rng, monkeypatch):
    """The split lean chain (bwt / mtf / rle2c as separate launches — the
    production route, since launches pipeline on the relay) must materialize
    identically to the full fused graph."""
    from tpubz.block import encode as E

    monkeypatch.setattr(E, "_split_ok", True)
    monkeypatch.setattr(E, "_full_ok", True)
    enc = E.DeviceBlockEncoder(1)
    cases = [
        rng.integers(0, 256, 80_000, dtype=np.uint8),
        np.tile(np.arange(256, dtype=np.uint8), 200),  # hits symbol 256
        np.frombuffer(b"abracadabra " * 5_000, np.uint8).copy(),
        np.zeros(1, np.uint8),
    ]
    for arr in cases:
        lean = E.materialize(enc.transform(arr, lean=True))
        full = E.materialize(enc.transform(arr, lean=False))
        assert lean[0] == full[0] and lean[2] == full[2]
        np.testing.assert_array_equal(lean[1][: lean[2]], full[1][: full[2]])
        np.testing.assert_array_equal(lean[3], np.asarray(full[3]))
        np.testing.assert_array_equal(np.asarray(lean[4]), np.asarray(full[4]))


@pytest.mark.slow
def test_split_lean_stream_byte_identical(rng, monkeypatch):
    """Production host-refine stream through the split lean chain: bytes
    must match the host reference exactly."""
    from tpubz.block import encode as E
    from tpubz.stream import api

    monkeypatch.setattr(E, "_split_ok", True)
    d = (
        bytes(np.tile(np.arange(256, dtype=np.uint8), 300))
        + b"lorem ipsum dolor sit amet\n" * 8_000
        + bytes(rng.integers(0, 256, 120_000, dtype=np.uint8))
    )
    c_dev = api.compress(d, 1)
    assert c_dev == host_compress(d, 1)
    assert decompress(c_dev) == d


@pytest.mark.slow
def test_hybrid_cpu_steal_byte_identical(rng, monkeypatch):
    """With hybrid scheduling on, idle CPU workers steal whole blocks from
    the device queue through the native engine; the stream must stay
    byte-identical to the pure device route and the oracle."""
    from tpubz.hostref.stream import compress as oracle
    from tpubz.stream import api

    d = bytes(rng.integers(0, 80, 350_000, dtype=np.uint8))
    monkeypatch.setenv("TPUBZ_HYBRID_CPU", "2")
    hybrid = api.compress(d, 1)
    monkeypatch.setenv("TPUBZ_HYBRID_CPU", "0")
    pure = api.compress(d, 1)
    assert hybrid == pure == oracle(d, 1)


@pytest.mark.parametrize("route", ["bwt", "full"])
def test_device_straggler_duplicated_onto_cpu(rng, monkeypatch, route):
    """A wedged device block must not stall the stream: the ordered drain
    duplicates an overdue device head block onto a CPU worker and takes the
    first finisher (stream/api.py pop_head). Simulated by making the device
    transform sleep far longer than the whole CPU encode. The route is
    pinned (warm-stamp bwt route vs cold-stamp full route) so the guard is
    proven on BOTH dispatch paths regardless of machine cache state."""
    import time

    monkeypatch.setenv("TPUBZ_MIN_DEVICE_BLOCKS", "1")
    # conftest disables the hybrid pool; the guard under test needs it
    monkeypatch.setenv("TPUBZ_HYBRID_CPU", "8")
    import tpubz.stream.api as api
    from tpubz.block import encode as E
    from tpubz.block.encode import DeviceBlockEncoder

    monkeypatch.setattr(E, "_split_ok", route == "bwt")

    d = (
        b"straggler guard corpus " * 9000
        + bytes(rng.integers(0, 256, 120000, dtype=np.uint8))
    )
    slept = []

    def wedge(self, blk, **kw):
        slept.append(time.time())
        time.sleep(8.0)
        raise RuntimeError("device wedged")

    # reset persistent scheduler estimates so the wedged device still gets
    # its probe block (cadence None -> one in-flight probe)
    monkeypatch.setattr(api, "_cpu_ema_g", [0.0])
    api._dev_done_g.clear()
    monkeypatch.setattr(DeviceBlockEncoder, "transform_bwt", wedge)
    monkeypatch.setattr(DeviceBlockEncoder, "transform", wedge)
    t0 = time.time()
    out = api.compress(d, 1)
    wall = time.time() - t0
    assert slept, "device probe block never dispatched"
    assert decompress(out) == d
    assert out == host_compress(d, 1)
    # must have finished well before the 8s device wedge resolves
    assert wall < 7.0, f"stream waited on the wedged device ({wall:.1f}s)"


def test_strike_inflated_cadence_cannot_stall_the_stream(
    rng, monkeypatch, tmp_path
):
    """One awful phase can strike-inflate the persisted device cadence (4x
    penalty on a multi-second block -> 12.5 s). The straggler guard's grace
    is 2x cadence, so an unclamped grace would wait 25 s on one wedged
    re-probe block — measured as 24 MB hybrid trials running 10-12 s vs
    0.7 s CPU-only. The grace must be bounded by the CPU alternative's cost
    scale regardless of what the profile claims."""
    import time

    from tpubz.stream import rigprofile

    monkeypatch.setenv("TPUBZ_MIN_DEVICE_BLOCKS", "1")
    monkeypatch.setenv("TPUBZ_HYBRID_CPU", "8")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    import tpubz.stream.api as api
    from tpubz.block import encode as E
    from tpubz.block.encode import DeviceBlockEncoder

    monkeypatch.setattr(E, "_split_ok", True)
    monkeypatch.setattr(api, "_cpu_ema_g", [0.0])
    monkeypatch.setattr(api, "_reprobe_left_g", [1])
    api._dev_done_g.clear()
    rigprofile.reset_memo()
    rigprofile.update(
        cpu_block_s=0.08,
        dev_cadence_s={"bwt": 12.5},
        host_leg_s={"bwt": 0.02},
    )

    def wedge(self, blk, **kw):
        time.sleep(8.0)
        raise RuntimeError("device wedged")

    monkeypatch.setattr(DeviceBlockEncoder, "transform_bwt", wedge)
    monkeypatch.setattr(DeviceBlockEncoder, "transform", wedge)
    # >WINDOW blocks so the wedged re-probe block is drained mid-stream
    # (non-tail pop — the path whose grace the clamp bounds)
    d = b"grace clamp corpus " * 60_000 + bytes(
        rng.integers(0, 256, 800_000, dtype=np.uint8)
    )
    t0 = time.time()
    out = api.compress(d, 1)
    wall = time.time() - t0
    rigprofile.reset_memo()
    assert decompress(out) == d
    assert out == host_compress(d, 1)
    assert wall < 7.0, f"grace honored the absurd cadence ({wall:.1f}s)"


def test_device_fast_error_healed_by_cpu_twin(rng, monkeypatch):
    """A device block that FAILS INSTANTLY (within the grace window) must be
    healed by the CPU twin exactly like a straggler — a transient fast
    device error must not kill the stream. Also guards
    the dev_inflight leak: after the error heals, the scheduler must still
    be willing to dispatch (inflight count returned to zero)."""
    monkeypatch.setenv("TPUBZ_MIN_DEVICE_BLOCKS", "1")
    monkeypatch.setenv("TPUBZ_HYBRID_CPU", "8")
    import tpubz.stream.api as api
    from tpubz.block import encode as E
    from tpubz.block.encode import DeviceBlockEncoder

    monkeypatch.setattr(E, "_split_ok", True)
    d = b"fast error corpus " * 11000 + bytes(
        rng.integers(0, 256, 100000, dtype=np.uint8)
    )

    def boom(self, blk, **kw):
        raise RuntimeError("transient device error")

    monkeypatch.setattr(api, "_cpu_ema_g", [0.0])
    api._dev_done_g.clear()
    monkeypatch.setattr(DeviceBlockEncoder, "transform_bwt", boom)
    monkeypatch.setattr(DeviceBlockEncoder, "transform", boom)
    out = api.compress(d, 1)
    assert decompress(out) == d
    assert out == host_compress(d, 1)


def test_concurrent_compress_calls_thread_safe(rng):
    """Library users may call compress() from several threads at once; the
    scheduler's process-global estimate state (EMAs, profile, epochs) must
    tolerate that — outputs stay valid streams that round-trip. (Per-stream
    stats/events can interleave — only correctness is asserted here.)"""
    from concurrent.futures import ThreadPoolExecutor

    from tpubz.stream.api import compress as dev_compress

    inputs = [
        (b"alpha beta gamma " * 20000
         + bytes(rng.integers(0, 256, 150_000, dtype=np.uint8)))
        for _ in range(4)
    ]
    with ThreadPoolExecutor(4) as ex:
        outs = list(ex.map(lambda d: dev_compress(d, 5), inputs))
    for d, z in zip(inputs, outs):
        assert decompress(z) == d
