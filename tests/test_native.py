"""Native C++ engine vs the pure-python oracle: bit-identical behavior."""
import os
import numpy as np
import pytest

from tpubz.native import refine_stream_native
import tpubz.hostref.huffman as H


def test_native_lib_builds_when_toolchain_present():
    """A C++ source error must FAIL the suite, not silently route production
    onto the (bit-identical but much slower) numpy fallbacks: when g++
    exists, the native lib must build and load."""
    import shutil

    from tpubz.native import get_lib

    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    assert get_lib() is not None, (
        "native lib failed to build/load with g++ present — check compile "
        "errors in tpubz/native/*.cpp"
    )


@pytest.fixture(scope="module")
def native_available():
    if refine_stream_native(np.array([0, 1, 2], np.uint16), 3, 8) is None:
        pytest.skip("native toolchain unavailable")


def _python_refine(rle2, alpha):
    freqs = np.bincount(rle2, minlength=258).astype(np.int64)
    return H.assign_selectors_and_lengths(np.asarray(rle2, np.int64), freqs, alpha)


def test_refine_native_matches_python(rng, native_available):
    for _ in range(6):
        alpha = int(rng.integers(3, 259))
        rle2_len = int(rng.integers(3, 30000))
        # skewed symbol distribution (zipf-ish) to exercise tree shapes
        p = 1.0 / (np.arange(alpha) + 1.0)
        p /= p.sum()
        rle2 = rng.choice(alpha, size=rle2_len, p=p).astype(np.uint16)
        rle2[-1] = alpha - 1  # EOB-ish tail
        sel_p, len_p, tc_p = _python_refine(rle2, alpha)
        nat = refine_stream_native(rle2, alpha, H.huffman_iters())
        sel_n, len_n, tc_n = nat
        assert tc_n == tc_p
        assert list(sel_n) == list(sel_p)
        assert np.array_equal(len_n[:tc_n], len_p[:tc_n])


def test_decode_rejects_oversubscribed_code_lengths(native_available):
    """A crafted block whose Huffman lengths oversubscribe the code space
    (all symbols length 1) must fail cleanly with -5, not overflow the
    12-bit LUT fill (previously heap corruption via decode_block_native)."""
    from tpubz.hostref.bitio import BitAccum
    from tpubz.native import decode_block_native

    acc = BitAccum()
    acc.put(0, 32)       # block CRC
    acc.put(0, 1)        # randomized flag
    acc.put(0, 24)       # BWT key
    acc.put(0x8000, 16)  # symbol map level 1: group 0 present
    acc.put(0x8000, 16)  # group 0: symbol 0 present -> nsyms=1, alpha=3
    acc.put(2, 3)        # table count
    acc.put(1, 15)       # selector count
    acc.put(0, 1)        # selector 0 unary-coded (table 0)
    for _ in range(2):   # two tables
        acc.put(1, 5)    # origin length 1
        for _ in range(3):
            acc.put(0, 1)  # no delta: three symbols all length 1 (3 > 2^1)
    payload, nbits = acc.pack()
    arr = np.frombuffer(payload + b"\x00" * 16, np.uint8)
    with pytest.raises(ValueError, match="code length"):
        decode_block_native(arr, 0, 1)


def test_stream_identical_with_and_without_native(rng, monkeypatch):
    from tpubz.hostref.stream import compress

    d = bytes(rng.integers(0, 100, 30000, dtype=np.uint8))
    with_native = compress(d, 1)
    import tpubz.native as N

    monkeypatch.setattr(N, "refine_stream_native", lambda *a, **k: None)
    without = compress(d, 1)
    assert with_native == without


def test_native_bwt_matches_hostref(rng):
    """SA-IS rotation BWT (bwt.cpp) == hostref prefix-doubling BWT, key and
    last column, across entropy regimes incl. the periodic tie cases the
    rotation-order reversal exists for."""
    from tpubz.hostref.bwt import bwt_encode
    from tpubz.native import bwt_native

    cases = [
        rng.integers(0, 256, 10000).astype(np.uint8),
        rng.integers(0, 4, 10000).astype(np.uint8),
        np.tile(np.frombuffer(b"ab", np.uint8), 5000),        # period 2 | n
        np.tile(np.frombuffer(b"abc", np.uint8), 3333),       # period 3 | n
        np.full(8192, 65, np.uint8),                          # period 1
        np.tile(np.frombuffer(b"ab", np.uint8), 5000)[:9999], # p does not | n
        np.frombuffer(b"a", np.uint8),
        np.frombuffer(b"ba", np.uint8),
        np.frombuffer(b"banana", np.uint8),
    ]
    z = np.zeros(10000, np.uint8)
    z[::7] = rng.integers(0, 256, z[::7].size)
    cases.append(z)
    for i, d in enumerate(cases):
        res = bwt_native(d)
        if res is None:
            import pytest

            pytest.skip("native lib unavailable")
        k0, l0 = bwt_encode(d)
        k1, l1 = res
        assert k0 == k1, f"case {i}: key {k0} != {k1}"
        assert np.array_equal(np.asarray(l0), l1), f"case {i}: last column"


def test_native_bwt_fuzz_periodic_regimes(rng):
    """Mini-fuzz of the least-rotation + prime-divisor-period + tie-class
    key derivation against the oracle: periodic, periodic-with-tail, and
    near-periodic (one flipped byte) inputs are exactly the shapes where a
    wrong minimal rotation or period would corrupt key/last."""
    from tpubz.hostref.bwt import bwt_encode
    from tpubz.native import bwt_native

    if bwt_native(np.frombuffer(b"ab", np.uint8)) is None:
        import pytest

        pytest.skip("native lib unavailable")
    for trial in range(300):
        kind = trial % 5
        if kind == 0:
            p = int(rng.integers(1, 7))
            a = np.tile(rng.integers(0, 3, p), int(rng.integers(2, 40)))
        elif kind == 1:  # periodic plus tail: period must NOT divide n
            p = int(rng.integers(1, 7))
            a = np.concatenate(
                [
                    np.tile(rng.integers(0, 3, p), int(rng.integers(2, 40))),
                    rng.integers(0, 3, int(rng.integers(1, p + 1))),
                ]
            )
        elif kind == 2:  # near-periodic: one byte flipped
            p = int(rng.integers(1, 8))
            a = np.tile(rng.integers(0, 4, p), int(rng.integers(3, 40))).copy()
            a[int(rng.integers(0, a.size))] ^= 1
        elif kind == 3:
            a = rng.integers(0, 2, int(rng.integers(1, 300)))
        else:
            a = rng.integers(0, 256, int(rng.integers(1, 300)))
        a = a.astype(np.uint8)
        k0, l0 = bwt_encode(a)
        k1, l1 = bwt_native(a)
        assert k0 == k1 and np.array_equal(np.asarray(l0), l1), (
            kind,
            a[:32].tolist(),
        )


def test_native_bwt_deep_recursion_fibonacci(rng):
    """Fibonacci words maximize SA-IS recursion depth (every level keeps
    ~1/phi of its LMS structure), pinning the arena-scratch recursion path
    (bwt.cpp) level by level; sizes straddle the u16/u32 reduced-string
    dispatch at names >= 2^15."""
    from tpubz.hostref.bwt import bwt_encode
    from tpubz.native import bwt_native

    if bwt_native(np.frombuffer(b"ab", np.uint8)) is None:
        import pytest

        pytest.skip("native lib unavailable")
    a, b = b"a", b"b"
    while len(a) < 200_000:
        a, b = a + b, a
    fib = np.frombuffer(a, np.uint8)
    for size in (1000, 30000, len(fib)):
        d = fib[:size]
        k0, l0 = bwt_encode(d)
        k1, l1 = bwt_native(d)
        assert k0 == k1 and np.array_equal(np.asarray(l0), l1), size
        # noisy variant: break the pure structure to vary names/m ratios
        e = d.copy()
        e[rng.integers(0, size, 8)] ^= 3
        k0, l0 = bwt_encode(e)
        k1, l1 = bwt_native(e)
        assert k0 == k1 and np.array_equal(np.asarray(l0), l1), size


def test_native_block_transform_matches_hostref(rng):
    from tpubz.hostref.bwt import bwt_encode
    from tpubz.hostref.mtf_rle2 import mtf_rle2_encode
    from tpubz.native import block_transform_native

    for d in (
        rng.integers(0, 256, 50000).astype(np.uint8),
        rng.integers(0, 3, 50000).astype(np.uint8),
        np.frombuffer(open("/etc/services", "rb").read()[:40000], np.uint8),
    ):
        res = block_transform_native(d)
        if res is None:
            import pytest

            pytest.skip("native lib unavailable")
        key, rle2, freqs, used = res
        k0, l0 = bwt_encode(d)
        rle0, f0, u0 = mtf_rle2_encode(l0)
        assert key == k0
        assert np.array_equal(rle0.astype(np.uint16), rle2)
        assert np.array_equal(f0.astype(np.uint32), freqs)
        assert np.array_equal(u0, used)


def test_cpu_engine_stream_identical(rng, sys_bunzip2):
    """The threaded CPU engine (native transform + native refine/emit) is
    byte-identical to the pure-python oracle, multi-block, and decodable by
    system bunzip2."""
    from tpubz.hostref.stream import compress as oracle
    from tpubz.stream.api import compress_cpu

    text = open("/etc/services", "rb").read() * 3
    d = (
        text[:150_000]
        + bytes(rng.integers(0, 256, 80_000, dtype=np.uint8))
        + b"A" * 50_000
    )
    c = compress_cpu(d, 1)  # level 1 -> multiple blocks
    assert c == oracle(d, 1)
    assert sys_bunzip2(c) == d


def test_cpu_engine_streaming_file(rng, tmp_path, sys_bunzip2, monkeypatch):
    """compress_stream's host branch routes through the threaded CPU
    pipeline and stays byte-identical to the one-shot path."""
    import io

    from tpubz.stream.api import compress_cpu
    from tpubz.stream import files as F
    from tpubz.stream.api import _HostFallbackEncoder

    monkeypatch.setattr(
        "tpubz.stream.api._encoder", lambda level: _HostFallbackEncoder(level)
    )
    monkeypatch.setattr(F, "WINDOW_BYTES", 300_000)
    d = bytes(rng.integers(0, 64, 900_000, dtype=np.uint8))
    buf = io.BytesIO()
    F.compress_stream(io.BytesIO(d), buf, 1)
    assert buf.getvalue() == compress_cpu(d, 1)
    assert sys_bunzip2(buf.getvalue()) == d


def test_foreign_build_key_is_rebuilt(tmp_path, monkeypatch):
    """A library built for another host's CPU is never loaded here: its
    build key differs, so this host compiles its own (the stale files
    stay untouched and unused)."""
    import ctypes
    import shutil

    from tpubz import native

    for s in native._SOURCES:
        shutil.copy(os.path.join(native._HERE, s), tmp_path)
    monkeypatch.setattr(native, "_HERE", str(tmp_path))
    real_cpu = native._host_cpu_id
    monkeypatch.setattr(native, "_host_cpu_id", lambda: "another host's CPU")
    foreign = native.lib_path()
    monkeypatch.setattr(native, "_host_cpu_id", real_cpu)
    for stale in (foreign, str(tmp_path / "libtpubz_native.so")):
        with open(stale, "wb") as f:
            f.write(b"not a library for this host")
    built = native._build()
    assert built == native.lib_path() != foreign
    ctypes.CDLL(built)  # a real library for this host, not the stale bytes
    assert native._build() == built  # found again, not rebuilt
