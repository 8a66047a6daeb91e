"""Per-stage host-reference tests: RLE1, BWT, MTF+RLE2, Huffman."""
import numpy as np
import pytest

from tpubz.hostref.bwt import bwt_decode, bwt_decode_fast, bwt_encode
from tpubz.hostref.huffman import (
    build_decode_table,
    canonical_codes,
    code_lengths_from_freqs,
)
from tpubz.hostref.mtf_rle2 import mtf_rle2_decode, mtf_rle2_encode, zero_run_digits
from tpubz.hostref.rle1 import rle1_decode, rle1_encode, split_blocks


RLE1_CASES = [
    b"",
    b"a",
    b"aaa",
    b"aaaa",
    b"aaaaa",
    b"a" * 255,
    b"a" * 256,
    b"a" * 300,
    b"abcd" * 100 + b"e" * 600,
]


@pytest.mark.parametrize("case", RLE1_CASES)
def test_rle1_roundtrip(case):
    arr = np.frombuffer(case, np.uint8)
    out, seg_out, seg_in = rle1_encode(arr)
    assert bytes(rle1_decode(out)) == case


def test_rle1_random_roundtrip(rng):
    for lo, hi in ((0, 4), (0, 256)):
        d = bytes(rng.integers(lo, hi, 20000, dtype=np.uint8))
        out, _, _ = rle1_encode(np.frombuffer(d, np.uint8))
        assert bytes(rle1_decode(out)) == d


def test_rle1_feed_matches_eager_scan(rng):
    """The streaming windowed producer (Rle1Feed) must yield exactly the
    eager whole-input scan's blocks and bytes — including when runs span
    window boundaries, when a window holds zero complete blocks (heavy-RLE
    data forcing window growth), and at EOF tail-join."""
    from tpubz.format.constants import block_budget
    from tpubz.hostref.rle1 import Rle1Feed, rle1_blocks

    budget = block_budget(1)
    cases = {
        "random": rng.integers(0, 256, 1_500_000, dtype=np.uint8),
        "text": np.frombuffer(
            (b"the quick brown fox " * 80_000)[:1_500_000], np.uint8
        ),
        "zeros": np.zeros(1_500_000, np.uint8),
        "runs": np.repeat(
            rng.integers(0, 4, 20_000), rng.integers(1, 300, 20_000)
        ).astype(np.uint8),
        "tiny": np.frombuffer(b"abc", np.uint8),
        "empty": np.zeros(0, np.uint8),
    }
    for name, arr in cases.items():
        out_e, blocks_e = rle1_blocks(arr, budget)
        for window in (1 << 17, 1 << 19):
            feed = Rle1Feed(arr, budget, window=window)
            blocks_f = list(feed)
            assert blocks_f == blocks_e, (name, window)
            if blocks_e:
                hi = blocks_e[-1][1]
                assert np.array_equal(feed.out[:hi], out_e[:hi]), (
                    name,
                    window,
                )
            assert feed.total_estimate() == len(blocks_e)


def test_rle1_feed_surfaces_scan_errors():
    """A failure inside the background scan thread must raise in the
    consumer's iteration, not hang it or vanish."""
    from tpubz.hostref.rle1 import Rle1Feed

    feed = Rle1Feed(np.zeros(10, np.uint8), budget=100)
    list(feed)  # drain the real scan first
    feed._done = False
    feed._error = RuntimeError("boom")
    feed._blocks = []
    feed._done = True
    with pytest.raises(RuntimeError, match="boom"):
        list(feed)


def test_rle1_block_split_preserves_data(rng):
    d = bytes(rng.integers(0, 4, 30000, dtype=np.uint8))
    arr = np.frombuffer(d, np.uint8)
    out, seg_out, seg_in = rle1_encode(arr)
    for budget in (10, 100, 5000):
        blocks = split_blocks(out, seg_out, seg_in, budget)
        dec = b"".join(bytes(rle1_decode(out[o0:o1])) for o0, o1, _, _ in blocks)
        assert dec == d
        # raw ranges tile the input exactly (needed for per-block CRC)
        assert blocks[0][2] == 0 and blocks[-1][3] == len(d)
        for (a, b) in zip(blocks, blocks[1:]):
            assert a[3] == b[2]


def test_bwt_matches_naive(rng):
    def naive(d):
        n = len(d)
        rots = sorted(range(n), key=lambda i: bytes(d[i:]) + bytes(d[:i]))
        return rots.index(0), np.array([d[(i - 1) % n] for i in rots], np.uint8)

    for case in (b"banana", b"mississippi", b"abababab", b"aaa",
                 bytes(rng.integers(0, 256, 500, dtype=np.uint8))):
        d = np.frombuffer(case, np.uint8)
        k, last = bwt_encode(d)
        nk, nlast = naive(d)
        assert (k, bytes(last)) == (nk, bytes(nlast))


def test_bwt_inverse(rng):
    for case in (b"banana", b"ab" * 300, bytes(rng.integers(0, 8, 5000, dtype=np.uint8))):
        d = np.frombuffer(case, np.uint8)
        k, last = bwt_encode(d)
        assert bytes(bwt_decode(k, last)) == case
        assert bytes(bwt_decode_fast(k, last)) == case


def test_zero_run_digits_bijective():
    def undo(ds):
        n, m = 0, 1
        for dd in ds:
            n += m * (dd + 1)
            m <<= 1
        return n

    for n in list(range(1, 300)) + [1000, 65535, 900000]:
        assert undo(zero_run_digits(n)) == n


def test_mtf_rle2_roundtrip(rng):
    for case in (b"banana", b"\x00" * 1000, bytes(rng.integers(0, 256, 4000, dtype=np.uint8))):
        d = np.frombuffer(case, np.uint8)
        rle2, freqs, used = mtf_rle2_encode(d)
        assert int(freqs.sum()) == rle2.size
        assert rle2[-1] == int(used.sum()) + 1  # EOB last
        dec = mtf_rle2_decode(rle2, np.flatnonzero(used).astype(np.uint8), len(case))
        assert bytes(dec) == case


def test_code_lengths_depth_cap():
    # pathological exponential freqs force the flattening retry
    freqs = np.array([1 << min(i, 40) for i in range(30)], dtype=np.int64)
    lens = code_lengths_from_freqs(freqs, 30)
    assert lens.max() <= 17
    assert lens.min() >= 1
    # Kraft inequality holds (complete prefix code)
    assert np.isclose(np.sum(2.0 ** -lens), 1.0)


def test_canonical_code_prefix_free():
    lens = np.array([3, 3, 2, 4, 4, 2])
    codes = canonical_codes(lens)
    bits = [format(c, f"0{l}b") for c, l in zip(codes, lens)]
    for i, a in enumerate(bits):
        for j, b in enumerate(bits):
            if i != j:
                assert not b.startswith(a)


def test_decode_table_roundtrip(rng):
    lens = np.array([2, 3, 3, 4, 4, 4, 4, 2])
    codes = canonical_codes(lens)
    t = build_decode_table(lens)
    from tpubz.hostref.bitio import BitAccum, BitReader
    from tpubz.hostref.huffman import huffman_decode_payload

    syms = rng.integers(0, 7, 500)  # exclude 7, use as EOB
    acc = BitAccum()
    for s in syms:
        acc.put(int(codes[s]), int(lens[s]))
    acc.put(int(codes[7]), int(lens[7]))  # EOB
    payload, _ = acc.pack()
    br = BitReader(payload)
    sel = np.zeros(1000, dtype=np.int64)
    out = huffman_decode_payload(br, [t], sel, eob=7)
    assert list(out) == list(syms)


def test_block_splits_match_c_bzip2(rng):
    """Block cut points replicate C bzip2's ADD_CHAR_TO_BLOCK budget rule
    exactly (check before each input byte, whole-segment flushes, EOF tail
    join): per-block raw sizes of our split == C's, which pins the
    <=-C-size guarantee on multi-block inputs."""
    import subprocess

    from tpubz.format.constants import block_budget
    from tpubz.hostref.rle1 import rle1_blocks
    from tpubz.native import decode_block_native, get_lib
    from tpubz.stream.decode import find_magic_bit_offsets

    if get_lib() is None:
        pytest.skip("native lib needed to parse C block structure")
    cases = [
        bytes(rng.integers(0, 4, 150_000, dtype=np.uint8)),
        bytes(rng.integers(0, 256, 250_000, dtype=np.uint8)),
        (b"ab" * 50 + b"x" * 300 + bytes(rng.integers(0, 8, 1000, dtype=np.uint8))) * 200,
        b"a" * 250_000,
    ]
    for d in cases:
        ref = subprocess.run(
            ["bzip2", "-1", "-c"], input=d, capture_output=True
        ).stdout
        arr = np.frombuffer(ref, np.uint8)
        c_sizes = [
            decode_block_native(arr, int(c) + 48, 1)[0].size
            for c in find_magic_bit_offsets(ref)
            if c >= 32
        ]
        _, blocks = rle1_blocks(np.frombuffer(d, np.uint8), block_budget(1))
        ours = [i1 - i0 for (_, _, i0, i1) in blocks]
        assert ours == c_sizes, (ours, c_sizes)


def test_size_never_worse_regression():
    """Seeds that previously produced output 1-2 bytes larger than C bzip2
    (block split divergence on low-entropy multi-block input at -1)."""
    import subprocess

    from tpubz.hostref.stream import compress

    for seed in (3, 39):
        r = np.random.default_rng(seed)
        d = bytes(r.integers(0, 4, 150_000, dtype=np.uint8))
        ours = len(compress(d, 1))
        theirs = len(
            subprocess.run(["bzip2", "-1", "-c"], input=d, capture_output=True).stdout
        )
        assert ours <= theirs, (seed, ours, theirs)


def test_rle1_decode_mirrors_native_semantics(rng):
    """hostref rle1_decode must agree with the native fused decoder's RLE1
    semantics (sequential run counting with reset after each expansion) on
    arbitrary -- including malformed -- inputs."""

    def native_semantics(d):
        out = []
        run = 0
        prev = -1
        expect_count = False
        for b in d:
            if expect_count:
                out.extend([prev] * b)
                expect_count = False
                run = 0
                continue
            out.append(b)
            if run > 0 and b == prev:
                run += 1
            else:
                run = 1
                prev = b
            if run == 4:
                expect_count = True
        return bytes(out)

    cases = [
        b"aaaa",  # trailing 4-run, count byte missing (malformed)
        b"aaaaa",
        b"aaaaaa\x01",
        b"baaaa",
        b"aaaa\x00aaaa\x02",
        b"\xff" * 9,
    ]
    for _ in range(30):
        n = int(rng.integers(0, 64))
        cases.append(bytes(rng.integers(0, 3, n, dtype=np.uint8)))
    for d in cases:
        got = bytes(rle1_decode(np.frombuffer(d, np.uint8)))
        assert got == native_semantics(d), d
