"""Whole-stream decompression with block-parallel structure.

The reference decodes strictly serially because the stream has no block
index and blocks are bit-aligned (src/compression/decompress.rs:3-4). We
instead scan the bitstream for 48-bit block magics at every bit offset
(vectorized sliding window), then decode blocks independently — the pbzip2
strategy (SURVEY.md §2 row 11): a magic can in principle occur inside a
payload, so candidates are validated by attempting decode and checking the
block CRC, falling back to serial continuation on a false positive.
"""
from __future__ import annotations

import os

import numpy as np

# The decode leg is host CPU work. A device inverse BWT exists
# (tpubz/kernels/ibwt.py, correctness-tested) but is not routed: whether its
# gathers beat the native segmented chase on a given device is an open
# measurement.
from ..format.constants import BLOCK_MAGIC, FOOTER_MAGIC, STREAM_MAGIC
from ..format.crc import block_crc, stream_crc_fold
from ..hostref.bitio import BitReader
from ..hostref.block import decode_block

# phase attribution for the most recent stream decode (bench.py prints this
# next to the encode phase profile): which engine decoded, how many blocks,
# and how many pre-decoded in parallel vs fell to the serial walk
last_decode_stats: dict = {}


def find_magic_bit_offsets(data: bytes, magic: int = BLOCK_MAGIC) -> np.ndarray:
    """All bit offsets where the 48-bit magic occurs (native scan with a
    vectorized numpy fallback)."""
    arr = np.frombuffer(data, dtype=np.uint8)
    if arr.size < 6:
        return np.zeros(0, dtype=np.int64)
    from ..native import find_magic_native

    nat = find_magic_native(arr, magic)
    if nat is not None:
        return nat
    # 56-bit windows starting at each byte: enough to cover any bit shift
    n = arr.size
    w = np.zeros(n, dtype=np.uint64)
    for k in range(7):
        chunk = np.zeros(n, dtype=np.uint64)
        chunk[: n - k] = arr[k:].astype(np.uint64)
        w = (w << np.uint64(8)) | chunk
    hits = []
    m = np.uint64(magic)
    mask48 = np.uint64((1 << 48) - 1)
    for shift in range(8):
        # bits [shift, shift+48) of each 56-bit window
        vals = (w >> np.uint64(8 - shift)) & mask48
        hit = np.flatnonzero(vals == m)
        # window at byte i starting bit = 8*i + shift
        hits.append(hit * 8 + shift)
    out = np.concatenate(hits)
    out.sort()
    # drop offsets whose 48 bits run past the buffer
    return out[out + 48 <= n * 8]


def decompress(data: bytes) -> bytes:
    """Decode a .bz2 file, including concatenated streams (like bunzip2:
    `cat a.bz2 b.bz2` decodes to the concatenation)."""
    out = []
    pos = 0
    while pos < len(data):
        chunk, consumed = _decompress_one(data[pos:])
        out.append(chunk)
        # streams are byte-padded; another stream may follow immediately
        pos += consumed
        if pos >= len(data) or data[pos : pos + 3] != b"BZh":
            break
    return b"".join(out)


def _decompress_one(data: bytes) -> tuple[bytes, int]:
    """Decode one .bz2 stream, validating per-block and stream CRCs.
    Returns (raw bytes, bytes consumed incl. padding).

    Native path: all candidate block starts decode concurrently on a thread
    pool (the native decoder is GIL-free), then results are stitched in
    stream order; a magic hit inside a payload simply yields a wasted decode
    that the stitch walk never consumes. Python fallback decodes serially.
    """
    br = BitReader(data)
    magic = bytes(br.read(8) for _ in range(3))
    if magic != STREAM_MAGIC:
        raise ValueError("not a bzip2 stream")
    level = br.read(8) - 0x30
    if not 1 <= level <= 9:
        raise ValueError("invalid block size digit")

    from ..native import decode_block_native, get_lib

    arr = np.frombuffer(data, dtype=np.uint8)
    use_native = get_lib() is not None
    futures: dict[int, object] = {}
    ex_box: list = [None]
    walk_pos = [32]  # shared with the scanner: skip already-walked blocks
    if use_native:
        # The magic scan + pre-decode submission run on a SIDE thread while
        # the stitch walk below starts decoding immediately: the walk's
        # first serial block decodes ride inside the scan instead of after
        # it. Candidates the walk has
        # already passed are not submitted (their pre-decode would be
        # pure waste); dict reads/writes are GIL-atomic.
        #
        # Bound the candidate scan at this stream's footer: blocks beyond
        # the first footer-magic hit belong to subsequent concatenated
        # streams (or are payload false positives) — pre-decoding them with
        # this stream's level wastes threads and made concatenations
        # O(streams x size). A false-positive footer hit only prunes
        # pre-decodes; the serial walk below still decodes those blocks.
        import threading
        from concurrent.futures import ThreadPoolExecutor

        from ..native import find_magic2_native

        def try_decode(c):
            try:
                return decode_block_native(arr, c + 48, level)
            except ValueError:
                return None

        scan_err: list = [None]

        def scan_and_submit():
            try:
                both = find_magic2_native(arr, BLOCK_MAGIC, FOOTER_MAGIC)
                if both is not None:
                    blocks_hits, footers = both
                else:
                    blocks_hits = find_magic_bit_offsets(data)
                    footers = find_magic_bit_offsets(data, FOOTER_MAGIC)
                candidates = [int(c) for c in blocks_hits if c >= 32]
                if footers.size:
                    cutoff = int(footers[0])
                    candidates = [c for c in candidates if c < cutoff]
                pending = [c for c in candidates if c >= walk_pos[0]]
                if len(pending) > 1:
                    # 2x cores saturates the latency-bound chase; wider
                    # pools measured ~5% slower on the 4-core rig (32
                    # threads pay scheduling churn). TPUBZ_DECODE_POOL
                    # overrides for unusual rigs.
                    width = int(
                        os.environ.get(
                            "TPUBZ_DECODE_POOL", 2 * (os.cpu_count() or 4)
                        )
                    )
                    ex_box[0] = ThreadPoolExecutor(
                        min(max(width, 1), len(pending))
                    )
                    for c in pending:
                        if c >= walk_pos[0]:
                            futures[c] = ex_box[0].submit(try_decode, c)
            except BaseException as e:
                # surfaced by the walk loop: before this moved off the main
                # thread a scan failure propagated to the caller — it still
                # must (a dead thread would otherwise silently degrade the
                # decode to serial and mask a real bug)
                scan_err[0] = e

        scan_thread = threading.Thread(target=scan_and_submit, daemon=True)
        scan_thread.start()

    try:
        s_crc = 0
        parts: list[np.ndarray] = []
        pos = 32  # bit position of the next expected block/footer magic
        while True:
            if use_native and scan_err[0] is not None:
                raise scan_err[0]
            walk_pos[0] = pos
            first48 = BitReader(data)
            first48.pos = pos
            tag = first48.read(48)
            if tag == FOOTER_MAGIC:
                stored = first48.read(32)
                if stored != s_crc:
                    raise ValueError(
                        f"stream CRC mismatch: stream says {stored:#010x}, got {s_crc:#010x}"
                    )
                pos = first48.pos
                break
            if tag != BLOCK_MAGIC:
                raise ValueError("invalid block header magic")
            fut = futures.get(pos)
            res = fut.result() if fut is not None else None
            if res is not None:
                raw, end_bit, blk_crc, actual = res
            elif use_native:
                raw, end_bit, blk_crc, actual = decode_block_native(
                    arr, pos + 48, level
                )
            else:
                raw, blk_crc = decode_block(first48, level)
                end_bit = first48.pos
                actual = block_crc(raw)
            if actual != blk_crc:
                raise ValueError(
                    f"block CRC mismatch: stream says {blk_crc:#010x}, got {actual:#010x}"
                )
            s_crc = stream_crc_fold(s_crc, blk_crc)
            parts.append(raw)
            pos = end_bit
    finally:
        if use_native:
            walk_pos[0] = 1 << 62  # stop the scanner submitting anything new
            scan_thread.join()
        if ex_box[0] is not None:
            # stop dispatching wasted pre-decodes once the walk is done
            for f in futures.values():
                f.cancel()
            ex_box[0].shutdown(wait=False)
    if use_native and scan_err[0] is not None:
        # a scan failure that landed after the walk's last check still
        # surfaces (pre-thread behavior: it propagated to the caller)
        raise scan_err[0]
    last_decode_stats.clear()
    last_decode_stats.update(
        engine="native" if use_native else "python",
        blocks=len(parts),
        parallel_candidates=len(futures),
    )
    # join over memoryviews: one output copy instead of two (per-part
    # tobytes + join)
    return b"".join(memoryview(p) for p in parts), (pos + 7) // 8


def split_blocks_for_parallel_decode(data: bytes) -> list[tuple[int, int]]:
    """Candidate (start_bit, end_bit) spans for data-parallel block decode.

    Magic hits inside payloads are possible; callers decode each span and
    fall back to serial continuation (``decompress``) on CRC/structure
    failure. End bit of a span = start of the next candidate (a block decoder
    stops at its EOB regardless of trailing slack).
    """
    candidates = [int(c) for c in find_magic_bit_offsets(data) if c >= 32]
    total_bits = len(data) * 8
    spans = []
    for i, c in enumerate(candidates):
        end = candidates[i + 1] if i + 1 < len(candidates) else total_bits
        spans.append((c, end))
    return spans
