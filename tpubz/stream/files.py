"""Streaming file compression: bounded memory for arbitrarily large inputs.

Greedy block splitting is prefix-stable: a block's boundary depends only on
bytes before it. So the stream compressor reads a window, emits every
complete block except the last, and carries the tail (plus any run that
could extend across the boundary) into the next window. The .bz2 stream is
written incrementally with the same bit-splice semantics as the in-memory
path (header first, blocks at bit granularity, footer + stream CRC last).
"""
from __future__ import annotations

import io
import os

import numpy as np

from ..format.constants import FOOTER_MAGIC, STREAM_MAGIC, block_budget
from ..format.crc import block_crc, stream_crc_fold
from ..hostref.bitio import BitAccum, pack_bits
from ..hostref.rle1 import rle1_blocks

WINDOW_BYTES = int(os.environ.get("TPUBZ_STREAM_WINDOW", str(32 * 1024 * 1024)))


class _BitSink:
    """Incremental MSB-first bit writer to a byte stream."""

    def __init__(self, fout):
        self.fout = fout
        self._rem_val = 0  # pending bits (< 8)
        self._rem_bits = 0
        self.total_bits = 0

    def write_fields(self, vals: np.ndarray, bits: np.ndarray) -> None:
        acc = BitAccum()
        acc.extend(np.asarray(vals, np.uint32), np.asarray(bits, np.int64))
        self.write_chunk(*acc.pack())

    def write_chunk(self, data: bytes, nbits: int) -> None:
        """Write a byte-padded bit chunk (pad bits must be zero), carrying
        the sub-byte remainder between calls — blocks arrive pre-packed
        from the worker threads and splice here at byte speed."""
        from ..hostref.bitio import splice_byte_chunks

        pieces = []
        if self._rem_bits:
            pieces.append(
                (
                    bytes([(self._rem_val << (8 - self._rem_bits)) & 0xFF]),
                    self._rem_bits,
                )
            )
        pieces.append((data, nbits))
        payload, total = splice_byte_chunks(pieces)
        self.total_bits += nbits
        full = total // 8
        rem = total - full * 8
        arr = np.frombuffer(payload, np.uint8)
        self.fout.write(arr[:full].tobytes())
        self._rem_val = (int(arr[full]) >> (8 - rem)) if rem else 0
        self._rem_bits = rem

    def close(self) -> None:
        if self._rem_bits:
            self.fout.write(bytes([(self._rem_val << (8 - self._rem_bits)) & 0xFF]))
            self._rem_bits = 0


class _WindowItems:
    """(blk_view, raw_view) items over a file read in windows, feeding ONE
    persistent block-results pipeline. The previous shape — a fresh
    pipeline per window — paid pool spin-up, engine re-probing, and a full
    pipeline fill+drain at EVERY window boundary plus a serial in-window
    RLE1 scan, and ran at about half the in-memory path's rate. Block cuts
    are prefix-stable (a boundary depends only on bytes to its left), so
    each window keeps every complete block
    except the last, whose raw tail becomes the next window's carry.
    Memory stays bounded: views pin at most the windows holding the
    pipeline's <= WINDOW in-flight blocks."""

    def __init__(self, fin, budget: int, first_data: np.ndarray | None = None):
        self._fin = fin
        self._budget = budget
        self._first = first_data
        self._emitted = 0
        self._raw_seen = 0  # raw bytes covered by emitted blocks
        self._done = False
        try:
            import os as _os

            pos = fin.tell()
            self._size_hint = max(
                0, _os.fstat(fin.fileno()).st_size - pos
            ) + (first_data.size if first_data is not None else 0)
        except (OSError, AttributeError, ValueError, io.UnsupportedOperation):
            self._size_hint = None

    def __iter__(self):
        # the read+scan of window N+1 runs on a producer thread while the
        # pipeline chews window N's blocks (queue depth 1 = one window of
        # lookahead, ~2x WINDOW_BYTES extra peak memory): dispatch would
        # otherwise stall for each window's serial boundary scan
        import queue
        import threading

        q: queue.Queue = queue.Queue(maxsize=1)
        stop = [False]

        def produce():
            try:
                budget = self._budget
                carry = np.zeros(0, np.uint8)
                pending = self._first
                self._first = None
                eof = False
                while (not eof or carry.size) and not stop[0]:
                    if pending is not None:
                        data, pending = pending, None
                        if data.size == 0:
                            eof = True
                            continue
                    else:
                        chunk = self._fin.read(WINDOW_BYTES) if not eof else b""
                        if not chunk:
                            eof = True
                        data = (
                            np.concatenate(
                                (carry, np.frombuffer(chunk, np.uint8))
                            )
                            if chunk
                            else carry
                        )
                        if data.size == 0:
                            break
                    out, blocks = rle1_blocks(data, budget)
                    if not eof and len(blocks) > 1:
                        keep = blocks[:-1]
                        carry = data[blocks[-1][2] :].copy()
                    elif not eof:
                        carry = data  # fewer than 2 blocks: need more data
                        continue
                    else:
                        keep = blocks
                        carry = np.zeros(0, np.uint8)
                    item = (out, data, keep)
                    while not stop[0]:
                        try:
                            q.put(item, timeout=0.2)
                            break
                        except queue.Full:
                            pass
                q.put(None)
            except BaseException as e:  # surfaced in the consumer
                q.put(e)

        threading.Thread(target=produce, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                out, data, keep = item
                for o0, o1, i0, i1 in keep:
                    self._emitted += 1
                    self._raw_seen += i1 - i0
                    yield out[o0:o1], data[i0:i1]
            self._done = True
        finally:
            # unblock the producer if the consumer abandoned mid-stream
            stop[0] = True
            try:
                q.get_nowait()
            except queue.Empty:
                pass

    def total_estimate(self) -> int:
        if self._done:
            return max(self._emitted, 1)
        if self._size_hint is None:
            # unseekable source (pipe/socket): length unknown — claim a
            # healthy remainder so the scheduler keeps the device eligible
            # mid-stream (the drain's immediate-twin guard bounds the tail
            # cost if the stream actually ends inside it)
            return self._emitted + 8
        rest = max(0, self._size_hint - self._raw_seen)
        return self._emitted + max(1, -(-rest // self._budget))


def compress_stream(fin: io.RawIOBase, fout: io.RawIOBase, level: int = 9) -> int:
    """Compress a binary stream to a .bz2 stream. Returns bytes written-ish
    (total output bits // 8 rounded up)."""
    if not 1 <= level <= 9:
        raise ValueError("level must be 1..9")
    from .api import (
        _HostFallbackEncoder,
        _device_block_results,
        _encoder,
        _encoder_for,
        _host_block_results,
    )

    sink = _BitSink(fout)
    header = BitAccum()
    for b in STREAM_MAGIC:
        header.put(b, 8)
    header.put(0x30 + level, 8)
    sink.write_fields(*header.arrays())

    budget = block_budget(level)
    # engine choice needs a block-count signal BEFORE the pipeline starts:
    # read the first window eagerly — a stream that ends inside it routes
    # tiny block counts to the CPU engine (api._encoder_for) so small
    # files never pay the jax import/init; everything else gets the
    # device-capable encoder and ONE pipeline spanning all windows
    first = np.frombuffer(fin.read(WINDOW_BYTES), np.uint8)
    items = _WindowItems(fin, budget, first_data=first)
    if first.size < WINDOW_BYTES:
        _, first_blocks = rle1_blocks(first, budget)
        enc = _encoder_for(level, len(first_blocks))
    else:
        enc = _encoder(level)

    s_crc = 0
    gen = (
        _host_block_results
        if isinstance(enc, _HostFallbackEncoder)
        else _device_block_results
    )
    for crc, blk_bytes, nbits in gen(enc, items):
        s_crc = stream_crc_fold(s_crc, crc)
        sink.write_chunk(blk_bytes, nbits)
    footer = BitAccum()
    footer.put(FOOTER_MAGIC, 48)
    footer.put(s_crc, 32)
    sink.write_fields(*footer.arrays())
    sink.close()
    return (sink.total_bits + 7) // 8


def compress_file(src: str, dst: str, level: int = 9) -> None:
    with open(src, "rb") as fin, open(dst, "wb") as fout:
        compress_stream(fin, fout, level)


def decompress_stream(fin: io.RawIOBase, fout: io.RawIOBase) -> int:
    """Decompress a .bz2 stream (including concatenated streams) with
    bounded memory: a sliding window holds only the bytes of blocks not yet
    fully decoded (a block's compressed span is at most ~1.01x its 900k
    budget, far below the window). Returns total bytes written."""
    from ..format.constants import BLOCK_MAGIC, FOOTER_MAGIC, STREAM_MAGIC
    from ..format.crc import stream_crc_fold
    from ..native import decode_block_native, get_lib
    from ..hostref.bitio import BitReader
    from ..hostref.block import decode_block
    from ..format.crc import block_crc

    from concurrent.futures import ThreadPoolExecutor

    window = max(WINDOW_BYTES, 64 * 1024)
    buf = b""
    eof = False
    pos = 0  # bit position within buf
    total = 0
    level = None
    s_crc = 0
    in_stream = False
    # parallel pre-decode: candidate block magics in the buffered window are
    # decoded ahead on a thread pool (the native decoder is GIL-free), the
    # serial walk consumes the results — the in-memory decoder's strategy
    # (stream/decode.py) applied to the bounded-memory path. Appends keep
    # bit offsets stable. A window re-base shifts offsets; futures survive it
    # (each decodes from its own buffer snapshot held by the closure) with a
    # recorded bit shift applied to their end_bit on consumption.
    pool: ThreadPoolExecutor | None = None
    predec: dict[int, list] = {}  # pos -> [future, bit_shift]
    scanned = 0
    try:
      while True:
        # top up: keep at least ~2 windows of unconsumed bytes buffered
        while not eof and len(buf) - pos // 8 < 2 * window:
            chunk = fin.read(window)
            if not chunk:
                eof = True
                break
            buf += chunk
        # drop consumed whole bytes once a window's worth accumulates
        # (re-basing shifts offsets, so it also drops pre-decoded results)
        drop = pos // 8
        if drop >= window:
            buf = buf[drop:]
            pos -= drop * 8
            shifted: dict[int, list] = {}
            for k, (f, sh) in predec.items():
                if k - drop * 8 >= pos:
                    shifted[k - drop * 8] = [f, sh + drop * 8]
                else:
                    f.cancel()
            predec = shifted
            scanned = max(scanned - drop, 0)
        if in_stream and level is not None and len(buf) > scanned and get_lib() is not None:
            arr_scan = np.frombuffer(buf, np.uint8)
            lo = max(scanned - 7, 0)
            from ..native import find_magic_native

            hits = find_magic_native(arr_scan[lo:], BLOCK_MAGIC)
            if hits is not None:
                if pool is None:
                    pool = ThreadPoolExecutor(4)
                lvl = level

                def _try(b0, a=arr_scan, lv=lvl):
                    try:
                        return decode_block_native(a, b0 + 48, lv)
                    except ValueError:
                        return None

                for h in hits:
                    b0 = int(h) + lo * 8
                    if b0 >= pos and b0 not in predec:
                        predec[b0] = [pool.submit(_try, b0), 0]
            scanned = len(buf)
        if not in_stream:
            if pos // 8 >= len(buf):
                break  # clean end between streams
            if total and buf[pos // 8 : pos // 8 + 3] != STREAM_MAGIC:
                break  # trailing non-stream bytes: stop like the in-memory path
            if len(buf) * 8 - pos < 32:
                raise ValueError("truncated stream header")
            hdr = BitReader(buf)
            hdr.pos = pos
            if bytes(hdr.read(8) for _ in range(3)) != STREAM_MAGIC:
                raise ValueError("not a bzip2 stream")
            level = hdr.read(8) - 0x30
            if not 1 <= level <= 9:
                raise ValueError("invalid block size digit")
            pos = hdr.pos
            s_crc = 0
            in_stream = True
            continue
        if len(buf) * 8 - pos < 48:
            raise ValueError("truncated stream")
        br = BitReader(buf)
        br.pos = pos
        tag = br.read(48)
        if tag == FOOTER_MAGIC:
            stored = br.read(32)
            if stored != s_crc:
                raise ValueError("stream CRC mismatch")
            # byte-align; another stream may follow
            pos = (br.pos + 7) // 8 * 8
            in_stream = False
            if eof and (pos // 8 >= len(buf)):
                break
            continue
        if tag != BLOCK_MAGIC:
            raise ValueError("invalid block header magic")
        arr = np.frombuffer(buf, np.uint8)
        entry = predec.pop(pos, None)
        res = entry[0].result() if entry is not None else None
        try:
            if res is not None:
                raw, end_bit, blk_crc, actual = res
                end_bit -= entry[1]
                raw = raw.tobytes()
            elif get_lib() is not None:
                raw, end_bit, blk_crc, actual = decode_block_native(
                    arr, pos + 48, level
                )
                raw = raw.tobytes()
            else:
                raw_a, blk_crc = decode_block(br, level)
                raw, end_bit, actual = (
                    raw_a.tobytes(),
                    br.pos,
                    block_crc(raw_a),
                )
        except ValueError:
            # A decode failure is ambiguous: the block may extend past the
            # buffered window, or it may be corrupt. Only retry with more
            # data while the buffered span past pos could still be smaller
            # than the largest possible compressed block (~3x the 900k
            # post-RLE1 budget is a safe over-bound: worst-case RLE2 length
            # is budget+1 symbols at <=20 bits each, plus headers). Beyond
            # that a valid block cannot need more bytes — raise instead of
            # slurping the remaining input (bounded-memory contract).
            max_block_bytes = level * 100_000 * 3 + 4096
            if not eof and len(buf) - pos // 8 < max_block_bytes:
                chunk = fin.read(window)
                if chunk:
                    buf += chunk
                    continue
                eof = True
            raise
        if actual != blk_crc:
            raise ValueError("block CRC mismatch")
        s_crc = stream_crc_fold(s_crc, blk_crc)
        fout.write(raw)
        total += len(raw)
        pos = end_bit
    finally:
        if pool is not None:
            for f, _ in predec.values():
                f.cancel()
            pool.shutdown(wait=False)
    return total


def decompress_file(src: str, dst: str) -> None:
    with open(src, "rb") as fin, open(dst, "wb") as fout:
        decompress_stream(fin, fout)
