"""Host (numpy) MSB-first bit packing and reading.

The packer is deliberately structured as (values, bit-lengths) streams packed
in one vectorized pass — the same algorithm the device bitpack kernel uses
(prefix-sum of lengths + word scatter), so this doubles as its oracle.

Reference semantics: src/bitstream/bitpacker.rs (MSB-first queue, zero-pad to
byte on flush), src/bitstream/bitreader.rs (MSB-first buffered reads).
"""
from __future__ import annotations

import numpy as np


class BitAccum:
    """Accumulates (value, nbits) emissions; packs once at the end.

    Storage is a list of numpy chunks (scalar puts buffer into a small python
    list that is flushed to a chunk) so bulk emissions — e.g. a block's
    entire Huffman payload — stay vectorized end to end.
    """

    def __init__(self):
        # tagged chunks: ("f", vals, bits) field runs, ("b", bytes, nbits)
        # pre-packed byte runs (zero-padded to the byte). Byte runs pass
        # through pack() verbatim via the vectorized splice instead of
        # being decomposed into fields and re-packed bit by bit.
        self._chunks: list[tuple] = []
        self._pend_vals: list[int] = []
        self._pend_bits: list[int] = []
        self._total = 0

    def put(self, value: int, nbits: int) -> None:
        if nbits < 0 or nbits > 48:
            raise ValueError(f"nbits out of range: {nbits}")
        if nbits == 0:
            return
        value &= (1 << nbits) - 1
        # split >24-bit fields so pack_bits can stay in uint32/uint64 math
        while nbits > 24:
            hi = nbits - 24
            self._pend_vals.append(value >> 24)
            self._pend_bits.append(hi)
            self._total += hi
            value &= (1 << 24) - 1
            nbits = 24
        self._pend_vals.append(value)
        self._pend_bits.append(nbits)
        self._total += nbits

    def _flush_pending(self) -> None:
        if self._pend_vals:
            self._chunks.append(
                (
                    "f",
                    np.asarray(self._pend_vals, dtype=np.uint32),
                    np.asarray(self._pend_bits, dtype=np.int64),
                )
            )
            self._pend_vals = []
            self._pend_bits = []

    def extend(self, vals, bits) -> None:
        vals = np.asarray(vals, dtype=np.uint32)
        bits = np.asarray(bits, dtype=np.int64)
        if vals.size == 0:
            return
        if int(bits.max(initial=0)) > 24:
            raise ValueError("extend() fields must be <= 24 bits")
        self._flush_pending()
        self._chunks.append(("f", vals, bits))
        self._total += int(bits.sum())

    def put_words(self, words: np.ndarray, nbits: int) -> None:
        """Append `nbits` of pre-packed MSB-first uint32 words (e.g. a
        device- or native-packed payload). Stored as a byte run: big-endian
        byte order with the sub-byte pad zeroed, so pack() splices it
        verbatim instead of re-packing word fields."""
        if nbits == 0:
            return
        nw = (nbits + 31) // 32
        w = np.ascontiguousarray(np.asarray(words[:nw], dtype=np.uint32))
        pad = nw * 32 - nbits
        if pad:
            w = w.copy()
            w[-1] &= np.uint32(0xFFFFFFFF) << np.uint32(pad)
        self._flush_pending()
        # astype('>u4') is endian-correct on any host (byteswap()-on-native
        # would corrupt the words on a big-endian machine)
        self._chunks.append(("b", w.astype(">u4").tobytes(), nbits))
        self._total += nbits

    def put_bytes(self, data: bytes, nbits: int) -> None:
        """Append `nbits` of pre-packed MSB-first bytes (pad bits beyond
        nbits in the final byte MUST be zero)."""
        if nbits == 0:
            return
        self._flush_pending()
        self._chunks.append(("b", data, nbits))
        self._total += nbits

    @property
    def bit_len(self) -> int:
        return self._total

    def arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Field-stream view (oracle/mirror consumers): byte runs decompose
        into 8-bit fields with a sub-byte tail."""
        self._flush_pending()
        if not self._chunks:
            return np.zeros(0, np.uint32), np.zeros(0, np.int64)
        vs, bs = [], []
        for c in self._chunks:
            if c[0] == "f":
                vs.append(c[1])
                bs.append(c[2])
            else:
                _, data, nbits = c
                arr = np.frombuffer(data, np.uint8)[: (nbits + 7) // 8]
                full = nbits // 8
                vs.append(arr[:full].astype(np.uint32))
                bs.append(np.full(full, 8, np.int64))
                rem = nbits - full * 8
                if rem:
                    vs.append(
                        np.array([int(arr[full]) >> (8 - rem)], np.uint32)
                    )
                    bs.append(np.array([rem], np.int64))
        return np.concatenate(vs), np.concatenate(bs)

    def pack(self) -> tuple[bytes, int]:
        """Returns (bytes zero-padded to a whole byte, exact bit length).
        Field runs pack natively; byte runs splice through untouched."""
        self._flush_pending()
        pieces: list[tuple[bytes, int]] = []
        fv: list[np.ndarray] = []
        fb: list[np.ndarray] = []

        def flush_fields():
            if fv:
                v = np.concatenate(fv) if len(fv) > 1 else fv[0]
                b = np.concatenate(fb) if len(fb) > 1 else fb[0]
                pieces.append((pack_bits(v, b), int(b.sum())))
                fv.clear()
                fb.clear()

        for c in self._chunks:
            if c[0] == "f":
                fv.append(c[1])
                fb.append(c[2])
            else:
                flush_fields()
                pieces.append((c[1], c[2]))
        flush_fields()
        data, total = splice_byte_chunks(pieces)
        assert total == self._total
        return data, self._total


def pack_bits(vals: np.ndarray, bits: np.ndarray) -> bytes:
    """Pack MSB-first: field i occupies bits [off_i, off_i + bits_i).

    Dispatches to the native sequential packer (cross-checked byte-for-byte
    in tests); the numpy fallback uses offset prefix sums + word scatters.
    Each field must be <= 24 bits so that with a <= 31-bit in-word offset it
    spans at most two 32-bit words (24 + 31 < 64).
    """
    from ..native import pack_bits_native

    nat = pack_bits_native(np.asarray(vals, np.uint32), np.asarray(bits, np.int64))
    if nat is not None:
        return nat
    vals = np.asarray(vals, dtype=np.uint64)
    bits = np.asarray(bits, dtype=np.int64)
    if vals.size == 0:
        return b""
    offs = np.concatenate(([0], np.cumsum(bits)))[:-1]
    total = int(offs[-1] + bits[-1])
    nwords = (total + 31) // 32 + 1
    words = np.zeros(nwords, dtype=np.uint64)
    w = offs >> 5
    b = offs & 31
    # 64-bit window starting at word w: value placed at bit (64 - b - bits)
    shift = (64 - b - bits).astype(np.uint64)
    contrib = vals << shift
    hi = (contrib >> np.uint64(32)).astype(np.uint64)
    lo = (contrib & np.uint64(0xFFFF_FFFF)).astype(np.uint64)
    np.bitwise_or.at(words, w, hi)
    np.bitwise_or.at(words, w + 1, lo)
    nbytes = (total + 7) // 8
    out = np.zeros(nwords * 4, dtype=np.uint8)
    out[0::4] = (words >> np.uint64(24)) & np.uint64(0xFF)
    out[1::4] = (words >> np.uint64(16)) & np.uint64(0xFF)
    out[2::4] = (words >> np.uint64(8)) & np.uint64(0xFF)
    out[3::4] = words & np.uint64(0xFF)
    return out[:nbytes].tobytes()


def splice_byte_chunks(chunks: list[tuple[bytes, int]]) -> tuple[bytes, int]:
    """Concatenate byte-padded bit chunks at bit granularity, vectorized:
    each chunk ORs into the output shifted right by (offset % 8) — three
    numpy passes over the chunk instead of one field per byte.

    chunks: [(payload_bytes, exact_bit_len), ...]; pad bits beyond the bit
    length in each chunk's final byte are masked off (BitAccum.pack and the
    native packer emit them zero already). Used by the stream assembler to join
    independently packed blocks (reference src/bitstream/bitwriter.rs:94-100
    does the same by backing its queue up by the padding bit count)."""
    total = sum(n for _, n in chunks)
    inc = IncrementalSplicer(cap_hint=(total + 7) // 8 + 1)
    for payload, nbits in chunks:
        inc.add(payload, nbits)
    return inc.finish()


def splice_bit_chunks(chunks: list[tuple[bytes, int]]) -> tuple[bytes, int]:
    """Back-compat alias of splice_byte_chunks (same contract)."""
    return splice_byte_chunks(chunks)


class IncrementalSplicer:
    """splice_byte_chunks, one chunk at a time: the stream assembler folds
    each block into the output buffer AS THE ORDERED DRAIN YIELDS IT (the
    main thread is otherwise waiting on workers there), so the end-of-stream
    serial splice pass disappears into the pipeline. Same three-pass
    shifted-OR per chunk; the buffer doubles on demand since the total bit
    length is unknown until the last block lands."""

    def __init__(self, cap_hint: int = 1 << 16):
        self._buf = np.zeros(max(cap_hint, 64), np.uint8)
        self._off = 0  # bit offset

    def add(self, payload: bytes, nbits: int) -> None:
        if nbits == 0:
            return
        nb = (nbits + 7) // 8
        need = ((self._off + nbits + 7) >> 3) + 1  # +1: lo-spill slack
        if need > self._buf.size:
            grown = np.zeros(max(need, 2 * self._buf.size), np.uint8)
            grown[: (self._off + 7) >> 3] = self._buf[: (self._off + 7) >> 3]
            self._buf = grown
        arr = np.frombuffer(payload, np.uint8)[:nb]
        rem = nbits & 7
        if rem and (int(arr[nb - 1]) & (0xFF >> rem)):
            arr = arr.copy()
            arr[nb - 1] &= (0xFF << (8 - rem)) & 0xFF
        base = self._off >> 3
        s = self._off & 7
        if s == 0:
            self._buf[base : base + nb] |= arr
        else:
            self._buf[base : base + nb] |= arr >> s
            self._buf[base + 1 : base + 1 + nb] |= arr << (8 - s)
        self._off += nbits

    def finish(self) -> tuple[bytes, int]:
        return self._buf[: (self._off + 7) >> 3].tobytes(), self._off


class BitReader:
    """MSB-first reader over an in-memory byte buffer."""

    def __init__(self, data: bytes):
        self._d = np.frombuffer(data, dtype=np.uint8)
        self.pos = 0  # bit position

    @property
    def bit_len(self) -> int:
        return len(self._d) * 8

    def remaining(self) -> int:
        return self.bit_len - self.pos

    def read(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        if self.pos + nbits > self.bit_len:
            raise EOFError("bitstream exhausted")
        out = 0
        pos = self.pos
        d = self._d
        # byte-at-a-time; header fields only — payload decode uses bulk paths
        first_byte = pos >> 3
        last_byte = (pos + nbits - 1) >> 3
        acc = 0
        for i in range(first_byte, last_byte + 1):
            acc = (acc << 8) | int(d[i])
        total_bits = (last_byte - first_byte + 1) * 8
        drop_right = total_bits - (pos & 7) - nbits
        out = (acc >> drop_right) & ((1 << nbits) - 1)
        self.pos = pos + nbits
        return out

    def read_bit(self) -> int:
        if self.pos >= self.bit_len:
            raise EOFError("bitstream exhausted")
        b = (int(self._d[self.pos >> 3]) >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return b

    def peek_bits_array(self, start_bit: int, count: int) -> np.ndarray:
        """Bulk: bits [start_bit, start_bit+count) as a uint8 0/1 array."""
        idx = np.arange(start_bit, start_bit + count)
        return (self._d[idx >> 3] >> (7 - (idx & 7))) & 1
