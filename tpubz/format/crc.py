"""bzip2 CRC-32 (a.k.a. CRC-32/BZIP2: MSB-first, poly 0x04C11DB7, init/xorout
0xFFFFFFFF, no reflection).

Semantics match reference src/tools/crc.rs:15-27: per-byte
``crc = (crc << 8) ^ TABLE[(crc >> 24) ^ byte]`` with pre/post inversion, and
the order-dependent stream fold ``s = rotl1(s) ^ block_crc``.

Fast path: CRC-32/BZIP2 is the bit-reversal of the reflected CRC-32 (zlib)
computed over bit-reversed bytes, so we ride zlib's SIMD CRC instead of a
Python byte loop: crc_bzip2(d) = rev32(zlib.crc32(rev8(d))).
"""
from __future__ import annotations

import zlib

import numpy as np

_POLY = 0x04C11DB7


def _make_table() -> np.ndarray:
    t = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i << 24
        for _ in range(8):
            c = ((c << 1) ^ _POLY) if (c & 0x8000_0000) else (c << 1)
            c &= 0xFFFF_FFFF
        t[i] = c
    return t


CRC32_TABLE = _make_table()

# 256-entry byte bit-reversal table.
_BITREV8 = np.array(
    [int(f"{i:08b}"[::-1], 2) for i in range(256)], dtype=np.uint8
)


def _rev32(x: int) -> int:
    return int(f"{x:032b}"[::-1], 2)


def block_crc(data) -> int:
    """CRC-32/BZIP2 of ``data`` (bytes or uint8 ndarray)."""
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
    if arr.size >= (1 << 16):
        # slice-by-8 native kernel: one pass, no bit-reversal scratch
        # (the zlib route below pays two extra full passes)
        from ..native import block_crc_native

        v = block_crc_native(arr)
        if v is not None:
            return v
    rev = _BITREV8[arr]
    z = zlib.crc32(rev.tobytes()) & 0xFFFF_FFFF
    return _rev32(z)


def block_crc_slow(data) -> int:
    """Table-driven scalar CRC, kept as the spec-literal oracle for tests."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    crc = 0xFFFF_FFFF
    t = CRC32_TABLE
    for b in arr:
        crc = ((crc << 8) & 0xFFFF_FFFF) ^ int(t[((crc >> 24) ^ int(b)) & 0xFF])
    return crc ^ 0xFFFF_FFFF


def stream_crc_fold(stream_crc: int, blk_crc: int) -> int:
    """Order-dependent stream CRC combine (reference src/tools/crc.rs:25-27)."""
    s = ((stream_crc << 1) | (stream_crc >> 31)) & 0xFFFF_FFFF
    return s ^ blk_crc
