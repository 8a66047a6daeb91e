"""Move-to-front + RLE2 zero-run coding, host reference.

Semantics of reference src/tools/rle2_mtf.rs:
  - MTF alphabet = the block's used bytes, sorted ascending (rle2_mtf.rs:27-39)
  - MTF rank 0 never emitted directly; zero runs of length n are written in
    bijective base-2 (digit RUNA=1, RUNB=2; low digit first) via
    ``n -= 1; loop {emit n&1; if n<2 break; n=(n-2)>>1}`` (rle2_mtf.rs:84-101)
  - literal rank r >= 1 -> symbol r+1; EOB = num_used+1 appended last
    (rle2_mtf.rs:42,172)
Returns RLE2-domain symbol frequencies alongside (rle2_mtf.rs:104).
"""
from __future__ import annotations

import numpy as np

from ..format.constants import ZERO_BOMB


def zero_run_digits(n: int) -> list[int]:
    """Bijective base-2 digits of a zero-run of length n (RUNA=0, RUNB=1)."""
    digits = []
    n -= 1
    while True:
        digits.append(n & 1)
        if n < 2:
            break
        n = (n - 2) >> 1
    return digits


def mtf_encode(block: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """block: uint8 BWT output. Returns (ranks int32[n], used bool[256]):
    each byte's MTF rank over the block's sorted used-byte alphabet."""
    block = np.asarray(block, dtype=np.uint8)
    used = np.zeros(256, dtype=bool)
    used[np.unique(block)] = True
    mtf = list(np.flatnonzero(used))  # mtf[rank] = byte value
    ranks = np.empty(block.size, dtype=np.int32)
    for i, b in enumerate(block.tolist()):
        r = mtf.index(b)
        ranks[i] = r
        if r:
            mtf.pop(r)
            mtf.insert(0, b)
    return ranks, used


def rle2_encode_ranks(ranks: np.ndarray, used: np.ndarray) -> np.ndarray:
    """MTF ranks -> RLE2 symbols (uint16), EOB = num_used+1 appended."""
    out: list[int] = []
    zeros = 0
    for r in np.asarray(ranks).tolist():
        if r == 0:
            zeros += 1
            continue
        if zeros:
            out.extend(zero_run_digits(zeros))
            zeros = 0
        out.append(r + 1)
    if zeros:
        out.extend(zero_run_digits(zeros))
    out.append(int(used.sum()) + 1)
    return np.asarray(out, dtype=np.uint16)


def mtf_rle2_encode(block: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """block: uint8 BWT output. Returns (rle2 uint16, freqs uint32[258], used bool[256])."""
    ranks, used = mtf_encode(block)
    rle2 = rle2_encode_ranks(ranks, used)
    freqs = np.bincount(rle2, minlength=258).astype(np.uint32)
    return rle2, freqs, used


def mtf_rle2_decode(rle2: np.ndarray, symbol_set: np.ndarray, max_size: int) -> np.ndarray:
    """Invert. rle2 excludes (or may include, as last element) the EOB symbol.

    symbol_set: sorted used byte values. Semantics of rle2_mtf.rs:191-287,
    including the 2 MiB zero-run bomb guard.
    """
    symbol_set = np.asarray(symbol_set, dtype=np.uint8)
    eob = symbol_set.size + 1
    mtf = list(symbol_set)
    out = np.empty(max_size, dtype=np.uint8)
    pos = 0
    zeros = 0
    bit_mult = 1
    for s in np.asarray(rle2, dtype=np.int64).tolist():
        if s <= 1:  # RUNA / RUNB
            zeros += bit_mult * (s + 1)
            bit_mult <<= 1
            if zeros > ZERO_BOMB:
                raise ValueError("zero-run bomb in RLE2 stream")
            continue
        if zeros:
            if pos + zeros > max_size:
                raise ValueError("RLE2 output exceeds block size")
            out[pos : pos + zeros] = mtf[0]
            pos += zeros
            zeros = 0
            bit_mult = 1
        if s == eob:
            break
        r = s - 1
        b = mtf.pop(r)
        mtf.insert(0, b)
        if pos >= max_size:
            raise ValueError("RLE2 output exceeds block size")
        out[pos] = b
        pos += 1
    if zeros:
        if pos + zeros > max_size:
            raise ValueError("RLE2 output exceeds block size")
        out[pos : pos + zeros] = mtf[0]
        pos += zeros
    return out[:pos]
