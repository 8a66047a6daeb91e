"""Per-block encode/decode pipelines, host reference.

Encode pipeline order (reference src/compression/compress_block.rs:24-66):
  block magic (48b) | block CRC (32b) | randomized bit (0) | BWT origin key
  (24b) | symbol map | Huffman tables/selectors/payload.
Decode mirrors src/compression/decompress.rs:81-389.
"""
from __future__ import annotations

import logging

import numpy as np

log = logging.getLogger("tpubz")

from ..format.constants import BLOCK_MAGIC, group_count_for
from ..format.symbol_map import decode_symbol_map
from .bitio import BitAccum, BitReader
from .bwt import bwt_decode_fast, bwt_encode
from .huffman import (
    build_decode_table,
    huffman_decode_payload,
    huffman_encode,
    read_huffman_tables,
)
from .mtf_rle2 import mtf_rle2_decode, mtf_rle2_encode
from .rle1 import rle1_decode


def encode_block(rle1_block: np.ndarray, crc: int) -> BitAccum:
    """One block of RLE1-encoded data + its pre-RLE1 CRC -> bit emissions."""
    acc = BitAccum()
    acc.put(BLOCK_MAGIC, 48)
    acc.put(crc, 32)
    acc.put(0, 1)  # randomized: always 0 (compress_block.rs:41)
    key, last = bwt_encode(rle1_block)
    log.debug("key %d written at bit %d", key, acc.bit_len)
    acc.put(key, 24)
    rle2, freqs, used = mtf_rle2_encode(last)
    # per-block stats, mirroring reference compress_block.rs:58-63
    log.info(
        "block: %d bytes in, %d symbols after MTF+RLE2, %d byte values in use",
        rle1_block.size, rle2.size, int(used.sum()),
    )
    huffman_encode(acc, rle2, freqs, used)
    return acc


def decode_block(br: BitReader, level: int) -> tuple[np.ndarray, int]:
    """Decode one block body (caller has consumed the 48-bit magic).

    Returns (raw bytes, block_crc_from_stream). The BWT inverse is the host
    counting-sort chase.
    """
    log.debug("block CRC read at bit %d", br.pos)
    blk_crc = br.read(32)
    br.read_bit()  # randomized flag: read and ignored (decompress.rs:102-103)
    log.debug("key read at bit %d", br.pos)
    key = br.read(24)
    if key > level * 100_000 + 10:
        raise ValueError("invalid BWT key pointer")
    log.debug("symbol map read at bit %d", br.pos)
    l1 = br.read(16)
    words = [l1]
    for _ in range(bin(l1).count("1")):
        words.append(br.read(16))
    symbol_set = decode_symbol_map(words)
    alpha = symbol_set.size + 2
    eob = symbol_set.size + 1
    log.debug("table count read at bit %d", br.pos)
    table_count = br.read(3)
    if not 2 <= table_count <= 6:
        raise ValueError("invalid table count")
    log.debug("selector count read at bit %d", br.pos)
    nsel = br.read(15)
    max_sel = level * 100_000 // 50
    raw_sel = np.empty(min(nsel, max_sel), dtype=np.int64)
    kept = 0
    for i in range(nsel):
        g = 0
        while br.read_bit():
            g += 1
        if nsel <= max_sel or kept < max_sel:
            if kept < raw_sel.size:
                raw_sel[kept] = g
                kept += 1
    # selector MTF undo
    idx = list(range(table_count))
    selectors = np.empty(raw_sel.size, dtype=np.int64)
    for i, g in enumerate(raw_sel):
        g = int(g)
        if g >= table_count:
            raise ValueError("selector out of range")
        selectors[i] = idx[g]
        idx.insert(0, idx.pop(g))
    lengths = read_huffman_tables(br, alpha, table_count)
    tables = [build_decode_table(lengths[t]) for t in range(table_count)]
    rle2 = huffman_decode_payload(br, tables, selectors, eob)
    mtf_out = mtf_rle2_decode(rle2, symbol_set, level * 100_000)
    if key >= mtf_out.size and mtf_out.size > 0:
        raise ValueError("BWT key out of range for block")
    bwt_out = bwt_decode_fast(int(key), mtf_out)
    raw = rle1_decode(bwt_out)
    return raw, blk_crc
