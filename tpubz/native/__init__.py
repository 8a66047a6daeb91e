"""Native (C++) host subsystem: hot sequential host-side stages.

The reference's runtime is 100% native (Rust); here the device compute path
is JAX/XLA and the host-side sequential stages (Huffman refinement, RLE1
scan, block decode) are C++ built on demand with the host's g++ for the
host's own CPU (see build_key) and loaded via ctypes. Every native entry
point has a numpy fallback and a test asserting bit-identical behavior.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading

import numpy as np

log = logging.getLogger("tpubz")

_HERE = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIB = None
_LIB_PATH: str | None = None
_LIB_FAILED = False

_SOURCES = ["refine.cpp", "rle1.cpp", "decode.cpp", "pack.cpp", "bwt.cpp", "emit.cpp"]
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]


def _host_cpu_id() -> str:
    """Identity of the CPU a -march=native build targets: the machine type
    plus the first processor's vendor, model and feature flags."""
    ident = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # end of the first processor's record
                k, _, v = line.partition(":")
                if k.strip() in (
                    "vendor_id", "cpu family", "model", "model name",
                    "flags", "CPU implementer", "CPU part", "Features",
                ):
                    ident.append(f"{k.strip()}={v.strip()}")
    except OSError:
        pass
    return "\n".join(ident)


def build_key() -> str:
    """Key of the library these sources, flags and this host's CPU build:
    a library copied from another machine carries another key and is never
    loaded here."""
    h = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(_HERE, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(_FLAGS).encode())
    h.update(_host_cpu_id().encode())
    return h.hexdigest()[:16]


def lib_path() -> str:
    """Where the library built for this host lives (built or not)."""
    return os.path.join(_HERE, f"libtpubz_native.{build_key()}.so")


def loaded_path() -> str | None:
    """Path of the library get_lib() loaded, or None."""
    return _LIB_PATH


def _build() -> str | None:
    so_path = lib_path()
    if os.path.exists(so_path):
        return so_path
    # build beside the target, then rename: a concurrent process never
    # loads a half-written library
    tmp = f"{so_path}.{os.getpid()}.tmp"
    srcs = [os.path.join(_HERE, s) for s in _SOURCES]
    try:
        subprocess.run(
            ["g++", *_FLAGS, *srcs, "-o", tmp],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, so_path)
        return so_path
    except (OSError, subprocess.SubprocessError) as e:
        log.warning("native build failed: %s", e)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def get_lib():
    """Returns the loaded native library, or None if unavailable."""
    global _LIB, _LIB_PATH, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        if os.environ.get("TPUBZ_NO_NATIVE"):
            _LIB_FAILED = True
            return None
        path = _build()
        if path is None:
            _LIB_FAILED = True
            return None
        try:
            lib = ctypes.CDLL(path)
            lib.tpubz_refine_stream.restype = ctypes.c_int64
            lib.tpubz_refine_stream.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.tpubz_code_lengths.restype = None
            lib.tpubz_code_lengths.argtypes = [
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
            ]
            lib.tpubz_mtf_selectors.restype = None
            lib.tpubz_mtf_selectors.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.tpubz_pack_bits.restype = ctypes.c_int64
            lib.tpubz_pack_bits.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.tpubz_emit_payload.restype = ctypes.c_int64
            lib.tpubz_emit_payload.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64,
            ]
            lib.tpubz_rle1_split.restype = ctypes.c_int64
            lib.tpubz_rle1_split.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64,
            ]
            lib.tpubz_find_magic.restype = ctypes.c_int64
            lib.tpubz_find_magic.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64,
                ctypes.c_void_p, ctypes.c_int64,
            ]
            lib.tpubz_find_magic2.restype = None
            lib.tpubz_find_magic2.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_uint64, ctypes.c_uint64,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.tpubz_bwt.restype = ctypes.c_int64
            lib.tpubz_bwt.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.tpubz_mtf_rle2.restype = ctypes.c_int64
            lib.tpubz_mtf_rle2.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.tpubz_block_transform.restype = ctypes.c_int64
            lib.tpubz_block_transform.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p,
            ]
            lib.tpubz_block_crc.restype = ctypes.c_uint32
            lib.tpubz_block_crc.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.tpubz_emit_block.restype = ctypes.c_int64
            lib.tpubz_emit_block.argtypes = [
                ctypes.c_int32, ctypes.c_uint32,
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.tpubz_decode_block.restype = ctypes.c_int64
            lib.tpubz_decode_block.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            _LIB = lib
            _LIB_PATH = path
        except (OSError, AttributeError) as e:
            log.warning("native library %s unusable: %s", path, e)
            _LIB_FAILED = True
        return _LIB


def code_lengths_native(freqs: np.ndarray, alpha: int):
    """Exact C-bzip2 code lengths for one table (17-bit cap + flattening
    retry). Returns int64[alpha] or None if the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    f = np.ascontiguousarray(freqs[:alpha], dtype=np.int64)
    out = np.zeros(alpha, dtype=np.int32)
    lib.tpubz_code_lengths(f.ctypes.data, alpha, out.ctypes.data)
    return out.astype(np.int64)


def mtf_selectors_native(selectors: np.ndarray):
    lib = get_lib()
    if lib is None:
        return None
    sel = np.ascontiguousarray(selectors, dtype=np.int32)
    out = np.zeros(sel.size, dtype=np.int32)
    lib.tpubz_mtf_selectors(sel.ctypes.data, sel.size, out.ctypes.data)
    return out.astype(np.int64)


def pack_bits_native(vals: np.ndarray, bits: np.ndarray):
    """Pack (vals, bits) fields MSB-first. Returns bytes or None."""
    lib = get_lib()
    if lib is None:
        return None
    vals = np.ascontiguousarray(vals, dtype=np.uint32)
    bits = np.ascontiguousarray(bits, dtype=np.int64)
    cap = int(bits.sum()) // 8 + 16
    out = np.empty(cap, dtype=np.uint8)
    total = np.zeros(1, dtype=np.int64)
    nbytes = lib.tpubz_pack_bits(
        vals.ctypes.data, bits.ctypes.data, vals.size,
        out.ctypes.data, cap, total.ctypes.data,
    )
    assert nbytes >= 0, "pack capacity underestimated"
    return out[:nbytes].tobytes()


def emit_payload_native(syms: np.ndarray, selectors: np.ndarray,
                        codes: np.ndarray, lens: np.ndarray):
    """One-pass Huffman payload pack: per-symbol (code, len) by its chunk's
    selector, packed MSB-first into uint32 words (final word left-aligned —
    BitAccum.put_words layout). Returns (words uint32[], total_bits) or
    None if the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    s = np.ascontiguousarray(syms, dtype=np.uint16)
    sel = np.ascontiguousarray(selectors, dtype=np.int32)
    cpad = np.zeros((6, 258), np.uint32)
    lpad = np.zeros((6, 258), np.int32)
    tc, alpha = codes.shape
    cpad[:tc, :alpha] = codes
    lpad[:tc, :alpha] = lens[:tc, :alpha]
    cap = (s.size * 20 + 31) // 32 + 2  # encoder never emits > 17 bits/sym
    words = np.empty(cap, dtype=np.uint32)
    total = lib.tpubz_emit_payload(
        s.ctypes.data, s.size, sel.ctypes.data,
        cpad.ctypes.data, lpad.ctypes.data, words.ctypes.data, cap,
    )
    assert total >= 0, "payload word capacity underestimated"
    return words, int(total)


def rle1_split_native(data: np.ndarray, budget: int):
    """RLE1-encode + split into blocks. Returns (rle1_out, blocks) where
    blocks is [(out_lo, out_hi, in_lo, in_hi), ...], or None."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.ascontiguousarray(data, dtype=np.uint8)
    n = arr.size
    # worst case: runs of exactly 4 expand 4 -> 5 bytes
    out_max = n + n // 4 + 16
    out = np.empty(out_max, dtype=np.uint8)
    out_len = np.zeros(1, dtype=np.int64)
    # blocks can close up to 5 bytes short of the budget (segment granularity)
    cap = max(4, out_max // max(budget - 5, 1) + 8)
    blocks = np.zeros((cap, 4), dtype=np.int64)
    nb = lib.tpubz_rle1_split(
        arr.ctypes.data, n, budget, out.ctypes.data,
        out_len.ctypes.data, blocks.ctypes.data, cap,
    )
    assert nb <= cap, "rle1 block capacity underestimated"
    return out[: int(out_len[0])], [tuple(int(x) for x in row) for row in blocks[:nb]]


def rle1_split_window(
    arr: np.ndarray, start: int, end: int, budget: int,
    out: np.ndarray, out_base: int,
):
    """Scan arr[start:end) with the native RLE1 splitter, writing output at
    out[out_base:]. Returns (blocks, out_len) with blocks in WINDOW-LOCAL
    coordinates ((out_lo, out_hi, in_lo, in_hi) relative to out_base/start),
    or None when the native lib is unavailable.

    The scanner treats `end` as EOF, so for end < arr.size the caller must
    discard trailing blocks whose cut decisions could see the boundary (the
    final block is always the scanner's forced tail-join) and re-scan from
    the last accepted cut — cuts are segment-aligned (reference
    src/tools/rle1.rs semantics), so a re-entered scan at a true block
    boundary reproduces the full scan's bytes exactly.
    """
    lib = get_lib()
    if lib is None:
        return None
    m = end - start
    cap = max(4, (out.size - out_base) // max(budget - 5, 1) + 8)
    blocks = np.zeros((cap, 4), dtype=np.int64)
    out_len = np.zeros(1, dtype=np.int64)
    nb = lib.tpubz_rle1_split(
        arr.ctypes.data + start, m, budget,
        out.ctypes.data + out_base, out_len.ctypes.data,
        blocks.ctypes.data, cap,
    )
    assert nb <= cap, "rle1 block capacity underestimated"
    return (
        [tuple(int(x) for x in row) for row in blocks[:nb]],
        int(out_len[0]),
    )


def find_magic_native(data: np.ndarray, magic: int):
    """All bit offsets of the 48-bit magic, or None if lib unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    cap = max(1024, data.size // 1000)
    while True:
        out = np.zeros(cap, dtype=np.int64)
        n = lib.tpubz_find_magic(data.ctypes.data, data.size, magic,
                                 out.ctypes.data, cap)
        if n < cap:
            return out[:n]
        cap *= 8


def _find_magic2_range(lib, data: np.ndarray, magic1: int, magic2: int):
    cap = max(1024, data.size // 1000)
    while True:
        out1 = np.zeros(cap, dtype=np.int64)
        out2 = np.zeros(cap, dtype=np.int64)
        n1 = np.zeros(1, dtype=np.int64)
        n2 = np.zeros(1, dtype=np.int64)
        lib.tpubz_find_magic2(
            data.ctypes.data, data.size, magic1, magic2,
            out1.ctypes.data, cap, n1.ctypes.data,
            out2.ctypes.data, cap, n2.ctypes.data,
        )
        if n1[0] <= cap and n2[0] <= cap:
            return out1[: int(n1[0])], out2[: int(n2[0])]
        cap *= 8


_CHUNK = 1 << 21  # 2 MB per scan chunk


def find_magic2_native(data: np.ndarray, magic1: int, magic2: int):
    """Bit offsets of two 48-bit magics in ONE pass over the data. Returns
    (offsets1, offsets2) int64 arrays, or None if the lib is unavailable.

    Large inputs scan chunk-parallel (the native scan releases the GIL):
    each chunk covers bytes [s, e) plus a 7-byte overlap so windows that
    straddle the boundary are attributed to the LEFT chunk, and per-chunk
    hits are filtered to byte positions < e - s before offsetting — hit
    lists concatenate in ascending order with no duplicates."""
    lib = get_lib()
    if lib is None:
        return None
    n = data.size
    if n <= _CHUNK + (_CHUNK >> 2):
        return _find_magic2_range(lib, data, magic1, magic2)
    from concurrent.futures import ThreadPoolExecutor

    starts = list(range(0, n, _CHUNK))

    def one(s):
        e = min(s + _CHUNK, n)
        sl = data[s : min(e + 7, n)]
        h1, h2 = _find_magic2_range(lib, sl, magic1, magic2)
        lim = 8 * (e - s)
        return (h1[h1 < lim] + 8 * s, h2[h2 < lim] + 8 * s)

    with ThreadPoolExecutor(min(8, len(starts))) as ex:
        parts = list(ex.map(one, starts))
    return (
        np.concatenate([p[0] for p in parts]),
        np.concatenate([p[1] for p in parts]),
    )


def decode_block_native(data: np.ndarray, start_bit: int, level: int):
    """Decode one block starting right after its 48-bit magic.

    Returns (raw bytes ndarray, end_bit, stream_blk_crc, computed_crc) or
    None if the native lib is unavailable. Raises ValueError on corrupt
    blocks. `data` must be a contiguous uint8 array of the whole stream.

    Output buffer is tiered: the RLE1 worst case is a 52x expansion
    (255 bytes per 5), but real blocks rarely exceed ~1.3x, so the first
    attempt uses a 2x+slack buffer and only retries with the full
    worst-case allocation on overflow — this keeps dozens of in-flight
    parallel block decodes from each touching a 46MB buffer.
    """
    lib = get_lib()
    if lib is None:
        return None
    nbits = data.size * 8
    end_bit = np.zeros(1, dtype=np.int64)
    blk_crc = np.zeros(1, dtype=np.uint32)
    comp_crc = np.zeros(1, dtype=np.uint32)
    rc = -9
    for cap in (level * 100_000 * 2 + 65536, level * 100_000 * 52 + 1024):
        out = np.empty(cap, dtype=np.uint8)
        rc = lib.tpubz_decode_block(
            data.ctypes.data, nbits, start_bit, level,
            out.ctypes.data, cap,
            end_bit.ctypes.data, blk_crc.ctypes.data, comp_crc.ctypes.data,
        )
        if rc != -9:
            break
    if rc < 0:
        reasons = {
            -1: "bitstream exhausted (truncated block)",
            -2: "invalid BWT key pointer",
            -3: "invalid Huffman table count",
            -4: "selector out of range",
            -5: "invalid code length",
            -6: "invalid Huffman code in payload",
            -7: "RLE2 output exceeds block size",
            -8: "zero-run bomb in RLE2 stream",
            -9: "RLE1 expansion exceeds output capacity",
            -10: "ran out of selectors before EOB",
        }
        raise ValueError(reasons.get(int(rc), f"block decode failed ({rc})"))
    return out[:rc].copy(), int(end_bit[0]), int(blk_crc[0]), int(comp_crc[0])


def bwt_native(block: np.ndarray):
    """Rotation BWT via SA-IS on the doubled string (bwt.cpp). Returns
    (key, last uint8[n]) or None; bit-identical to hostref.bwt.bwt_encode
    including periodic-input tie-breaks."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.ascontiguousarray(block, dtype=np.uint8)
    last = np.empty(max(arr.size, 1), dtype=np.uint8)
    key = np.zeros(1, dtype=np.int32)
    rc = lib.tpubz_bwt(arr.ctypes.data, arr.size, last.ctypes.data,
                       key.ctypes.data)
    if rc < 0:
        return None
    return int(key[0]), last[: arr.size]


def mtf_rle2_native(last: np.ndarray):
    """MTF + RLE2 over a BWT last column in one GIL-free native call.
    Returns (rle2 uint16, freqs uint32[258], used bool[256]) or None —
    the host half of the bwt-only device route (the device does the suffix
    sort, the host does the serial per-symbol scan it is better at)."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.ascontiguousarray(last, dtype=np.uint8)
    out = np.empty(arr.size + 8, dtype=np.uint16)
    freqs = np.zeros(258, dtype=np.uint32)
    used = np.zeros(256, dtype=np.uint8)
    rl = lib.tpubz_mtf_rle2(
        arr.ctypes.data, arr.size, out.ctypes.data, freqs.ctypes.data,
        used.ctypes.data,
    )
    if rl < 0:
        return None
    return out[:rl], freqs, used.astype(bool)


def block_transform_native(block: np.ndarray):
    """Fused BWT + MTF + RLE2 in one GIL-free native call. Returns
    (key, rle2 uint16, freqs uint32[258], used bool[256]) or None —
    the exact inputs DeviceBlockEncoder.emit_block consumes."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.ascontiguousarray(block, dtype=np.uint8)
    out = np.empty(arr.size + 8, dtype=np.uint16)
    freqs = np.zeros(258, dtype=np.uint32)
    used = np.zeros(256, dtype=np.uint8)
    key = np.zeros(1, dtype=np.int32)
    rl = lib.tpubz_block_transform(
        arr.ctypes.data, arr.size, out.ctypes.data, freqs.ctypes.data,
        used.ctypes.data, key.ctypes.data,
    )
    if rl < 0:
        return None
    return int(key[0]), out[:rl], freqs, used.astype(bool)


def refine_stream_native(rle2: np.ndarray, alpha: int, iters: int):
    """Native mirror of hostref.huffman refinement on the raw symbol stream.
    Returns (selectors, lengths[6, alpha], table_count) or None."""
    lib = get_lib()
    if lib is None:
        return None
    syms = np.ascontiguousarray(rle2, dtype=np.uint16)
    nsel = (syms.size + 49) // 50
    selectors = np.zeros(nsel, dtype=np.int32)
    lengths = np.zeros((6, alpha), dtype=np.int32)
    table_count = np.zeros(1, dtype=np.int32)
    lib.tpubz_refine_stream(
        syms.ctypes.data, syms.size, alpha, iters,
        selectors.ctypes.data, lengths.ctypes.data, table_count.ctypes.data,
    )
    return selectors.astype(np.int64), lengths.astype(np.int64), int(table_count[0])


def block_crc_native(arr: np.ndarray):
    """CRC-32/BZIP2 via the native slice-by-8 kernel. Returns int or None."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(arr, dtype=np.uint8)
    return int(lib.tpubz_block_crc(a.ctypes.data, a.size))


def emit_block_native(key: int, crc: int, syms: np.ndarray, used: np.ndarray,
                      iters: int):
    """Whole-block emission (refine + headers + payload + pack) in ONE
    GIL-free native call. Returns (packed bytes, bit length) or None."""
    lib = get_lib()
    if lib is None:
        return None
    s = np.ascontiguousarray(syms, dtype=np.uint16)
    u = np.ascontiguousarray(used, dtype=np.uint8)
    cap = int(s.size) * 20 // 8 + 8192
    out = np.empty(cap, dtype=np.uint8)
    tb = np.zeros(1, dtype=np.int64)
    n = lib.tpubz_emit_block(
        int(key), int(crc) & 0xFFFFFFFF, s.ctypes.data, s.size,
        u.ctypes.data, int(iters), out.ctypes.data, cap, tb.ctypes.data,
    )
    if n < 0:
        return None
    return out[:n].tobytes(), int(tb[0])
