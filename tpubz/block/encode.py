"""Device block-encode pipeline.

Per block (reference pipeline src/compression/compress_block.rs:24-66): the
O(n) transforms — BWT suffix sort, MTF, RLE2 — run as jitted device graphs
on fixed padded shapes; the O(alpha x nsel) Huffman refinement runs in the
native C++ engine on the symbol stream (SURVEY.md §7 step 3: six
<=258-symbol tree builds are not worth device time), and emission packs via
the vectorized packer.

Because the device transforms and the refinement are bit-exact against the
host reference, the full device-path stream is byte-identical to
`tpubz.hostref.stream.compress`.
"""
from __future__ import annotations

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np

log = logging.getLogger("tpubz")

from ..cache import cache_dir
from ..format.constants import (
    BLOCK_MAGIC,
    GROUP_SIZE,
    huffman_iters,
    group_count_for,
)
from ..hostref.bitio import BitAccum
from ..hostref.huffman import (
    c_code_lengths,
    c_init_tables,
    huffman_emit_headers,
    mtf_selectors,
)
from ..kernels.mtf import mtf_ranks
from ..kernels.rle2 import rle2_encode
from ..kernels.suffix_sort import bwt_forward
from . import emit

MTF_CHUNK = 256

_cache_ready = False


def setup_jax_cache():
    """Persistent compilation cache (tpubz/cache.py): the 900k transforms
    take a while to compile cold, so processes share what earlier ones
    built.
    Called by every entry path that jits device kernels."""
    global _cache_ready
    if _cache_ready:
        return
    try:
        # the warm stamps live here too, whoever names the directory
        os.makedirs(cache_dir(), exist_ok=True)
    except OSError as e:
        log.warning("no persistent compile cache at %s: %s", cache_dir(), e)
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)
    _cache_ready = True


@jax.jit
def _stage_bwt(data, n):
    return bwt_forward(data, n)


@jax.jit
def _stage_mtf(last, n):
    return mtf_ranks(last, n, chunk=MTF_CHUNK)


@jax.jit
def _stage_rle2(ranks, n, used):
    eob = jnp.sum(used).astype(jnp.int32) + 1
    return rle2_encode(ranks, n, eob)


HI_CAP = 8192  # sidecar capacity for symbols >= 256 (rare: ranks 255+/EOB)


@jax.jit
def _stage_compact(syms, rle2_len):
    """Compact transfer form: u8 symbol stream + packed sidecar of the rare
    symbols >= 256 ((pos << 1) | (sym - 256)), half the device-to-host
    bytes of the u16 stream; callers fall back to the full u16 array when
    the sidecar overflows."""
    OUT = syms.shape[0]
    idx = jnp.arange(OUT, dtype=jnp.int32)
    s32 = syms.astype(jnp.int32)
    is_hi = (s32 >= 256) & (idx < rle2_len)
    hi_rank = jnp.cumsum(is_hi.astype(jnp.int32)) - 1
    tgt = jnp.where(is_hi & (hi_rank < HI_CAP), hi_rank, HI_CAP)
    hi_packed = (
        jnp.zeros(HI_CAP, jnp.int32)
        .at[tgt]
        .set((idx << 1) | (s32 - 256), mode="drop")
    )
    return syms.astype(jnp.uint8), hi_packed, jnp.sum(is_hi.astype(jnp.int32))


# Several blocks per launch on one device is not a stream route; the
# batched forms (lax.map convergence BWT + flat batch mtf/rle2) live in
# dist/sharded.py, which needs multi-block-per-dispatch semantics.


@jax.jit
def _stage_post(last, n):
    """Everything after the BWT in ONE launch: MTF + RLE2 + compact
    transfer form + the per-chunk histogram of the device-refine path."""
    from ..kernels.huffman_dev import chunk_hist

    ranks, used = mtf_ranks(last, n, chunk=MTF_CHUNK)
    eob = jnp.sum(used).astype(jnp.int32) + 1
    syms, rle2_len, freqs = rle2_encode(ranks, n, eob)
    syms_u8, hi_packed, hi_count = _stage_compact(syms, rle2_len)
    # host-refine callers never fetch the histogram
    hist = chunk_hist(syms, rle2_len)
    return syms, rle2_len, freqs, used, syms_u8, hi_packed, hi_count, hist


@jax.jit
def _stage_full(data, n):
    """The whole per-block transform (BWT + MTF + RLE2 + compact + hist) as
    ONE launch; the production path routes here only once warm_aot_full has
    stamped it (see _transform)."""
    key, last = bwt_forward(data, n)
    post = _stage_post(last, n)
    return (key, *post)


def _rle2_compact(ranks, n, used):
    """Lean RLE2 + compact transfer form — the shared body of _stage_rle2c
    (split chain) and _stage_full_lean (fused fallback), so the transfer
    contract materialize() depends on (EOB-free sidecar of body symbols
    == 256, HI_CAP, quarter layout) is encoded once. No device freqs/hist:
    the host bincounts the fetched stream and the native refine engine
    builds its own chunk histograms; the EOB symbol is re-stamped on host
    (its position rle2_len-1 and value used_count+1 are both known there).
    The stream leaves the device as FOUR quarter arrays so the host can
    fetch only ceil(rle2_len / quarter) of them — RLE2 typically shrinks
    the stream to ~70% of the block, saving a quarter or two of D2H time."""
    eob = jnp.sum(used).astype(jnp.int32) + 1
    syms, rle2_len, _ = rle2_encode(ranks, n, eob, with_freqs=False)
    s32 = syms.astype(jnp.int32)
    idx = jnp.arange(s32.shape[0], dtype=jnp.int32)
    is_hi = (s32 >= 256) & (idx < rle2_len - 1)
    hi_count = jnp.sum(is_hi.astype(jnp.int32))

    # body symbols >= 256 exist only when the block uses all 256 byte values
    # AND hits MTF rank 255, so the position-extraction sort sits behind a
    # real runtime branch (lax.cond compiles to an HLO conditional on this
    # per-block graph) — most blocks skip a full-width sort entirely
    def _extract_hi():
        hi_key = jnp.where(is_hi, idx, jnp.int32(1 << 30))
        (hi_sorted,) = jax.lax.sort((hi_key,), num_keys=1)
        return hi_sorted[:HI_CAP]

    hi_pos = jax.lax.cond(
        hi_count > 0,
        _extract_hi,
        lambda: jnp.full((HI_CAP,), 1 << 30, jnp.int32),
    )
    syms_u8 = jnp.minimum(s32, 255).astype(jnp.uint8)
    q = syms_u8.reshape(4, -1)
    return rle2_len, (q[0], q[1], q[2], q[3]), hi_pos, hi_count, syms


@jax.jit
def _stage_rle2c(ranks, n, used):
    """Lean RLE2 + compact transfer form as its own launch: the third graph
    of the split lean chain (bwt / mtf / rle2c), which lets async dispatch
    overlap the stages of consecutive in-flight blocks."""
    return _rle2_compact(ranks, n, used)


@jax.jit
def _stage_full_lean(data, n):
    """Host-refine production transform: BWT + MTF + RLE2 + compact in ONE
    launch (the fallback route when only this graph is warm; see
    _rle2_compact for the transfer contract)."""
    key, last = bwt_forward(data, n)
    ranks, used = mtf_ranks(last, n, chunk=MTF_CHUNK)
    rle2_len, quarters, hi_pos, hi_count, syms = _rle2_compact(ranks, n, used)
    return key, syms, rle2_len, used, quarters, hi_pos, hi_count


# whether the fused single-launch graphs are available (compiled/cached) on
# this backend; probed once by _transform
_full_ok: bool | None = None
_lean_ok: bool | None = None


def _src_hash() -> str:
    """Hash of every source that shapes the fused graph; the warm stamp pins
    the compiled cache entry to these exact sources so a stale cache from an
    older kernel version can't route production onto an inline recompile."""
    import hashlib

    import inspect

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    h = hashlib.sha256()
    kdir = os.path.join(root, "kernels")
    for name in sorted(os.listdir(kdir)):
        if name.endswith(".py"):
            with open(os.path.join(kdir, name), "rb") as f:
                h.update(f.read())
    # only the graph-shaping pieces of this module, so unrelated host-side
    # edits don't force a re-warm
    for fn in (
        _stage_full,
        _stage_full_lean,
        _stage_post,
        _stage_compact,
        _stage_rle2c,
        _stage_mtf,
        _rle2_compact,
    ):
        h.update(inspect.getsource(getattr(fn, "__wrapped__", fn)).encode())
    h.update(f"{MTF_CHUNK},{HI_CAP}".encode())
    return h.hexdigest()


def _stamp_path() -> str:
    return os.path.join(cache_dir(), "tpubz_full_stamp")


def _probe_full() -> bool:
    """True if warm_aot_full() compiled _stage_full for exactly the current
    sources (production only fuses when the stamp proves the persistent
    cache holds the graph, so no block waits on an inline compile).
    TPUBZ_FUSED=0/1 overrides."""
    global _full_ok
    if _full_ok is None:
        mode = os.environ.get("TPUBZ_FUSED", "auto")
        if mode in ("0", "1"):
            _full_ok = mode == "1"
        else:
            try:
                with open(_stamp_path()) as f:
                    _full_ok = f.read().strip() == _src_hash()
            except OSError:
                _full_ok = False
    return _full_ok


def _probe_full_lean() -> bool:
    """Like _probe_full, for the lean host-refine fused graph (its own stamp
    since it compiles separately). TPUBZ_FUSED=0/1 overrides both."""
    global _lean_ok
    if _lean_ok is None:
        mode = os.environ.get("TPUBZ_FUSED", "auto")
        if mode in ("0", "1"):
            _lean_ok = mode == "1"
        else:
            try:
                with open(_stamp_path() + "_lean") as f:
                    _lean_ok = f.read().strip() == _src_hash()
            except OSError:
                _lean_ok = False
    return _lean_ok


_split_ok: bool | None = None


def _probe_split_lean() -> bool:
    """True when the split lean stages (bwt / mtf / rle2c) are AOT-warmed
    for the current sources — the preferred production route (launches
    pipeline across in-flight blocks). TPUBZ_SPLIT=0/1 overrides."""
    global _split_ok
    if _split_ok is None:
        mode = os.environ.get("TPUBZ_SPLIT", "auto")
        if mode in ("0", "1"):
            _split_ok = mode == "1"
        else:
            try:
                with open(_stamp_path() + "_split") as f:
                    _split_ok = f.read().strip() == _src_hash()
            except OSError:
                _split_ok = False
    return _split_ok


def warm_aot_full(level: int = 9, lean_only: bool = False):
    """AOT-compile the split lean chain and the fused single-launch graphs
    into the persistent cache and stamp them so _transform routes through
    them. The lean (host-refine) graphs are the production default; the
    full graph also carries freqs/hist for the device-refine path."""
    setup_jax_cache()
    N = DeviceBlockEncoder(level).N
    d = jax.ShapeDtypeStruct((N,), jnp.uint8)
    n = jax.ShapeDtypeStruct((), jnp.int32)
    # the split lean chain (production default: launches pipeline)
    _stage_bwt.lower(d, n).compile()
    _stage_mtf.lower(d, n).compile()
    exe = _stage_rle2c.lower(
        jax.ShapeDtypeStruct((N,), jnp.int32),
        n,
        jax.ShapeDtypeStruct((256,), jnp.bool_),
    ).compile()
    with open(_stamp_path() + "_split", "w") as f:
        f.write(_src_hash())
    exe = _stage_full_lean.lower(d, n).compile()
    with open(_stamp_path() + "_lean", "w") as f:
        f.write(_src_hash())
    if lean_only:
        return exe
    exe = _stage_full.lower(d, n).compile()
    with open(_stamp_path(), "w") as f:
        f.write(_src_hash())
    return exe


def _transform(data, n, lean: bool = False):
    """data uint8[N] (first n valid) -> transform tuple (lean 7-tuple or
    full 9-tuple; materialize handles both).

    Routes by the warm stamps: the split lean chain, then a fused
    single-launch graph; an unstamped process takes two stages (BWT, fused
    post).
    """
    if lean and _probe_split_lean():
        key, last = _stage_bwt(data, n)
        ranks, used = _stage_mtf(last, n)
        rle2_len, quarters, hi_pos, hi_count, syms = _stage_rle2c(
            ranks, n, used
        )
        return key, syms, rle2_len, used, quarters, hi_pos, hi_count
    if lean and _probe_full_lean():
        return _stage_full_lean(data, n)
    if _probe_full():
        return _stage_full(data, n)
    key, last = _stage_bwt(data, n)
    post = _stage_post(last, n)
    return (key, *post)


def materialize(out):
    """Fetch everything the host needs from a _transform result: returns
    (key, syms u16, rle2_len, freqs, used). The symbol stream travels in
    the compact u8 + sidecar form; the full u16 array is only
    pulled on sidecar overflow (rare). Lean 7-tuples (no device freqs) get
    their frequency table from a host bincount over the fetched stream and
    the EOB re-stamped at rle2_len-1."""
    if len(out) == 7:
        key, syms, rle2_len, used, quarters, hi_pos, hi_count = out
        # two-phase fetch: the tiny sidecars first, then only the
        # symbol-stream quarters rle2_len actually covers
        key, rle2_len, used, hi_pos, hc = jax.device_get(
            (key, rle2_len, used, hi_pos, hi_count)
        )
        rl, hc = int(rle2_len), int(hc)
        if hc > HI_CAP:
            s = np.asarray(syms)
            freqs = np.bincount(s[:rl], minlength=258).astype(np.int64)
        else:
            ql = quarters[0].shape[0]
            need = min(4, (rl + ql - 1) // ql)
            syms_u8 = np.concatenate(jax.device_get(quarters[:need]))
            # count the u8 form (cheaper than a u16 bincount), then fix up
            # the clamped hi symbols and the EOB slot
            eob = int(used.sum()) + 1
            freqs = np.zeros(258, np.int64)
            freqs[:256] = np.bincount(syms_u8[:rl], minlength=256)
            s = syms_u8.astype(np.uint16)
            if hc:
                s[hi_pos[:hc]] = 256
                freqs[255] -= hc
                freqs[256] += hc
            s[rl - 1] = eob
            freqs[min(eob, 255)] -= 1
            freqs[eob] += 1
        return int(key), s, rl, freqs, used
    key, syms, rle2_len, freqs, used, syms_u8, hi_packed, hi_count = out[:8]
    key, rle2_len, freqs, used, syms_u8, hi_packed, hc = jax.device_get(
        (key, rle2_len, freqs, used, syms_u8, hi_packed, hi_count)
    )
    hc = int(hc)
    if hc > HI_CAP:
        s = np.asarray(syms)
    else:
        s = uncompact_syms(syms_u8, hi_packed, hc)
    return int(key), s, int(rle2_len), freqs, used


def uncompact_syms(syms_u8, hi_packed, hc: int) -> np.ndarray:
    """Invert _stage_compact's transfer form: u8 stream -> u16 symbols with
    the packed sidecar's rare symbols >= 256 patched back in. THE single
    host-side decoder of the `(pos << 1) | (sym - 256)` contract — every
    consumer (materialize here, dist/multihost's shard fetch) must route
    through it so a packing change cannot silently desynchronize them.
    Caller handles sidecar overflow (hc > HI_CAP) by fetching full rows."""
    s = syms_u8.astype(np.uint16)
    if hc:
        packed = hi_packed[:hc]
        s[packed >> 1] = 256 + (packed & 1)
    return s


class DeviceBlockEncoder:
    """Encodes RLE1 blocks through the device transform pipeline."""

    def __init__(self, level: int):
        setup_jax_cache()
        self.level = level
        raw = level * 100_000
        self.N = ((raw + MTF_CHUNK - 1) // MTF_CHUNK) * MTF_CHUNK

    def transform(self, rle1_block: np.ndarray, lean: bool = False):
        pad = np.zeros(self.N, np.uint8)
        pad[: rle1_block.size] = rle1_block
        return _transform(jnp.asarray(pad), jnp.int32(rle1_block.size), lean)

    def transform_bwt(self, rle1_block: np.ndarray):
        """BWT-only device dispatch (MTF/RLE2 run natively on the fetched
        last column — see stream/api.py's bwt route). Returns (key_dev,
        last_dev, n)."""
        pad = np.zeros(self.N, np.uint8)
        pad[: rle1_block.size] = rle1_block
        key_d, last_d = _stage_bwt(jnp.asarray(pad), jnp.int32(rle1_block.size))
        return key_d, last_d, rle1_block.size

    def encode_block(self, rle1_block: np.ndarray, crc: int) -> BitAccum:
        key, syms, rle2_len, freqs, used = materialize(
            self.transform(rle1_block, lean=True)
        )
        return self.emit_block(key, syms, rle2_len, freqs, used, crc)

    # host emission lives in the jax-free tpubz/block/emit.py so CPU-only
    # paths never import this module (and its jax dependency) to reach it
    emit_block = staticmethod(emit.emit_block)

    def encode_block_devrefine(self, trans_out, crc: int) -> BitAccum:
        """Encode with the refinement argmin/rfreq matmuls and the payload
        packing on device (SURVEY.md §2 row 9; reference huffman.rs:139-174 +
        bitpacker.rs:17-111): only per-pass lens/rfreq/selector sidecars and
        the packed payload bits leave the device — never the 900k u8 symbol
        stream. Output bytes are identical to emit_block (same refinement
        trajectory, same snapshot rule; cross-checked in tests)."""
        import jax.numpy as jnp

        from ..kernels.huffman_dev import (
            nsel_cap,
            pack_payload,
            refine_pass,
        )
        from ..native import code_lengths_native

        key_d, syms_d, rle2_len_d, freqs_d, used_d = trans_out[:5]
        hist_d = trans_out[8]
        key, rle2_len, freqs, used = jax.device_get(
            (key_d, rle2_len_d, freqs_d, used_d)
        )
        key, rle2_len = int(key), int(rle2_len)
        alpha = int(used.sum()) + 2
        tc = group_count_for(rle2_len)
        nsel = (rle2_len + GROUP_SIZE - 1) // GROUP_SIZE
        lens = c_init_tables(freqs.astype(np.int64), tc, alpha)
        iters = huffman_iters()
        best = None
        stale = 0
        for it in range(iters):
            sel_d, rfreq_d = refine_pass(
                hist_d, jnp.asarray(lens, jnp.int32), jnp.int32(tc)
            )
            sel_full, rfreq = jax.device_get((sel_d, rfreq_d))
            sel = sel_full[:nsel].astype(np.int64)
            rfreq64 = rfreq.astype(np.int64)
            for t in range(tc):
                cl = code_lengths_native(rfreq64[t], alpha)
                if cl is None:
                    cl = c_code_lengths(rfreq64[t], alpha)
                lens[t, :alpha] = cl
            # exact emitted bits for this snapshot (same formula as the
            # native engine: payload via rfreq x NEW lens)
            payload = int((rfreq64[:tc, :alpha] * lens[:tc, :alpha]).sum())
            sel_bits = int(mtf_selectors(sel, tc).sum()) + nsel
            dl = int(np.abs(np.diff(lens[:tc, :alpha], axis=1)).sum())
            bits = payload + sel_bits + dl * 2 + tc * (alpha + 5)
            if best is None or bits < best[0]:
                best = (bits, sel, lens.copy(), rfreq64.copy())
                stale = 0
            else:
                stale += 1
            # adaptive stop: past the C-faithful 4 passes, quit after ONE
            # flat extra pass — in sync with refine.cpp and hostref
            if it >= 3 and stale >= 1:
                break
        _, sel_b, lens_b, rfreq_b = best
        payload_bits = int((rfreq_b[:tc, :alpha] * lens_b[:tc, :alpha]).sum())
        acc = BitAccum()
        acc.put(BLOCK_MAGIC, 48)
        acc.put(crc, 32)
        acc.put(0, 1)
        acc.put(key, 24)
        codes = huffman_emit_headers(acc, used, sel_b, lens_b[:, :alpha], tc)
        codes_pad = np.zeros((6, 258), np.uint32)
        codes_pad[:tc, :alpha] = codes
        lens_pad = np.zeros((6, 258), np.int32)
        lens_pad[:tc, :alpha] = lens_b[:tc, :alpha]
        sel_pad = np.zeros(nsel_cap(syms_d.shape[0]), np.int8)
        sel_pad[:nsel] = sel_b
        words_d, total_d = pack_payload(
            syms_d,
            rle2_len_d,
            jnp.asarray(sel_pad),
            jnp.asarray(codes_pad),
            jnp.asarray(lens_pad),
        )
        # fetch only the words the payload needs, bucketed to a few static
        # slice shapes so each bucket compiles one tiny slice program
        nwords = (payload_bits + 31) // 32
        cap = 4096
        while cap < nwords:
            cap *= 2
        cap = min(cap, words_d.shape[0])
        words, total = jax.device_get((words_d[:cap], total_d))
        if int(total) != payload_bits:
            # a non-exact matmul or a backend bug: never emit the stream
            raise RuntimeError(
                f"device payload bits diverged ({int(total)} != "
                f"{payload_bits})"
            )
        acc.put_words(np.asarray(words), payload_bits)
        return acc
