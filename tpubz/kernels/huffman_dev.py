"""Device Huffman refinement stages + on-device payload packing.

The reference's Huffman refinement is a per-pass scan: for each 50-symbol
chunk, sum code lengths under each candidate table, pick the argmin, and
re-accumulate per-table symbol frequencies (src/huffman_coding/huffman.rs:
139-174). The chunk-cost argmin is a matmul-shaped op (SURVEY.md §2 row
9): with per-chunk histograms hist[nsel, 258] built once, every pass is

    cost  = hist @ lens.T            (nsel, 258) @ (258, 6)   -> argmin
    rfreq = onehot(sel).T @ hist     (6, nsel)   @ (nsel, 258)

two small matmuls. Only the six <=258-leaf tree builds per pass run on
host (native engine), with tiny lens/rfreq arrays leaving the device
instead of the 900k-symbol stream.

Exactness: all matmul operands are small integers (counts <= 50, lengths
<= 20, one-hot 0/1) and every sum stays below 2^24 (a block has < 2^20
symbols), so f32 products and sums are exact. The matmuls run at
`precision="highest"`, which keeps a GPU from computing them in TF32 (10
mantissa bits would round lengths x counts), so cost/rfreq are bit-exact
against the native integer engine (cross-checked in tests). argmin ties
resolve to the lowest table index in both engines (jnp.argmin picks the
first minimum; the native scan uses strict `<`).

Payload packing (reference src/bitstream/bitpacker.rs:17-111) then happens
on device: per-symbol (code, length) gathers from the 6x258 tables by the
chunk's selector, packed by the prefix-sum bitpack kernel — so the payload
leaves the device as packed bits, not as the u8 symbol stream.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..format.constants import GROUP_SIZE
from .bitpack import pack_bits_device

ALPHA_MAX = 258
PAYLOAD_MAX_BITS_PER_SYM = 20  # format ceiling; encoder emits <= 17


def nsel_cap(out_len: int) -> int:
    return (out_len + GROUP_SIZE - 1) // GROUP_SIZE


def payload_words_cap(out_len: int) -> int:
    return (out_len * PAYLOAD_MAX_BITS_PER_SYM + 31) // 32 + 1


@jax.jit
def chunk_hist(syms: jnp.ndarray, rle2_len: jnp.ndarray) -> jnp.ndarray:
    """Per-50-symbol-chunk histograms: (NSEL, 258) int32 (zero past rle2_len)."""
    out = syms.shape[0]
    nsel = nsel_cap(out)
    idx = jnp.arange(out, dtype=jnp.int32)
    flat = jnp.where(
        idx < rle2_len,
        (idx // GROUP_SIZE) * ALPHA_MAX + syms.astype(jnp.int32),
        nsel * ALPHA_MAX,
    )
    hist = jnp.zeros(nsel * ALPHA_MAX, jnp.int32).at[flat].add(1, mode="drop")
    return hist.reshape(nsel, ALPHA_MAX)


@jax.jit
def refine_pass(
    hist: jnp.ndarray, lens: jnp.ndarray, table_count: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One refinement pass: (selectors int8[NSEL], rfreq int32[6, 258]).

    hist: int32[NSEL, 258]; lens: int32[6, 258]; table_count: 2..6.
    Rows of hist past the real selector count are all-zero, so their
    selectors are garbage (host slices them off) and they add nothing to
    rfreq.
    """
    histf = hist.astype(jnp.float32)
    lensf = lens.astype(jnp.float32)
    cost = jnp.dot(histf, lensf.T, precision="highest")  # (NSEL, 6)
    cost = cost + jnp.where(
        jnp.arange(6)[None, :] < table_count, 0.0, jnp.float32(3.0e8)
    )
    sel = jnp.argmin(cost, axis=1).astype(jnp.int8)
    onehot = (sel.astype(jnp.int32)[:, None] == jnp.arange(6)[None, :]).astype(
        jnp.float32
    )
    rfreq = jnp.dot(onehot.T, histf, precision="highest")  # (6, 258)
    return sel, rfreq.astype(jnp.int32)


@jax.jit
def pack_payload(
    syms: jnp.ndarray,
    rle2_len: jnp.ndarray,
    sel: jnp.ndarray,
    codes: jnp.ndarray,
    lens: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Pack the Huffman payload on device.

    syms uint16[OUT] (first rle2_len valid), sel int8[NSEL] (final
    selectors), codes uint32[6, 258], lens int32[6, 258].
    Returns (words uint32[CAP] MSB-first, total_bits).
    """
    out = syms.shape[0]
    idx = jnp.arange(out, dtype=jnp.int32)
    valid = idx < rle2_len
    s = sel[idx // GROUP_SIZE].astype(jnp.int32)
    flat = s * ALPHA_MAX + syms.astype(jnp.int32)
    v = codes.reshape(-1)[flat]
    b = jnp.where(valid, lens.reshape(-1)[flat], 0)
    return pack_bits_device(
        v.astype(jnp.uint32), b.astype(jnp.int32), payload_words_cap(out)
    )


def chunk_hist_batch(syms: jnp.ndarray, rle2_len: jnp.ndarray) -> jnp.ndarray:
    """Batched per-chunk histograms over [B, OUT] symbol streams as one flat
    scatter-add: (B, NSEL, 258) int32."""
    B, out = syms.shape
    nsel = nsel_cap(out)
    idx = jnp.broadcast_to(jnp.arange(out, dtype=jnp.int32), (B, out))
    chunk = (
        jnp.arange(B, dtype=jnp.int32)[:, None] * nsel + idx // GROUP_SIZE
    )
    flat = jnp.where(
        idx < rle2_len[:, None],
        chunk * ALPHA_MAX + syms.astype(jnp.int32),
        B * nsel * ALPHA_MAX,
    )
    hist = (
        jnp.zeros(B * nsel * ALPHA_MAX, jnp.int32).at[flat].add(1, mode="drop")
    )
    return hist.reshape(B, nsel, ALPHA_MAX)
