"""Device bitstream packer: MSB-first variable-length fields -> uint32 words.

The reference packs bits serially through a 64-bit queue
(src/bitstream/bitpacker.rs:17-111). Data-parallel form: per-field bit offsets
via exclusive cumsum of field lengths, then each field's contribution lands
in at most two 32-bit words (field <= 24 bits, in-word offset <= 31), written
with two scatter-adds (bit ranges are disjoint, so add == or).
"""
from __future__ import annotations

import jax.numpy as jnp


def pack_bits_device(
    vals: jnp.ndarray, bits: jnp.ndarray, out_words: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """vals uint32[M] (fields, <= 24 bits each), bits int32[M] (0 allowed).

    Returns (words uint32[out_words] big-endian bit order, total_bits).
    """
    vals = vals.astype(jnp.uint32)
    bits = bits.astype(jnp.int32)
    offs = jnp.cumsum(bits) - bits
    total = offs[-1] + bits[-1]
    w = offs >> 5
    b = offs & 31
    end = b + bits
    fits = end <= 32
    sh_hi = jnp.where(fits, 32 - end, 0).astype(jnp.uint32)
    k = jnp.where(fits, 0, end - 32).astype(jnp.uint32)
    hi = jnp.where(fits, vals << sh_hi, vals >> k)
    sh_lo = jnp.where(fits, 0, 64 - end).astype(jnp.uint32)
    lo = jnp.where(fits, jnp.uint32(0), vals << sh_lo)
    # zero-length fields contribute nothing (vals masked to 0 bits by caller)
    hi = jnp.where(bits > 0, hi, 0)
    lo = jnp.where(bits > 0, lo, 0)
    words = jnp.zeros(out_words, jnp.uint32)
    words = words.at[w].add(hi, mode="drop")
    words = words.at[w + 1].add(lo, mode="drop")
    return words, total


def words_to_bytes(words, total_bits: int):
    """Host-side: big-endian byte view of the packed words, zero-padded."""
    import numpy as np

    arr = np.asarray(words, dtype=np.uint32)
    out = np.zeros(arr.size * 4, dtype=np.uint8)
    out[0::4] = (arr >> 24) & 0xFF
    out[1::4] = (arr >> 16) & 0xFF
    out[2::4] = (arr >> 8) & 0xFF
    out[3::4] = arr & 0xFF
    nbytes = (int(total_bits) + 7) // 8
    return out[:nbytes].tobytes()
