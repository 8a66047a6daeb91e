"""Inverse BWT on device: pointer-doubling orbit construction.

The reference's inverse is a serial pointer chase (src/bwt_algorithms/
bwt_sort.rs:91-130, flagged "cache coherency" TBD at decompress.rs:12).
Data-parallel form: build the next-pointer permutation with a stable
counting sort (one variadic sort), then materialize the orbit of the key in
O(log n) doubling steps — positions[k:2k] = jump^k(positions[:k]) — so the
serial chain becomes log n batched permutation applications.

STATUS: correctness-tested device formulation, NOT a production route:
decode is host CPU work (stream/decode.py). Whether the gathers this
inverse is made of beat the native segmented chase on a given device is an
open measurement.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def _next_pointers(last, n):
    """Stable counting-sort next-pointer vector: nxt[j] = index in `last` of
    the j-th occurrence in (byte, position) order."""
    N = last.shape[0]
    idx = jnp.arange(N, dtype=jnp.int32)
    sym = jnp.where(idx < n, last.astype(jnp.int32), 256)
    _, nxt = jax.lax.sort((sym, idx), num_keys=1)
    return nxt


@jax.jit
def _gather(jump, positions):
    return jump[positions]


def bwt_inverse_device(key: int, last: np.ndarray, n: int) -> np.ndarray:
    """Invert the rotation BWT of `last[:n]` on device. Returns uint8[n]."""
    N = last.shape[0] if hasattr(last, "shape") else len(last)
    pad = np.zeros(N, np.uint8)
    pad[:n] = np.asarray(last)[:n]
    dev_last = jnp.asarray(pad)
    nxt = _next_pointers(dev_last, jnp.int32(n))
    if n == 0:
        return np.zeros(0, np.uint8)
    # host-driven doubling: log2(n) standalone gathers over power-of-two
    # position blocks (positions[k:2k] = jump^k(positions[:k]))
    positions = np.empty(n, dtype=np.int32)
    positions[0] = int(nxt[key])
    filled = 1
    jump = nxt
    while filled < n:
        take = min(filled, n - filled)
        block = np.asarray(_gather(jump, jnp.asarray(positions[:filled])))
        positions[filled : filled + take] = block[:take]
        filled += take
        if filled < n:
            jump = _gather(jump, jump)
    host_last = np.asarray(dev_last)
    return host_last[positions].astype(np.uint8)
