"""RLE2 zero-run coding on device: segmented formulation.

Reference semantics (src/tools/rle2_mtf.rs:84-101): MTF rank 0 never emitted;
a zero run of length L becomes the bijective base-2 digits of L (RUNA=0,
RUNB=1 symbols, low digit first; digit_j = ((L+1) >> j) & 1 over
floor(log2(L+1)) digits); literal rank r >= 1 becomes symbol r+1; EOB
(= used+1) is appended last.

Vectorized as ONE direct scatter: every input position computes its own
output slot and symbol in closed form — the (t+1)-th zero of a run carries
digit t of that run's bijective coding (digit count <= run length always,
so the run's zeros can host all its digits), and a nonzero position carries
its literal at offset + digit-count. Targets are unique by construction, so
the scatter is a plain unique-index set. This replaced an inverse-mapping
formulation (stamp emitter ids, cummax forward-fill, gather payloads):
one scatter + three scans instead of one scatter + one scan + two gathers.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp




def num_digits(run_len):
    """Digit count of the bijective base-2 coding: floor(log2(L+1)); 0 if L==0."""
    L1 = (run_len + 1).astype(jnp.uint32)
    return jnp.where(run_len > 0, 31 - jax.lax.clz(L1).astype(jnp.int32), 0)


def rle2_encode(
    ranks: jnp.ndarray,
    n: jnp.ndarray,
    eob: jnp.ndarray,
    with_freqs: bool = True,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray | None]:
    """ranks: int32[N] MTF ranks (first n valid).

    Returns (syms uint16[N+8], rle2_len, freqs int32[258]): the RLE2 symbol
    stream (length rle2_len incl. trailing EOB; run coding only shrinks zero
    runs so output stays below input length + digits slack). with_freqs=False
    skips the frequency histogram (freqs is None) — the lean host-refine
    graph counts on host instead.
    """
    N = ranks.shape[0]
    OUT = N + 8  # slack for EOB + trailing digits; last slot is a dump lane
    BIG = jnp.int32(1 << 30)
    idx = jnp.arange(N, dtype=jnp.int32)
    valid = idx < n
    nonzero = valid & (ranks != 0)
    # last nonzero index strictly before i (or -1): exclusive prefix max
    nz_idx = jnp.where(nonzero, idx, -1)
    last_nz = jax.lax.associative_scan(jnp.maximum, nz_idx)
    prev_nz = jnp.concatenate((jnp.full(1, -1, jnp.int32), last_nz[:-1]))
    # next nonzero index at/after i (or BIG): reverse prefix min. Zeros use
    # it to find their run's closing literal; a trailing run has none.
    next_nz = jax.lax.associative_scan(
        jnp.minimum, jnp.where(nonzero, idx, BIG), reverse=True
    )
    run_before = jnp.where(nonzero, idx - prev_nz - 1, 0)
    d = num_digits(run_before)
    emit = jnp.where(nonzero, d + 1, 0)
    off = jnp.cumsum(emit) - emit  # exclusive; constant across a zero run,
    # so a zero position reads its run's emitter offset directly
    total_body = jnp.sum(emit)
    # trailing zero run after the last nonzero (or the whole block)
    last_valid_nz = jnp.max(jnp.where(nonzero, idx, -1))
    tail_run = n - 1 - last_valid_nz
    tail_d = num_digits(tail_run)

    # Direct scatter: the (t+1)-th zero of a run (t = i - prev_nz - 1)
    # carries digit t of the run's bijective code — digit count
    # floor(log2(L+1)) <= L, so a run's zeros always cover its digits; a
    # nonzero carries its literal at off + d. Each output slot is written
    # by exactly one input position (unique targets), trailing-run zeros
    # land after total_body via the same formulas (their off IS total_body).
    run_len = jnp.minimum(next_nz, n) - prev_nz - 1  # this zero's run length
    t = idx - prev_nz - 1  # ordinal within the run
    zero_live = valid & (ranks == 0) & (t < num_digits(run_len))
    tgt = jnp.where(
        nonzero,
        off + d,
        jnp.where(zero_live, off + t, OUT),
    )
    val = jnp.where(
        nonzero,
        ranks + 1,
        ((run_len + 1) >> jnp.clip(t, 0, 31)) & 1,
    )
    rle2_len = total_body + tail_d + 1
    syms = (
        jnp.zeros(OUT, jnp.int32)
        .at[tgt]
        .set(val, mode="drop", unique_indices=True)
        .at[rle2_len - 1]
        .set(eob)
        .astype(jnp.uint16)
    )
    if not with_freqs:
        return syms, rle2_len, None
    out_idx = jnp.arange(OUT, dtype=jnp.int32)
    freqs = (
        jnp.zeros(258, jnp.int32)
        .at[jnp.where(out_idx < rle2_len, syms.astype(jnp.int32), 258)]
        .add(1, mode="drop")
    )
    return syms, rle2_len, freqs


def rle2_encode_batch(
    ranks: jnp.ndarray, n: jnp.ndarray, eob: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Batched RLE2 over [B, N] blocks: the single-block formulation with
    every scan/cumsum running along axis=1 (resets per block by
    construction) and scatters flattened with per-block row bases. One
    launch, single-block op count — the vmapped variant's compile cost
    scales badly on this backend.

    ranks int32[B, N], n int32[B], eob int32[B] ->
    (syms uint16[B, N+8], rle2_len int32[B], freqs int32[B, 258]).
    """
    B, N = ranks.shape
    OUT = N + 8
    BIG = jnp.int32(1 << 30)
    idx = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32), (B, N))
    valid = idx < n[:, None]
    nonzero = valid & (ranks != 0)
    nz_idx = jnp.where(nonzero, idx, -1)
    last_nz = jax.lax.associative_scan(jnp.maximum, nz_idx, axis=1)
    prev_nz = jnp.concatenate(
        (jnp.full((B, 1), -1, jnp.int32), last_nz[:, :-1]), axis=1
    )
    next_nz = jax.lax.associative_scan(
        jnp.minimum, jnp.where(nonzero, idx, BIG), axis=1, reverse=True
    )
    run_before = jnp.where(nonzero, idx - prev_nz - 1, 0)
    d = num_digits(run_before)
    emit = jnp.where(nonzero, d + 1, 0)
    off = jnp.cumsum(emit, axis=1) - emit  # exclusive, per block
    total_body = jnp.sum(emit, axis=1)  # [B]
    last_valid_nz = jnp.max(jnp.where(nonzero, idx, -1), axis=1)  # [B]
    tail_run = n - 1 - last_valid_nz
    tail_d = num_digits(tail_run)

    # same direct-scatter formulation as the single-block path, with
    # per-block row bases flattening the scatter targets
    run_len = jnp.minimum(next_nz, n[:, None]) - prev_nz - 1
    t = idx - prev_nz - 1
    zero_live = valid & (ranks == 0) & (t < num_digits(run_len))
    row_base = jnp.arange(B, dtype=jnp.int32)[:, None] * OUT
    tgt_flat = jnp.where(
        nonzero,
        row_base + off + d,
        jnp.where(zero_live, row_base + off + t, B * OUT),
    )
    val = jnp.where(
        nonzero,
        ranks + 1,
        ((run_len + 1) >> jnp.clip(t, 0, 31)) & 1,
    )
    rle2_len = total_body + tail_d + 1
    eob_tgt = jnp.arange(B, dtype=jnp.int32) * OUT + rle2_len - 1
    syms = (
        jnp.zeros(B * OUT, jnp.int32)
        .at[tgt_flat.reshape(B * N)]
        .set(val.reshape(B * N), mode="drop", unique_indices=True)
        .at[eob_tgt]
        .set(eob, mode="drop", unique_indices=True)
        .reshape(B, OUT)
        .astype(jnp.uint16)
    )
    out_idx = jnp.broadcast_to(jnp.arange(OUT, dtype=jnp.int32), (B, OUT))
    frow = jnp.arange(B, dtype=jnp.int32)[:, None] * 258
    freqs = (
        jnp.zeros(B * 258, jnp.int32)
        .at[
            jnp.where(
                out_idx < rle2_len[:, None], frow + syms.astype(jnp.int32), B * 258
            )
        ]
        .add(1, mode="drop")
    ).reshape(B, 258)
    return syms, rle2_len, freqs
