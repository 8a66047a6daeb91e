"""Move-to-front on device, scan-free.

The reference's MTF is an inherently serial per-byte scan over a 256-entry
list (src/tools/rle2_mtf.rs:61-138). Data-parallel formulation, built from
sorts, rolls, cumscans, structured scatters and elementwise compare-reduces
— no lax loops, no batched gathers:

  1. The MTF list at any point is: symbols seen so far ordered by last
     occurrence (most recent first), then unseen symbols in initial
     (sorted-alphabet) order. Define the chunk-start *recency key* of
     symbol s at chunk c:
         key[c, s] = N - last_before[c, s]        if seen before the chunk
                   = 2N + init_rank[s]            otherwise
     Chunk-start MTF rank of s = #{s' used : key[c, s'] < key[c, s]} —
     keys are distinct across symbols, so rank comparisons reduce to key
     comparisons and no rank-by-sort / table lookup is needed anywhere:
     for a first-in-chunk position i, key_i falls out of the global
     prev-occurrence array directly (prev_g[i] IS sym_i's last occurrence
     before the chunk).
  2. Within a chunk, rank[i] = # distinct symbols since the previous
     occurrence of sym[i]:
       prev in-chunk:     #{j in (prev_i, i) : next_j >= i}  (positions that
                          are last-in-window occurrences of their symbol)
       prev out-of-chunk: srank[i] + #{j < i : first-in-chunk_j,
                          key_j >= key_i}  (symbols re-seen in the chunk
                          moved in front; the rest keep chunk-start order)
     Both cases reduce over one (chunk x chunk) boolean dominance matrix,
     and srank[i] is one (chunk x 256) compare-count against the chunk's
     key row. Each is written as a broadcast compare feeding a sum, which
     XLA fuses into one reduction, so the (rows, chunk, chunk) boolean
     tensor is never stored.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

ABSENT = 256  # plain int: no backend init at import time


def _prev_next(symk, flat_idx, M):
    """Global prev/next occurrence of each position's symbol, from one sort
    of (symbol, position) and one 3-operand sort back. (The initial-rank of
    a first-occurrence symbol used to ride this sort as a 4th operand; it is
    cheaper as a standalone gather from the init_rank table at the caller.)"""
    s_key, s_idx = jax.lax.sort((symk, flat_idx), num_keys=1)
    same_prev = jnp.concatenate(
        (jnp.zeros(1, jnp.bool_), s_key[1:] == s_key[:-1])
    )
    same_next = jnp.concatenate(
        (s_key[1:] == s_key[:-1], jnp.zeros(1, jnp.bool_))
    )
    prev_sorted = jnp.where(same_prev, jnp.roll(s_idx, 1), -1)
    next_sorted = jnp.where(same_next, jnp.roll(s_idx, -1), M)
    _, prev_g, next_g = jax.lax.sort(
        (s_idx, prev_sorted, next_sorted), num_keys=1
    )
    return s_key, s_idx, prev_g, next_g


def _ranks_from_parts(lprev, lnext, keyi, keyrow, chunk):
    """Fuse the dominance count (in-chunk) with the chunk-start rank count
    (vs the key row). lprev/lnext/keyi: (rows, chunk); keyrow: (rows, 256)."""
    lfirst = lprev < 0
    # chunk-start rank = #used symbols with a smaller recency key. Unused
    # symbols carry key 2N+ABSENT, larger than any used key, so they never
    # count. Only meaningful (and used) at first-in-chunk positions.
    srank = jnp.sum(
        keyrow[:, None, :] < keyi[:, :, None], axis=-1, dtype=jnp.int32
    )
    li = jnp.arange(chunk, dtype=jnp.int32)
    ii = li[None, :, None]  # row: position i
    jj = li[None, None, :]  # col: candidate j
    before = jj < ii
    case1 = (jj > lprev[:, :, None]) & (lnext[:, None, :] >= ii)
    # key comparisons are equivalent to chunk-start rank comparisons:
    # keys are distinct per distinct symbol and rank is monotone in key
    case2 = lfirst[:, None, :] & (keyi[:, None, :] >= keyi[:, :, None])
    has_prev = (lprev >= 0)[:, :, None]
    mat = before & jnp.where(has_prev, case1, case2)
    counts = jnp.sum(mat, axis=-1, dtype=jnp.int32)
    return counts + jnp.where(lfirst, srank, 0)


def mtf_ranks(
    last: jnp.ndarray, n: jnp.ndarray, chunk: int = 256
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """last: uint8[N] BWT output (first n valid; N % chunk == 0).

    Returns (ranks int32[N], used bool[256]): ranks[i] = MTF rank of last[i]
    over the compacted used-symbol alphabet; pad lanes carry garbage.
    """
    N = last.shape[0]
    assert N % chunk == 0, "N must be a multiple of the chunk size"
    nc = N // chunk
    idx = jnp.arange(N, dtype=jnp.int32)
    valid = idx < n
    # pad lanes carry symbol 256 (their own column in last_pos) so `used`
    # falls out of the occurrence scan below with no dedicated scatter
    sym = jnp.where(valid, last.astype(jnp.int32), 256)

    s_sym, s_idx, prev_g, next_g = _prev_next(sym, idx, N)

    # per-(chunk, symbol) last occurrence: flag last-in-chunk entries in the
    # (sym, idx) sorted stream, one structured scatter into (nc, 257).
    # Marked entries hit unique (chunk, symbol) cells by construction (one
    # last-entry per group), so this is a plain unique-index SET, not a
    # scatter-max
    s_cid = s_idx // chunk
    nxt_diff = jnp.concatenate(
        ((s_sym[1:] != s_sym[:-1]) | (s_cid[1:] != s_cid[:-1]), jnp.ones(1, jnp.bool_))
    )
    # flat 1-D target index (precomputed) rather than a 2-D-indexed scatter
    tgt = jnp.where(nxt_diff, s_cid * 257 + s_sym, nc * 257)
    last_pos = (
        jnp.full(nc * 257, -1, jnp.int32)
        .at[tgt]
        .set(s_idx, mode="drop", unique_indices=True)
        .reshape(nc, 257)
    )
    # exclusive running max over chunks = last occurrence before chunk start;
    # the scan's final row is the global last occurrence, so `used` is free
    run = jax.lax.associative_scan(jnp.maximum, last_pos, axis=0)
    used = run[-1, :256] >= 0
    init_rank = jnp.where(used, jnp.cumsum(used.astype(jnp.int32)) - 1, ABSENT)
    last_before = jnp.concatenate(
        (jnp.full((1, 256), -1, jnp.int32), run[:-1, :256]), axis=0
    )
    keyrow = jnp.where(
        last_before >= 0, N - last_before, 2 * N + init_rank[None, :]
    )

    cid = idx // chunk
    cstart = cid * chunk
    # recency key of each position's own symbol at its chunk start: for
    # first-in-chunk positions prev_g IS the last occurrence before the
    # chunk (that's the only place keyi is consumed). First-EVER occurrences
    # key by the symbol's initial rank = #{used t < sym} — computed as a
    # fused broadcast-compare count instead of a table gather. Pad lanes
    # (sym == 256) count every used symbol; their value is never consumed.
    irank_pos = jnp.sum(
        used[None, None, :]
        & (jnp.arange(256, dtype=jnp.int32)[None, None, :]
           < sym.reshape(nc, chunk)[:, :, None]),
        axis=-1,
        dtype=jnp.int32,
    ).reshape(N)
    keyi = jnp.where(prev_g >= 0, N - prev_g, 2 * N + irank_pos).reshape(
        nc, chunk
    )
    lprev = jnp.where(prev_g >= cstart, prev_g - cstart, -1).reshape(nc, chunk)
    lnext = jnp.where(next_g < cstart + chunk, next_g - cstart, chunk).reshape(
        nc, chunk
    )
    ranks = _ranks_from_parts(lprev, lnext, keyi, keyrow, chunk)
    return ranks.reshape(N), used


def mtf_ranks_batch(
    last: jnp.ndarray, n: jnp.ndarray, chunk: int = 256
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Batched MTF over [B, N] blocks as ONE flat problem (no vmap).

    Per-block symbols are namespaced as block*256+sym, so every heavy op is
    the single-block op at B-times-larger shapes: one variadic sort over
    B*N, one scatter into (B*nc, 256), and the same (rows, C, C) dominance
    reduction with rows = B*nc instead of nc. The compiled graph therefore
    has the single-block graph's op count, unlike a vmapped one.

    Returns (ranks int32[B, N], used bool[B, 256]); pad lanes garbage.
    """
    B, N = last.shape
    assert N % chunk == 0
    nc = N // chunk
    M = B * N
    flat_idx = jnp.arange(M, dtype=jnp.int32)
    bid = flat_idx // N
    pos_in_b = flat_idx % N
    n_flat = jnp.repeat(n.astype(jnp.int32), N)
    valid = pos_in_b < n_flat
    sym = jnp.where(valid, last.reshape(M).astype(jnp.int32), 255)
    symk = bid * 256 + sym  # block-namespaced symbol

    used_flat = (
        jnp.zeros(B * 256, jnp.bool_)
        .at[jnp.where(valid, symk, B * 256)]
        .set(True, mode="drop")
    )
    used = used_flat.reshape(B, 256)
    init_rank = jnp.where(
        used, jnp.cumsum(used.astype(jnp.int32), axis=1) - 1, ABSENT
    )

    # prev/next same-block by construction (equal symk implies equal block);
    # the initial rank of each position's symbol = #{used t < sym} in its
    # block, computed as a broadcast-compare count (same reformulation as
    # the single-block path)
    s_key, s_idx, prev_g, next_g = _prev_next(symk, flat_idx, M)
    used_rows = jnp.broadcast_to(used[:, None, :], (B, nc, 256)).reshape(
        B * nc, 256
    )
    irank_pos = jnp.sum(
        used_rows[:, None, :]
        & (jnp.arange(256, dtype=jnp.int32)[None, None, :]
           < sym.reshape(B * nc, chunk)[:, :, None]),
        axis=-1,
        dtype=jnp.int32,
    ).reshape(M)

    # per-(global chunk, symbol) last occurrence (chunks never span blocks)
    s_cid = s_idx // chunk
    nxt_diff = jnp.concatenate(
        (
            (s_key[1:] != s_key[:-1]) | (s_cid[1:] != s_cid[:-1]),
            jnp.ones(1, jnp.bool_),
        )
    )
    tgt = jnp.where(nxt_diff, s_cid * 256 + s_key % 256, B * nc * 256)
    last_pos = (
        jnp.full(B * nc * 256, -1, jnp.int32)
        .at[tgt]
        .set(s_idx, mode="drop", unique_indices=True)
        .reshape(B * nc, 256)
    )
    # exclusive running max over chunks, RESET per block; positions are
    # global flat indices — subtract the block base so keys stay < 2N
    run = jax.lax.associative_scan(
        jnp.maximum, last_pos.reshape(B, nc, 256), axis=1
    )
    last_before = jnp.concatenate(
        (jnp.full((B, 1, 256), -1, jnp.int32), run[:, :-1]), axis=1
    )
    block_base = (jnp.arange(B, dtype=jnp.int32) * N)[:, None, None]
    init_rank_bc = init_rank[:, None, :]
    keyrow = jnp.where(
        last_before >= 0,
        N - (last_before - block_base),
        2 * N + init_rank_bc,
    ).reshape(B * nc, 256)

    cid = flat_idx // chunk
    cstart = cid * chunk
    keyi = jnp.where(
        prev_g >= 0, N - (prev_g - bid * N), 2 * N + irank_pos
    ).reshape(B * nc, chunk)
    lprev = jnp.where(prev_g >= cstart, prev_g - cstart, -1).reshape(
        B * nc, chunk
    )
    lnext = jnp.where(next_g < cstart + chunk, next_g - cstart, chunk).reshape(
        B * nc, chunk
    )
    ranks = _ranks_from_parts(lprev, lnext, keyi, keyrow, chunk)
    return ranks.reshape(B, N), used
