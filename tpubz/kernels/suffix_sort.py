"""Rotation suffix sort (BWT forward) on device: prefix doubling.

The reference's hot kernel is a comparator rotation sort with a SA-IS
fallback (src/bwt_algorithms/bwt_sort.rs:27-86, sais_fallback.rs). Here it
is prefix doubling: O(log n) rounds of a lexicographic four-key sort
(`jax.lax.sort` variadic), re-ranking by cumsum of adjacent-difference
flags. Ranks compose mod n, so *rotation* (wraparound) order falls out
naturally and the reference's Duval-rotation SA-IS workaround
(sais_fallback.rs:582-620) is unnecessary.

Formulation: the kernel is built from sorts, rolls and scans only — no
arbitrary gathers or scatters:
  - the mod-n shifted-rank lookup is two dynamic rolls + a select;
  - the rank write-back to position space is a sort keyed by position
    instead of a scatter;
  - the final last-column extraction is ONE stable 2-operand sort keyed by
    the shifted final rank (last[pos(rotation j+1)] = data[j]) instead of a
    data[sa-1] gather, and the block key is a compare-count — which also
    drops the suffix-array carry from the loop.
The loop body is a fixed-trip `fori_loop` with converged rounds skipped
via lax.cond, and the initial rank packs THREE bytes into one int32 key
(cover 3 before the first sort instead of 1), which drops ~log2(3)
doubling rounds. Whether gathers, scatters and packed radix-pair sorts
beat this shape on a given device is a measurement, not a given.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

PAD_RANK = 1 << 30
ROUNDS = 10  # 4-ary doubling: cover 3*4^10 = 3.1M >= 900k; rank refinement
             # is monotone and frozen via `done` once it reaches fixpoint


def bwt_forward(
    data: jnp.ndarray, n: jnp.ndarray, skip_converged: bool = True
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """data: uint8[N] (first n valid). Returns (key, last uint8[N]).

    last[i] for i < n is the BWT last column; key is rotation 0's sorted
    position. Padded output lanes are zero.

    skip_converged=True wraps each doubling round in lax.cond so converged
    blocks stop paying for sorts — only valid for a single block per trace
    (under vmap/shard_map cond degenerates to select / trips axis-variance
    checks). Batched callers pass "batch": the round loop becomes a
    lax.while_loop exiting on convergence, which vmap lifts to "run until
    ALL blocks in the batch are done" — the batch pays max(active rounds)
    instead of the fixed ROUNDS. False keeps the fixed-trip fori_loop with
    where-freeze (bitwise-identical rounds, no early exit).
    """
    N = data.shape[0]
    n = jnp.asarray(n, jnp.int32)
    idx = jnp.arange(N, dtype=jnp.int32)
    valid = idx < n
    nn = jnp.maximum(n, 1)

    def shifted(rank, k):
        """rank[(i+k) mod n] for i < n, via two rolls + select (no gather)."""
        kp = jnp.remainder(k, nn)
        a = jnp.roll(rank, -kp)          # rank[i + kp] when i + kp < N
        b = jnp.roll(rank, nn - kp)      # rank[i + kp - n] when i >= n - kp
        return jnp.where(idx < nn - kp, a, b)

    def one_round(rank, prev_distinct, k):
        """4-ary doubling: sorting by (r[i], r[i+k], r[i+2k], r[i+3k])
        refines coverage k into 4k, halving the round count vs classic
        2-ary doubling (10 rounds instead of 19 at 900k), for three extra
        sort operands per round.

        Convergence is detected IN SORT SPACE, before the write-back:
        distinct = class count of the refined partition, read straight off
        the re-rank cumsum. distinct == n means this round's keys totally
        ordered the rotations (its write-back rank is dense final
        positions), and distinct == prev_distinct means the partition
        stopped refining (classes only ever split, so an unchanged count is
        an unchanged partition — the classic doubling fixpoint, permanent
        ties). A STALL round skips its write-back sort: the previous
        round's rank already encodes the identical partition, and rank is
        only ever consumed as a sort key. A distinct==n round DOES write
        back — the final (key, last) extraction below reads rank directly,
        which is what lets the loop drop the suffix-array carry and the
        900k last-column gather entirely."""
        r2 = jnp.where(valid, shifted(rank, k), PAD_RANK)
        r3 = jnp.where(valid, shifted(rank, 2 * k), PAD_RANK)
        r4 = jnp.where(valid, shifted(rank, 3 * k), PAD_RANK)
        a, b, c, d, order = jax.lax.sort((rank, r2, r3, r4, idx), num_keys=4)
        flag = jnp.concatenate(
            (
                jnp.zeros(1, jnp.int32),
                (
                    (a[1:] != a[:-1])
                    | (b[1:] != b[:-1])
                    | (c[1:] != c[:-1])
                    | (d[1:] != d[:-1])
                ).astype(jnp.int32),
            )
        )
        new_sorted = jnp.cumsum(flag)
        # valid lanes sort first (pads carry PAD_RANK keys), so the class
        # count of the valid partition is the cumsum at the last valid slot
        distinct = new_sorted[nn - 1] + 1
        stalled = distinct == prev_distinct
        done_now = (distinct == nn) | stalled

        def write_back():
            # back to position space via sort-by-position (scatter-free)
            _, nr = jax.lax.sort((order, new_sorted), num_keys=1)
            return jnp.where(valid, nr, PAD_RANK)

        if skip_converged is True:
            # a stall round never refines — skip the write-back sort
            # (real HLO branch)
            new_rank = jax.lax.cond(stalled, lambda: rank, write_back)
        else:
            new_rank = jnp.where(stalled, rank, write_back())
        return new_rank, distinct, done_now

    # initial rank: THREE bytes packed into one int32 (cyclic), so the
    # first sort round already refines cover-3 order into cover-6 — the
    # rank values need only be order-consistent, not dense, and 24 bits
    # stay below PAD_RANK
    d0 = data.astype(jnp.int32)
    rank0 = (d0 << 16) | (shifted(d0, 1) << 8) | shifted(d0, 2)
    rank = jnp.where(valid, rank0, PAD_RANK)

    def body(i, carry):
        rank, k, done, prevd = carry
        if skip_converged is True:
            # converged rounds skip the sorts entirely (real HLO branch)
            new_rank, newd, done_now = jax.lax.cond(
                done,
                lambda r, p: (r, p, True),
                lambda r, p: one_round(r, p, k),
                rank,
                prevd,
            )
        else:
            nr, distinct, done_now = one_round(rank, prevd, k)
            new_rank = jnp.where(done, rank, nr)
            newd = jnp.where(done, prevd, distinct)
        done2 = done | done_now
        return new_rank, k * 4, done2, newd

    # prev_distinct starts at -1 (no real class count equals it), so the
    # stall check can't fire before a second data point exists.
    # (-1 + (rank[0] & 0) keeps the initial carry's mesh-axis variance
    # equal to the loop outputs' under shard_map — bare constants are
    # unvarying while the loop outputs are data-derived.)
    init = (rank, jnp.int32(3), n < 0, jnp.int32(-1) + (rank[0] & 0))
    if skip_converged == "batch":
        # convergence-exit loop: vmap's while_loop batching rule runs the
        # body while ANY batch element's cond holds and freezes finished
        # elements' carries, so a batched/sharded call pays max(active
        # rounds) across its blocks, not the fixed ROUNDS
        def w_cond(carry):
            _, _, done, _, i = carry[0]
            return (~done) & (i < ROUNDS)

        def w_body(carry):
            (rank, k, done, prevd, i) = carry[0]
            rank, k, done, prevd = body(i, (rank, k, done, prevd))
            return ((rank, k, done, prevd, i + 1),)

        ((rank, _, _, _, _),) = jax.lax.while_loop(
            w_cond, w_body, ((*init, jnp.int32(0)),)
        )
    else:
        rank, _, _, _ = jax.lax.fori_loop(0, ROUNDS, body, init)
    # rank is position-consistent (dense positions after a distinct==n
    # round; otherwise classes of IDENTICAL rotations sharing a value).
    # Rotation 0's sorted position = #rotations strictly before it; its
    # within-class ties all have larger indices, so the class count is
    # exact. The last column satisfies last[pos(rotation j+1)] = data[j],
    # so ONE stable 2-operand sort keyed by rank[(j+1) mod n] produces it
    # directly — within a tie class all rotations share their final
    # character (ties = identical rotations = periodic strings), so the
    # stable j-order inside a class is byte-equivalent to true SA order.
    key = jnp.sum(valid & (rank < rank[0]), dtype=jnp.int32)
    k1 = jnp.where(valid, shifted(rank, 1), PAD_RANK)
    _, last = jax.lax.sort(
        (k1, jnp.where(valid, data, 0).astype(jnp.uint8)), num_keys=1
    )
    return key, last
