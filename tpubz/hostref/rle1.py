"""RLE1: the bzip2 first-stage run-length pre-pass, vectorized on host.

Semantics (reference src/tools/rle1.rs): runs of 4..255 identical bytes are
emitted as 4 literals + a count byte (run_len - 4, 0..251); longer runs are
re-scanned greedily in 255-byte segments. The per-block CRC is computed over
the *pre-RLE1* raw bytes (reference src/tools/rle1.rs:148,193), and the block
budget applies to the *post-RLE1* output size (reference
src/compression/compress.rs:55), which makes block splitting a sequential
scan over the RLE1 output — here done once, vectorized, with per-segment
cut points.
"""
from __future__ import annotations

import numpy as np

from ..format.constants import MAX_RUN, RUN_THRESHOLD


def rle1_encode(data: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized RLE1.

    Returns (out, seg_out_start, seg_in_start):
      out           -- uint8 RLE1 output stream
      seg_out_start -- int64 output offsets that are valid block cut points
                       (each is the start of a self-contained RLE1 segment)
      seg_in_start  -- int64 matching raw-input offset for each cut point
                       (for block CRC ranges). A final sentinel entry maps
                       len(out) -> len(data).
    """
    data = np.asarray(data, dtype=np.uint8)
    n = data.size
    if n == 0:
        empty = np.zeros(0, np.uint8)
        sent = np.zeros(1, np.int64)
        return empty, sent, sent
    # run decomposition
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(data[1:], data[:-1], out=change[1:])
    run_starts = np.flatnonzero(change)
    run_lens = np.diff(np.concatenate((run_starts, [n])))
    # each run splits greedily into segments of up to MAX_RUN input bytes
    q, f = np.divmod(run_lens, MAX_RUN)
    seg_cnt = q + (f > 0)
    total_segs = int(seg_cnt.sum())
    seg_run = np.repeat(np.arange(run_starts.size), seg_cnt)
    # position of each segment within its run: 0..seg_cnt-1
    seg_ofs = np.concatenate(([0], np.cumsum(seg_cnt)))[:-1]
    seg_pos = np.arange(total_segs) - np.repeat(seg_ofs, seg_cnt)
    is_last = seg_pos == (seg_cnt[seg_run] - 1)
    seg_len = np.where(is_last & (f[seg_run] > 0), f[seg_run], MAX_RUN)
    seg_in = run_starts[seg_run] + seg_pos * MAX_RUN
    lit_len = np.minimum(seg_len, RUN_THRESHOLD)
    has_cnt = seg_len >= RUN_THRESHOLD
    out_len = lit_len + has_cnt
    out_off = np.concatenate(([0], np.cumsum(out_len)))
    total_out = int(out_off[-1])
    out = np.empty(total_out, dtype=np.uint8)
    # literals: gather — positions out_off[s] + j for j < lit_len[s]
    lit_out_idx = np.repeat(out_off[:-1], lit_len) + (
        np.arange(int(lit_len.sum())) - np.repeat(np.concatenate(([0], np.cumsum(lit_len)))[:-1], lit_len)
    )
    lit_in_idx = np.repeat(seg_in, lit_len) + (
        np.arange(int(lit_len.sum())) - np.repeat(np.concatenate(([0], np.cumsum(lit_len)))[:-1], lit_len)
    )
    out[lit_out_idx] = data[lit_in_idx]
    # count bytes
    cnt_segs = np.flatnonzero(has_cnt)
    out[out_off[cnt_segs] + RUN_THRESHOLD] = (seg_len[cnt_segs] - RUN_THRESHOLD).astype(np.uint8)
    seg_out_start = np.concatenate((out_off[:-1], [total_out]))
    seg_in_start = np.concatenate((seg_in, [n]))
    return out, seg_out_start, seg_in_start


def split_blocks(
    out: np.ndarray,
    seg_out_start: np.ndarray,
    seg_in_start: np.ndarray,
    budget: int,
) -> list[tuple[int, int, int, int]]:
    """Block split of the RLE1 output at segment cut points, replicating C
    bzip2's ADD_CHAR_TO_BLOCK cut rule: the `nblock >= nblockMAX` check runs
    BEFORE each input byte and pending runs flush whole, so a block closes at
    the end of the first segment that brings its output size >= budget
    (overshoot up to 4 bytes) — provided at least two input bytes follow the
    boundary (otherwise the EOF flush joins the tail to the current block).
    Matching C's cuts keeps per-block content identical to C bzip2's, which
    pins the <=-C-size guarantee on multi-block inputs.

    Returns [(out_lo, out_hi, in_lo, in_hi), ...] — RLE1-output and raw-input
    ranges per block.
    """
    total = int(seg_out_start[-1])
    if total == 0:
        return []
    blocks = []
    i = 0  # index into seg arrays
    nsegs = seg_out_start.size - 1
    n = int(seg_in_start[-1])
    while i < nsegs:
        lo = int(seg_out_start[i])
        # smallest m with seg_out_start[m] - lo >= budget: block = segments
        # i..m-1 (the crossing segment included)
        m = int(np.searchsorted(seg_out_start, lo + budget, side="left"))
        if m > nsegs or int(seg_in_start[m]) > n - 2:
            m = nsegs  # no further cut possible: tail joins this block
        blocks.append(
            (
                lo,
                int(seg_out_start[m]),
                int(seg_in_start[i]),
                int(seg_in_start[m]),
            )
        )
        i = m
    return blocks


def rle1_blocks(data: np.ndarray, budget: int):
    """RLE1-encode ``data`` and split into blocks: returns (rle1_out, blocks)
    with blocks = [(out_lo, out_hi, in_lo, in_hi), ...]. Dispatches to the
    native C++ scanner (cross-checked bit-identical in tests) with this
    module's vectorized numpy path as fallback."""
    from ..native import rle1_split_native

    nat = rle1_split_native(data, budget)
    if nat is not None:
        return nat
    out, seg_out, seg_in = rle1_encode(data)
    return out, split_blocks(out, seg_out, seg_in, budget)


class Rle1Feed:
    """Streaming RLE1 block producer: the reference's sequential-iterator-
    feeding-the-worker-pool design (src/tools/rle1.rs:250 + compress.rs:125)
    rebuilt for the hybrid pipeline. A background thread scans the input in
    growing windows with the native splitter, re-entering at the last
    confirmed block boundary (cuts are segment-aligned, so a re-entered
    scan reproduces the full scan's bytes exactly); the consumer iterates
    blocks as they are confirmed, so dispatch starts after the FIRST window
    (~2 blocks of input) instead of after the whole-input scan.

    Attributes:
      out     -- preallocated worst-case RLE1 output buffer; each yielded
                 block's (out_lo, out_hi) indexes into it, and only regions
                 belonging to yielded blocks are ever final.
    Methods:
      __iter__          -- yields (out_lo, out_hi, in_lo, in_hi) in order
      total_estimate()  -- exact block count once the scan completes;
                           until then a monotone estimate (confirmed +
                           remaining input / budget)
    """

    # decisions at input position p use at most bytes p..p+3 (run4 probe)
    # plus the maybe_cut lookahead of 2; any margin >= 8 is safe — 4096
    # also keeps re-scan overlap negligible
    MARGIN = 4096

    def __init__(self, data: np.ndarray, budget: int, window: int = 1 << 23):
        import threading

        self._arr = np.ascontiguousarray(data, dtype=np.uint8)
        n = self._arr.size
        self._budget = budget
        self._window = window
        # worst case: runs of exactly 4 expand 4 -> 5 bytes
        self.out = np.empty(n + n // 4 + 16, dtype=np.uint8)
        self._blocks: list[tuple[int, int, int, int]] = []
        self._done = False
        self._error: BaseException | None = None
        self._cv = threading.Condition()
        self._in_confirmed = 0  # input bytes covered by confirmed blocks
        self._thread = threading.Thread(target=self._scan, daemon=True)
        self._thread.start()

    def _publish(self, blocks, done):
        with self._cv:
            self._blocks.extend(blocks)
            if blocks:
                self._in_confirmed = blocks[-1][3]
            self._done = self._done or done
            self._cv.notify_all()

    def _scan(self):
        import time

        self.scan_t0 = time.time()
        try:
            self._scan_inner()
        except BaseException as e:  # surfaced to the consumer
            with self._cv:
                self._error = e
                self._done = True
                self._cv.notify_all()
        finally:
            self.scan_t1 = time.time()

    def _scan_inner(self):
        from ..native import rle1_split_window

        arr, budget = self._arr, self._budget
        n = arr.size
        start = out_base = 0
        window = max(self._window, 2 * budget)
        while True:
            end = min(n, start + window)
            res = rle1_split_window(arr, start, end, budget, self.out, out_base)
            if res is None:
                # no native lib: one eager vectorized scan (same cuts);
                # copy into the preallocated buffer so consumers holding a
                # reference to self.out stay valid
                out, seg_out, seg_in = rle1_encode(arr)
                self.out[: out.size] = out
                self._publish(split_blocks(out, seg_out, seg_in, budget), True)
                return
            blocks, out_len = res
            if end == n:
                # final window: every block is final (EOF semantics real)
                self._publish(
                    [
                        (
                            out_base + o0,
                            out_base + o1,
                            start + i0,
                            start + i1,
                        )
                        for o0, o1, i0, i1 in blocks
                    ],
                    True,
                )
                return
            # partial window: drop the scanner's forced tail block, then
            # accept only blocks cut safely inside the window
            safe = (end - start) - self.MARGIN
            acc = [
                b for b in blocks[: len(blocks) - 1] if b[3] <= safe
            ]
            if not acc:
                # window smaller than one block (heavy-RLE data): grow
                window *= 2
                continue
            self._publish(
                [
                    (out_base + o0, out_base + o1, start + i0, start + i1)
                    for o0, o1, i0, i1 in acc
                ],
                False,
            )
            out_base += acc[-1][1]
            start += acc[-1][3]

    def __iter__(self):
        i = 0
        while True:
            with self._cv:
                while i >= len(self._blocks) and not self._done:
                    self._cv.wait()
                if self._error is not None:
                    raise self._error
                if i >= len(self._blocks):
                    return
                b = self._blocks[i]
            i += 1
            yield b

    def total_estimate(self) -> int:
        with self._cv:
            nb = len(self._blocks)
            if self._done:
                return nb
            rest = self._arr.size - self._in_confirmed
        # assume expansionless data for the unscanned remainder: an
        # OVERestimate on heavy-RLE inputs, converging to exact as the
        # scan (≫ encode rate) finishes early in the stream
        return nb + max(1, -(-rest // self._budget))


def rle1_decode(data: np.ndarray) -> np.ndarray:
    """Undo RLE1 (reference src/tools/rle1.rs:267-316).

    Finds 4-byte equal groups (which, in a valid stream, are always followed
    by a count byte) and expands them.
    """
    d = np.asarray(data, dtype=np.uint8)
    n = d.size
    if n < RUN_THRESHOLD:
        return d.copy()
    eq = d[:-1] == d[1:]
    cand = np.flatnonzero(eq[:-2] & eq[1:-1] & eq[2:])
    if cand.size == 0:
        return d.copy()
    pieces = []
    cursor = 0
    ci = 0
    nc = cand.size
    while ci < nc:
        p = int(cand[ci])
        if p < cursor:
            ci += 1
            continue
        # literals up to and including the 4-run
        pieces.append(d[cursor : p + 4])
        if p + 4 >= n:
            # malformed (run at very end without count) — emit as-is
            cursor = p + 4
            break
        cnt = int(d[p + 4])
        if cnt:
            pieces.append(np.full(cnt, d[p], dtype=np.uint8))
        cursor = p + 5
        ci += 1
    if cursor < n:
        pieces.append(d[cursor:])
    return np.concatenate(pieces) if pieces else np.zeros(0, np.uint8)
