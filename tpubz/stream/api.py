"""Device-path whole-stream compression API.

Mirrors the host reference stream assembly (tpubz/hostref/stream.py) but
routes every block's O(n) transforms through the jitted device pipeline,
with Huffman refinement in the native C++ engine. Output is byte-identical
to the host reference (and therefore decodable by reference bzip2).

Parallelism: the reference overlaps block compression via a rayon pool with
an ordered channel fan-in (src/compression/compress.rs:69-132). Here the
same overlap is a 3-stage pipeline:

  main thread      -- async device dispatch for a sliding window of blocks
  fetch pool       -- device->host transfers (device_get releases the GIL)
  emit pool        -- per-block CRC + Huffman refinement (native engine,
                      GIL-free) + emission, several blocks concurrently
  main thread      -- ordered drain: stream-CRC fold + bit splice in block
                      order (the reference's writer-thread reorder queue)
"""
from __future__ import annotations

import logging
import os
import time
from collections import deque

import numpy as np

log = logging.getLogger("tpubz")

from ..format.constants import FOOTER_MAGIC, STREAM_MAGIC, block_budget
from ..format.crc import block_crc, stream_crc_fold
from ..hostref.bitio import BitAccum, IncrementalSplicer
from ..hostref.rle1 import Rle1Feed, rle1_blocks


def _items_total(items) -> int:
    """Block count of an item stream: exact for a materialized list, the
    producer's scan-progress estimate for a streaming source (exact once
    its scan finishes, early in the stream)."""
    est = getattr(items, "total_estimate", None)
    return est() if est is not None else len(items)


class _FeedItems:
    """(blk_view, raw_view) item stream over an Rle1Feed for the
    block-results generators: each item pairs the block's RLE1 bytes with
    its raw input range (for the pre-RLE1 CRC). Views keep the backing
    buffers alive only while blocks are in flight."""

    def __init__(self, feed: Rle1Feed, arr: np.ndarray):
        self.feed = feed
        self._arr = arr

    def __iter__(self):
        for o0, o1, i0, i1 in self.feed:
            yield self.feed.out[o0:o1], self._arr[i0:i1]

    def total_estimate(self) -> int:
        return self.feed.total_estimate()

# In-flight block window of the ordered drain. The head blocks dispatch
# when the window fills, so the depth must ride out a straggler block (a
# throttled worker or a slow device leg) without idling the engines. Each
# slot pins ~1-3 MB (input view + packed output), so 28 ~= +35 MB peak.
WINDOW = int(os.environ.get("TPUBZ_WINDOW", "28"))
# engine-speed estimates shared across compress() calls (a warm-up stream
# trains the hybrid scheduler for the whole process); see device_ok/steal_ok
_cpu_ema_g = [0.0]
_dev_done_g: deque = deque(maxlen=8)
# stream epoch: device completion gaps are only meaningful between blocks
# of the SAME stream (an abandoned straggler from a previous stream that
# resolves mid-stream would otherwise fabricate a fast cadence out of two
# unrelated completions)
_stream_epoch_g = [0]
# one live device re-probe per process: when the persisted profile says the
# device loses, a single probe block per process is the recovery path for a
# healthy device sitting behind a stale pessimistic profile — without it
# the device could stay off forever; with more, a genuinely bad device
# taxes every stream
_reprobe_left_g = [1]
# phase attribution for the most recent device-path stream (bench.py prints
# it so throughput swings are explainable: which engine carried the blocks
# and what each engine's per-block cost measured)
last_stream_stats: dict = {}
# per-block execution spans of the most recent device-path stream:
# (engine, block_in_lo, t_start, t_end) wall-clock tuples, appended as each
# block's worker runs. Cheap (a few tuples per block), always on; the
# timeline renderer (tools/probe_timeline.py) turns them into a per-engine
# Gantt so scheduling stalls are attributable — the reference's analogue is
# its RX-queue depth logging (compress.rs:81-85)
last_stream_events: list = []
# The device-refine engine (DeviceBlockEncoder.encode_block_devrefine,
# kernels/huffman_dev.py) is byte-identity-tested but not a stream route;
# batching lives in dist/sharded.py.
# Which stages run on device per block: "full" = bwt+mtf+rle2 (3-launch
# lean chain), "bwt" = suffix sort only with native host MTF/RLE2 on the
# fetched last column, "auto" (default) = derive from the measured rig
# profile (rigprofile.choose_stage) — the device-vs-host economics differ
# per machine, and the profile records what THIS machine measured instead
# of baking one machine's numbers in as defaults.
DEVICE_STAGE = os.environ.get("TPUBZ_DEVICE_STAGE", "auto")
EMIT_THREADS = int(os.environ.get("TPUBZ_EMIT_THREADS", "3"))

_encoders: dict[int, object] = {}


class _HostFallbackEncoder:
    """CPU block encoder: the drop-in for DeviceBlockEncoder when no
    accelerator backend can initialize (or when the user forces the host
    engine). The heavy stages run in ONE GIL-free native call per block
    (SA-IS BWT + MTF + RLE2, tpubz/native/bwt.cpp) feeding the same native
    refinement/emission the device path uses, so output bytes are identical
    to both the device path and the numpy oracle; falls back to the oracle
    pipeline if the native lib is unavailable."""

    def __init__(self, level: int):
        self.level = level

    def encode_block(self, rle1_block, crc):
        from ..native import block_transform_native

        res = block_transform_native(rle1_block)
        if res is None:
            from ..hostref.block import encode_block

            return encode_block(rle1_block, crc)
        key, rle2, freqs, used = res
        # jax-free emission module: the CPU engine must never pull in jax
        from ..block.emit import emit_block

        return emit_block(key, rle2, rle2.size, freqs, used, crc)


def _encoder(level: int):
    if level not in _encoders:
        try:
            from ..block.encode import DeviceBlockEncoder

            enc = DeviceBlockEncoder(level)
            # force backend init now so failure falls back cleanly
            import jax

            jax.devices()
            _encoders[level] = enc
        except Exception:
            # CPU-only users keep the native engine; last_stream_stats then
            # reports engine "cpu"
            log.warning(
                "no device backend; encoding on the CPU engine", exc_info=True
            )
            _encoders[level] = _HostFallbackEncoder(level)
    return _encoders[level]


def _encoder_for(level: int, n_blocks: int):
    """Engine choice given the stream's block count: tiny streams route to
    the CPU engine when the device encoder isn't already warm — a 1-2 block
    stream can't pipeline launches, the CPU engine's bytes are identical,
    and skipping the device keeps jax entirely out of the process (import +
    backend init cost seconds, more than a few native blocks; the C tool does a
    tiny file in milliseconds, reference lib.rs:35's tiny-file regime)."""
    if level not in _encoders:
        min_dev = int(os.environ.get("TPUBZ_MIN_DEVICE_BLOCKS", "3"))
        if n_blocks < min_dev:
            return _HostFallbackEncoder(level)
    return _encoder(level)


def compress(data: bytes | np.ndarray, level: int = 9) -> bytes:
    """Whole-stream device-path compression. TPUBZ_PROFILE=<dir> wraps the
    call in a jax.profiler trace (device + host timelines, viewable with
    tensorboard / xprof) — the device analogue of the reference's leveled
    tracing (SURVEY.md §5)."""
    prof_dir = os.environ.get("TPUBZ_PROFILE")
    if prof_dir:
        import jax

        with jax.profiler.trace(prof_dir):
            return _compress_impl(data, level)
    return _compress_impl(data, level)


def compress_cpu(data: bytes | np.ndarray, level: int = 9) -> bytes:
    """Force the CPU engine (threaded native transform; no accelerator
    used). Output bytes are identical to the device path."""
    return _compress_impl(data, level, force_host=True)


def _compress_impl(
    data: bytes | np.ndarray, level: int = 9, force_host: bool = False
) -> bytes:
    if not 1 <= level <= 9:
        raise ValueError("level must be 1..9")
    arr = (
        np.frombuffer(data, dtype=np.uint8)
        if isinstance(data, (bytes, bytearray, memoryview))
        else np.asarray(data, dtype=np.uint8)
    )
    last_stream_events.clear()
    _t0 = time.time()
    budget = block_budget(level)
    feed = None
    if arr.size > 4 * budget:
        # big stream: scan in a background thread and dispatch blocks as
        # they are confirmed (the reference's sequential-producer design,
        # rle1.rs:250 + compress.rs:125) instead of an eager whole-input
        # scan that serializes the stream's head
        feed = Rle1Feed(arr, budget)
        items = _FeedItems(feed, arr)
    else:
        # small stream: the scan is ~ms and the exact block count drives
        # tiny-stream engine routing
        out, blocks = rle1_blocks(arr, budget)
        items = [
            (out[o0:o1], arr[i0:i1]) for o0, o1, i0, i1 in blocks
        ]
        last_stream_events.append(("rle1", 0, _t0, time.time()))
    enc = (
        _HostFallbackEncoder(level)
        if force_host
        else _encoder_for(level, _items_total(items))
    )

    header = BitAccum()
    for b in STREAM_MAGIC:
        header.put(b, 8)
    header.put(0x30 + level, 8)
    # fold blocks into the output as the ordered drain yields them — the
    # main thread idles in the drain anyway, so the end-of-stream splice
    # pass rides inside the pipeline
    splicer = IncrementalSplicer(cap_hint=arr.size // 2 + 64)
    splicer.add(*header.pack())
    s_crc = 0
    gen = (
        _host_block_results
        if isinstance(enc, _HostFallbackEncoder)
        else _device_block_results
    )
    for crc, data_b, nbits in gen(enc, items):
        s_crc = stream_crc_fold(s_crc, crc)
        splicer.add(data_b, nbits)
    if feed is not None and hasattr(feed, "scan_t1"):
        last_stream_events.append(("rle1", 0, feed.scan_t0, feed.scan_t1))
    footer = BitAccum()
    footer.put(FOOTER_MAGIC, 48)
    footer.put(s_crc, 32)
    _t0 = time.time()
    splicer.add(*footer.pack())
    payload, _ = splicer.finish()
    last_stream_events.append(("splice", 0, _t0, time.time()))
    return payload


def _host_block_results(enc, items):
    """CPU-engine pipeline: per-block transform + refinement + emission on a
    thread pool (the heavy stages are GIL-free native calls — the rayon-pool
    analogue of reference compress.rs:125-132), with an ordered sliding
    window bounding in-flight memory. ``items`` yields (blk_view, raw_view)
    pairs (RLE1 block bytes + raw range for the pre-RLE1 CRC). Yields
    (crc, packed_bytes, nbits) in block order (each block packs in its
    worker thread)."""
    from concurrent.futures import ThreadPoolExecutor

    # default 3x the core count, capped at 24: the native transform is
    # cache/memory-bound, so oversubscription hides the stalls
    workers = max(
        1,
        min(
            int(
                os.environ.get(
                    "TPUBZ_HOST_THREADS", str(3 * (os.cpu_count() or 4))
                )
            ),
            24,
        ),
    )

    def one(idx, blk, raw):
        t0 = time.time()
        crc = block_crc(raw)
        b = enc.encode_block(blk, crc)
        data, nbits = b.pack()
        last_stream_events.append(("cpu", idx, t0, time.time()))
        return crc, data, nbits

    n_est = _items_total(items)
    last_stream_stats.clear()
    last_stream_stats.update(
        engine="cpu", blocks=n_est, dev_blocks=0, cpu_blocks=n_est
    )
    n_done = 0
    if workers == 1 or n_est <= 1:
        for idx, (blk, raw) in enumerate(items):
            n_done += 1
            yield one(idx, blk, raw)
    else:
        pool = ThreadPoolExecutor(workers)
        inflight: deque = deque()
        try:
            for idx, (blk, raw) in enumerate(items):
                inflight.append(pool.submit(one, idx, blk, raw))
                if len(inflight) >= 2 * workers:
                    n_done += 1
                    yield inflight.popleft().result()
            while inflight:
                n_done += 1
                yield inflight.popleft().result()
        finally:
            pool.shutdown(wait=False)
    # correct the pre-scan estimate to the actual count (a streaming feed
    # on heavy-RLE input overestimates until its scan completes)
    last_stream_stats.update(blocks=n_done, cpu_blocks=n_done)


def _device_block_results(enc, items):
    """Run blocks through the device pipeline; yield (crc, packed_bytes, nbits) in
    block order while later blocks are still in flight. ``items`` yields
    (blk_view, raw_view) pairs (RLE1 block bytes + raw input range for the
    pre-RLE1 CRC) — a list or a streaming producer (Rle1Feed wrapper, the
    file compressor's window chain).

    Hybrid scheduling: the device pipeline leaves most host cores idle,
    and the native CPU engine (tpubz/native/bwt.cpp) produces
    byte-identical blocks — so whenever a dedicated CPU worker is
    free, the next block routes to it instead of the device
    (TPUBZ_HYBRID_CPU=N workers; default 3x cores — the memory-latency-
    bound native engine's oversubscription knee). Aggregate
    throughput becomes device rate + CPU rate; ordering is preserved by the
    same in-flight deque."""
    from concurrent.futures import (
        FIRST_COMPLETED,
        ThreadPoolExecutor,
        TimeoutError as _FutTimeout,
        wait as _fut_wait,
    )

    from ..block.encode import DeviceBlockEncoder, materialize

    # entries are (future, kind, block_args): kind "dev" futures carry their
    # block ranges so the drain can duplicate an overdue device block onto a
    # CPU worker (bytes are engine-identical)
    inflight: deque = deque()
    # device->host fetches run on a side thread pool (device_get releases
    # the GIL) so each block's transfer overlaps other blocks' work; the
    # emit pool runs CRC + native refinement (also GIL-free) + emission for
    # several blocks concurrently.
    fetch_pool = ThreadPoolExecutor(
        int(os.environ.get("TPUBZ_FETCH_THREADS", "4"))
    )
    emit_pool = ThreadPoolExecutor(EMIT_THREADS)
    # single-thread launch dispatcher: keeps device launches in block order
    # (FIFO) while isolating the main loop from a blocking/raising launch
    dispatch_pool = ThreadPoolExecutor(1)

    def emit(fetch_fut, raw):
        key, syms, rle2_len, freqs, used = fetch_fut.result()
        t0 = time.time()
        crc = block_crc(raw)
        blk = DeviceBlockEncoder.emit_block(key, syms, rle2_len, freqs, used, crc)
        data, nbits = blk.pack()
        leg_samples.append(time.time() - t0)
        return crc, data, nbits

    def _materialize_bwt(bfut):
        import jax

        key_d, last_d, n = bfut
        key, last = jax.device_get((key_d, last_d))
        return int(key), np.asarray(last)[:n]

    def emit_bwt(fetch_fut, raw):
        from ..native import mtf_rle2_native

        key, last = fetch_fut.result()
        t0 = time.time()
        crc = block_crc(raw)
        res = mtf_rle2_native(last)
        if res is None:  # no native lib: numpy mirror
            from ..hostref.mtf_rle2 import mtf_rle2_encode

            res = mtf_rle2_encode(last)
        rle2, freqs, used = res
        blk = DeviceBlockEncoder.emit_block(
            key, rle2, rle2.size, freqs, used, crc
        )
        data, nbits = blk.pack()
        leg_samples.append(time.time() - t0)
        return crc, data, nbits

    import threading
    import time

    from . import rigprofile

    prof = rigprofile.load()
    # worker count: env override > rig profile knee > generic default of
    # 3x cores. Oversubscription is the generic shape for a memory-latency-
    # bound engine (threads hide each other's DRAM stalls); the exact knee
    # is host-specific, so the profile can store a measured one.
    # The steal_ok EMA guard still sheds workers whenever the device
    # cadence beats the CPU block time.
    knee = float(prof.get("cpu_knee", 3))
    hybrid_n = int(
        os.environ.get(
            "TPUBZ_HYBRID_CPU",
            str(min(int(knee * (os.cpu_count() or 4)), 24)),
        )
    )
    cpu_pool = cpu_slots = None
    if hybrid_n > 0:
        from ..native import get_lib

        if get_lib() is not None:
            cpu_pool = ThreadPoolExecutor(hybrid_n)
            cpu_slots = threading.Semaphore(hybrid_n)
    host_enc = _HostFallbackEncoder(enc.level)
    # A hybrid only makes sense when the device is a SEPARATE compute
    # resource. When jax's backend is the host CPU itself (no accelerator),
    # every "device" dispatch steals the same cores the native engine uses
    # — XLA-jnp loses to the native transform on identical silicon, so the
    # device leg is pure overhead. Route
    # everything through the pool unless the user explicitly configured a
    # hybrid (tests pin mixed-engine behavior that way).
    dev_is_host = False
    if cpu_pool is not None and "TPUBZ_HYBRID_CPU" not in os.environ:
        try:
            import jax

            dev_is_host = jax.devices()[0].platform == "cpu"
        except Exception:
            pass

    # Symmetric adaptive arbitration. Both engines' speeds can swing on a
    # shared host, so per-block routing compares live estimates that
    # PERSIST across compress() calls (module-level _cpu_ema_g /
    # _dev_done_g — a warm-up pass trains them for the whole process):
    #   device_ok: dispatch to the device only if it would clear its queue
    #     plus this block before the CPU pool would reach the end of the
    #     remaining queue anyway (a slow device's tail block otherwise
    #     dominates short streams);
    #   steal_ok: mirror guard for a throttled CPU worker.
    dev_inflight = [0]  # blocks dispatched to the device, not yet emitted
    cpu_inflight = [0]  # blocks submitted to the CPU pool, not yet finished
    # dispatch wall times of the blocks currently in device flight: the
    # oldest entry's age, divided by the flight depth, is a LIVE lower
    # bound on the device's current cadence (a healthy q-deep pipeline
    # holds oldest_age ~ q*cadence; a stalled device grows it without
    # bound) — the signal that a stale-fast profile cadence is lying
    # before any completion arrives to retrain it. Keyed per-dispatch so a
    # device idle gap cannot fake staleness (an earlier last-completion-
    # timestamp formulation starved a healthy device right after every
    # gap).
    dev_flight_t: dict[int, float] = {}
    dev_flight_seq = [0]
    dev_lock = threading.Lock()  # += / -= race between dispatch and emits
    dev_strikes = [0]  # non-tail head blocks lost to their CPU twin: ground
    # truth that a device dispatch HURT the stream; two strikes shut the
    # device off for the rest of this stream regardless of estimates
    _stream_epoch_g[0] += 1
    epoch = _stream_epoch_g[0]
    _dev_done_g.clear()  # per-stream gap state; cross-stream memory is the
    # rig profile (trained at stream end), not stale completion timestamps
    if _items_total(items) >= 8:
        # long streams refresh the re-probe budget: phases swing on minute
        # scales, so a device struck off in one dead phase must get one
        # block per stream to argue its way back in. The cost of a wasted
        # probe is bounded (the straggler guard duplicates it onto a CPU
        # worker after a capped grace while the 16-deep window keeps the
        # pool busy); the upside — the device's additive MB/s in every
        # recovered phase — is not. Short streams keep the stricter
        # once-per-process budget: a probe there can BE the stream tail.
        _reprobe_left_g[0] = max(_reprobe_left_g[0], 1)
    eff_cores = min(hybrid_n or 1, os.cpu_count() or 4)
    leg_samples: list[float] = []  # host-side cost per device block (trains
    # the rig profile's host_leg_s for the chosen stage)
    dev_lat_samples: list[float] = []  # dispatch->emit latency per device
    # block (the cadence fallback when too few blocks ran for gap samples)
    # seed the live estimates from the last sessions' measurements so the
    # first blocks of a fresh process are routed on rig data, not probes
    if not _cpu_ema_g[0] and prof.get("cpu_block_s"):
        _cpu_ema_g[0] = float(prof["cpu_block_s"])

    def cpu_one(idx, blk, raw):
        t0 = time.time()
        try:
            crc = block_crc(raw)
            b = host_enc.encode_block(blk, crc)
            data, nbits = b.pack()
            return crc, data, nbits
        finally:
            dt = time.time() - t0
            if _stream_epoch_g[0] == epoch:
                # epoch-guarded like the device spans: an abandoned twin
                # resolving during the next stream must not pollute its
                # timeline
                last_stream_events.append(("cpu", idx, t0, t0 + dt))
            _cpu_ema_g[0] = (
                dt if not _cpu_ema_g[0] else 0.5 * _cpu_ema_g[0] + 0.5 * dt
            )
            with dev_lock:
                cpu_inflight[0] -= 1
            cpu_slots.release()

    def cpu_acquire(blocking=False, timeout=None):
        """cpu_slots.acquire + inflight accounting (released in cpu_one)."""
        ok = (
            cpu_slots.acquire(timeout=timeout)
            if blocking
            else cpu_slots.acquire(blocking=False)
        )
        if ok:
            with dev_lock:
                cpu_inflight[0] += 1
        return ok

    def _timed(fn, t_disp, seq, idx, *args):
        """Wrap a device-route emit: dev_inflight decrements even when the
        block errors (a healed error must not permanently suppress device
        dispatch), while cadence samples record only successes (an instant
        failure would otherwise train a falsely fast cadence). Also records
        the block's dispatch->emit LATENCY: when a stream completes too few
        device blocks for gap samples (e.g. a single probe block on a rig
        whose 'device' is dreadful), the latency median is what trains the
        profile — otherwise every future stream re-pays the probe block."""
        ok = False
        try:
            r = fn(*args)
            ok = True
            return r
        finally:
            with dev_lock:
                dev_inflight[0] -= 1
                dev_flight_t.pop(seq, None)
            if _stream_epoch_g[0] == epoch:
                # the span runs dispatch -> emit-done (the device block's
                # full latency as the stream experiences it).
                # Epoch-guarded: an abandoned straggler resolving during
                # the NEXT stream must not pollute its timeline
                last_stream_events.append(("dev", idx, t_disp, time.time()))
            if ok and _stream_epoch_g[0] == epoch:
                _dev_done_g.append(time.time())
                dev_lat_samples.append(time.time() - t_disp)

    def emit_timed(fetch_fut, t_disp, seq, idx, raw):
        return _timed(emit, t_disp, seq, idx, fetch_fut, raw)

    def emit_bwt_timed(fetch_fut, t_disp, seq, idx, raw):
        return _timed(emit_bwt, t_disp, seq, idx, fetch_fut, raw)

    def dev_cadence():
        """Median gap between recent device completions. Gaps up to 5s are
        real samples — a stalled device produces multi-second blocks, exactly
        the regime device_ok must see to stop feeding it; only longer
        gaps (device parked between streams) are discarded. Until 2 live
        samples survive, falls back to the rig profile's persisted cadence
        for the chosen stage (None when the rig has never measured one)."""
        ts = list(_dev_done_g)
        ds = sorted(b - a for a, b in zip(ts, ts[1:]) if b - a < 5.0)
        if ds:
            return ds[len(ds) // 2]
        if dev_lat_samples:
            # no gaps yet, but this process has latency evidence (a probe
            # block that completed — or lost its duplication race): an
            # overestimate of pipelined cadence, but live, so it outranks
            # the persisted profile (a stale-pessimistic profile must lose
            # to a fresh healthy measurement, and a fresh bad rig must stop
            # after exactly one probe block)
            return sorted(dev_lat_samples)[len(dev_lat_samples) // 2]
        return (prof.get("dev_cadence_s") or {}).get(stage)

    def device_ok(remaining: int) -> bool:
        if dev_strikes[0] >= 2:
            return False  # twice-proven liability this stream
        cad = dev_cadence()
        if cad is None:
            return dev_inflight[0] < 1  # single probe trains the estimate
        if cpu_pool is None:
            return True
        if not _cpu_ema_g[0]:
            return dev_inflight[0] < 2
        t_dev = cad * (dev_inflight[0] + 1)
        t_cpu = remaining * _cpu_ema_g[0] / eff_cores
        if t_dev < t_cpu:
            # Probation: if the cadence rests ONLY on the persisted profile
            # (no completion and no latency sample from THIS process yet),
            # it may describe a different device phase — a wedged device that
            # the profile remembers as healthy would otherwise soak up a
            # deep in-flight window whose every block must be twinned at
            # the drain head (stalls with no block running). Cap at 2
            # until live evidence arrives; the cap releases on the first
            # completions and costs a healthy phase only the first ~1
            # cadence of ramp.
            if (
                not dev_lat_samples
                and len(_dev_done_g) < 2
                and dev_inflight[0] >= 2
            ):
                return False
            return True
        # the estimates reject the device. If the rejection rests ONLY on
        # the persisted profile (no live evidence this process), spend the
        # process's single re-probe — stale pessimism must be refutable.
        if (
            _reprobe_left_g[0] > 0
            and not dev_lat_samples
            and len(_dev_done_g) < 2
            and dev_inflight[0] == 0
        ):
            _reprobe_left_g[0] -= 1
            return True
        return False

    def steal_ok(remaining: int) -> bool:
        if not _cpu_ema_g[0]:
            return True  # probe
        cad = dev_cadence() or 0.1  # no device sample: assume healthy
        return _cpu_ema_g[0] < cad * max(1, remaining + dev_inflight[0])

    def _dev_hopeless() -> bool:
        """Device cadence so far past the CPU alternative that even
        overflow dispatch (saturated pool) shouldn't feed it — one such
        block becomes the stream head and costs its whole grace window."""
        cad = dev_cadence()
        return cad is not None and cad > max(3 * (_cpu_ema_g[0] or 0.4), 2.0)

    # stage choice: explicit env override wins; otherwise derive from the
    # measured rig profile (falling back to "bwt" until both routes have
    # been measured — the live arbitration trains the profile as it runs)
    stage = DEVICE_STAGE
    if stage == "auto":
        stage = (
            rigprofile.choose_stage(
                prof, hybrid_n if cpu_pool is not None else 0, eff_cores
            )
            or "bwt"
        )
    # bwt-only routing needs the split-chain stamp (the bwt stage is AOT
    # warmed as part of it) AND the native lib (host MTF/RLE2 on the
    # fetched last column would otherwise fall back to the per-symbol
    # pure-Python oracle — seconds per block); a cold cache or missing lib
    # falls back to the full device transform, which carries its own
    # compile-safe fallbacks
    if stage == "bwt":
        from ..block.encode import _probe_split_lean
        from ..native import get_lib

        if not _probe_split_lean() or get_lib() is None:
            stage = "full"
    n_dev = [0]  # blocks dispatched to each engine (phase attribution)
    n_cpu = [0]

    def dispatch_device(idx, blk, raw):
        n_dev[0] += 1
        t_disp = time.time()
        with dev_lock:
            dev_inflight[0] += 1
            dev_flight_seq[0] += 1
            seq = dev_flight_seq[0]
            dev_flight_t[seq] = t_disp
        if stage == "bwt":
            # bwt-only route: the device runs just the suffix sort and
            # the host's native engine runs
            # MTF/RLE2 on the fetched last column. The launch runs on a
            # DEDICATED single-thread dispatcher: launches stay in block
            # order (FIFO), never queue behind the fetch pool's blocking
            # device_get calls, and a wedged device call (a hang, a
            # compile storm despite
            # the stamp) stalls only this dispatcher thread — the drain's
            # straggler guard then duplicates the block onto a CPU worker
            # instead of the wedge propagating out of compress().
            launch_fut = dispatch_pool.submit(enc.transform_bwt, blk)
            fetch_fut = fetch_pool.submit(
                lambda: _materialize_bwt(launch_fut.result())
            )
            f = emit_pool.submit(
                emit_bwt_timed, fetch_fut, t_disp, seq, idx, raw
            )
        else:
            # full-chain route, host refine (never reads freqs/hist on
            # device: lean graph). Runs via the pools so a cold compile
            # (stale persistent cache after a kernel edit) stalls one
            # in-flight block — which the drain's straggler guard
            # duplicates onto a CPU worker — instead of wedging the main
            # dispatch loop for minutes.
            fetch_fut = fetch_pool.submit(
                lambda: materialize(enc.transform(blk, lean=True))
            )
            f = emit_pool.submit(emit_timed, fetch_fut, t_disp, seq, idx, raw)
        inflight.append((f, "dev", ((idx, blk, raw), t_disp)))
        # queue-depth observability, mirroring the reference's RX queue
        # logging (compress.rs:81-85)
        log.debug("in-flight device blocks: %d", len(inflight))

    def pop_head(tail=False):
        """Ordered drain of one block. A device block at the head can outlast
        the entire CPU queue when the device is slow (the hybrid then loses
        to CPU-only on device stragglers), so an
        overdue device head is duplicated onto a free CPU worker and the
        first engine to finish wins — output bytes are identical, and the
        stream tail is then bounded by one CPU block instead of an unbounded
        device latency."""
        fut, kind, args = inflight.popleft()
        if kind == "dev" and cpu_pool is not None:
            args, t_disp = args
            # grace window GRANTED to the device before a twin loss counts
            # as a strike (ground truth of a harmful dispatch). The twin
            # itself starts the moment the pool has an idle slot — idle
            # capacity costs nothing and first-engine-wins on identical
            # bytes. Measured failure shapes this replaces: a per-stream
            # probe block into a stalled device held the drain head for
            # its full grace while the window capped dispatch, idling the
            # whole host; and a
            # one-shot slot check at head-pop missed the slots that free
            # as the pool drains DURING the wait.
            if tail:
                grace = 0.02
            else:
                cad = dev_cadence()
                grace = max(2 * cad, 0.25) if cad is not None else 0.5
                # cap at the cost scale of the CPU alternative: a
                # strike-inflated cadence (e.g. 12.5 s after one awful
                # phase) would otherwise grant a 25 s grace and stall a
                # stream on ONE device block
                grace = min(grace, max(1.0, 3 * (_cpu_ema_g[0] or 0.4)))

            def race():
                """Twin the head block; first engine to finish wins. A
                twin loss within the grace window is a fair race a healthy
                device loses routinely (the twin starts as soon as
                capacity exists) — record plain elapsed; outlasting the
                grace is the ground truth of a harmful dispatch: strike +
                4x pessimism penalty, so a losing device argues its way
                back in through the re-probe, not flattering estimates.
                (The elapsed-so-far is only a LOWER bound on the device
                latency — the abandoned future usually resolves after the
                stream has trained.)"""
                dup = cpu_pool.submit(cpu_one, *args)
                done, _ = _fut_wait((fut, dup), return_when=FIRST_COMPLETED)
                pick = fut if (fut in done and not fut.exception()) else (
                    dup if dup in done else fut
                )
                if pick is dup and not fut.done():
                    elapsed = time.time() - t_disp
                    if not tail and elapsed >= grace:
                        dev_strikes[0] += 1
                        dev_lat_samples.append(4 * elapsed)
                    else:
                        dev_lat_samples.append(elapsed)
                try:
                    return pick.result()
                except Exception as pick_exc:
                    # the winner errored — fall back to the twin, but
                    # BOUNDED: the twin may be the wedged device future
                    # that never completes; surface the concrete error
                    # instead of reverting to the hang this guard prevents
                    twin = dup if pick is fut else fut
                    bound = max(3 * (_cpu_ema_g[0] or 1.0), 5.0)
                    try:
                        return twin.result(timeout=bound)
                    except _FutTimeout:
                        raise pick_exc from None

            # incremental wait: return the instant the device finishes,
            # twin the instant a CPU slot frees (the pool draining toward
            # idle IS the signal that waiting longer wastes the rig)
            dev_errored = False
            while not fut.done():
                if cpu_acquire():
                    return race()
                try:
                    return fut.result(timeout=0.02)
                except _FutTimeout:
                    continue
                except Exception:
                    dev_errored = True
                    break
            if dev_errored or fut.exception() is not None:
                # device errored: a CPU twin IS the block (transient fast
                # errors must not kill a stream the guard protects)
                if cpu_acquire(blocking=True, timeout=30.0):
                    return cpu_pool.submit(cpu_one, *args).result()
                raise fut.exception()
        return fut.result()

    try:
        idx = -1
        for idx, (blk, raw) in enumerate(items):
            remaining = _items_total(items) - idx
            # The device runs CONCURRENTLY with the CPU workers and (on the
            # bwt route) costs only ~1/3 of a CPU block's host time. It is
            # eligible whenever its measured cadence says the block
            # finishes before the CPU pool would reach the queue tail
            # (device_ok) — and not at all when the device is slow
            # enough that a device block would BECOME the stream's tail.
            # Among eligible engines the block goes to the one whose QUEUE
            # finishes it sooner (greedy least-completion-time): the old
            # device-first-refusal rule starved the CPU pool mid-stream
            # when the device was fast — device_ok compares the device
            # against the pool draining the ENTIRE remaining queue, so once
            # the cadence trains fast every block routes to the device and
            # aggregate throughput collapses from device+CPU to
            # device-only.
            dev_eligible = not dev_is_host and device_ok(remaining)
            routed_cpu = False
            # The device's FIRST block each stream always probes (a
            # profile-rejected device that device_ok just granted its
            # re-probe must actually receive a block, and each stream's
            # opening block retrains a stale profile); greedy applies from
            # the second device block on.
            probe_needed = (
                not dev_lat_samples
                and len(_dev_done_g) == 0
                and dev_inflight[0] == 0
            )
            if (
                dev_eligible
                and not probe_needed
                and cpu_pool is not None
                and _cpu_ema_g[0]
            ):
                cad = dev_cadence()
                if cad is not None:
                    # while blocks are in flight, the oldest in-flight
                    # block's age over the flight depth is a live lower
                    # bound on current cadence (a healthy q-deep pipeline
                    # holds oldest_age ~ q*cad): it overrides a stale-fast
                    # estimate the moment a stalled device stops
                    # producing completions, and a fresh dispatch after an idle
                    # gap reads young — no false staleness
                    with dev_lock:
                        oldest = min(dev_flight_t.values(), default=None)
                        q = dev_inflight[0]
                    eff = cad
                    if q and oldest is not None:
                        eff = max(cad, (time.time() - oldest) / q)
                    t_dev = eff * (q + 1)
                    # pool completion estimate for one more block: a free
                    # slot starts it immediately (latency ~ cpu_ema at the
                    # pool's standing contention); queue depth adds wait
                    t_cpu = _cpu_ema_g[0] * (
                        1 + cpu_inflight[0] / max(1, hybrid_n)
                    )
                    if (
                        t_cpu < t_dev
                        and steal_ok(remaining)
                        and cpu_acquire()
                    ):
                        routed_cpu = True
            if dev_eligible and not routed_cpu:
                dispatch_device(idx, blk, raw)
            elif routed_cpu or (
                cpu_pool is not None
                and steal_ok(remaining)
                and cpu_acquire()
            ):
                n_cpu[0] += 1
                inflight.append(
                    (cpu_pool.submit(cpu_one, idx, blk, raw), "cpu", None)
                )
                log.debug("in-flight blocks (cpu steal): %d", len(inflight))
            elif cpu_pool is not None and cpu_acquire(
                blocking=True,
                timeout=None
                if dev_is_host or dev_strikes[0] >= 2 or _dev_hopeless()
                else 0.5,
            ):
                # all slots busy: waiting for a CPU slot beats force-feeding
                # an engine the estimates just rejected (and with the device
                # disabled outright — or measured hopeless — the pool is
                # the only engine worth feeding: wait indefinitely; slots
                # always free because cpu_one releases in a finally)
                n_cpu[0] += 1
                inflight.append(
                    (cpu_pool.submit(cpu_one, idx, blk, raw), "cpu", None)
                )
            else:
                # no CPU pool (or it stayed saturated past the wait and the
                # device still looks usable): overflow to the device; the
                # ordered drain applies the remaining backpressure
                dispatch_device(idx, blk, raw)
            if len(inflight) >= WINDOW:
                yield pop_head()
        while inflight:
            yield pop_head(tail=True)
        # train the rig profile with this stream's measurements (only
        # fields that actually collected data; EMA-folded into the file)
        ts = list(_dev_done_g)
        live = sorted(b - a for a, b in zip(ts, ts[1:]) if b - a < 5.0)
        leg_med = (
            sorted(leg_samples)[len(leg_samples) // 2] if leg_samples else 0.0
        )
        # cadence of record: completion-gap median when the stream pipelined
        # enough device blocks. Latency medians (dispatch->emit, including
        # tail-race losses' elapsed-so-far) overestimate pipelined cadence
        # several-fold on short streams, so they train the PERSISTED
        # cadence only when they're the rig's first signal for this stage or when the
        # stream recorded real head losses (strikes — a degraded device
        # must still argue the profile up). Without this gate, every short
        # hybrid stream (1-2 probe blocks, all drained at the tail) EMAs a
        # healthy gap-trained cadence toward its own unpipelined latency,
        # and each stream makes the next one distrust the device.
        if live:
            cad_train = live[len(live) // 2]
        elif dev_lat_samples and (
            dev_strikes[0] or stage not in (prof.get("dev_cadence_s") or {})
        ):
            cad_train = sorted(dev_lat_samples)[len(dev_lat_samples) // 2]
        else:
            cad_train = 0.0
        if dev_strikes[0] and dev_lat_samples:
            # a stream with real head losses must not train a flattering
            # cadence off bunched completion gaps
            cad_train = max(
                cad_train, sorted(dev_lat_samples)[len(dev_lat_samples) // 2]
            )
        # cap at the gap filter's 5 s boundary: anything above already means
        # "device unusable", and an uncapped strike-inflated value (4x
        # penalty on an awful-phase block) poisons grace windows and stage
        # scoring far beyond what any later evidence can quickly heal
        cad_train = min(cad_train, 5.0)
        rigprofile.update(
            cpu_block_s=_cpu_ema_g[0],
            dev_cadence_s={stage: cad_train},
            host_leg_s={stage: leg_med},
        )
        # phase attribution for this stream (consumed by bench.py)
        last_stream_stats.clear()
        last_stream_stats.update(
            engine="hybrid" if cpu_pool is not None else "device",
            stage=stage,
            blocks=idx + 1,
            dev_blocks=n_dev[0],
            cpu_blocks=n_cpu[0],
            cpu_block_s=round(_cpu_ema_g[0], 4),
            dev_cadence_s=round(live[len(live) // 2], 4) if live else None,
            dev_host_leg_s=round(leg_med, 4),
        )
    finally:
        dispatch_pool.shutdown(wait=False)
        fetch_pool.shutdown(wait=False)
        emit_pool.shutdown(wait=False)
        if cpu_pool is not None:
            cpu_pool.shutdown(wait=False)
