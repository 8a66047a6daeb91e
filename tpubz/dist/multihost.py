"""Multi-host block-data-parallel compression (the cluster-scale analogue of
the reference's rayon pool + ordered writer channel,
src/compression/compress.rs:69-132).

SPMD contract: every process calls :func:`compress_multihost` with the same
input bytes (on a real deployment each host reads the input from shared
storage). Per batch of `global device count` blocks:

  1. every host builds the GLOBAL [G, N] block batch but materializes only
     its local devices' rows via ``jax.make_array_from_process_local_data``
     (per-host block feeding over a global 1-D "blocks" mesh),
  2. the sharded transform (dist/sharded.py, shard_map over the mesh) runs
     the BWT/MTF/RLE2 pipeline with no cross-block communication,
  3. each host fetches ITS OWN output shards (addressable, no network
     copy), runs Huffman refinement + emission for its blocks in the
     native engine — distributing the host-side work across hosts like the rayon pool,
  4. host 0 gathers only the per-block PACKED BITS, per batch: a small
     manifest allgather of block indices + bit lengths, then each process's
     flat-packed payload moves to process 0 ONLY via the jax.distributed KV
     store (_gather_bytes_to_zero — each payload crosses the network once
     instead of landing on every process; TPUBZ_MULTIHOST_ALLGATHER=1 restores the
     padded allgather), and host 0 splices in block order, folding the
     order-dependent stream CRC (src/tools/crc.rs:25-27) exactly as the
     single-host path does. Gathering inside the batch loop bounds every
     non-zero host's peak memory by one batch of compressed blocks,
     independent of stream length (process 0 necessarily accumulates the
     output it returns).

Runs unchanged single-process (the gathers degenerate to identity), which is
how `__graft_entry__.dryrun_multichip` and the CPU-mesh tests exercise it;
`tests/test_multihost.py` additionally runs it as two real processes with
`jax.distributed.initialize` over a 4-device CPU mesh.
"""
from __future__ import annotations

import os

import numpy as np

from ..format.constants import FOOTER_MAGIC, STREAM_MAGIC, block_budget
from ..format.crc import block_crc, stream_crc_fold
from ..hostref.bitio import BitAccum
from ..hostref.rle1 import rle1_blocks


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Bring up the JAX distributed runtime (idempotent passthrough)."""
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


# Network accounting for the dominant (payload) transfers, per process: lets
# the 2-process test assert that gather-to-0 moves ~1/nproc of the allgather's
# bytes. received counts only what THIS process pulled.
last_multihost_stats: dict = {"payload_bytes_sent": 0, "payload_bytes_received": 0, "transport": None}

_KV_CHUNK = 3 << 20  # stay under gRPC message limits
_kv_seq = [0]


def _accel_backend() -> bool:
    """True on accelerator backends; isolated so tests can patch the
    cold-compile guard without perturbing the backend elsewhere."""
    import jax

    return jax.default_backend() != "cpu"


def _kv_client():
    try:
        from jax._src import distributed as _dist

        c = _dist.global_state.client
        return c if c is not None else None
    except Exception:
        return None


def _agree_kv_transport(pid: int, nproc: int) -> bool:
    """Collectively agree on the payload transport for this call: the KV
    gather-to-0 runs only if EVERY process has a usable KV client and none
    disabled it — transport is asymmetric (senders set keys, process 0
    pulls), so a per-process local choice could pair a process blocking in
    an allgather with one waiting on KV keys that never arrive."""
    want = (
        not os.environ.get("TPUBZ_MULTIHOST_ALLGATHER")
        and _kv_client() is not None
    )
    if nproc <= 1:
        return want
    from jax.experimental import multihost_utils

    flags = np.asarray(
        multihost_utils.process_allgather(
            np.asarray([1 if want else 0], np.int32)
        )
    ).reshape(-1)
    return bool(flags.min())


def _gather_bytes_to_zero(tag, payload, sizes, pid, nproc, use_kv):
    """Move each process's payload bytes to process 0 ONLY.

    `sizes[p]` (from the preceding manifest allgather) tells process 0 how
    much to pull from each peer. Transport is the jax.distributed KV store
    (coordination service): each payload crosses the network once to the
    coordinator and once out, instead of landing on every process the way
    `process_allgather` does — on an N-host cluster that is ~N x less traffic
    for the dominant transfer. Falls back to the padded allgather when
    `use_kv` (agreed collectively via _agree_kv_transport) is False.

    Returns a list of per-process uint8 arrays on process 0, None elsewhere.
    """
    client = _kv_client() if use_kv else None
    if client is None:
        from jax.experimental import multihost_utils

        last_multihost_stats["transport"] = "allgather"
        mx = max(max(sizes), 1)
        pad = np.zeros(mx, np.uint8)
        pad[: payload.size] = payload
        all_flat = np.asarray(multihost_utils.process_allgather(pad))
        # every process receives every other process's padded payload
        last_multihost_stats["payload_bytes_sent"] += mx * (nproc - 1)
        last_multihost_stats["payload_bytes_received"] += mx * (nproc - 1)
        if pid != 0:
            return None
        return [all_flat[p, : sizes[p]] for p in range(nproc)]
    last_multihost_stats["transport"] = "kv-gather-to-0"
    if pid != 0:
        b = payload.tobytes()
        for ci in range(0, max((len(b) + _KV_CHUNK - 1) // _KV_CHUNK, 0)):
            client.key_value_set_bytes(
                f"{tag}/p{pid}/c{ci}", b[ci * _KV_CHUNK : (ci + 1) * _KV_CHUNK]
            )
        last_multihost_stats["payload_bytes_sent"] += len(b)
        return None
    outs = []
    for p in range(nproc):
        if p == 0:
            outs.append(np.asarray(payload[: sizes[0]]))
            continue
        nch = (sizes[p] + _KV_CHUNK - 1) // _KV_CHUNK
        parts = []
        for ci in range(nch):
            key = f"{tag}/p{p}/c{ci}"
            parts.append(client.blocking_key_value_get_bytes(key, 600_000))
            client.key_value_delete(key)
        buf = b"".join(parts)
        last_multihost_stats["payload_bytes_received"] += len(buf)
        outs.append(np.frombuffer(buf, np.uint8))
    return outs


def compress_multihost(data: bytes | np.ndarray, level: int = 9):
    """Compress over all hosts/devices of the global mesh.

    Returns the .bz2 bytes on process 0 and None on other processes.
    """
    import jax
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..block.encode import (
        HI_CAP,
        DeviceBlockEncoder,
        setup_jax_cache,
        uncompact_syms,
    )
    from .sharded import block_mesh, make_sharded_transform

    if not 1 <= level <= 9:
        raise ValueError("level must be 1..9")
    setup_jax_cache()
    arr = (
        np.frombuffer(data, dtype=np.uint8)
        if isinstance(data, (bytes, bytearray, memoryview))
        else np.asarray(data, dtype=np.uint8)
    )
    pid = jax.process_index()
    nproc = jax.process_count()

    use_kv = _agree_kv_transport(pid, nproc)

    out, blocks = rle1_blocks(arr, block_budget(level))
    enc = DeviceBlockEncoder(level)
    N = enc.N
    mesh = block_mesh()
    devs = list(mesh.devices.flat)
    G = len(devs)
    my_rows = [i for i, d in enumerate(devs) if d.process_index == pid]
    sharding = NamedSharding(mesh, P("blocks"))
    fn, out_len = make_sharded_transform(mesh, N)
    _kv_seq[0] += 1
    last_multihost_stats.update(
        payload_bytes_sent=0, payload_bytes_received=0, transport=None
    )

    # Warm-stamp discipline: on an accelerator backend, refuse to compile
    # the sharded transform inline (every process of a cluster would stall
    # on it) unless explicitly allowed — the CPU backend (tests, dryrun) is
    # exempt.
    # The decision must be COLLECTIVE: stamps and env overrides are
    # host-local, and a cluster where only some hosts refuse would leave the
    # others hanging in the first collective — so every process reports
    # its readiness and they all raise together if ANY host is cold.
    from .sharded import probe_sharded

    cold_here = (
        _accel_backend()
        and not probe_sharded(mesh, G, N)
        and not os.environ.get("TPUBZ_POD_COLD_OK")
    )
    if nproc > 1:
        flags = np.asarray(
            multihost_utils.process_allgather(
                np.asarray([1 if cold_here else 0], np.int32)
            )
        ).reshape(-1)
        cold_any = bool(flags.max())
        cold_hosts = [p for p in range(nproc) if flags[p]]
    else:
        cold_any = cold_here
        cold_hosts = [0] if cold_here else []
    if cold_any:
        raise RuntimeError(
            "sharded transform is not AOT-warmed on process(es) "
            f"{cold_hosts} for mesh shape {mesh.devices.shape} (B={G}, "
            f"N={N}) with the current kernel sources. Run "
            f"tpubz.dist.sharded.warm_sharded(level={level}) once on "
            "each host, or set TPUBZ_POD_COLD_OK=1 on every host to "
            "accept a cold inline compile."
        )

    nblocks = len(blocks)
    rows_per_proc = max(
        sum(1 for d in devs if d.process_index == p) for p in range(nproc)
    )
    # per-block packed bits, accumulated on process 0 only: the gather runs
    # INSIDE the batch loop so a non-zero host's peak memory is one batch of
    # compressed blocks regardless of stream length, and payloads travel
    # flat-packed (size-prefixed manifest + contiguous concatenation padded
    # to the max per-process FLAT size) instead of one pad-to-global-max row
    # per block.
    per_block: dict[int, tuple[np.ndarray | bytes, int]] = {}
    for base in range(0, nblocks, G):
        batch = blocks[base : base + G]
        local_data = np.zeros((len(my_rows), N), np.uint8)
        local_n = np.ones(len(my_rows), np.int32)  # pad rows: 1-byte dummy
        for r, g in enumerate(my_rows):
            if g < len(batch):
                o0, o1, _, _ = batch[g]
                local_data[r, : o1 - o0] = out[o0:o1]
                local_n[r] = o1 - o0
        data_g = jax.make_array_from_process_local_data(sharding, local_data, (G, N))
        n_g = jax.make_array_from_process_local_data(sharding, local_n, (G,))
        outs = fn(data_g, n_g)
        # fetch only the addressable (local) shards, and only the COMPACT
        # symbol form (u8 stream + sidecar of the rare symbols >= 256 — a
        # quarter of the i32 rows' bytes); the full symbol rows are fetched
        # per row only on sidecar overflow. All seven outputs' shards move
        # in ONE device_get, so their copies overlap instead of paying one
        # round trip each
        fetch = (outs[0], *outs[2:])
        shard_lists = [
            [s.data for s in o.addressable_shards] for o in fetch
        ]
        flat = jax.device_get([d for lst in shard_lists for d in lst])
        it = iter(flat)
        key_l, len_l, freq_l, used_l, u8_l, hip_l, hic_l = (
            np.concatenate([np.asarray(next(it)) for _ in lst])
            for lst in shard_lists
        )
        batch_payloads: dict[int, tuple[bytes, int]] = {}
        for r, g in enumerate(my_rows):
            if g >= len(batch):
                continue
            bi = base + g
            _, _, i0, i1 = batch[g]
            crc = block_crc(arr[i0:i1])
            hc = int(hic_l[r])
            if hc > HI_CAP:  # sidecar overflow (pathological): full row
                syms_r = np.concatenate(
                    [np.asarray(s.data) for s in outs[1].addressable_shards]
                )[r]
            else:
                syms_r = uncompact_syms(u8_l[r], hip_l[r], hc)
            acc = DeviceBlockEncoder.emit_block(
                int(key_l[r]), syms_r, int(len_l[r]), freq_l[r], used_l[r], crc
            )
            payload, nbits = acc.pack()
            batch_payloads[bi] = (payload, nbits)
        if nproc == 1:
            for bi, (payload, nbits) in batch_payloads.items():
                per_block[bi] = (np.frombuffer(payload, np.uint8), nbits)
            continue
        # manifest: (block index + 1, bit length) per local row; flat payload
        order = sorted(batch_payloads)
        manifest = np.zeros((max(rows_per_proc, 1), 2), np.int64)
        for j, bi in enumerate(order):
            manifest[j] = (bi + 1, batch_payloads[bi][1])
        flat = (
            np.concatenate(
                [
                    np.frombuffer(batch_payloads[bi][0], np.uint8)
                    for bi in order
                ]
            )
            if order
            else np.zeros(0, np.uint8)
        )
        all_man = np.asarray(multihost_utils.process_allgather(manifest))
        flat_caps = (all_man[:, :, 1] + 7) // 8 * (all_man[:, :, 0] > 0)
        sizes = [int(flat_caps[p].sum()) for p in range(nproc)]
        flats = _gather_bytes_to_zero(
            f"tpubz/enc/{_kv_seq[0]}/{base}", flat, sizes, pid, nproc, use_kv
        )
        if pid != 0:
            continue
        for p in range(nproc):
            off = 0
            for j in range(all_man.shape[1]):
                bi, nbits = int(all_man[p, j, 0]) - 1, int(all_man[p, j, 1])
                if bi < 0:
                    continue
                nbytes = (nbits + 7) // 8
                per_block[bi] = (flats[p][off : off + nbytes], nbits)
                off += nbytes

    if pid != 0:
        return None

    # assemble in block order with the order-dependent stream CRC fold
    from ..hostref.bitio import splice_byte_chunks

    header = BitAccum()
    for b in STREAM_MAGIC:
        header.put(b, 8)
    header.put(0x30 + level, 8)
    chunks = [header.pack()]
    s_crc = 0
    for bi in range(nblocks):
        _, _, i0, i1 = blocks[bi]
        s_crc = stream_crc_fold(s_crc, block_crc(arr[i0:i1]))
        payload, nbits = per_block[bi]
        chunks.append((np.ascontiguousarray(payload).tobytes(), nbits))
    footer = BitAccum()
    footer.put(FOOTER_MAGIC, 48)
    footer.put(s_crc, 32)
    chunks.append(footer.pack())
    stream, _ = splice_byte_chunks(chunks)
    return stream


def decompress_multihost(data: bytes) -> bytes | None:
    """Decode .bz2 bytes data-parallel over all processes of the global
    jax.distributed cluster — the cluster-scale extension of the single-host
    thread-parallel decode (stream/decode.py). The reference decodes
    strictly serially because the stream carries no block index and blocks
    are bit-aligned (src/compression/decompress.rs:3-4); the magic-scan +
    validate strategy removes that constraint, and here the validated
    per-block decodes spread across HOSTS, not just threads. Decode is
    host-native work (the chase/Huffman engines are CPU kernels), so the
    parallel resource is the cluster's host cores; devices are not involved.

    SPMD contract: every process calls with the same bytes (each host reads
    the input from shared storage on a real deployment). Returns the raw
    bytes on process 0 and None elsewhere.

    Mechanics mirror the encode side's ordered fan-in: candidate block
    starts (48-bit magic scan over the whole buffer, concatenated streams
    included) are partitioned round-robin across processes; each process
    pre-decodes its share with the GIL-free native engine on a local thread
    pool; one two-phase allgather (sizes, then payloads padded to the max)
    lands every decoded block on every process; process 0 walks the
    bit-chain stream by stream, consuming gathered results and falling back
    to a local serial decode for any candidate that is missing or was a
    payload false positive, validating block CRCs and the stream CRC
    exactly like the serial path.
    """
    import jax
    from concurrent.futures import ThreadPoolExecutor

    from jax.experimental import multihost_utils

    from ..format.crc import stream_crc_fold
    from ..hostref.bitio import BitReader
    from ..format.constants import BLOCK_MAGIC
    from ..native import decode_block_native, find_magic2_native, get_lib
    from ..stream.decode import decompress, find_magic_bit_offsets

    pid = jax.process_index()
    nproc = jax.process_count()
    # the engine choice must be agreed COLLECTIVELY: if the on-demand native
    # build succeeded on some hosts but not others, a local early return here
    # would leave the rest blocked forever in process_allgather — so every
    # process reports its native availability first and the serial fallback
    # (or the parallel path) is taken by all processes together
    has_native = get_lib() is not None
    if nproc > 1:
        flags = np.asarray(
            multihost_utils.process_allgather(
                np.asarray([1 if has_native else 0], np.int32)
            )
        )
        has_native = bool(flags.min())
    if not has_native:
        # no native engine somewhere: decode serially on process 0
        return decompress(data) if pid == 0 else None
    use_kv = _agree_kv_transport(pid, nproc)
    if len(data) < 4 or data[:3] != STREAM_MAGIC:
        raise ValueError("not a bzip2 stream")

    arr = np.ascontiguousarray(np.frombuffer(data, dtype=np.uint8))

    # ---- candidate scan (identical on every process: same input) ----
    both = find_magic2_native(arr, BLOCK_MAGIC, FOOTER_MAGIC)
    if both is not None:
        blocks_hits, _footers = both
    else:
        blocks_hits = find_magic_bit_offsets(data)
    candidates = [int(c) for c in blocks_hits if c >= 32]

    # per-candidate level: byte-aligned "BZh"+digit headers partition the
    # buffer into streams; a payload false positive here only mislevels a
    # pre-decode, which the process-0 walk heals by re-decoding locally
    hdr_bytes = np.flatnonzero(
        (arr[:-3] == 0x42) & (arr[1:-2] == 0x5A) & (arr[2:-1] == 0x68)
        & (arr[3:] >= 0x31) & (arr[3:] <= 0x39)
    )
    if hdr_bytes.size == 0 or hdr_bytes[0] != 0:
        raise ValueError("invalid block size digit")
    cand_levels = [
        int(arr[hdr_bytes[np.searchsorted(hdr_bytes * 8 + 32, c, "right") - 1] + 3])
        - 0x30
        for c in candidates
    ]

    # ---- local pre-decode + windowed gather ----
    def try_decode(i):
        """Returns (raw, end_bit, blk_crc, actual, used_level) or None.

        A payload false-positive "BZh" header between this candidate's true
        stream header and the candidate can mislevel it; decode is level-
        independent apart from the output cap, so a failed pre-decode
        retries at the format maximum before giving up — otherwise one
        bogus header collapses parallelism for every later candidate. The
        level actually used rides along because a retry at 9 enforces a
        LOOSER output cap than the stream's true level: the stitch must not
        accept such a result for a lower-level stream (it would admit
        oversized blocks the serial decoder rejects), so it re-decodes at
        the true level whenever used_level exceeds it."""
        try:
            res = decode_block_native(arr, candidates[i] + 48, cand_levels[i])
            return (*res, cand_levels[i])
        except ValueError:
            if cand_levels[i] < 9:
                try:
                    res = decode_block_native(arr, candidates[i] + 48, 9)
                    return (*res, 9)
                except ValueError:
                    return None
            return None

    decoded: dict[int, tuple[np.ndarray, int, int, int, int]] = {}

    # ---- incremental ordered stitch (process 0) ----
    # The walk advances as far as gathered windows allow after EVERY window
    # (instead of once at the end): consumed payloads are released
    # immediately, and the walked-past bit position is broadcast so later
    # windows skip candidates the chain already passed (payload false
    # positives) and stop entirely once the final footer is consumed —
    # the cluster analogue of the single-host cancel-on-done
    # (stream/decode.py).
    out_parts: list[bytes] = []
    walk = {
        "pos_byte": 0,
        "pos": -1,
        "s_crc": 0,
        "level": 0,
        "in_stream": False,
        "done": False,
    }

    def advance_walk(limit_bit):
        """Stitch forward until done, or until the next needed block sits
        past `limit_bit` (not yet gathered; None = no limit, fall back to
        local decode for anything missing)."""
        while not walk["done"]:
            if not walk["in_stream"]:
                pb = walk["pos_byte"]
                if pb + 4 > len(data) or data[pb : pb + 3] != STREAM_MAGIC:
                    walk["done"] = True
                    break
                level = data[pb + 3] - 0x30
                if not 1 <= level <= 9:
                    raise ValueError("invalid block size digit")
                walk["level"] = level
                walk["pos"] = pb * 8 + 32
                walk["s_crc"] = 0
                walk["in_stream"] = True
            pos = walk["pos"]
            br = BitReader(data)
            br.pos = pos
            tag = br.read(48)
            if tag == FOOTER_MAGIC:
                stored = br.read(32)
                if stored != walk["s_crc"]:
                    raise ValueError(
                        f"stream CRC mismatch: stream says {stored:#010x}, "
                        f"got {walk['s_crc']:#010x}"
                    )
                walk["pos_byte"] = (br.pos + 7) // 8
                walk["in_stream"] = False
                continue
            if tag != BLOCK_MAGIC:
                raise ValueError("invalid block header magic")
            hit = decoded.get(pos)
            if hit is not None and hit[4] > walk["level"]:
                # pre-decoded under a looser output cap than this stream's
                # true level enforces (the mislevel-retry path): re-decode
                # at the true level so an oversized block raises exactly as
                # the serial/single-host decoders would
                hit = None
            if hit is None:
                if limit_bit is not None and pos > limit_bit:
                    return  # a future window will bring this block
                hit = decode_block_native(arr, pos + 48, walk["level"])
                hit = (*hit, walk["level"])
            else:
                decoded.pop(pos, None)  # consumed: release the payload
            raw, end_bit, blk_crc, actual, _ = hit
            if int(actual) != int(blk_crc):
                raise ValueError(
                    f"block CRC mismatch: stream says {int(blk_crc):#010x}, "
                    f"got {int(actual):#010x}"
                )
            walk["s_crc"] = stream_crc_fold(walk["s_crc"], int(blk_crc))
            out_parts.append(np.asarray(raw).tobytes())
            walk["pos"] = int(end_bit)

    if nproc == 1:
        mine = list(range(len(candidates)))
        if mine:
            with ThreadPoolExecutor(min(32, len(mine))) as ex:
                for i, res in zip(mine, ex.map(try_decode, mine)):
                    if res is not None:
                        decoded[candidates[i]] = (
                            res[0], res[1], int(res[2]), int(res[3]), res[4]
                        )
        advance_walk(None)
        return b"".join(out_parts)

    # Candidates are processed in WINDOWS so peak host memory is bounded
    # by one window of decoded blocks; payloads travel flat-packed via the
    # gather-to-0 transport (only process 0 stitches). Window default: 8
    # candidates per process per round (~7 MB/process at 900k blocks).
    win = max(1, int(os.environ.get("TPUBZ_MULTIHOST_WINDOW", "8")))
    rows = max(1, win)
    walked_past = 0  # broadcast after each window: skip candidates below
    ex = ThreadPoolExecutor(min(32, max(1, rows)))
    try:
        for w0 in range(0, len(candidates), win * nproc):
            win_ids = list(range(w0, min(w0 + win * nproc, len(candidates))))
            mine = [
                i
                for i in win_ids
                if (i - w0) % nproc == pid and candidates[i] >= walked_past
            ]
            local: dict[int, tuple] = {}
            for i, res in zip(mine, ex.map(try_decode, mine)):
                if res is not None:
                    local[candidates[i]] = res
            # manifest fields ride as uint32 lo/hi word pairs:
            # process_allgather runs under the default (x64-disabled)
            # jax config, which silently truncates int64 payloads to
            # int32 — CRCs above 2^31 and bit offsets in large streams
            # would corrupt. Field 0 stores c+1 so an all-zero row means
            # "empty slot".
            meta = np.zeros((rows, 12), np.uint32)
            for j, c in enumerate(sorted(local)):
                raw, end_bit, blk_crc, actual, used_lvl = local[c]
                fields = (
                    c + 1, int(end_bit), int(blk_crc), int(actual),
                    raw.size, used_lvl,
                )
                for f, v in enumerate(fields):
                    meta[j, 2 * f] = v & 0xFFFFFFFF
                    meta[j, 2 * f + 1] = v >> 32
            all_meta = np.asarray(
                multihost_utils.process_allgather(meta), np.uint64
            )

            def fld(p, j, f):
                return int(all_meta[p, j, 2 * f]) | (
                    int(all_meta[p, j, 2 * f + 1]) << 32
                )

            flat_sizes = [
                sum(
                    fld(p, j, 4)
                    for j in range(all_meta.shape[1])
                    if fld(p, j, 0) > 0
                )
                for p in range(nproc)
            ]
            if any(flat_sizes):
                flat = (
                    np.concatenate(
                        [np.asarray(local[c][0]) for c in sorted(local)]
                    )
                    if local
                    else np.zeros(0, np.uint8)
                )
                flats = _gather_bytes_to_zero(
                    f"tpubz/dec/{_kv_seq[0]}/{w0}", flat, flat_sizes,
                    pid, nproc, use_kv,
                )
                if pid == 0:
                    for p in range(nproc):
                        off = 0
                        for j in range(all_meta.shape[1]):
                            if fld(p, j, 0) == 0:
                                continue
                            size = fld(p, j, 4)
                            decoded[fld(p, j, 0) - 1] = (
                                flats[p][off : off + size],
                                fld(p, j, 1),
                                fld(p, j, 2),
                                fld(p, j, 3),
                                fld(p, j, 5),
                            )
                            off += size
            # incremental stitch + walk-state broadcast (u32 pair: the
            # broadcast also runs under x64-disabled jax config). A stitch
            # failure (corrupt stream: CRC/magic errors) must NOT raise
            # here on process 0 alone — the peers are already waiting in
            # this broadcast / the next window's allgather and would hang;
            # the error rides the done flag (2) so everyone exits the
            # collective loop together and process 0 re-raises after.
            walk_err = None
            if pid == 0:
                try:
                    advance_walk(candidates[win_ids[-1]])
                except (ValueError, EOFError) as e:
                    walk_err = e
            state = np.zeros(3, np.uint32)
            if pid == 0:
                wp = max(
                    walk["pos"] if walk["in_stream"] else walk["pos_byte"] * 8,
                    0,
                )
                state[:] = (
                    wp & 0xFFFFFFFF,
                    wp >> 32,
                    2 if walk_err is not None else int(walk["done"]),
                )
            state = np.asarray(multihost_utils.broadcast_one_to_all(state))
            walked_past = int(state[0]) | (int(state[1]) << 32)
            if state[2]:
                # done (1) or stitch error on process 0 (2): every process
                # cancels its remaining windows together
                if walk_err is not None:
                    raise walk_err
                break
    finally:
        ex.shutdown(wait=False)

    if pid != 0:
        return None
    advance_walk(None)
    return b"".join(out_parts)
