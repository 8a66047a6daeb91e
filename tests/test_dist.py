"""Multi-chip (virtual 8-device mesh) end-to-end encode.

Shards a batch of RLE1 blocks over the mesh via shard_map, assembles the
ordered bitstream on host 0, and validates the result against the host
reference decoder and system bunzip2 — the multi-host-sim strategy from
SURVEY.md §4.
"""
import numpy as np
import pytest

from tpubz.format.constants import BLOCK_MAGIC, FOOTER_MAGIC, STREAM_MAGIC, block_budget
from tpubz.format.crc import block_crc, stream_crc_fold
from tpubz.hostref.bitio import BitAccum
from tpubz.hostref.rle1 import rle1_blocks
from tpubz.hostref.stream import decompress
from tpubz.block.encode import DeviceBlockEncoder


def test_sharded_encode_roundtrip(rng, sys_bunzip2):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpubz.dist.sharded import block_mesh, make_sharded_transform

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    mesh = block_mesh(jax.devices()[:8])
    level = 1
    # craft input yielding >= 8 blocks at level 1 (low-entropy, ~8.5 x 100k)
    data = bytes(rng.integers(0, 32, 860_000, dtype=np.uint8))
    arr = np.frombuffer(data, np.uint8)
    out, blocks = rle1_blocks(arr, block_budget(level))
    assert len(blocks) >= 8

    N = 2048 * ((block_budget(level) + 2047) // 2048)
    fn, out_len = make_sharded_transform(mesh, N)
    B = 8  # one batch of 8 blocks across the mesh; rest go single-device
    batch = np.zeros((B, N), np.uint8)
    ns = np.ones(B, np.int32)
    for i in range(B):
        o0, o1, _, _ = blocks[i]
        batch[i, : o1 - o0] = out[o0:o1]
        ns[i] = o1 - o0
    sharding = NamedSharding(mesh, P("blocks"))
    res = fn(
        jax.device_put(jnp.asarray(batch), sharding),
        jax.device_put(jnp.asarray(ns), sharding),
    )
    key, syms, rle2_len, freqs, used = (np.asarray(x) for x in res[:5])
    # compact transfer form must reconstruct the u16 symbol rows exactly
    u8, hip, hic = (np.asarray(x) for x in res[5:])
    for r in range(syms.shape[0]):
        rl, hc = int(rle2_len[r]), int(hic[r])
        rec = u8[r].astype(np.uint16)
        if hc:
            hi = hip[r, :hc]
            rec[hi >> 1] = 256 + (hi & 1)
        assert (rec[:rl] == syms[r][:rl]).all()

    acc = BitAccum()
    for b in STREAM_MAGIC:
        acc.put(b, 8)
    acc.put(0x30 + level, 8)
    s_crc = 0
    enc = DeviceBlockEncoder  # emission is static
    for i, (o0, o1, i0, i1) in enumerate(blocks):
        crc = block_crc(arr[i0:i1])
        s_crc = stream_crc_fold(s_crc, crc)
        if i < B:
            blk = enc.emit_block(
                int(key[i]), syms[i], int(rle2_len[i]), freqs[i], used[i], crc
            )
        else:  # tail blocks via the single-block path
            blk = DeviceBlockEncoder(level).encode_block(out[o0:o1], crc)
        vals, bits = blk.arrays()
        acc.extend(vals, bits)
    acc.put(FOOTER_MAGIC, 48)
    acc.put(s_crc, 32)
    payload, _ = acc.pack()

    assert decompress(payload) == data
    assert sys_bunzip2(payload) == data


def test_warm_sharded_stamp(tmp_path, monkeypatch):
    """Pod warm-stamp discipline: probe false on a cold cache, true after
    warm_sharded, false again when the stamp predates a source change
    (tampered hash)."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    from tpubz.block.encode import DeviceBlockEncoder
    from tpubz.dist.sharded import (
        _sharded_stamp_path,
        block_mesh,
        probe_sharded,
        warm_sharded,
    )

    mesh = block_mesh()
    B = mesh.devices.size
    N = DeviceBlockEncoder(9).N
    assert not probe_sharded(mesh, B, N)
    warm_sharded(9, mesh)
    assert probe_sharded(mesh, B, N)
    with open(_sharded_stamp_path(mesh.devices.shape, B, N), "w") as f:
        f.write("stale-hash-from-older-sources")
    assert not probe_sharded(mesh, B, N)


def test_multihost_refuses_cold_pod_compile(monkeypatch, tmp_path, rng):
    """On an accelerator backend with no warm stamp, compress_multihost
    fails fast with re-warm instructions instead of eating a cold compile;
    TPUBZ_POD_COLD_OK=1 overrides."""
    import tpubz.dist.multihost as mh

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))  # no stamps here
    monkeypatch.setattr(mh, "_accel_backend", lambda: True)
    data = bytes(rng.integers(0, 200, 50_000, dtype=np.uint8))
    with pytest.raises(RuntimeError, match=r"warm_sharded\(level=1\).*TPUBZ_POD_COLD_OK=1"):
        mh.compress_multihost(data, 1)
    monkeypatch.setenv("TPUBZ_POD_COLD_OK", "1")
    out = mh.compress_multihost(data, 1)  # CPU devices: compiles in seconds
    from tpubz.hostref.stream import decompress as href_dec

    assert href_dec(out) == data
