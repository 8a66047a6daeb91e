"""Data-parallel block encoding over a device mesh.

bzip2's parallelism is block-level data parallelism (SURVEY.md §2: the
reference fans RLE1 blocks over a rayon pool, src/compression/compress.rs:
125-132, with an ordered channel fan-in). Device equivalent: batches of
fixed-shape blocks sharded over a 1-D `Mesh` axis ("blocks") via
`shard_map`; the per-block transform needs no cross-block communication (no
shared dictionary — all tables are per-block), so the only collective surface is the ordered
gather of per-block outputs, which rides the jax.Array output sharding back
to host 0 in block order.

Multi-host design (validated on the virtual 8-device CPU mesh; a real
cluster uses the same code): `jax.distributed.initialize()` per host, a
global mesh over all devices, and the same block-DP sharding — per-host
input feeding via `jax.make_array_from_process_local_data` on each host's
slice of the block batch, outputs gathered to host 0 by fetching the global
arrays. Every device of one host reaches every other at the same rate, so
the mesh is 1-D and follows the algorithm alone. The stream CRC fold
is order-dependent (reference src/tools/crc.rs:25-27) and is applied on
host 0 in block order during assembly, exactly as in the single-host path.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..kernels.suffix_sort import bwt_forward
from ..block.encode import MTF_CHUNK


def block_mesh(devices=None, axis: str = "blocks") -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (axis,))


def make_sharded_transform(mesh: Mesh, N: int, axis: str = "blocks"):
    """Returns a jitted fn (data uint8[B,N], n int32[B]) -> per-block outputs,
    with B sharded across the mesh axis. B must be a multiple of mesh size."""
    out_len = N + 8
    spec = P(axis)

    def batched(data, n):
        # BWT via lax.map: under scan the convergence while_loop's cond is
        # scalar, so each local block exits at its own round count —
        # sum(rounds) per shard instead of vmap's B_local x max(rounds).
        # With one block per device the two coincide. mtf/rle2 use the
        # FLAT block-namespaced batch formulations (kernels/mtf.py,
        # kernels/rle2.py), which keep the single-block op count.
        from ..kernels.mtf import mtf_ranks_batch
        from ..kernels.rle2 import rle2_encode_batch

        keys, lasts = jax.lax.map(
            lambda a: bwt_forward(a[0], a[1], skip_converged="batch"),
            (data, n),
        )
        ranks, used = mtf_ranks_batch(lasts, n, chunk=MTF_CHUNK)
        eob = jnp.sum(used, axis=1).astype(jnp.int32) + 1
        syms, rle2_len, freqs = rle2_encode_batch(ranks, n, eob)
        # compact transfer form (u8 stream + packed sidecar of the rare
        # symbols >= 256): a quarter of the device-to-host bytes of the i32
        # symbol rows. Full syms stays an output solely for
        # the sidecar-overflow fallback; consumers simply never fetch it
        # otherwise (jax.Array transfers are per-fetch).
        from ..block.encode import _stage_compact

        syms_u8, hi_packed, hi_count = jax.vmap(_stage_compact)(syms, rle2_len)
        return keys, syms, rle2_len, freqs, used, syms_u8, hi_packed, hi_count

    sharded = jax.shard_map(
        batched,
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=(spec,) * 8,
    )
    return jax.jit(sharded), out_len


# ---- warm-stamp discipline (mirrors block/encode.py's AOT stamps) ----
#
# warm_sharded() AOT-compiles the sharded transform into the persistent
# compile cache and stamps it with a hash of the graph-shaping sources keyed
# by (mesh shape, batch, N); compress_multihost refuses to cold-compile on
# an accelerator backend unless TPUBZ_POD_COLD_OK=1.


def _sharded_src_hash() -> str:
    import hashlib
    import inspect

    from ..block import encode as _enc

    h = hashlib.sha256()
    h.update(_enc._src_hash().encode())
    h.update(inspect.getsource(make_sharded_transform).encode())
    return h.hexdigest()


def _sharded_stamp_path(mesh_shape, B: int, N: int) -> str:
    import os

    from ..cache import cache_dir

    key = "x".join(map(str, mesh_shape)) or "1"
    return os.path.join(cache_dir(), f"tpubz_sharded_stamp_{key}_b{B}_n{N}")


def probe_sharded(mesh: Mesh, B: int, N: int) -> bool:
    """True if warm_sharded() stamped this exact (mesh, batch, N, sources)
    combination — i.e. the persistent compile cache holds the transform."""
    try:
        with open(_sharded_stamp_path(mesh.devices.shape, B, N)) as f:
            return f.read().strip() == _sharded_src_hash()
    except OSError:
        return False


def warm_sharded(level: int = 9, mesh: Mesh | None = None, B: int | None = None):
    """AOT-compile the sharded transform for this mesh shape and stamp it.

    Run once per host and mesh shape after any kernel edit. Returns the
    compiled executable so callers can keep it."""
    from jax.sharding import NamedSharding

    from ..block.encode import DeviceBlockEncoder, setup_jax_cache

    setup_jax_cache()
    if mesh is None:
        mesh = block_mesh()
    if B is None:
        B = mesh.devices.size
    N = DeviceBlockEncoder(level).N
    fn, _ = make_sharded_transform(mesh, N)
    sh = NamedSharding(mesh, P("blocks"))
    exe = fn.lower(
        jax.ShapeDtypeStruct((B, N), jnp.uint8, sharding=sh),
        jax.ShapeDtypeStruct((B,), jnp.int32, sharding=sh),
    ).compile()
    with open(_sharded_stamp_path(mesh.devices.shape, B, N), "w") as f:
        f.write(_sharded_src_hash())
    return exe
