"""Multi-host compression layer: single-process on the virtual 8-device CPU
mesh, and a REAL 2-process run with jax.distributed over a 4-device CPU mesh
(SURVEY.md §4's 'multi-node without a real cluster' strategy)."""
import os
import subprocess
import sys

import numpy as np
import pytest


def _mixed_input(rng, n=260_000):
    return (
        bytes(rng.integers(0, 200, n // 2, dtype=np.uint8))
        + b"m" * (n // 4)
        + bytes(rng.integers(0, 8, n // 4, dtype=np.uint8))
    )


def test_multihost_singleprocess_matches_hostref(rng):
    from tpubz.dist.multihost import compress_multihost
    from tpubz.hostref.stream import compress, decompress

    d = _mixed_input(rng)
    got = compress_multihost(d, 1)
    assert got == compress(d, 1)
    assert decompress(got) == d


def test_multihost_decode_singleprocess(rng):
    """decompress_multihost single-process: same candidate-partition +
    stitch code path as the pod run (allgather degenerates), incl. a
    concatenated pair of streams at different levels."""
    from tpubz.dist.multihost import decompress_multihost
    from tpubz.hostref.stream import compress

    d = _mixed_input(rng)
    s1 = compress(d, 1)  # multi-block at level 1 (budget ~100k)
    assert decompress_multihost(s1) == d

    d2 = b"concat tail " * 400
    s2 = compress(d2, 9)
    assert decompress_multihost(s1 + s2) == d + d2


def test_multihost_decode_concat_level_cap_binds(rng):
    """Concatenated streams where the SECOND stream's blocks exceed the
    first stream's output cap: a level-1 stream followed by a level-9
    stream whose single block decodes to ~260k (> the 100k level-1 bound).
    The per-candidate level partition (or, if that ever mispartitions, the
    retry-at-9 healing path in try_decode) must decode it — a regression
    guard for the ADVICE r3 mislevel finding."""
    from tpubz.dist.multihost import decompress_multihost
    from tpubz.hostref.stream import compress

    d1 = _mixed_input(rng, 120_000)
    big = (b"abcdefgh" * 16_000 + bytes(rng.integers(0, 4, 4_000, dtype=np.uint8))) * 2
    s = compress(d1, 1) + compress(big, 9)
    assert decompress_multihost(s) == d1 + big


def test_multihost_decode_rejects_corruption(rng):
    from tpubz.dist.multihost import decompress_multihost
    from tpubz.hostref.stream import compress

    d = _mixed_input(rng)
    s = bytearray(compress(d, 1))
    s[len(s) // 2] ^= 0x40  # flip a payload bit
    with pytest.raises(ValueError):
        decompress_multihost(bytes(s))


WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1])
nproc = int(sys.argv[4])
jax.distributed.initialize(sys.argv[2], num_processes=nproc, process_id=pid)
import numpy as np
rng = np.random.default_rng(321)
n = 260_000
d = (bytes(rng.integers(0, 200, n // 2, dtype=np.uint8))
     + b"m" * (n // 4)
     + bytes(rng.integers(0, 8, n // 4, dtype=np.uint8)))
from tpubz.dist.multihost import compress_multihost
out = compress_multihost(d, 1)
if pid == 0:
    # write to a file: Gloo prints rank-connection logs to stdout
    open(sys.argv[3], "wb").write(out)
"""


WORKER_DECODE = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1])
nproc = int(sys.argv[4])
jax.distributed.initialize(sys.argv[2], num_processes=nproc, process_id=pid)
import numpy as np
rng = np.random.default_rng(321)
n = 260_000
d = (bytes(rng.integers(0, 200, n // 2, dtype=np.uint8))
     + b"m" * (n // 4)
     + bytes(rng.integers(0, 8, n // 4, dtype=np.uint8)))
from tpubz.hostref.stream import compress
from tpubz.dist.multihost import decompress_multihost
raw = decompress_multihost(compress(d, 1))
if pid == 0:
    assert raw == d, "multihost decode mismatch"
    open(sys.argv[3], "wb").write(raw)
else:
    assert raw is None
"""


@pytest.mark.slow
def test_multihost_decode_2_processes(tmp_path):
    """Real 2-process jax.distributed decode: candidates pre-decode on both
    processes, gathered payloads stitch on process 0, byte-identical."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(WORKER_DECODE)
    coord = "localhost:12417"
    out_file = tmp_path / "out.raw"
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), coord, str(out_file), "2"],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE,
            env=env,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e.decode()[-2000:]
    rng = np.random.default_rng(321)
    n = 260_000
    d = (
        bytes(rng.integers(0, 200, n // 2, dtype=np.uint8))
        + b"m" * (n // 4)
        + bytes(rng.integers(0, 8, n // 4, dtype=np.uint8))
    )
    assert out_file.read_bytes() == d


@pytest.mark.slow
@pytest.mark.parametrize("nproc,port", [(2, 12411), (4, 12413)])
def test_multihost_n_processes(tmp_path, nproc, port):
    """Real multi-process jax.distributed runs: 2 hosts x 2 devices and
    4 hosts x 2 devices (an 8-device global mesh), byte-identical to the
    single-process oracle."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    coord = f"localhost:{port}"
    out_file = tmp_path / "out.bz2"
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), coord, str(out_file), str(nproc)],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE,
            env=env,
        )
        for i in range(nproc)
    ]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e.decode()[-2000:]
    stream = out_file.read_bytes()

    rng = np.random.default_rng(321)
    n = 260_000
    d = (
        bytes(rng.integers(0, 200, n // 2, dtype=np.uint8))
        + b"m" * (n // 4)
        + bytes(rng.integers(0, 8, n // 4, dtype=np.uint8))
    )
    from tpubz.hostref.stream import compress, decompress

    assert stream == compress(d, 1)
    assert decompress(stream) == d


WORKER_SKEW = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["TPUBZ_MULTIHOST_WINDOW"] = "2"  # force several gather windows
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1])
nproc = int(sys.argv[4])
jax.distributed.initialize(sys.argv[2], num_processes=nproc, process_id=pid)
import numpy as np
rng = np.random.default_rng(77)
# skewed blocks: long zero runs RLE1-compress ~50x, so decoded block sizes
# swing from ~2 KB to ~5 MB across the stream — the pad-to-global-max
# gather this exercises used to inflate every row to the largest block
d = (b"\x00" * 5_000_000
     + bytes(rng.integers(0, 250, 150_000, dtype=np.uint8))
     + b"z" * 2_000_000
     + bytes(rng.integers(0, 250, 120_000, dtype=np.uint8)))
from tpubz.hostref.stream import compress
from tpubz.dist.multihost import compress_multihost, decompress_multihost
stream = compress_multihost(d, 1)
raw = decompress_multihost(compress(d, 1))
if pid == 0:
    assert stream == compress(d, 1), "skewed multihost encode mismatch"
    assert raw == d, "skewed multihost decode mismatch"
    open(sys.argv[3], "wb").write(b"ok")
else:
    assert stream is None and raw is None
"""


@pytest.mark.slow
def test_multihost_skewed_blocks_2_processes(tmp_path):
    """Real 2-process run over a stream whose decoded block sizes are
    heavily skewed (RLE1 zero-bombs next to entropy blocks): exercises the
    bounded flat-packed windowed gather on both the encode and decode
    side."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(WORKER_SKEW)
    coord = "localhost:12421"
    out_file = tmp_path / "ok.txt"
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), coord, str(out_file), "2"],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE,
            env=env,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e.decode()[-2000:]
    assert out_file.read_bytes() == b"ok"


WORKER_DCN_STATS = r"""
import os, sys, json
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1])
nproc = int(sys.argv[4])
jax.distributed.initialize(sys.argv[2], num_processes=nproc, process_id=pid)
import numpy as np
rng = np.random.default_rng(321)
n = 260_000
d = (bytes(rng.integers(0, 200, n // 2, dtype=np.uint8))
     + b"m" * (n // 4)
     + bytes(rng.integers(0, 8, n // 4, dtype=np.uint8)))
from tpubz.hostref.stream import compress
from tpubz.dist import multihost
s = compress(d, 1)
raw = multihost.decompress_multihost(s)
kv_stats = dict(multihost.last_multihost_stats)
if pid == 0:
    assert raw == d
os.environ["TPUBZ_MULTIHOST_ALLGATHER"] = "1"
raw2 = multihost.decompress_multihost(s)
ag_stats = dict(multihost.last_multihost_stats)
if pid == 0:
    assert raw2 == d
with open(sys.argv[3] + f".p{pid}.json", "w") as f:
    json.dump({"kv": kv_stats, "allgather": ag_stats}, f)
"""


@pytest.mark.slow
def test_multihost_dcn_gather_to_zero(tmp_path):
    """The payload gather moves bytes to process 0 ONLY: on the real
    2-process run the KV transport's non-zero-process send volume must be
    well under the padded allgather's (which delivers every payload to
    every process) — the transfer-size probe."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env.pop("TPUBZ_MULTIHOST_ALLGATHER", None)
    script = tmp_path / "worker.py"
    script.write_text(WORKER_DCN_STATS)
    coord = "localhost:12421"
    tag = tmp_path / "stats"
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), coord, str(tag), "2"],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE,
            env=env,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e.decode()[-2000:]
    import json

    p1 = json.loads((tmp_path / "stats.p1.json").read_text())
    assert p1["kv"]["transport"] == "kv-gather-to-0"
    assert p1["allgather"]["transport"] == "allgather"
    # decode stats include the decompress_multihost payload windows; the
    # KV path sends each payload once (to process 0), the allgather lands
    # max-padded payloads on BOTH processes
    assert p1["kv"]["payload_bytes_sent"] > 0
    assert p1["kv"]["payload_bytes_sent"] <= p1["allgather"]["payload_bytes_sent"] / 1.8


WORKER_CORRUPT = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1])
nproc = int(sys.argv[4])
jax.distributed.initialize(sys.argv[2], num_processes=nproc, process_id=pid)
import numpy as np
rng = np.random.default_rng(321)
d = bytes(rng.integers(0, 200, 300_000, dtype=np.uint8))
from tpubz.hostref.stream import compress
from tpubz.dist.multihost import decompress_multihost
s = bytearray(compress(d, 1))
s[len(s) // 2] ^= 0x40  # corrupt a payload bit mid-stream
try:
    decompress_multihost(bytes(s))
except ValueError:
    pass  # expected on process 0 (stitch CRC error)
# a second healthy call proves neither process is wedged in a collective
ok = decompress_multihost(compress(d, 1))
if pid == 0:
    assert ok == d
open(sys.argv[3] + f".p{pid}", "w").write("done")
"""


@pytest.mark.slow
def test_multihost_corrupt_stream_does_not_hang(tmp_path):
    """A corrupt stream raises on process 0's incremental stitch; the error
    must ride the walk-state broadcast so BOTH processes exit their
    collective loops (instead of peers hanging in the next allgather), and
    the cluster must stay usable for a subsequent healthy call."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(WORKER_CORRUPT)
    coord = "localhost:12423"
    tag = tmp_path / "done"
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), coord, str(tag), "2"],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE,
            env=env,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e.decode()[-2000:]
    assert (tmp_path / "done.p0").exists() and (tmp_path / "done.p1").exists()


WORKER_ASYM_TRANSPORT = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1])
nproc = int(sys.argv[4])
if pid == 1:
    os.environ["TPUBZ_MULTIHOST_ALLGATHER"] = "1"  # asymmetric on purpose
jax.distributed.initialize(sys.argv[2], num_processes=nproc, process_id=pid)
import numpy as np
rng = np.random.default_rng(321)
d = bytes(rng.integers(0, 200, 260_000, dtype=np.uint8))
from tpubz.hostref.stream import compress
from tpubz.dist import multihost
raw = multihost.decompress_multihost(compress(d, 1))
if pid == 0:
    assert raw == d
    # the agreement must have demoted BOTH processes to allgather
    assert multihost.last_multihost_stats["transport"] == "allgather"
open(sys.argv[3] + f".p{pid}", "w").write("done")
"""


@pytest.mark.slow
def test_multihost_asymmetric_transport_env_agrees(tmp_path):
    """TPUBZ_MULTIHOST_ALLGATHER set on only ONE process must not deadlock
    (KV sender paired with an allgather waiter): the transport choice is
    agreed collectively, so both demote to allgather."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env.pop("TPUBZ_MULTIHOST_ALLGATHER", None)
    script = tmp_path / "worker.py"
    script.write_text(WORKER_ASYM_TRANSPORT)
    coord = "localhost:12425"
    tag = tmp_path / "done"
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), coord, str(tag), "2"],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE,
            env=env,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e.decode()[-2000:]
    assert (tmp_path / "done.p0").exists() and (tmp_path / "done.p1").exists()
