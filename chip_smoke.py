"""Prove that tpubz's encode/decode main path runs on a GPU.

Run from the repository root on a machine with an NVIDIA GPU:

    python chip_smoke.py           # one card: kernels, then the entry points
    python chip_smoke.py --four    # four cards: the block-parallel dist path

Phases, in order (any failure raises, so the script exits non-zero):

  preamble  the card's name and power limit, the JAX version and devices;
            exits non-zero at once without a GPU; checks that the native
            library was built on this host
  kernels   every stage graph at full block width (levels 9 and 1) on three
            seeded blocks, compared exactly with the host oracle
            (tpubz/hostref); the device-refine emitter and the device
            inverse BWT once each
  stream    a seeded corpus of >= 64 MiB through tpubz.compress (three
            pinned device routes, the hybrid default, level 1), tpubz.open
            and the CLI; every output byte-identical to compress_cpu and
            decoded back
  four      (--four only, and nothing else) warm_sharded, then
            compress_multihost / decompress_multihost on a 1-D mesh of four
            cards, byte-identical to one card and to compress_cpu

Every time printed is a smoke timing of the card named in the preamble,
not a benchmark number. The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# the full-width routes every hybrid-off stream run pins (see _route)
_ROUTE_VARS = ("TPUBZ_HYBRID_CPU", "TPUBZ_DEVICE_STAGE", "TPUBZ_SPLIT", "TPUBZ_FUSED")
FRESH = {"TPUBZ_HYBRID_CPU": "0", "TPUBZ_DEVICE_STAGE": "full",
         "TPUBZ_SPLIT": "0", "TPUBZ_FUSED": "0"}
SPLIT = {"TPUBZ_HYBRID_CPU": "0", "TPUBZ_DEVICE_STAGE": "full",
         "TPUBZ_SPLIT": "1", "TPUBZ_FUSED": "0"}
BWT_ONLY = {"TPUBZ_HYBRID_CPU": "0", "TPUBZ_DEVICE_STAGE": "bwt",
            "TPUBZ_SPLIT": "1", "TPUBZ_FUSED": "0"}


def say(*parts) -> None:
    print(*parts, flush=True)


def card_lines() -> list[str]:
    """`nvidia-smi --query-gpu=name,power.limit` lines (one per card)."""
    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi unavailable: {e}"]
    return [l.strip() for l in p.stdout.splitlines() if l.strip()] or [
        f"nvidia-smi rc={p.returncode}: {p.stderr.strip()[:200]}"
    ]


def preamble():
    """Print the card and JAX setup; return jax.devices()."""
    import jax

    for line in card_lines():
        say(f"card: {line}")
    devs = jax.devices()
    say(f"jax {jax.__version__}; devices: {devs}")
    return devs


def check_native() -> None:
    """The native engine must be a library built on THIS host."""
    from tpubz import native

    lib = native.get_lib()
    if lib is None:
        raise RuntimeError("native library failed to build or load")
    if native.loaded_path() != native.lib_path():
        raise RuntimeError(
            f"loaded {native.loaded_path()}, but this host builds "
            f"{native.lib_path()}"
        )
    say(f"native: {os.path.basename(native.loaded_path())} "
        f"(key {native.build_key()} = sources + flags + this host's CPU)")


# ---------------------------------------------------------------- kernels

def kernel_blocks(level: int, seed: int = 0) -> dict[str, np.ndarray]:
    """Three full-width RLE1 blocks for one level.

    mixed     the first RLE1 block of bench.build_corpus (text + binary)
    periodic  a random 1000-byte period repeated over a whole number of
              periods (so the wrap continues it) with one byte lowered:
              rotations 1000 apart agree for up to n - 1001 bytes, so 4-ary
              doubling needs every round (all ROUNDS=10 at level 9)
    random    uniform bytes: all 256 symbols, MTF rank 255 and the
              HI_CAP sidecar of symbols >= 256
    """
    import bench
    from tpubz.format.constants import block_budget
    from tpubz.hostref.rle1 import rle1_blocks

    n = block_budget(level)
    rng = np.random.default_rng(seed + level)
    corpus = np.frombuffer(bench.build_corpus(2 * level // 9 + 1), np.uint8)
    out, blocks = rle1_blocks(corpus, n)
    o0, o1, _, _ = blocks[0]
    period = rng.integers(0, 256, 1000, dtype=np.uint8)
    periodic = np.tile(period, n // 1000)
    # lower one byte: the rotation that meets it first sorts first, against
    # index order, so a tie left by a missing round would show as a wrong
    # last column
    m = periodic.size // 2 + int(np.argmax(period[periodic.size // 2 % 1000:] > 0))
    periodic[m] -= 1
    return {
        "mixed": np.array(out[o0:o1]),
        "periodic": periodic,
        "random": rng.integers(0, 256, n, dtype=np.uint8),
    }


def _hist(rle2: np.ndarray, nsel: int) -> np.ndarray:
    from tpubz.format.constants import GROUP_SIZE

    h = np.zeros((nsel, 258), np.int64)
    np.add.at(h, (np.arange(rle2.size) // GROUP_SIZE, rle2.astype(np.int64)), 1)
    return h


def _eq(what: str, got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = "shape" if got.shape != want.shape else int(
            np.flatnonzero(got.reshape(-1) != want.reshape(-1))[0]
        )
        raise AssertionError(f"{what}: device != oracle (first diff at {bad})")


class _Oracle:
    """Host reference results for one block (tpubz/hostref)."""

    def __init__(self, block: np.ndarray):
        from tpubz.hostref.bwt import bwt_encode
        from tpubz.hostref.mtf_rle2 import mtf_encode, rle2_encode_ranks

        self.n = block.size
        self.key, self.last = bwt_encode(block)
        self.ranks, self.used = mtf_encode(self.last)
        self.rle2 = rle2_encode_ranks(self.ranks, self.used)
        self.freqs = np.bincount(self.rle2, minlength=258)
        self.hi = int(np.sum(self.rle2[:-1] >= 256))

    def check_materialized(self, what, mat) -> None:
        from tpubz.block.encode import materialize

        key, syms, rl, freqs, used = materialize(mat)
        if key != self.key or rl != self.rle2.size:
            raise AssertionError(f"{what}: key/len {key}/{rl} != "
                                 f"{self.key}/{self.rle2.size}")
        _eq(f"{what} fetched symbols", syms[:rl], self.rle2)
        _eq(f"{what} fetched freqs", freqs, self.freqs)
        _eq(f"{what} used", used, self.used)


def _graphs():
    from tpubz.block import encode as E

    return {
        "_stage_bwt": E._stage_bwt,
        "_stage_mtf": E._stage_mtf,
        "_stage_rle2c": E._stage_rle2c,
        "_stage_post": E._stage_post,
        "_stage_full_lean": E._stage_full_lean,
        "_stage_full": E._stage_full,
    }


def _check_block(o: _Oracle, run, data, n):
    """Run every graph on one block and compare each output exactly."""
    key, last = run["_stage_bwt"](data, n)
    if int(key) != o.key:
        raise AssertionError(f"_stage_bwt key {int(key)} != {o.key}")
    last_h = np.asarray(last)
    _eq("_stage_bwt last", last_h[: o.n], o.last)
    _eq("_stage_bwt pad lanes", last_h[o.n:], np.zeros(last_h.size - o.n, np.uint8))

    ranks, used = run["_stage_mtf"](last, n)
    _eq("_stage_mtf ranks", np.asarray(ranks)[: o.n], o.ranks)
    _eq("_stage_mtf used", used, o.used)

    rle2_len, quarters, hi_pos, hi_count, syms = run["_stage_rle2c"](ranks, n, used)
    rl = int(rle2_len)
    _eq("_stage_rle2c symbols", np.asarray(syms)[:rl], o.rle2)
    if int(hi_count) != o.hi:
        raise AssertionError(f"_stage_rle2c hi_count {int(hi_count)} != {o.hi}")
    o.check_materialized(
        "_stage_rle2c", (key, syms, rle2_len, used, quarters, hi_pos, hi_count)
    )

    post = run["_stage_post"](last, n)
    _eq("_stage_post symbols", np.asarray(post[0])[: int(post[1])], o.rle2)
    _eq("_stage_post freqs", post[2], o.freqs)
    nsel = post[7].shape[0]
    _eq("_stage_post chunk histogram", post[7], _hist(o.rle2, nsel))
    o.check_materialized("_stage_post", (key, *post))

    lean = run["_stage_full_lean"](data, n)
    _eq("_stage_full_lean symbols", np.asarray(lean[1])[: int(lean[2])], o.rle2)
    o.check_materialized("_stage_full_lean", lean)

    full = run["_stage_full"](data, n)
    _eq("_stage_full symbols", np.asarray(full[1])[: int(full[2])], o.rle2)
    _eq("_stage_full chunk histogram", full[8], _hist(o.rle2, nsel))
    o.check_materialized("_stage_full", full)
    return full


def phase_kernels(levels=(9, 1), seed: int = 0) -> None:
    """Compile every stage graph per level, print compile seconds, temp
    bytes and one wall time, and compare each on three blocks with the
    host oracle. Tolerance zero: the pipeline is integer."""
    import jax
    import jax.numpy as jnp

    from tpubz.block.encode import DeviceBlockEncoder, materialize
    from tpubz.format.crc import block_crc
    from tpubz.kernels.ibwt import bwt_inverse_device

    say("phase kernels: smoke timings of this card, not benchmark numbers")
    for level in levels:
        enc = DeviceBlockEncoder(level)
        N = enc.N
        blocks = kernel_blocks(level, seed)
        u8 = jax.ShapeDtypeStruct((N,), jnp.uint8)
        i32 = jax.ShapeDtypeStruct((), jnp.int32)
        specs = {
            "_stage_bwt": (u8, i32),
            "_stage_mtf": (u8, i32),
            "_stage_rle2c": (
                jax.ShapeDtypeStruct((N,), jnp.int32), i32,
                jax.ShapeDtypeStruct((256,), jnp.bool_),
            ),
            "_stage_post": (u8, i32),
            "_stage_full_lean": (u8, i32),
            "_stage_full": (u8, i32),
        }
        run = {}
        for name, fn in _graphs().items():
            t0 = time.perf_counter()
            run[name] = fn.lower(*specs[name]).compile()
            dt = time.perf_counter() - t0
            mem = run[name].memory_analysis()
            temp = getattr(mem, "temp_size_in_bytes", None)
            say(f"  L{level} N={N} {name}: compile {dt:.2f} s, "
                f"temp {temp} bytes")
        first = None
        for bname, block in blocks.items():
            n = block.size
            pad = np.zeros(N, np.uint8)
            pad[:n] = block
            data, nd = jnp.asarray(pad), jnp.int32(n)
            t0 = time.perf_counter()
            o = _Oracle(block)
            t_oracle = time.perf_counter() - t0
            full = _check_block(o, run, data, nd)
            say(f"  L{level} {bname} n={n}: all 6 graphs == host oracle "
                f"(rle2_len {o.rle2.size}, symbols >= 256: {o.hi}; "
                f"oracle {t_oracle:.1f} s)")
            if first is None:
                first = (block, o, data, nd, full)
        # one wall time per graph on the first block, outputs ready
        block, o, data, nd, full = first
        last = run["_stage_bwt"](data, nd)[1]
        ranks, used = run["_stage_mtf"](last, nd)
        args = {
            "_stage_bwt": (data, nd), "_stage_mtf": (last, nd),
            "_stage_rle2c": (ranks, nd, used), "_stage_post": (last, nd),
            "_stage_full_lean": (data, nd), "_stage_full": (data, nd),
        }
        for name, exe in run.items():
            jax.block_until_ready(exe(*args[name]))
            t0 = time.perf_counter()
            jax.block_until_ready(exe(*args[name]))
            say(f"  L{level} {name}: one call {1e3 * (time.perf_counter() - t0):.2f} ms")
        if level == levels[0]:
            crc = block_crc(block)
            dev = enc.encode_block_devrefine(full, crc).pack()
            host = enc.emit_block(*materialize(full), crc).pack()
            if dev != host:
                raise AssertionError("encode_block_devrefine != host emission")
            say(f"  L{level} encode_block_devrefine == host emission "
                "(refine_pass is the only float op: f32 matmuls at "
                "precision='highest', no TF32; integer operands and sums "
                "below 2^24, so exact)")
            inv = bwt_inverse_device(o.key, o.last, o.n)
            _eq("kernels/ibwt.py inverse BWT", inv, block)
            say(f"  L{level} kernels/ibwt.py inverse == original block")


# ----------------------------------------------------------------- stream

@contextlib.contextmanager
def _route(env: dict):
    """Pin one device route for a stream run: set the route variables (any
    not in env are unset), and drop the memos that read them."""
    from tpubz.block import encode as E
    from tpubz.stream import api

    saved = {k: os.environ.get(k) for k in _ROUTE_VARS}
    saved_stage = api.DEVICE_STAGE
    for k in _ROUTE_VARS:
        if k in env:
            os.environ[k] = env[k]
        else:
            os.environ.pop(k, None)
    api.DEVICE_STAGE = env.get("TPUBZ_DEVICE_STAGE", "auto")
    E._split_ok = E._lean_ok = E._full_ok = None
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        api.DEVICE_STAGE = saved_stage
        E._split_ok = E._lean_ok = E._full_ok = None


def stream_corpus(mb: int) -> bytes:
    """The seeded mixed corpus (bench.build_corpus: text, random bytes, a
    low alphabet, long runs, strided records)."""
    import bench

    return bench.build_corpus(mb)


def _check_stats(name: str, hybrid_off: bool) -> dict:
    from tpubz.stream.api import last_stream_stats as st

    st = dict(st)
    if hybrid_off and (st.get("engine") != "device"
                       or st.get("dev_blocks") != st.get("blocks")):
        raise AssertionError(f"{name}: not every block ran on the device: {st}")
    return st


def phase_stream(mb: int = 64, level: int = 9, low_level: int = 1) -> None:
    """The corpus through every user entry point; every output must equal
    compress_cpu's bytes at its level and decode back to the corpus."""
    import tpubz
    from tpubz import cli
    from tpubz.stream.api import compress_cpu

    say("phase stream: smoke timings of this card, not benchmark numbers")
    corpus = stream_corpus(mb)
    say(f"  corpus {len(corpus)} bytes, sha256 "
        f"{hashlib.sha256(corpus).hexdigest()}")
    ref = {}
    for lv in dict.fromkeys((level, low_level)):
        t0 = time.perf_counter()
        ref[lv] = compress_cpu(corpus, lv)
        say(f"  compress_cpu -{lv}: {len(ref[lv])} bytes, "
            f"{time.perf_counter() - t0:.2f} s")

    def check(name, lv, out, env):
        if out != ref[lv]:
            raise AssertionError(f"{name}: output != compress_cpu -{lv}")
        st = _check_stats(name, env.get("TPUBZ_HYBRID_CPU") == "0")
        return st

    runs = [
        ("fresh-machine route (full, unstamped: bwt + post)", level, FRESH),
        ("split lean chain (bwt / mtf / rle2c)", level, SPLIT),
        ("bwt-only route (host MTF/RLE2)", level, BWT_ONLY),
        ("hybrid default", level, {}),
        (f"level -{low_level} (split lean chain)", low_level, SPLIT),
    ]
    for name, lv, env in runs:
        with _route(env):
            t0 = time.perf_counter()
            out = tpubz.compress(corpus, lv)
            dt = time.perf_counter() - t0
            st = check(name, lv, out, env)
        say(f"  tpubz.compress {name}: == compress_cpu -{lv}, {dt:.2f} s, "
            f"blocks {st.get('blocks')} (device {st.get('dev_blocks')}, "
            f"cpu {st.get('cpu_blocks')}, engine {st.get('engine')}, "
            f"stage {st.get('stage')})")

    with tempfile.TemporaryDirectory(prefix="tpubz_smoke_") as tmp:
        path = os.path.join(tmp, "corpus.bin")
        with _route(SPLIT):
            t0 = time.perf_counter()
            with tpubz.open(path + ".open.bz2", "wb", level) as f:
                f.write(corpus)
            with open(path + ".open.bz2", "rb") as f:
                check("tpubz.open write", level, f.read(), SPLIT)
            with tpubz.open(path + ".open.bz2", "rb") as f:
                if f.read() != corpus:
                    raise AssertionError("tpubz.open read != corpus")
            say(f"  tpubz.open write + read: == compress_cpu -{level}, "
                f"round trip ok, {time.perf_counter() - t0:.2f} s")

            with open(path, "wb") as f:
                f.write(corpus)
            t0 = time.perf_counter()
            rc = cli.run(["-z", "-k", f"-{level}", path], "tpubz")
            if rc != 0:
                raise AssertionError(f"CLI compress rc={rc}")
            with open(path + ".bz2", "rb") as f:
                check("CLI -z", level, f.read(), SPLIT)
            rc = cli.run(["-d", "-k", "-f", path + ".bz2"], "tpubz")
            with open(path, "rb") as f:
                if rc != 0 or f.read() != corpus:
                    raise AssertionError(f"CLI -d rc={rc} or bytes differ")
            say(f"  CLI -z / -d in-process: == compress_cpu -{level}, "
                f"round trip ok, {time.perf_counter() - t0:.2f} s")

    # every run equals compress_cpu, so decoding each level's bytes once
    # decodes them all
    bunzip2 = shutil.which("bunzip2")
    say(f"  system bunzip2: {bunzip2 or 'not found'}")
    for lv, out in ref.items():
        t0 = time.perf_counter()
        if tpubz.decompress(out) != corpus:
            raise AssertionError(f"tpubz.decompress -{lv} != corpus")
        say(f"  tpubz.decompress -{lv}: == corpus, "
            f"{time.perf_counter() - t0:.2f} s")
        if bunzip2:
            p = subprocess.run([bunzip2, "-c"], input=out, capture_output=True)
            if p.returncode != 0 or p.stdout != corpus:
                raise AssertionError(f"bunzip2 -{lv}: rc={p.returncode}")
            say(f"  bunzip2 -{lv}: == corpus")


# ------------------------------------------------------------------- four

def phase_four(mb: int = 64, level: int = 9) -> None:
    """Block-data-parallel encode and decode over a 1-D mesh of four cards
    (all to all over NVLink, so the mesh follows the algorithm alone)."""
    import jax

    import tpubz
    from tpubz.dist.multihost import compress_multihost, decompress_multihost
    from tpubz.dist.sharded import block_mesh, warm_sharded
    from tpubz.stream.api import compress_cpu

    devs = jax.devices()
    if len(devs) != 4:
        raise AssertionError(f"--four needs 4 devices, found {len(devs)}")
    say("phase four: smoke timings of these cards, not benchmark numbers")
    t0 = time.perf_counter()
    warm_sharded(level, block_mesh(devs))
    say(f"  warm_sharded -{level} on mesh (4,): cold compile "
        f"{time.perf_counter() - t0:.2f} s")
    corpus = stream_corpus(mb)
    say(f"  corpus {len(corpus)} bytes, sha256 "
        f"{hashlib.sha256(corpus).hexdigest()}")
    ref = compress_cpu(corpus, level)
    t0 = time.perf_counter()
    multi = compress_multihost(corpus, level)
    say(f"  compress_multihost: {time.perf_counter() - t0:.2f} s")
    with _route(SPLIT):
        one = tpubz.compress(corpus, level)
        _check_stats("one-card compress", True)
    if not multi == one == ref:
        raise AssertionError("compress_multihost, one card and compress_cpu differ")
    say(f"  compress_multihost == one card == compress_cpu -{level}")
    t0 = time.perf_counter()
    if decompress_multihost(multi) != corpus:
        raise AssertionError("decompress_multihost != corpus")
    say(f"  decompress_multihost == corpus, {time.perf_counter() - t0:.2f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card block-parallel phase")
    args = ap.parse_args(argv)
    devs = preamble()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}",
              file=sys.stderr)
        return 2
    from tpubz.block.encode import setup_jax_cache
    from tpubz.cache import cache_dir

    setup_jax_cache()
    say(f"compile cache: {cache_dir()} ({len(os.listdir(cache_dir()))} "
        "entries at start; compile times are cold only where it was empty)")
    check_native()
    if args.four:
        phase_four()
    else:
        phase_kernels()
        phase_stream()
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
