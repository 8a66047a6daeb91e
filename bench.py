"""Benchmark driver: prints ONE JSON line with the headline metric.

Headline: single-chip bzip2 -9 encode throughput on a REAL-FILE corpus
(ELF binaries + program source + headers + config text actually present on
the image, deterministically manifested and interleaved — see
build_real_corpus; falls back to the synthetic Silesia proxy only if the
image lacks the material or TPUBZ_BENCH_SYNTH=1), measured end-to-end
through the device-path compressor (RLE1 host scan -> device transforms ->
Huffman refinement -> stream assembly), with output validated against
system bunzip2. A decode-of-C-streams interop throughput (our decoder on
`bzip2 -9` output) is reported alongside decode-of-ours.

Robustness: host CPU scheduling can be bursty, so encode and decode run
TPUBZ_BENCH_TRIALS trials (default 7) and the headline value is the MEDIAN;
best is reported alongside. The default corpus is 32 MB (TPUBZ_BENCH_MB
overrides), so startup/tail effects do not hide steady-state pipeline
throughput.

The JSON line names the device JAX ran on (platform, kind, count) and the
card's `nvidia-smi` name and power limit.
"""
import glob
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# Real-file corpus (default since r5): assembled deterministically from
# files actually present on the image, mirroring Silesia's ingredient
# classes with real data instead of generated approximations —
# executables/shared objects (Silesia: mozilla/ooffice), program source
# (samba), English-adjacent text/config, and structured records. Chunks
# from the categories are INTERLEAVED (1 MiB round-robin by weight) so any
# prefix of the corpus keeps the full mix — TPUBZ_BENCH_MB slices a prefix.
_REAL_CATEGORIES = [
    # (name, weight, glob patterns, per-file byte cap)
    (
        "binary",
        5,
        ["/usr/lib/x86_64-linux-gnu/*.so*", "/usr/bin/*"],
        8 << 20,
    ),
    (
        "source",
        3,
        [
            "/usr/local/lib/python3.12/*.py",
            "/usr/local/lib/python3.12/**/*.py",
            "/opt/venv/lib/python3.12/site-packages/numpy/**/*.py",
            "/opt/venv/lib/python3.12/site-packages/jax/**/*.py",
        ],
        1 << 20,
    ),
    ("headers", 2, ["/usr/include/**/*.h", "/usr/include/**/*.hpp"], 1 << 20),
    (
        "text",
        2,
        ["/etc/services", "/etc/ssl/openssl.cnf", "/usr/share/doc/**/copyright"],
        1 << 20,
    ),
]


def _real_category_bytes(patterns, need, cap):
    """Deterministic byte stream for one category: files in sorted path
    order, symlinks skipped, each file contributing at most `cap` bytes,
    until `need` bytes are collected. Returns (bytes, manifest rows)."""
    out = []
    manifest = []
    got = 0
    seen = set()
    for pat in patterns:
        for p in sorted(glob.glob(pat, recursive=True)):
            if got >= need:
                break
            if p in seen or os.path.islink(p) or not os.path.isfile(p):
                continue
            seen.add(p)
            try:
                with open(p, "rb") as f:
                    d = f.read(min(cap, need - got))
            except OSError:
                continue
            if not d:
                continue
            out.append(d)
            manifest.append([p, len(d)])
            got += len(d)
    return b"".join(out), manifest


def build_real_corpus(mb: int):
    """Assemble the real-file bench corpus (>=`mb` MiB) with its manifest.

    Cached on disk keyed by size: the file set is deterministic for a given
    image, and the manifest (per-category file list + sha256 of the blob)
    is written next to the corpus so a reader can audit provenance.
    Returns (corpus_bytes, provenance_dict) or None if the image lacks the
    material (then the synthetic proxy is the fallback).

    The cached assembly is always >= 128 MiB regardless of the requested
    size — the bench takes a prefix (safe: the interleave keeps every
    prefix representative), so every run, whatever its TPUBZ_BENCH_MB,
    reads from the SAME audited corpus."""
    base_mb = max(mb, 128)
    total = base_mb * 1024 * 1024
    want = mb * 1024 * 1024
    cache = os.path.join(
        os.environ.get("TPUBZ_BENCH_CACHE", "/tmp"),
        f"tpubz_real_corpus_{base_mb}mb",
    )
    if os.path.exists(cache + ".bin") and os.path.exists(cache + ".json"):
        with open(cache + ".bin", "rb") as f:
            blob = f.read()
        with open(cache + ".json") as f:
            prov = json.load(f)
        if len(blob) >= want and prov.get("sha256") == hashlib.sha256(
            blob
        ).hexdigest():
            prov["sliced_mb"] = mb
            return blob[:want], prov
    wsum = sum(w for _, w, _, _ in _REAL_CATEGORIES)
    streams = []
    manifest = {}
    for name, w, pats, cap in _REAL_CATEGORIES:
        # binary is the plentiful category (1.1 GB of shared objects on
        # this image): let it collect up to the whole total so it can fill
        # in for categories that run short of their weighted share
        need = total if name == "binary" else total * w // wsum + (1 << 20)
        data, rows = _real_category_bytes(pats, need, cap)
        streams.append((name, data))
        manifest[name] = {"bytes": len(data), "files": len(rows)}
    # 1 MiB round-robin interleave by weight so every prefix keeps the mix
    chunk = 1 << 20
    offs = {name: 0 for name, _ in streams}
    parts = []
    got = 0
    while got < total:
        progressed = False
        for (name, w, _, _), (_, data) in zip(_REAL_CATEGORIES, streams):
            for _ in range(w):
                if got >= total:
                    break
                o = offs[name]
                if o >= len(data):
                    continue
                d = data[o : o + chunk]
                offs[name] = o + len(d)
                parts.append(d)
                got += len(d)
                progressed = True
        if not progressed:
            break
    blob = b"".join(parts)[:total]
    if len(blob) < want:
        return None
    for name, _ in streams:
        manifest[name]["bytes_used"] = offs[name]
    prov = {
        "kind": "real-files",
        "total_mb": len(blob) >> 20,
        "categories": manifest,
        "interleave": "1MiB round-robin, weights binary5:source3:headers2:text2",
        "sha256": hashlib.sha256(blob).hexdigest(),
    }
    try:
        with open(cache + ".bin", "wb") as f:
            f.write(blob)
        with open(cache + ".json", "w") as f:
            json.dump(prov, f)
    except OSError:
        pass
    prov = dict(prov, sliced_mb=mb)
    return blob[:want], prov


def build_corpus(mb: int = 8) -> bytes:
    """Deterministic mixed corpus roughly mirroring Silesia's composition.

    Provenance: the real Silesia corpus is NOT obtainable in this offline
    environment (zero egress; no copy ships in the image), so this is an
    explicit PROXY built from the same ingredient classes Silesia samples —
    natural-language text, high-entropy/incompressible data, low-alphabet
    data, long runs, and strided record-like structure. The headline metric
    is therefore "mixed Silesia-like", not Silesia itself; swap in the real
    corpus via TPUBZ_BENCH_CORPUS=<path to a file or directory> when one is
    available."""
    path = os.environ.get("TPUBZ_BENCH_CORPUS")
    if path:
        datas = []
        if os.path.isdir(path):
            for name in sorted(os.listdir(path)):
                with open(os.path.join(path, name), "rb") as f:
                    datas.append(f.read())
        else:
            with open(path, "rb") as f:
                datas.append(f.read())
        blob = b"".join(datas)
        return blob[: mb * 1024 * 1024] if mb else blob
    rng = np.random.default_rng(42)
    parts = []
    # text: system files cycled
    text = b""
    for p in ("/etc/services", "/etc/ssl/openssl.cnf", "/usr/share/dict/words"):
        if os.path.exists(p):
            with open(p, "rb") as f:
                text += f.read()
    if not text:
        text = b"the quick brown fox jumps over the lazy dog\n" * 10000
    target = mb * 1024 * 1024
    while sum(map(len, parts)) < target:
        parts.append(text)
        parts.append(rng.integers(0, 256, target // 8, dtype=np.uint8).tobytes())
        parts.append(bytes(rng.integers(0, 16, target // 8, dtype=np.uint8)))
        parts.append(b"A" * (target // 16))
        struct = np.zeros(target // 8, dtype=np.uint8)
        struct[::7] = rng.integers(0, 256, struct[::7].size, dtype=np.uint8)
        parts.append(struct.tobytes())
    return b"".join(parts)[:target]


def _device() -> dict:
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def _card() -> str | None:
    """`nvidia-smi` name and power limit of each card (None without one)."""
    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return "; ".join(l.strip() for l in p.stdout.splitlines() if l.strip()) or None


def main():
    level = 9
    trials = max(1, int(os.environ.get("TPUBZ_BENCH_TRIALS", "7")))
    mb = int(os.environ.get("TPUBZ_BENCH_MB", "32"))
    corpus_prov = None
    if os.environ.get("TPUBZ_BENCH_CORPUS"):
        corpus = build_corpus(mb)
        corpus_label = os.environ["TPUBZ_BENCH_CORPUS"]
    elif os.environ.get("TPUBZ_BENCH_SYNTH"):
        corpus = build_corpus(mb)
        corpus_label = "silesia-proxy"
    else:
        real = build_real_corpus(mb)
        if real is not None:
            corpus, corpus_prov = real
            corpus_label = "real-files"
        else:
            corpus = build_corpus(mb)
            corpus_label = "silesia-proxy"
    from tpubz.stream.api import compress
    from tpubz.stream.decode import decompress

    # warm-up: a small prefix first (pays any pending compiles without
    # holding the full corpus in flight), then one full-size untimed pass so
    # the timed trials measure the steady-state pipeline (thread pools
    # spawned, caches hot)
    compress(corpus[: 64 * 1024], level)
    # measurement hygiene: one short DEVICE-ONLY pass trains the rig
    # profile's cadence from real pipelined completion GAPS — the hybrid's
    # short streams drain their 1-2 device blocks at the tail and can only
    # produce unpipelined latency (a 5-10x overestimate the trainer
    # rightly distrusts), so without this the timed trials route on stale
    # or first-contact guesses instead of this phase's actual device speed
    _prev_hybrid = os.environ.get("TPUBZ_HYBRID_CPU")
    try:
        os.environ["TPUBZ_HYBRID_CPU"] = "0"
        compress(corpus[: 4 * 1024 * 1024], level)
    except Exception:
        pass
    finally:
        if _prev_hybrid is None:
            os.environ.pop("TPUBZ_HYBRID_CPU", None)
        else:
            os.environ["TPUBZ_HYBRID_CPU"] = _prev_hybrid
    compress(corpus, level)

    enc_times = []
    out = None
    for _ in range(trials):
        t0 = time.time()
        out = compress(corpus, level)
        enc_times.append(time.time() - t0)
    gbps = len(corpus) / statistics.median(enc_times) / 1e9
    gbps_best = len(corpus) / min(enc_times) / 1e9

    # validate through system bunzip2
    p = subprocess.run(["bunzip2", "-c"], input=out, capture_output=True)
    ok = p.returncode == 0 and p.stdout == corpus

    dec_times = []
    back = None
    for _ in range(trials):
        t0 = time.time()
        back = decompress(out)
        dec_times.append(time.time() - t0)
    dec_mbps = len(corpus) / statistics.median(dec_times) / 1e6
    dec_mbps_best = len(corpus) / min(dec_times) / 1e6
    ok = ok and back == corpus

    # size check vs reference C bzip2
    ref = subprocess.run(
        ["bzip2", "-9", "-c"], input=corpus, capture_output=True
    ).stdout
    ratio = len(out) / len(corpus)

    # interop decode: OUR decoder on the C-produced stream (bunzip2
    # compatibility is already asserted in the other direction above)
    c_dec_mbps = None
    if ref:
        c_dec_times = []
        cd = None
        for _ in range(trials):
            t0 = time.time()
            cd = decompress(ref)
            c_dec_times.append(time.time() - t0)
        ok = ok and cd == corpus
        c_dec_mbps = len(corpus) / statistics.median(c_dec_times) / 1e6
    # phase attribution: which engine carried the blocks and what each
    # engine's per-block cost measured on the LAST timed trial — makes
    # trial swings explainable (device phase vs host-CPU phase)
    from tpubz.stream.api import last_stream_stats

    def _decode_stats():
        try:
            from tpubz.stream.decode import last_decode_stats

            return dict(last_decode_stats)
        except Exception:
            return {}

    result = {
        "metric": "encode_GBps_mixed_-9_1chip",
        "value": round(gbps, 4),
        "unit": "GB/s",
        "device": _device(),
        "card": _card(),
        "trials": trials,
        "encode_best_GBps": round(gbps_best, 4),
        "encode_trials_s": [round(t, 2) for t in enc_times],
        "corpus_mb": len(corpus) // (1024 * 1024),
        "corpus": corpus_label,
        "corpus_provenance": corpus_prov,
        "compressed_ratio": round(ratio, 4),
        "size_vs_c_bzip2": round(len(out) / max(len(ref), 1), 6),
        "decode_MBps": round(dec_mbps, 2),
        "decode_best_MBps": round(dec_mbps_best, 2),
        "decode_c_stream_MBps": round(c_dec_mbps, 2) if c_dec_mbps else None,
        "roundtrip_ok": ok,
        "phase_profile": dict(last_stream_stats),
        "decode_phase_profile": _decode_stats(),
    }
    print(json.dumps(result))
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
