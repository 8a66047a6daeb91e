"""Device (jnp) kernels vs the host reference, on the CPU backend.

Shapes stay small: XLA CPU executes these kernels slowly and tests must be
fast; bit-exactness is shape-independent.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpubz.hostref.bwt import bwt_encode
from tpubz.kernels.bitpack import pack_bits_device, words_to_bytes
from tpubz.kernels.mtf import mtf_ranks
from tpubz.kernels.rle2 import rle2_encode
from tpubz.kernels.suffix_sort import bwt_forward
from tpubz.hostref.bitio import pack_bits
from tpubz.hostref.mtf_rle2 import mtf_rle2_encode

N = 1024


def _pad(d):
    p = np.zeros(N, np.uint8)
    p[: d.size] = d
    return jnp.asarray(p)


@pytest.fixture(scope="module")
def cases(rng):
    return [
        b"banana" * 30,
        b"aaaa" * 100,
        b"ab" * 300,
        bytes(rng.integers(0, 256, 1000, dtype=np.uint8)),
        bytes(rng.integers(0, 4, 1024, dtype=np.uint8)),
        b"x",
    ]


def test_device_bwt_matches_host(cases):
    f = jax.jit(bwt_forward)
    for c in cases:
        d = np.frombuffer(c, np.uint8)
        key, last = f(_pad(d), jnp.int32(d.size))
        hk, hlast = bwt_encode(d)
        assert int(key) == hk
        assert bytes(np.asarray(last)[: d.size]) == bytes(hlast)


def test_device_bwt_batch_mode_matches_host(cases):
    """skip_converged="batch" (while_loop convergence exit, used by the
    vmapped/sharded paths) must be bitwise-identical to the host reference
    for a batch mixing fast- and slow-converging blocks — the loop exits at
    max(active rounds), freezing already-done blocks."""
    f = jax.jit(
        jax.vmap(lambda d, m: bwt_forward(d, m, skip_converged="batch"))
    )
    batch = jnp.stack([_pad(np.frombuffer(c, np.uint8)) for c in cases])
    ns = jnp.asarray([len(c) for c in cases], jnp.int32)
    keys, lasts = f(batch, ns)
    for i, c in enumerate(cases):
        hk, hlast = bwt_encode(np.frombuffer(c, np.uint8))
        assert int(keys[i]) == hk
        assert bytes(np.asarray(lasts[i])[: len(c)]) == bytes(hlast)


def test_device_mtf_rle2_matches_host(cases):
    @jax.jit
    def chain(data, n):
        ranks, used = mtf_ranks(data, n, chunk=128)
        eob = jnp.sum(used) + 1
        return rle2_encode(ranks, n, eob)

    for c in cases:
        d = np.frombuffer(c, np.uint8)
        syms, rlen, freqs = chain(_pad(d), jnp.int32(d.size))
        h_rle2, h_freqs, _ = mtf_rle2_encode(d)
        assert list(np.asarray(syms)[: int(rlen)]) == list(h_rle2)
        assert list(np.asarray(freqs)) == list(h_freqs.astype(np.int64))


def test_device_bitpack_matches_host(rng):
    m = 500
    bits = rng.integers(1, 25, m).astype(np.int32)
    vals = (rng.integers(0, 1 << 24, m) & ((1 << bits) - 1)).astype(np.uint32)
    # sprinkle zero-length fields
    bits[::7] = 0
    vals[::7] = 0
    total = int(bits.sum())
    words, nbits = jax.jit(pack_bits_device, static_argnames=("out_words",))(
        jnp.asarray(vals), jnp.asarray(bits), out_words=(total + 31) // 32 + 1
    )
    assert int(nbits) == total
    got = words_to_bytes(words, total)
    exp = pack_bits(vals[bits > 0], bits[bits > 0])
    assert got == exp


def test_device_ibwt_matches_host(rng):
    """Device pointer-doubling inverse BWT vs the host chase. The kernel is
    not a stream route (decode runs on the host); this keeps the device
    formulation itself correct."""
    from tpubz.hostref.bwt import bwt_decode_fast, bwt_encode
    from tpubz.kernels.ibwt import bwt_inverse_device

    cases = [
        b"banana" * 100,
        bytes(rng.integers(0, 256, 5000, dtype=np.uint8)),
        b"a" * 2000,
        b"x",
        bytes(rng.integers(0, 4, 9000, dtype=np.uint8)),
    ]
    for d in cases:
        arr = np.frombuffer(d, np.uint8)
        key, last = bwt_encode(arr)
        host = bwt_decode_fast(int(key), last)
        dev = bwt_inverse_device(int(key), last, last.size)
        assert np.array_equal(host, dev), d[:16]
        assert bytes(host) == d


def test_python_decode_path_matches_native(rng, monkeypatch):
    """The pure-Python envelope decode path (taken when the native lib is
    unavailable) must match the native path byte-for-byte."""
    import tpubz.stream.decode as sd
    from tpubz.hostref.stream import compress

    d = bytes(rng.integers(0, 200, 60_000, dtype=np.uint8)) + b"z" * 5000
    c = compress(d, 1)
    assert sd.decompress(c) == d
    monkeypatch.setattr("tpubz.native.get_lib", lambda: None)
    assert sd.decompress(c) == d


def _block_class(kind: str, n: int) -> np.ndarray:
    """Small stand-ins for chip_smoke.py's three full-width block classes."""
    rng = np.random.default_rng(7)
    if kind == "mixed":
        text = np.frombuffer(b"the quick brown fox jumps over the lazy dog\n" * 40, np.uint8)
        return np.concatenate((text, rng.integers(0, 256, n, dtype=np.uint8)))[:n]
    if kind == "periodic":
        b = np.resize(rng.integers(0, 256, 100, dtype=np.uint8), n)
        b[n // 2] ^= 0x5A
        return b
    return rng.integers(0, 256, n, dtype=np.uint8)


@pytest.mark.parametrize("kind", ["mixed", "periodic", "random"])
def test_mtf_ranks_matches_host_oracle(kind):
    """The jnp dominance MTF (the one device MTF engine) gives the host
    oracle's rank of every byte, and its used-symbol set."""
    from tpubz.hostref.mtf_rle2 import mtf_encode

    n = 3000
    block = _block_class(kind, n)
    pad = np.zeros(4096, np.uint8)
    pad[:n] = block
    ranks, used = jax.jit(mtf_ranks, static_argnames="chunk")(
        jnp.asarray(pad), jnp.int32(n), chunk=256
    )
    h_ranks, h_used = mtf_encode(block)
    assert np.array_equal(np.asarray(ranks)[:n], h_ranks)
    assert np.array_equal(np.asarray(used), h_used)
