"""tpubz — an accelerator-native bzip2-format codec (JAX/XLA).

Public API:
  compress(data, level=9)   -> bytes   (device pipeline; host fallback)
  decompress(data)          -> bytes   (block-parallel host decode)

Layer map (data-parallel rebuild of the reference, see SURVEY.md):
  format/   stream constants, CRC-32/BZIP2, symbol maps
  kernels/  device kernels in plain JAX: suffix sort (BWT), MTF, RLE2,
            bitpack; all jit/vmap/shard_map-composable on fixed shapes
  hostref/  scalar numpy reference codec, bit-exact vs system bzip2 —
            the oracle for every kernel
  block/    per-block jitted encode pipeline
  stream/   whole-stream assembly: RLE1 pre-pass, ordered bit splicing,
            block-magic scan for parallel decode
  dist/     block-data-parallel shard_map over device meshes
"""

__version__ = "0.1.0"

# stdlib bz2's module surface; the class objects themselves load lazily
# via __getattr__ so `import tpubz` stays numpy-only (no jax import)
__all__ = [
    "BZ2Compressor",
    "BZ2Decompressor",
    "BZ2File",
    "compress",
    "decompress",
    "open",
]


def __dir__():
    return sorted(set(globals()) | set(__all__))


def open(filename, mode: str = "rb", compresslevel: int = 9,  # noqa: A001
         encoding=None, errors=None, newline=None):
    """Open a .bz2 file for incremental reading/writing — a drop-in for
    the stdlib ``bz2.open`` (constant memory; device/hybrid engines under
    the hood). See tpubz/fileobj.py."""
    from .fileobj import open as _open

    return _open(filename, mode, compresslevel, encoding, errors, newline)


def compress(data, level: int = 9) -> bytes:
    try:
        from .stream.api import compress as _c
        return _c(data, level)
    except ImportError:
        from .hostref.stream import compress as _c
        return _c(data, level)


def decompress(data) -> bytes:
    from .stream.decode import decompress as _d
    return _d(bytes(data))


def __getattr__(name):
    # stdlib-bz2-compatible incremental codec objects, loaded lazily
    if name in ("BZ2Compressor", "BZ2Decompressor"):
        from . import incremental

        return getattr(incremental, name)
    if name == "BZ2File":
        # bz2.BZ2File drop-in (binary file object incl. read-mode
        # seek/peek); see tpubz/fileobj.py
        from .fileobj import TpubzFile

        return TpubzFile
    raise AttributeError(f"module 'tpubz' has no attribute {name!r}")
