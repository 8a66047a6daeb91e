"""bzip2-compatible command-line driver.

Flag surface mirrors the reference CLI (src/tools/cli.rs:306-340): combined
short flags (``-v4k``), ``-1..-9`` block sizes, ``--fast``/``--best``,
invoked-as dispatch (bunzip2 -> decompress, bzcat -> decompress to stdout),
stdin/stdout when no files are given. Where the reference leaves flags
unimplemented (``-k`` always keeps, ``-f``, ``-t`` no-op — cli.rs:314-322,
main.rs:33), this driver implements the real semantics of the canonical C
tool: delete inputs on success unless -k, refuse to overwrite without -f,
and -t actually decodes and checks CRCs.
"""
from __future__ import annotations

import os
import sys

LICENSE = """tpubz — an accelerator-native bzip2-format codec (JAX/XLA).
Implements the bzip2 stream format of Julian Seward's bzip2.
This software is provided as-is, without warranty."""

VERSION = "0.1.0"

HELP = """usage: tpubz [flags and input files in any order]

   -h --help           print this message
   -d --decompress     force decompression
   -z --compress       force compression
   -k --keep           keep (don't delete) input files
   -f --force          overwrite existing output files
   -t --test           test compressed file integrity
   -c --stdout         output to standard out
   -q --quiet          suppress noncritical error messages
   -v --verbose        be verbose (a 2nd -v gives more)
   -L --license        display software version & license
   -V --version        display software version & license
   -s --small          use less memory (accepted; same engine)
   -1 .. -9            set block size to 100k .. 900k
   --fast              alias for -1
   --best              alias for -9
   --iterations=N      Huffman refinement passes (default 8, min 4;
                       more passes can only shrink output)
   --workfactor=N      accepted for flag-surface parity with bzip2's
                       fallback-sort control (0-250); this codec's BWT
                       engines have no randomization fallback, so the
                       value is parsed, validated and unused — exactly
                       the reference's stance (cli.rs:62-85 parses it,
                       nothing reads it)
   --profile=DIR       write a jax.profiler trace of the compression to
                       DIR (device-engine runs; view with tensorboard)
   --trace-bits        decode through the scalar reference decoder with
                       a bit-position log line for every header field
                       and decoded symbol (format debugging; implies -vv
                       on the decode path; the reference's equivalent is
                       its decompress.rs:312-318 trace)

   If invoked as `bunzip2', default action is to decompress.
              as `bzcat', default action is to decompress to stdout.

   If no file names are given, tpubz compresses or decompresses
   from standard input to standard output. You can combine
   short flags, so `-v -4' means the same as -v4 or -4v, &c."""


class Opts:
    def __init__(self):
        self.mode = "zip"  # zip | unzip | test
        self.level = 9
        self.keep = False
        self.force = False
        self.stdout = False
        self.quiet = False
        self.small = False
        self.verbosity = 0
        self.files: list[str] = []
        self.engine = "auto"  # auto | host | device
        self.iterations: int | None = None
        self.profile: str | None = None
        self.trace_bits = False
        self.workfactor: int | None = None  # parsed-unused, like the ref


def parse_args(argv: list[str], prog: str = "tpubz") -> Opts:
    o = Opts()
    base = os.path.basename(prog)
    if base.startswith("bunzip2") or base.startswith("tpunzip"):
        o.mode = "unzip"
    elif base.startswith("bzcat") or base.startswith("tpcat"):
        o.mode = "unzip"
        o.stdout = True

    def short(ch: str):
        if ch == "h":
            print(HELP)
            raise SystemExit(0)
        elif ch == "d":
            o.mode = "unzip"
        elif ch == "z":
            o.mode = "zip"
        elif ch == "k":
            o.keep = True
        elif ch == "f":
            o.force = True
        elif ch == "t":
            o.mode = "test"
        elif ch == "c":
            o.stdout = True
        elif ch == "q":
            o.quiet = True
        elif ch == "v":
            o.verbosity += 1
        elif ch in "LV":
            print(f"tpubz {VERSION}\n{LICENSE}")
            raise SystemExit(0)
        elif ch == "s":
            o.small = True
        elif ch in "123456789":
            o.level = int(ch)
        else:
            raise SystemExit(f"tpubz: bad flag -{ch} (see --help)")

    long_flags = {
        "--help": "h",
        "--decompress": "d",
        "--compress": "z",
        "--keep": "k",
        "--force": "f",
        "--test": "t",
        "--stdout": "c",
        "--quiet": "q",
        "--verbose": "v",
        "--license": "L",
        "--version": "V",
        "--small": "s",
        "--fast": "1",
        "--best": "9",
    }
    for arg in argv:
        if arg.startswith("--"):
            if arg.startswith("--iterations="):
                try:
                    o.iterations = int(arg.split("=", 1)[1])
                except ValueError:
                    raise SystemExit(f"tpubz: bad value in {arg} (see --help)")
            elif arg.startswith("--profile="):
                o.profile = arg.split("=", 1)[1]
            elif arg == "--trace-bits":
                o.trace_bits = True
            elif arg.startswith("--workfactor="):
                try:
                    o.workfactor = int(arg.split("=", 1)[1])
                except ValueError:
                    raise SystemExit(f"tpubz: bad value in {arg} (see --help)")
                if not 0 <= o.workfactor <= 250:
                    raise SystemExit(
                        f"tpubz: workfactor must be 0..250 (see --help)"
                    )
            elif arg == "--host-engine":
                o.engine = "host"
            elif arg == "--device-engine":
                o.engine = "device"
            elif arg in long_flags:
                short(long_flags[arg])
            else:
                raise SystemExit(f"tpubz: bad flag {arg} (see --help)")
        elif arg.startswith("-") and len(arg) > 1:
            for ch in arg[1:]:
                short(ch)
        else:
            o.files.append(arg)
    return o


def _log(o: Opts, level: int, msg: str):
    if o.verbosity >= level and not o.quiet:
        print(msg, file=sys.stderr)


def _compress_fn(o: Opts):
    if o.engine == "device":
        from .stream.api import compress

        return compress
    if o.engine == "host":
        # threaded native CPU engine (same output bytes as the device path;
        # the pure-python oracle stays available as tpubz.hostref.stream)
        from .stream.api import compress_cpu

        return compress_cpu
    # auto: device if an accelerator is importable, else host
    try:
        from .stream.api import compress

        return compress
    except Exception:
        from .hostref.stream import compress

        return compress


def _decompress_fn(trace_bits: bool = False):
    if trace_bits:
        # the scalar reference decoder is the one wired for bit tracing
        # (hostref/block.py field positions + per-symbol positions in
        # hostref/huffman.py behind TPUBZ_TRACE_BITS)
        import logging
        import os

        os.environ["TPUBZ_TRACE_BITS"] = "1"
        logging.getLogger("tpubz").setLevel(logging.DEBUG)
        from .hostref.stream import decompress

        return decompress
    from .stream.decode import decompress

    return decompress


def _setup_logging(o: Opts):
    import logging

    # -v..-vvvvv maps to log levels like the reference (cli.rs:294-301)
    level = (
        logging.ERROR if o.verbosity == 0 or o.quiet
        else logging.WARNING if o.verbosity == 1
        else logging.INFO if o.verbosity in (2, 3)
        else logging.DEBUG
    )
    logging.basicConfig(stream=sys.stderr, level=level,
                        format="tpubz: %(message)s")
    logging.getLogger("tpubz").setLevel(level)


def run(argv: list[str], prog: str = "tpubz") -> int:
    o = parse_args(argv, prog)
    _setup_logging(o)
    if o.profile:
        # one jax.profiler trace around the whole operation (covers the
        # streaming file paths too); library callers get the same via
        # TPUBZ_PROFILE on stream.api.compress
        import jax

        with jax.profiler.trace(o.profile):
            return _run(o)
    return _run(o)


def _run(o: Opts) -> int:
    if o.iterations is not None:
        from .format.constants import set_huffman_iters

        set_huffman_iters(o.iterations)
    compress = _compress_fn(o) if o.mode == "zip" else None
    decompress = (
        _decompress_fn(o.trace_bits) if o.mode in ("unzip", "test") else None
    )

    if not o.files:
        # stdin/stdout: the bounded-memory streaming paths, like the C
        # tool (`bzip2 < huge` must not load the input whole); the
        # persistent pipeline keeps throughput equal to the in-memory path
        from .stream.files import compress_stream, decompress_stream

        if o.mode == "zip":
            if o.engine == "host":
                sys.stdout.buffer.write(compress(sys.stdin.buffer.read(), o.level))
            else:
                compress_stream(sys.stdin.buffer, sys.stdout.buffer, o.level)
        elif o.mode == "unzip":
            if o.trace_bits:
                # the traced scalar decoder needs the whole buffer
                sys.stdout.buffer.write(decompress(sys.stdin.buffer.read()))
            else:
                decompress_stream(sys.stdin.buffer, sys.stdout.buffer)
        else:
            decompress(sys.stdin.buffer.read())
            _log(o, 1, "stdin: ok")
        return 0

    rc = 0
    for fname in o.files:
        try:
            # --trace-bits must flow through the whole-buffer scalar
            # decoder (the traced one), not the windowed file decoder —
            # but the flag only affects DECODE, so compression keeps its
            # bounded-memory streaming path either way
            if (
                o.mode in ("zip", "unzip")
                and not o.stdout
                and not (o.trace_bits and o.mode == "unzip")
            ):
                # streaming paths: bounded memory for arbitrarily large files
                if o.mode == "zip":
                    out_name = fname + ".bz2"
                else:
                    out_name = fname[:-4] if fname.endswith(".bz2") else fname + ".out"
                if os.path.exists(out_name) and not o.force:
                    print(
                        f"tpubz: output file {out_name} already exists "
                        "(use -f to overwrite)",
                        file=sys.stderr,
                    )
                    rc = 1
                    continue
                from .stream.files import compress_file, decompress_file

                try:
                    if o.mode == "zip":
                        compress_file(fname, out_name, o.level)
                    else:
                        decompress_file(fname, out_name)
                except BaseException:
                    # don't leave a partial output behind on failure
                    # (matches C bzip2, which deletes incomplete output)
                    try:
                        os.unlink(out_name)
                    except OSError:
                        pass
                    raise
                _log(o, 1, f"{fname} -> {out_name}")
                if not o.keep:
                    os.unlink(fname)
                continue
            with open(fname, "rb") as f:
                data = f.read()
            if o.mode == "zip":
                out = compress(data, o.level)
                out_name = fname + ".bz2"
            elif o.mode == "unzip":
                out = decompress(data)
                out_name = fname[:-4] if fname.endswith(".bz2") else fname + ".out"
            else:
                decompress(data)
                # per-file test success is reported only with -v, like the
                # canonical tool
                _log(o, 1, f"{fname}: ok")
                continue
            if o.stdout:
                sys.stdout.buffer.write(out)
            else:
                if os.path.exists(out_name) and not o.force:
                    print(
                        f"tpubz: output file {out_name} already exists "
                        "(use -f to overwrite)",
                        file=sys.stderr,
                    )
                    rc = 1
                    continue
                with open(out_name, "wb") as f:
                    f.write(out)
                _log(o, 1, f"{fname} -> {out_name}")
                if not o.keep:
                    os.unlink(fname)
        except FileNotFoundError:
            print(f"tpubz: can't open {fname}", file=sys.stderr)
            rc = 1
        except (ValueError, EOFError) as e:
            print(f"tpubz: {fname}: {e}", file=sys.stderr)
            rc = 2
    return rc


def main():
    raise SystemExit(run(sys.argv[1:], sys.argv[0]))


if __name__ == "__main__":
    main()
