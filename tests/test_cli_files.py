"""End-to-end CLI file-mode semantics.

These are exactly the behaviors the reference parses but leaves broken
(`-k` always keeps, `-f` ignored, `-t` a no-op — reference
src/tools/cli.rs:314-322, src/main.rs:33) and this driver implements for
real: delete-on-success unless -k, refuse-to-overwrite without -f, -t CRC
test mode, invoked-as bunzip2/bzcat dispatch through the real entry
points, partial-output cleanup on failure, and the 0/1/2 exit codes.
Everything drives `cli.run` on tmp files and asserts filesystem effects.
"""
import io
import os
import sys

import numpy as np
import pytest

from tpubz.cli import run


@pytest.fixture
def sample(tmp_path):
    rng = np.random.default_rng(11)
    data = (
        b"cli file mode sample\n" * 500
        + bytes(rng.integers(0, 250, 20_000, dtype=np.uint8))
    )
    p = tmp_path / "sample.txt"
    p.write_bytes(data)
    return p, data


def _bz2_of(sample_path):
    return sample_path.parent / (sample_path.name + ".bz2")


def test_compress_deletes_input_by_default(sample):
    p, data = sample
    assert run([str(p)]) == 0
    assert not p.exists(), "input must be deleted on success without -k"
    assert _bz2_of(p).exists()


def test_compress_keep_flag_keeps_input(sample, sys_bunzip2):
    p, data = sample
    assert run(["-k", str(p)]) == 0
    assert p.exists(), "-k must keep the input file"
    assert sys_bunzip2(_bz2_of(p).read_bytes()) == data


def test_compress_refuses_existing_output_without_force(sample):
    p, data = sample
    out = _bz2_of(p)
    out.write_bytes(b"precious")
    assert run(["-k", str(p)]) == 1
    assert out.read_bytes() == b"precious", "must not clobber without -f"
    assert p.exists(), "refused file must not delete its input"


def test_compress_force_overwrites(sample, sys_bunzip2):
    p, data = sample
    out = _bz2_of(p)
    out.write_bytes(b"stale")
    assert run(["-kf", str(p)]) == 0
    assert sys_bunzip2(out.read_bytes()) == data


def test_decompress_roundtrip_deletes_bz2(sample):
    p, data = sample
    assert run(["-k", str(p)]) == 0
    bz = _bz2_of(p)
    p.unlink()
    assert run(["-d", str(bz)]) == 0
    assert not bz.exists(), "decompress must delete the .bz2 without -k"
    assert p.read_bytes() == data


def test_decompress_refuses_existing_plain_without_force(sample):
    p, data = sample
    assert run(["-k", str(p)]) == 0
    assert run(["-d", "-k", str(_bz2_of(p))]) == 1  # sample.txt exists
    assert p.read_bytes() == data
    assert run(["-d", "-k", "-f", str(_bz2_of(p))]) == 0


def test_test_mode_ok_and_corrupt(sample, capsys):
    p, data = sample
    assert run(["-k", str(p)]) == 0
    bz = _bz2_of(p)
    assert run(["-t", str(bz)]) == 0
    assert bz.exists() and p.exists(), "-t must not touch any file"
    # corrupt a payload byte: CRC mismatch -> exit code 2, stderr names it
    raw = bytearray(bz.read_bytes())
    raw[len(raw) // 2] ^= 0x10
    bad = p.parent / "bad.bz2"
    bad.write_bytes(bytes(raw))
    assert run(["-t", str(bad)]) == 2
    assert "bad.bz2" in capsys.readouterr().err


def test_decompress_failure_cleans_partial_output(sample, capsys):
    p, data = sample
    assert run(["-k", str(p)]) == 0
    raw = bytearray(_bz2_of(p).read_bytes())
    raw[len(raw) // 2] ^= 0x10
    bad = p.parent / "trunc.bz2"
    bad.write_bytes(bytes(raw))
    assert run(["-d", str(bad)]) == 2
    assert bad.exists(), "failed decompress must keep its input"
    assert not (p.parent / "trunc").exists(), "no partial output on failure"
    capsys.readouterr()


def test_missing_file_exit_code(tmp_path, capsys):
    assert run([str(tmp_path / "nope.txt")]) == 1
    assert "can't open" in capsys.readouterr().err


def test_invoked_as_bunzip2_and_bzcat(sample, monkeypatch, capsys):
    p, data = sample
    assert run(["-k", str(p)]) == 0
    bz = _bz2_of(p)
    p.unlink()
    # bunzip2 semantics through the real entry point (prog dispatch)
    assert run(["-k", str(bz)], prog="/usr/local/bin/bunzip2") == 0
    assert p.read_bytes() == data
    # bzcat: decompress to stdout, touch nothing
    buf = io.BytesIO()
    monkeypatch.setattr(
        sys, "stdout", type("W", (), {"buffer": buf, "flush": lambda s: None})()
    )
    assert run([str(bz)], prog="bzcat") == 0
    assert buf.getvalue() == data
    assert bz.exists(), "bzcat must not delete its input"


def test_stdout_flag_writes_stream_touches_nothing(sample, monkeypatch):
    p, data = sample
    buf = io.BytesIO()
    monkeypatch.setattr(
        sys, "stdout", type("W", (), {"buffer": buf, "flush": lambda s: None})()
    )
    assert run(["-c", "-k", str(p)]) == 0
    assert p.exists()
    assert not _bz2_of(p).exists(), "-c must not create an output file"
    from tpubz.stream.decode import decompress

    assert decompress(buf.getvalue()) == data


def test_multi_file_mixed_exit_code(sample, tmp_path, capsys):
    p, data = sample
    other = tmp_path / "other.txt"
    other.write_bytes(b"second file " * 100)
    # one missing file among good ones: work continues, rc = 1
    assert run(["-k", str(p), str(tmp_path / "gone"), str(other)]) == 1
    assert _bz2_of(p).exists() and (tmp_path / "other.txt.bz2").exists()
    capsys.readouterr()


def test_console_entry_points_exist():
    """The installed commands dispatch through cli.main (pyproject
    [project.scripts]); parse-level invoked-as behavior is pinned here so a
    rename breaks loudly."""
    import tomllib

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["tpubz"] == "tpubz.cli:main"
    assert scripts["tpunzip2"] == "tpubz.cli:main"
    assert scripts["tpcat"] == "tpubz.cli:main"
    from tpubz.cli import parse_args

    assert parse_args([], prog="tpunzip2").mode == "unzip"
    o = parse_args([], prog="tpcat")
    assert o.mode == "unzip" and o.stdout


def test_stdin_stdout_streams_bounded(monkeypatch, capsysbinary):
    """No-file invocations stream stdin->stdout through the bounded-memory
    paths (the C tool's `bzip2 < huge` shape): compressed output must be a
    valid stream, and -d must invert it."""
    import bz2

    rng = np.random.default_rng(5)
    raw = (b"stream me please " * 4000
           + bytes(rng.integers(0, 256, 120_000, dtype=np.uint8)))

    monkeypatch.setattr(
        "sys.stdin", type("S", (), {"buffer": io.BytesIO(raw)})()
    )
    assert run(["-q", "-1"]) == 0
    z = capsysbinary.readouterr().out
    assert bz2.decompress(z) == raw

    monkeypatch.setattr(
        "sys.stdin", type("S", (), {"buffer": io.BytesIO(z)})()
    )
    assert run(["-q", "-d"]) == 0
    assert capsysbinary.readouterr().out == raw
