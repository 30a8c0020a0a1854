"""--checkpoint FILE: crash-kill / resume produces byte-identical
output.

The reference's closest feature is manual resume via --counter-offset
(options.rs:78-80); this build checkpoints the full streaming state
(mission carry states + stream offset + carry tail + held boundary
findings) after every chunk, so an interrupted scan resumes
mid-stream with output byte-identical to an uninterrupted run.
"""

import io
import json
import os

import numpy as np
import pytest

from stringsext_tpu import native
from stringsext_tpu.cli import parse_args
from stringsext_tpu.mission import Missions
from stringsext_tpu.run import _run_streaming_stdin, run

pytestmark = pytest.mark.skipif(
    native.get_lib() is None, reason="no native toolchain"
)

rng = np.random.default_rng(17)


def _corpus(n=80_000):
    data = bytearray(rng.integers(0, 256, n, np.uint8).tobytes())
    msgs = [
        b"checkpointed ascii string",
        "resume déjà € utf-8".encode("utf-8"),
        "wide ЖЖ utf16 string".encode("utf-16-le"),
    ]
    k = 0
    for edge in range(4096, n - 64, 4096):
        m = msgs[k % len(msgs)]
        off = edge - 1 - (k % (len(m) - 1))
        data[off:off + len(m)] = m
        k += 1
    return bytes(data)


class _DyingReader:
    """Raises after serving `die_after` bytes (simulated crash)."""

    def __init__(self, blob, die_after):
        self.src = io.BytesIO(blob)
        self.left = die_after

    def read(self, n):
        if self.left <= 0:
            raise RuntimeError("simulated crash")
        got = self.src.read(n)
        self.left -= len(got)
        return got


ARGV = ["-t", "x", "-e", "UTF-8", "-e", "utf-16le"]


def _stream_once(blob, argv, ck=None, chunk=8192, die_after=None):
    args = parse_args(argv + ["-"])
    ms = Missions.from_args(args)
    buf = io.BytesIO()
    src = io.BytesIO(blob) if die_after is None else _DyingReader(
        blob, die_after)
    rc = _run_streaming_stdin(
        args, ms, buf, src=src, chunk_bytes=chunk, checkpoint_path=ck)
    assert rc == 0
    return buf.getvalue()


def test_kill_resume_byte_identical(tmp_path):
    blob = _corpus()
    expected = _stream_once(blob, ARGV)

    ck = str(tmp_path / "scan.ck")
    args = parse_args(ARGV + ["-"])
    ms = Missions.from_args(args)
    buf1 = io.BytesIO()
    with pytest.raises(RuntimeError, match="simulated crash"):
        _run_streaming_stdin(
            args, ms, buf1, src=_DyingReader(blob, 3 * 8192),
            chunk_bytes=8192, checkpoint_path=ck)
    assert os.path.exists(ck)  # crash left a resumable checkpoint

    # Resume from a FRESH stream of the same input (non-seekable path).
    buf2 = io.BytesIO()
    rc = _run_streaming_stdin(
        args, ms, buf2, src=_NoSeek(blob),
        chunk_bytes=8192, checkpoint_path=ck)
    assert rc == 0
    assert buf1.getvalue() + buf2.getvalue() == expected
    assert not os.path.exists(ck)  # completion removes the checkpoint


class _NoSeek:
    def __init__(self, blob):
        self.src = io.BytesIO(blob)

    def read(self, n):
        return self.src.read(n)


@pytest.mark.parametrize("die_chunks", [1, 2, 5])
def test_kill_resume_various_points(tmp_path, die_chunks):
    blob = _corpus(50_000)
    expected = _stream_once(blob, ARGV, chunk=4096)
    ck = str(tmp_path / "scan.ck")
    args = parse_args(ARGV + ["-"])
    ms = Missions.from_args(args)
    buf1 = io.BytesIO()
    with pytest.raises(RuntimeError):
        _run_streaming_stdin(
            args, ms, buf1, src=_DyingReader(blob, die_chunks * 4096),
            chunk_bytes=4096, checkpoint_path=ck)
    buf2 = io.BytesIO()
    rc = _run_streaming_stdin(
        args, ms, buf2, src=_NoSeek(blob), chunk_bytes=4096,
        checkpoint_path=ck)
    assert rc == 0
    assert buf1.getvalue() + buf2.getvalue() == expected


def test_double_resume(tmp_path):
    """Crash twice, resume twice: three fragments concatenate to the
    uninterrupted output."""
    blob = _corpus(60_000)
    expected = _stream_once(blob, ARGV, chunk=4096)
    ck = str(tmp_path / "scan.ck")
    args = parse_args(ARGV + ["-"])
    ms = Missions.from_args(args)
    frags = []
    for die in (2 * 4096, 6 * 4096, None):
        buf = io.BytesIO()
        src = _NoSeek(blob) if die is None else _DyingReader(blob, die)
        if die is None:
            rc = _run_streaming_stdin(
                args, ms, buf, src=src, chunk_bytes=4096,
                checkpoint_path=ck)
            assert rc == 0
        else:
            with pytest.raises(RuntimeError):
                _run_streaming_stdin(
                    args, ms, buf, src=src, chunk_bytes=4096,
                    checkpoint_path=ck)
        frags.append(buf.getvalue())
    assert b"".join(frags) == expected


def test_run_checkpoint_file_input(tmp_path):
    """run() routes --checkpoint file scans through the streaming path
    (no crash: the checkpoint is written and then removed)."""
    blob = _corpus(40_000)
    p = tmp_path / "in.bin"
    p.write_bytes(blob)
    ck = tmp_path / "scan.ck"
    buf = io.BytesIO()
    rc = run(parse_args(ARGV + ["--checkpoint", str(ck), str(p)]), out=buf)
    assert rc == 0
    assert not ck.exists()
    buf2 = io.BytesIO()
    rc = run(parse_args(ARGV + [str(p)]), out=buf2)
    assert rc == 0
    assert buf.getvalue() == buf2.getvalue()


def test_run_checkpoint_validations(tmp_path):
    p1 = tmp_path / "a.bin"
    p2 = tmp_path / "b.bin"
    p1.write_bytes(b"x" * 10)
    p2.write_bytes(b"y" * 10)
    ck = tmp_path / "scan.ck"
    with pytest.raises(RuntimeError, match="single input"):
        run(parse_args(
            ARGV + ["--checkpoint", str(ck), str(p1), str(p2)]),
            out=io.BytesIO())


def test_checkpoint_with_dist_stdin_rejected():
    """--checkpoint + --dist-nprocs is SUPPORTED for file inputs
    (per-rank scan-phase resume; process-level kill/resume pinned in
    tests/test_distributed_2proc.py::test_two_process_checkpoint_resume),
    but stdin still cannot be sharded - that combination must fail
    loudly before joining any runtime."""
    with pytest.raises(RuntimeError, match="stdin"):
        run(parse_args(
            ARGV + ["--checkpoint", "/tmp/never.ck", "--dist-nprocs", "2",
                    "--dist-rank", "0", "-"]),
            out=io.BytesIO())


def test_resume_refuses_foreign_output(tmp_path):
    """Resuming into a DIFFERENT pre-existing file that is longer than
    the checkpointed offset must refuse (truncating would destroy the
    unrelated file's tail); the checkpoint records the original
    output's (st_dev, st_ino)."""
    blob = _corpus(60_000)
    ck = str(tmp_path / "scan.ck")
    outp = tmp_path / "out.bin"
    args = parse_args(ARGV + ["-"])
    ms = Missions.from_args(args)
    with open(outp, "wb") as out:
        with pytest.raises(RuntimeError, match="simulated crash"):
            _run_streaming_stdin(
                args, ms, out, src=_DyingReader(blob, 3 * 8192),
                chunk_bytes=8192, checkpoint_path=ck)
    other = tmp_path / "unrelated.bin"
    other.write_bytes(b"Z" * (outp.stat().st_size + 4096))
    with open(other, "r+b") as out:
        with pytest.raises(RuntimeError, match="refusing"):
            _run_streaming_stdin(
                args, ms, out, src=_NoSeek(blob),
                chunk_bytes=8192, checkpoint_path=ck)
    # the unrelated file is untouched
    assert other.read_bytes() == b"Z" * (outp.stat().st_size + 4096)
    # resuming into the ORIGINAL file still works
    with open(outp, "r+b") as out:
        rc = _run_streaming_stdin(
            args, ms, out, src=_NoSeek(blob),
            chunk_bytes=8192, checkpoint_path=ck)
        assert rc == 0
    expected = io.BytesIO()
    rc = _run_streaming_stdin(args, ms, expected, src=_NoSeek(blob),
                              chunk_bytes=8192)
    assert rc == 0
    assert outp.read_bytes() == expected.getvalue()


def test_resume_mission_set_mismatch(tmp_path):
    blob = _corpus(30_000)
    ck = str(tmp_path / "scan.ck")
    args = parse_args(ARGV + ["-"])
    ms = Missions.from_args(args)
    with pytest.raises(RuntimeError):
        _run_streaming_stdin(
            args, ms, io.BytesIO(), src=_DyingReader(blob, 4096),
            chunk_bytes=4096, checkpoint_path=ck)
    args2 = parse_args(["-e", "UTF-8", "-"])
    ms2 = Missions.from_args(args2)
    with pytest.raises(ValueError, match="mission"):
        _run_streaming_stdin(
            args2, ms2, io.BytesIO(), src=_NoSeek(blob),
            chunk_bytes=4096, checkpoint_path=ck)


def test_checkpoint_json_shape(tmp_path):
    """The on-disk checkpoint is versioned JSON with the documented
    fields (a user can inspect progress with jq)."""
    blob = _corpus(30_000)
    ck = str(tmp_path / "scan.ck")
    args = parse_args(ARGV + ["-"])
    ms = Missions.from_args(args)
    with pytest.raises(RuntimeError):
        _run_streaming_stdin(
            args, ms, io.BytesIO(), src=_DyingReader(blob, 2 * 4096),
            chunk_bytes=4096, checkpoint_path=ck)
    with open(ck) as f:
        d = json.load(f)
    assert d["version"] == 2
    assert d["stream_pos"] == 2 * 4096
    assert len(d["missions"]) == 2
    assert isinstance(d["carry"], str) and isinstance(d["held"], list)


def test_resume_same_count_different_missions_rejected(tmp_path):
    """Same mission COUNT but different encodings/filters must be
    rejected (the fingerprint check): carry states seeded into the
    wrong decoders would silently corrupt the resumed output."""
    blob = _corpus(30_000)
    ck = str(tmp_path / "scan.ck")
    args = parse_args(ARGV + ["-"])  # UTF-8 + utf-16le
    ms = Missions.from_args(args)
    with pytest.raises(RuntimeError):
        _run_streaming_stdin(
            args, ms, io.BytesIO(), src=_DyingReader(blob, 4096),
            chunk_bytes=4096, checkpoint_path=ck)
    # two missions again, but a different set / different -n
    for argv2 in (["-t", "x", "-e", "UTF-8", "-e", "utf-16be", "-"],
                  ["-t", "x", "-e", "UTF-8", "-e", "utf-16le", "-n", "9",
                   "-"]):
        args2 = parse_args(argv2)
        ms2 = Missions.from_args(args2)
        with pytest.raises(ValueError, match="mission"):
            _run_streaming_stdin(
                args2, ms2, io.BytesIO(), src=_NoSeek(blob),
                chunk_bytes=4096, checkpoint_path=ck)


def test_resume_same_file_truncates_duplicate_tail(tmp_path):
    """Exactly-once on a same-file resume: lines written AFTER the last
    checkpoint save (crash in the emit->save window) are truncated on
    resume, so the final file equals an uninterrupted run."""
    blob = _corpus(60_000)
    ck = str(tmp_path / "scan.ck")
    outp = tmp_path / "out.bin"
    args = parse_args(ARGV + ["-"])
    ms = Missions.from_args(args)

    expected = io.BytesIO()
    rc = _run_streaming_stdin(args, ms, expected, src=_NoSeek(blob),
                              chunk_bytes=8192)
    assert rc == 0

    with open(outp, "wb") as out:
        with pytest.raises(RuntimeError):
            _run_streaming_stdin(
                args, ms, out, src=_DyingReader(blob, 3 * 8192),
                chunk_bytes=8192, checkpoint_path=ck)
        # simulate the crash window: garbage written after the save
        out.write(b"DUPLICATE CHUNK LINES THAT MUST VANISH")
    with open(outp, "r+b") as out:
        rc = _run_streaming_stdin(
            args, ms, out, src=_NoSeek(blob),
            chunk_bytes=8192, checkpoint_path=ck)
        assert rc == 0
    assert outp.read_bytes() == expected.getvalue()
    assert not os.path.exists(ck)  # removed on success
